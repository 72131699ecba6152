# forge3d_tpu_torch/guiding.py
# Path guiding (forge3d_tpu/guiding.py): a spatial-directional radiance
# cache that steers bounce sampling. A dense (cells^2, res^2) float32
# histogram over a world AABB; directions are binned by a concentric
# octahedral map. Kernel E7 (csrc/leaf.cuh, launched by csrc/leaf.cu):
# `octa_encode` and `octa_decode` (one thread a direction or bin),
# `GuidingCache.record` (one thread a record forms its flat bin, the
# records are sorted by bin with torch.sort(stable=True), one thread a
# sorted record marks its bin's run, then one thread a bin adds its run in
# record order), and `GuidingCache.sample`
# (one thread a query). The plain PyTorch versions sit beside each here;
# CPU tensors run them, CUDA tensors launch the kernels.
#
# Rounding against JAX, which runs these functions eagerly on XLA's CPU:
# - record's scatter-add applies the updates in record order there, so each
#   bin is its old value plus its records' luminance in turn; both versions
#   sum so (atomics would sum in any order), and equal JAX bit for bit;
# - sample's row total and CDF follow XLA's own orders for jnp.sum and
#   jnp.cumsum (csrc/leaf.cuh has them), so the CDF, and with it the
#   sampled bin and its pdf, equal JAX bit for bit; the jittered directions
#   go through cos and sin, which XLA does not compute as the C library
#   does: 1e-5 (1 + |ref|);
# - a float32 to int32 conversion is XLA's: toward zero, saturating, NaN to
#   0 (so a zero direction lands in bin 0).

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _kernels
from .ops.shading import fdiv, fma32, sqrt32

__all__ = ["GuidingCache", "octa_encode", "octa_decode"]

_F32 = torch.float32


def _f(x) -> float:
    return float(np.float32(x))


def _to_int(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 -> int32 conversion (as int64): toward zero,
    saturating, NaN -> 0."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return torch.clamp(x, -2.0 ** 31, 2.0 ** 31 - 1).to(torch.int64)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: NaN stays NaN (torch.sign gives 0)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _octa_encode_plain(dx, dy, dz, res: int):
    nrm = (dx.abs() + dy.abs()) + dz.abs()
    u = fdiv(dx, nrm)
    v = fdiv(dz, nrm)
    # fold the lower hemisphere
    lower = dy < 0
    u2 = torch.where(lower, (1.0 - v.abs()) * _sign(u), u)
    v2 = torch.where(lower, (1.0 - u.abs()) * _sign(v), v)
    iu = torch.clamp(_to_int((u2 * 0.5 + 0.5) * float(res)), 0, res - 1)
    iv = torch.clamp(_to_int((v2 * 0.5 + 0.5) * float(res)), 0, res - 1)
    return (iv * res + iu).to(torch.int32)


def _octa_decode_plain(bin_idx, res: int):
    b = bin_idx.to(torch.int64)
    iv = b // res
    iu = b % res
    u = fdiv(iu.to(_F32) + 0.5, float(res)) * 2.0 - 1.0
    v = fdiv(iv.to(_F32) + 0.5, float(res)) * 2.0 - 1.0
    y = (1.0 - u.abs()) - v.abs()
    lower = y < 0
    u2 = torch.where(lower, (1.0 - v.abs()) * _sign(u), u)
    v2 = torch.where(lower, (1.0 - u.abs()) * _sign(v), v)
    # jnp.linalg.norm is jitted: its squares fused into the sum
    nrm = sqrt32(fma32(v2, v2, fma32(y, y, u2 * u2)))
    return torch.stack([fdiv(u2, nrm), fdiv(y, nrm), fdiv(v2, nrm)], -1)


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32, device=device)


def octa_encode(dx, dy, dz, res: int, device=None):
    """Direction -> octahedral bin index in [0, res*res), int32. Tensors
    stay on their device; numpy input goes to `device` (the card unless
    device="cpu")."""
    from .pt.terrain_ref import device_for

    dev = device_for(dx, device)
    d = torch.broadcast_tensors(*(_as_f32(c, dev) for c in (dx, dy, dz)))
    if dev.type == "cpu":
        return _octa_encode_plain(*d, int(res))
    return _octa_encode_kernel(*d, int(res))


def _octa_encode_kernel(dx, dy, dz, res: int):
    d = [c.contiguous() for c in (dx, dy, dz)]
    _kernels.require_cuda("E7 octa_encode", *d)
    out = torch.empty(d[0].shape, dtype=torch.int32, device=d[0].device)
    err = _kernels.lib().f3d_octa_encode(*(_kernels.ptr(c) for c in d), out.numel(), res,
                                         _kernels.ptr(out), _kernels.stream_ptr(out.device))
    _kernels.check(err, "E7 octa_encode")
    octa_encode.launches += 1
    return out


def octa_decode(bin_idx, res: int, device=None):
    """Bin center -> unit direction, (..., 3) float32."""
    from .pt.terrain_ref import device_for

    dev = device_for(bin_idx, device)
    b = torch.as_tensor(bin_idx, device=dev)
    if dev.type == "cpu":
        return _octa_decode_plain(b, int(res))
    return _octa_decode_kernel(b, int(res))


def _octa_decode_kernel(bin_idx, res: int):
    b = bin_idx.to(torch.int32).contiguous()
    _kernels.require_cuda("E7 octa_decode", b)
    out = torch.empty((3,) + tuple(b.shape), dtype=_F32, device=b.device)
    err = _kernels.lib().f3d_octa_decode(_kernels.ptr(b), b.numel(), res, _kernels.ptr(out),
                                         _kernels.stream_ptr(b.device))
    _kernels.check(err, "E7 octa_decode")
    octa_decode.launches += 1
    return torch.movedim(out, 0, -1)


octa_encode.launches = 0
octa_decode.launches = 0


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """jnp.sum(x, -1) in XLA's CPU order: sequential up to 32 elements,
    else windows of 32 (zero-padded evenly at both ends), each summed in
    order, then the window sums by the same rule."""
    B = x.shape[-1]
    if B <= 32:
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for j in range(B):
            acc = acc + x[..., j]
        return acc
    nw = -(-B // 32)
    lo = (nw * 32 - B) // 2
    xp = torch.nn.functional.pad(x, (lo, nw * 32 - B - lo))
    return xla_sum(xla_sum(xp.reshape(x.shape[:-1] + (nw, 32))))


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """jnp.cumsum(x, -1) in XLA's CPU order: sequential up to 16 elements,
    else blocks of 16 (zero-padded at the end), a sequential prefix in each,
    plus the exclusive prefix of the block totals, cumsummed by the same
    rule."""
    B = x.shape[-1]
    if B <= 16:
        out = torch.empty_like(x)
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for j in range(B):
            acc = acc + x[..., j]
            out[..., j] = acc
        return out
    nb = -(-B // 16)
    inb = xla_cumsum(torch.nn.functional.pad(x, (0, nb * 16 - B)).reshape(
        x.shape[:-1] + (nb, 16)))
    inc = xla_cumsum(inb[..., 15])
    ex = torch.nn.functional.pad(inc[..., :-1], (1, 0))
    return (inb + ex[..., None]).reshape(x.shape[:-1] + (nb * 16,))[..., :B]


class GuidingCache(NamedTuple):
    """(cells_x * cells_z, bins) luminance histogram over a world AABB; the
    histogram is a float32 tensor on the cache's device."""

    hist: torch.Tensor
    origin: Tuple[float, float]
    extent: Tuple[float, float]
    cells: int
    octa_res: int

    @staticmethod
    def create(origin_xz, extent_xz, *, cells: int = 32,
               octa_res: int = 8, device="cuda") -> "GuidingCache":
        """An empty cache on `device` (the card unless device="cpu")."""
        from .pt.terrain_ref import resolve_device

        return GuidingCache(
            hist=torch.full((cells * cells, octa_res * octa_res), _f(1e-3), dtype=_F32,
                            device=resolve_device(device)),
            origin=(float(origin_xz[0]), float(origin_xz[1])),
            extent=(float(extent_xz[0]), float(extent_xz[1])),
            cells=cells, octa_res=octa_res)

    def _cell_of(self, px, pz):
        cx = torch.clamp(_to_int(fdiv(px - _f(self.origin[0]), _f(self.extent[0]))
                                 * float(self.cells)), 0, self.cells - 1)
        cz = torch.clamp(_to_int(fdiv(pz - _f(self.origin[1]), _f(self.extent[1]))
                                 * float(self.cells)), 0, self.cells - 1)
        return cz * self.cells + cx

    def kernel_args(self) -> _kernels.GuideArgs:
        return _kernels.GuideArgs(_f(self.origin[0]), _f(self.origin[1]), _f(self.extent[0]),
                                  _f(self.extent[1]), _f(self.cells),
                                  _f(2 * math.pi / self.octa_res), self.cells, self.octa_res)

    def _inputs(self, *arrays):
        return torch.broadcast_tensors(*(_as_f32(a, self.hist.device) for a in arrays))

    def record(self, px, pz, dx, dy, dz, luminance) -> "GuidingCache":
        """Scatter-add observed radiance into the cache (pure update): each
        touched bin is its old value plus its records' luminance in record
        order. Inputs go to the cache's device; a CUDA cache launches E7
        record."""
        px, pz, dx, dy, dz, lum = self._inputs(px, pz, dx, dy, dz, luminance)
        if self.hist.device.type == "cpu":
            flat = (self._cell_of(px, pz) * (self.octa_res ** 2)
                    + _octa_encode_plain(dx, dy, dz, self.octa_res))
            hist = record_plain(self.hist, flat.reshape(-1), lum.reshape(-1))
        else:
            hist = _record_kernel(self, px, pz, dx, dy, dz, lum)
        return self._replace(hist=hist)

    def sample(self, px, pz, u1, u2):
        """Importance-sample a direction per point from the cached
        distribution; returns (dx, dy, dz, pdf). CDF inversion per cell.
        Inputs go to the cache's device; a CUDA cache launches E7 sample."""
        px, pz, u1, u2 = self._inputs(px, pz, u1, u2)
        if self.hist.device.type == "cpu":
            return sample_plain(self, px, pz, u1, u2)
        return _sample_kernel(self, px, pz, u1, u2)

    def stats(self) -> dict:
        h = self.hist.cpu().numpy()
        return {"cells": self.cells, "bins": self.octa_res ** 2,
                "total_energy": float(h.sum()),
                "max_cell_energy": float(h.sum(-1).max()),
                "nbytes": int(h.nbytes)}


def record_plain(hist: torch.Tensor, flat: torch.Tensor, lum: torch.Tensor) -> torch.Tensor:
    """Plain version of E7 record: a new histogram, each bin of `flat` its
    old value plus the records' luminance in record order (numpy's add.at
    is unbuffered and applies the updates in index order), on the
    histogram's device."""
    out = hist.detach().cpu().numpy().reshape(-1).copy()
    np.add.at(out, flat.detach().cpu().numpy().reshape(-1),
              lum.detach().cpu().numpy().astype(np.float32).reshape(-1))
    return torch.from_numpy(out).reshape(hist.shape).to(hist.device)


# E7 record's split: a run of more records than this is summed by a block
# of its own from a shared-memory ring (csrc/leaf.cu:guide_long_kernel);
# shorter runs by one thread a bin from device memory.
RECORD_LONG_RUN = 1024


def _record_kernel(cache: GuidingCache, px, pz, dx, dy, dz, lum, mark=None) -> torch.Tensor:
    """E7 record on the card: keys, a stable sort by key, the runs' bounds,
    then the short runs one thread a bin and the long runs a block a bin.
    `mark(step)`, if given, is called after each step is queued (the split
    timing in chip_smoke.py)."""
    ins = [t.contiguous() for t in (px, pz, dx, dy, dz, lum)]
    _kernels.require_cuda("E7 record", cache.hist, *ins)
    mark = mark or (lambda step: None)
    n = ins[0].numel()
    g = cache.kernel_args()
    dev = cache.hist.device
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    stream = _kernels.stream_ptr(dev)
    err = _kernels.lib().f3d_guide_keys(g, *(_kernels.ptr(t) for t in ins[:5]), n,
                                        _kernels.ptr(keys), stream)
    _kernels.check(err, "E7 record (keys)")
    mark("keys")
    skeys, perm = torch.sort(keys, stable=True)
    mark("sort")
    hist_in = cache.hist.contiguous()
    bins = hist_in.numel()
    seg = torch.zeros((2, bins), dtype=torch.int32, device=dev)   # empty runs
    # padded to 4 floats: the long runs' bulk copies move 16 bytes at a time
    lum_sorted = torch.zeros(-(-n // 4) * 4, dtype=_F32, device=dev)
    err = _kernels.lib().f3d_guide_bounds(_kernels.ptr(skeys.contiguous()),
                                          _kernels.ptr(perm.contiguous()), _kernels.ptr(ins[5]),
                                          n, _kernels.ptr(seg[0]), _kernels.ptr(seg[1]),
                                          _kernels.ptr(lum_sorted), stream)
    _kernels.check(err, "E7 record (bounds)")
    mark("bounds")
    max_long = min(bins, n // (RECORD_LONG_RUN + 1))
    long_list = torch.zeros(1 + max_long, dtype=torch.int32, device=dev)
    out = torch.empty_like(hist_in)
    err = _kernels.lib().f3d_guide_bins(_kernels.ptr(seg[0]), _kernels.ptr(seg[1]),
                                        _kernels.ptr(lum_sorted), _kernels.ptr(hist_in), bins,
                                        RECORD_LONG_RUN, _kernels.ptr(long_list),
                                        _kernels.ptr(out), stream)
    _kernels.check(err, "E7 record (short runs)")
    mark("short runs")
    err = _kernels.lib().f3d_guide_long(_kernels.ptr(seg[0]), _kernels.ptr(seg[1]),
                                        _kernels.ptr(lum_sorted), _kernels.ptr(hist_in),
                                        _kernels.ptr(long_list), max_long, _kernels.ptr(out),
                                        stream)
    _kernels.check(err, "E7 record (long runs)")
    mark("long runs")
    GuidingCache.record.launches += 1
    return out


def sample_plain(cache: GuidingCache, px, pz, u1, u2):
    """Plain version of E7 sample over float32 tensors of one shape."""
    res = cache.octa_res
    B = res * res
    rows = cache.hist[cache._cell_of(px, pz)]             # (..., bins)
    den = torch.clamp(xla_sum(rows), min=_f(1e-20))
    cdf = fdiv(xla_cumsum(rows), den[..., None])
    bin_idx = torch.clamp((cdf < u1[..., None]).to(torch.int32).sum(-1), 0, B - 1)
    d = _octa_decode_plain(bin_idx, res)
    pdf_bin = fdiv(torch.gather(rows, -1, bin_idx[..., None].to(torch.int64))[..., 0], den)
    # bin solid angle = 4pi / bins
    pdf = fdiv(pdf_bin * float(B), _f(4 * math.pi))
    # jitter within the bin via u2 (rotate slightly around y)
    ang = (u2 - 0.5) * _f(2 * math.pi / res)
    ca = torch.cos(ang)
    sa = torch.sin(ang)
    return (d[..., 0] * ca - d[..., 2] * sa, d[..., 1], d[..., 0] * sa + d[..., 2] * ca, pdf)


def _sample_kernel(cache: GuidingCache, px, pz, u1, u2):
    ins = [t.contiguous() for t in (px, pz, u1, u2)]
    hist = cache.hist.contiguous()
    _kernels.require_cuda("E7 sample", hist, *ins)
    if cache.octa_res ** 2 > 4096:
        raise ValueError("E7 sample: the kernel's CDF covers at most 4096 bins (octa_res <= 64)")
    n = ins[0].numel()
    out = torch.empty((4, n), dtype=_F32, device=hist.device)
    err = _kernels.lib().f3d_guide_sample(cache.kernel_args(), _kernels.ptr(hist),
                                          *(_kernels.ptr(t) for t in ins), n, _kernels.ptr(out),
                                          _kernels.stream_ptr(hist.device))
    _kernels.check(err, "E7 sample")
    GuidingCache.sample.launches += 1
    return tuple(out[c].reshape(px.shape) for c in range(4))


GuidingCache.record.launches = 0
GuidingCache.sample.launches = 0
