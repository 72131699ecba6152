# forge3d_tpu_torch/ops/restir.py
# ReSTIR DI reservoirs as structure-of-arrays tensors, and the reuse passes
# of forge3d_tpu/ops/restir.py: the history M-clamp, the temporal merge and
# the K-neighbour spatial streaming RIS.
#
# `spatial_reuse` is the wrapper of kernel K7 (csrc/kernels.cu:
# spatial_kernel), which comes in two instantiations by where a tap's
# window is read from (`kernel_instance`); the wrappers count launches by
# it. `m_clamp` and `temporal_merge` are per pixel; the frame
# kernel K6 applies them to its own pixel (csrc/common.cuh:frame_pixel), so
# their plain versions here serve the plain frame step and the tests.
# Integer fields are int32 (the JAX package keeps u32; values stay far
# below 2**31).

from __future__ import annotations

import dataclasses
from collections import Counter
from dataclasses import dataclass

import torch

from .. import _kernels
from .rng import MASK32, xorshift32
from .shading import fdiv, rsqrt

_F32 = torch.float32
_I32 = torch.int32

M_CAP = 512  # history cap

#: the widest radius whose window K7 stages in shared memory (kernel_instance);
#: wider ones are read from device memory
SHARED_RADIUS = 8


@dataclass(frozen=True)
class Reservoirs:
    """SoA reservoir buffer over N pixels; each field is an (N,) tensor."""

    dir_x: torch.Tensor
    dir_y: torch.Tensor
    dir_z: torch.Tensor
    intensity: torch.Tensor
    light_type: torch.Tensor   # i32: 0 none, 1 directional
    light_index: torch.Tensor  # i32
    w_sum: torch.Tensor
    m: torch.Tensor            # i32
    weight: torch.Tensor
    target_pdf: torch.Tensor

    @staticmethod
    def zeros(n: int, device="cpu") -> "Reservoirs":
        return Reservoirs._alloc(torch.zeros, n, device)

    @staticmethod
    def empty(n: int, device="cpu") -> "Reservoirs":
        return Reservoirs._alloc(torch.empty, n, device)

    @staticmethod
    def _alloc(make, n, device) -> "Reservoirs":
        return Reservoirs(**{
            f.name: make(n, dtype=_I32 if f.name in _INT_FIELDS else _F32, device=device)
            for f in dataclasses.fields(Reservoirs)})

    def fields(self):
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def replace(self, **kw) -> "Reservoirs":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Reservoirs":
        return Reservoirs(*(x.to(device) for x in self.fields()))

    def kernel_args(self) -> _kernels.ResArgs:
        _kernels.require_cuda("reservoirs", *self.fields())
        return _kernels.ResArgs(*(_kernels.ptr(x) for x in self.fields()))


_INT_FIELDS = ("light_type", "light_index", "m")


def valid(r: Reservoirs):
    return (r.m > 0) & (r.weight > 0.0) & (r.target_pdf > 0.0)


def m_clamp(r: Reservoirs, cap: int = M_CAP) -> Reservoirs:
    """Rescale history to at most `cap` M before the temporal merge."""
    over = r.m > cap
    scale = torch.where(over, fdiv(float(cap), torch.clamp(r.m.to(_F32), min=1.0)), 1.0)
    w_sum = r.w_sum * scale
    m = torch.where(over, cap, r.m).to(_I32)
    weight = torch.where(over & (r.target_pdf > 0.0),
                         w_sum / (m.to(_F32) * r.target_pdf), r.weight)
    return r.replace(w_sum=w_sum, m=m, weight=weight)


def _select(pred, a: Reservoirs, b: Reservoirs) -> Reservoirs:
    return Reservoirs(*(torch.where(pred, xa, xb) for xa, xb in zip(a.fields(), b.fields())))


def temporal_merge(prev: Reservoirs, curr: Reservoirs) -> Reservoirs:
    """Combine the merged history with fresh candidates: keep the
    higher-weight sample, sum w_sum and M, refinalize W."""
    pv = valid(prev)
    cv = valid(curr)
    choose_prev = prev.weight > curr.weight
    merged_sample = _select(choose_prev, prev, curr)
    m = prev.m + curr.m
    w_sum = prev.w_sum + curr.w_sum
    tp = merged_sample.target_pdf
    weight = torch.where((w_sum > 0.0) & (tp > 0.0),
                         w_sum / (m.to(_F32) * torch.clamp(tp, min=1e-30)), 0.0)
    merged = merged_sample.replace(w_sum=w_sum, m=m, weight=weight)
    return _select(pv & cv, merged, _select(pv, prev, curr))


def spatial_reuse_plain(res_in: Reservoirs, gb_nx, gb_ny, gb_nz, width: int, height: int,
                        frame_index: int, seed_hi: int, k_neighbors: int = 8,
                        radius: int = 3, row0: int = 0, rows=None) -> Reservoirs:
    """Plain PyTorch version of K7: streaming RIS over the pixel itself and
    K random neighbours in radius `radius` (one directional light:
    selection pdf 1, facing test against the receiver normal). Reads the
    whole frame's reservoirs and normals; returns the reservoirs of the rows
    row0 .. row0 + rows - 1 (the whole frame by default)."""
    dev = res_in.m.device
    rows = height if rows is None else int(rows)
    band = slice(row0 * width, (row0 + rows) * width)
    idx = torch.arange(band.start, band.stop, dtype=torch.int64, device=dev)
    n = idx.numel()
    x = idx % width
    y = idx // width
    gb_nx, gb_ny, gb_nz = gb_nx[band], gb_ny[band], gb_nz[band]
    seed = (((int(seed_hi) ^ int(frame_index)) & MASK32) + idx * 1664525 + 1013904223) & MASK32

    def consider(w_acc, ch, ch_pdf, seed, cand: Reservoirs):
        inv = rsqrt(cand.dir_x * cand.dir_x + cand.dir_y * cand.dir_y
                    + cand.dir_z * cand.dir_z + 1e-30)
        cosr = gb_nx * cand.dir_x * inv + gb_ny * cand.dir_y * inv + gb_nz * cand.dir_z * inv
        ok = (cand.light_type == 1) & (cosr > 0.0) & (cand.target_pdf > 0.0)
        p_curr = torch.where(ok, 1.0, 0.0).to(_F32)
        w = torch.where(ok, cand.w_sum * (p_curr / torch.clamp(cand.target_pdf, min=1e-6)), 0.0)
        take = w > 0.0
        w_acc = w_acc + torch.where(take, w, 0.0)
        seed, u = xorshift32(seed)
        choose = take & (u < w / torch.clamp(w_acc, min=1e-30))
        return (w_acc, _select(choose, cand, ch), torch.where(choose, p_curr, ch_pdf), seed)

    r_self = Reservoirs(*(c[band] for c in res_in.fields()))
    state = consider(torch.zeros(n, dtype=_F32, device=dev), r_self, r_self.target_pdf,
                     seed, r_self)
    m_total = r_self.m.to(torch.int64)
    span = 2 * radius + 1
    for _ in range(k_neighbors):
        w_acc, ch, ch_pdf, seed = state
        seed, u1 = xorshift32(seed)
        seed, u2 = xorshift32(seed)
        rx = torch.floor(u1 * span).to(torch.int64) - radius
        ry = torch.floor(u2 * span).to(torch.int64) - radius
        self_tap = (rx == 0) & (ry == 0)
        ni = torch.clamp(y + ry, 0, height - 1) * width + torch.clamp(x + rx, 0, width - 1)
        rn = Reservoirs(*(c[ni] for c in res_in.fields()))
        after = consider(w_acc, ch, ch_pdf, seed, rn)
        # a (0, 0) tap skips the candidate and its draw
        state = (
            torch.where(self_tap, w_acc, after[0]),
            _select(self_tap, ch, after[1]),
            torch.where(self_tap, ch_pdf, after[2]),
            torch.where(self_tap, seed, after[3]),
        )
        m_total = m_total + torch.where(self_tap, 0, rn.m.to(torch.int64))

    w_acc, ch, ch_pdf, _ = state
    m_total = (m_total & MASK32).to(_I32)
    weight = torch.where((w_acc > 0.0) & (ch_pdf > 0.0),
                         w_acc / (m_total.to(_F32) * torch.clamp(ch_pdf, min=1e-30)), 0.0)
    return ch.replace(w_sum=w_acc, m=m_total, weight=weight, target_pdf=ch_pdf)


def kernel_instance(radius: int) -> str:
    """The instantiation K7 launches for `radius`: where its taps' window is
    read from (csrc/kernels.cu:spatial_kernel<true> stages it, <false>
    reads device memory)."""
    return "shared window" if 0 <= radius <= SHARED_RADIUS else "global window"


def _spatial_reuse_kernel(res_in: Reservoirs, gb_nx, gb_ny, gb_nz, width, height,
                          frame_index, seed_hi, k_neighbors, radius, row0=0, rows=None,
                          counter=None) -> Reservoirs:
    n = width * height
    rows = height if rows is None else int(rows)
    if not 0 <= row0 <= row0 + rows <= height:
        raise ValueError(f"spatial_reuse: rows {row0} .. {row0 + rows - 1} outside the "
                         f"frame's {height}")
    for t in res_in.fields() + (gb_nx, gb_ny, gb_nz):
        if t.numel() != n:
            raise ValueError(f"spatial_reuse: expected {n} elements, got {t.numel()}")
    _kernels.require_cuda("spatial_reuse", gb_nx, gb_ny, gb_nz)
    out = Reservoirs.empty(width * rows, res_in.m.device)
    dev = gb_nx.device
    instance = kernel_instance(int(radius))
    err = _kernels.lib().f3d_spatial_reuse(
        res_in.kernel_args(), out.kernel_args(), _kernels.ptr(gb_nx), _kernels.ptr(gb_ny),
        _kernels.ptr(gb_nz), int(width), int(height), int(frame_index) & MASK32,
        int(seed_hi) & MASK32, int(k_neighbors), int(radius), int(row0), rows,
        int(instance == "shared window"), _kernels.stream_ptr(dev))
    _kernels.check(err, "K7 spatial_reuse")
    counter = spatial_reuse if counter is None else counter
    counter.launches += 1
    counter.instances[instance] += 1
    return out


def spatial_reuse(res_in: Reservoirs, gb_nx, gb_ny, gb_nz, width: int, height: int,
                  frame_index: int, seed_hi: int, k_neighbors: int = 8,
                  radius: int = 3) -> Reservoirs:
    """K-neighbour spatial reuse (kernel K7). CPU tensors run the plain
    version; CUDA tensors launch the kernel, which reads `res_in` and writes
    a new buffer."""
    if res_in.m.device.type == "cpu":
        return spatial_reuse_plain(res_in, gb_nx, gb_ny, gb_nz, width, height,
                                   frame_index, seed_hi, k_neighbors, radius)
    return _spatial_reuse_kernel(res_in, gb_nx, gb_ny, gb_nz, width, height,
                                 frame_index, seed_hi, k_neighbors, radius)


spatial_reuse.launches = 0
spatial_reuse.instances = Counter()   # launches by kernel_instance


def spatial_reuse_band(res_in: Reservoirs, gb_nx, gb_ny, gb_nz, width: int, height: int,
                       frame_index: int, seed_hi: int, row0: int, rows: int,
                       k_neighbors: int = 8, radius: int = 3) -> Reservoirs:
    """Spatial reuse on the band of rows row0 .. row0 + rows - 1 (K7 band, a
    rank's rows of a sharded render): reads the whole frame's reservoirs
    and normals, as neighbours lie up to `radius` rows outside the band,
    and returns the band's reservoirs, bit-equal to those rows of
    spatial_reuse. CPU tensors run the plain version; CUDA tensors launch
    the kernel."""
    if res_in.m.device.type == "cpu":
        return spatial_reuse_plain(res_in, gb_nx, gb_ny, gb_nz, width, height, frame_index,
                                   seed_hi, k_neighbors, radius, row0, rows)
    return _spatial_reuse_kernel(res_in, gb_nx, gb_ny, gb_nz, width, height, frame_index,
                                 seed_hi, k_neighbors, radius, row0, rows,
                                 counter=spatial_reuse_band)


spatial_reuse_band.launches = 0
spatial_reuse_band.instances = Counter()
