# forge3d_tpu_torch/ops/denoise.py
# The edge-avoiding a-trous denoiser of forge3d_tpu/ops/denoise.py:
# iterative 5x5 a-trous passes with doubling tap spacing, guided by the
# albedo / normal / depth AOVs through per-tap weights
# w = w_color * w_albedo * w_normal * w_depth, each exp(-dist / sigma**2).
#
# `atrous_denoise` is the wrapper of kernel E3 (csrc/post.cu:atrous_kernel,
# a CTA a tile of one sub-lattice of the pass's spacing, each pair's weight
# formed once, csrc/post.cuh:atrous_tile; launched once per iteration): on a CUDA
# tensor it launches the kernel, on a CPU tensor it runs
# `atrous_denoise_plain`. Numpy input goes to `device` ("cuda" by default,
# which raises DeviceError without CUDA). The depth guide's scaling by its
# max |.| (NaN and +inf taken as 0) is glue in PyTorch before either.

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels
from .shading import fdiv

_F32 = torch.float32
_KERNEL_1D = (1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16)   # exact in float32


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a, np.float32))


def _as_plane(a, device, channels: int):
    if a is None:
        return None
    t = _as_tensor(a).to(device=device, dtype=_F32)
    if channels == 1 and t.ndim == 3 and t.shape[2] == 1:
        t = t[..., 0]
    return t.contiguous()


def _prepare(color, albedo, normal, depth, device=None):
    c = _as_tensor(color).to(device=device, dtype=_F32).contiguous()
    if c.ndim != 3 or c.shape[2] != 3:
        raise ValueError("color must be (H, W, 3)")
    alb = _as_plane(albedo, c.device, 3)
    nrm = _as_plane(normal, c.device, 3)
    dep = _as_plane(depth, c.device, 1)
    if dep is not None:
        dep = torch.nan_to_num(dep, nan=0.0, posinf=0.0)
        scale = torch.clamp(dep.abs().amax(), min=1e-6)
        dep = (dep / scale).contiguous()
    return c, alb, nrm, dep


def _sigma_k(sigma: float) -> float:
    """float32(sigma**2 + 1e-8), the weights' denominator as JAX forms it."""
    return float(np.float32(sigma ** 2 + 1e-8))


def _shift2d(a, dy: int, dx: int):
    """Edge-clamped shift: out[y, x] = a[clamp(y - dy), clamp(x - dx)]."""
    H, W = a.shape[:2]
    rows = torch.clamp(torch.arange(H, device=a.device) - dy, 0, H - 1)
    cols = torch.clamp(torch.arange(W, device=a.device) - dx, 0, W - 1)
    return a[rows][:, cols]


def atrous_denoise_plain(color, albedo=None, normal=None, depth=None, iterations: int = 5,
                         sigma_color: float = 0.30, sigma_albedo: float = 0.30,
                         sigma_normal: float = 0.60, sigma_depth: float = 0.80):
    """Plain PyTorch version of E3 on (H, W, 3) color; returns a tensor of
    the same shape."""
    return _atrous_plain(*_prepare(color, albedo, normal, depth), iterations,
                         *map(_sigma_k, (sigma_color, sigma_albedo, sigma_normal, sigma_depth)))


def _atrous_plain(c, alb, nrm, dep, iterations, kc, ka, kn, kd):
    def dist(p, dy, dx):
        d = _shift2d(p, dy, dx) - p
        d = d * d
        return d[..., 0] + d[..., 1] + d[..., 2]

    def weight(d, k):
        return torch.exp(fdiv(-d, k))

    out = c
    for it in range(int(iterations)):
        step = 1 << it
        acc = torch.zeros_like(out)
        wacc = torch.zeros_like(out[..., 0])
        for ky in range(-2, 3):
            for kx in range(-2, 3):
                dy, dx = ky * step, kx * step
                cs = _shift2d(out, dy, dx)
                w = torch.full_like(wacc, _KERNEL_1D[ky + 2] * _KERNEL_1D[kx + 2])
                w = w * weight(dist(out, dy, dx), kc)
                if alb is not None:
                    w = w * weight(dist(alb, dy, dx), ka)
                if nrm is not None:
                    w = w * weight(dist(nrm, dy, dx), kn)
                if dep is not None:
                    dd = _shift2d(dep, dy, dx) - dep
                    w = w * weight(dd * dd, kd)
                acc = acc + cs * w[..., None]
                wacc = wacc + w
        out = acc / torch.clamp(wacc, min=1e-8)[..., None]
    return out


def atrous_attrs() -> dict:
    """E3's build (csrc/post.cu:f3d_atrous_attrs): registers and local bytes
    a thread, resident blocks an SM and shared bytes a block with all three
    guides, and the tile's slots (x, y). Its sizes have one home,
    csrc/post.cuh."""
    out = (ctypes.c_int * 6)()
    _kernels.check(_kernels.lib().f3d_atrous_attrs(out), "E3 atrous_denoise (attributes)")
    return {"registers": out[0], "local_bytes": out[1], "blocks": out[2], "shared_bytes": out[3],
            "tile": (out[4], out[5])}


def _atrous_kernel(c, alb, nrm, dep, iterations, kc, ka, kn, kd):
    _kernels.require_cuda("atrous_denoise", c, *(g for g in (alb, nrm, dep) if g is not None))
    H, W = c.shape[:2]
    for g, shape in ((alb, (H, W, 3)), (nrm, (H, W, 3)), (dep, (H, W))):
        if g is not None and tuple(g.shape) != shape:
            raise ValueError(f"atrous_denoise: guide of shape {tuple(g.shape)}, expected {shape}")
    args = _kernels.AtrousArgs(*(None if g is None else g.data_ptr() for g in (alb, nrm, dep)),
                               W, H, kc, ka, kn, kd)
    stream = _kernels.stream_ptr(c.device)
    bufs = (torch.empty_like(c), torch.empty_like(c))   # the input stays the caller's
    src = c
    for it in range(int(iterations)):
        dst = bufs[it % 2]
        err = _kernels.lib().f3d_atrous_pass(args, _kernels.ptr(src), _kernels.ptr(dst),
                                             1 << it, stream)
        _kernels.check(err, "E3 atrous_denoise")
        atrous_denoise.launches += 1
        src = dst
    return src


def atrous_denoise(color, albedo=None, normal=None, depth=None, iterations: int = 5,
                   sigma_color: float = 0.30, sigma_albedo: float = 0.30,
                   sigma_normal: float = 0.60, sigma_depth: float = 0.80, *, device=None):
    """Guided a-trous denoise of (H, W, 3) color (kernel E3, one launch per
    iteration); returns a float32 tensor of the same shape. Guidance planes
    are optional; a missing plane drops its weight term. It runs on
    `device`, else on color's device when color is a tensor, else on
    "cuda" (DeviceError without CUDA); on the CPU it runs the plain
    version."""
    from ..pt.terrain_ref import device_for

    c, alb, nrm, dep = _prepare(color, albedo, normal, depth, device_for(color, device))
    run = _atrous_plain if c.device.type == "cpu" else _atrous_kernel
    return run(c, alb, nrm, dep, iterations,
               *map(_sigma_k, (sigma_color, sigma_albedo, sigma_normal, sigma_depth)))


atrous_denoise.launches = 0


def svgf_denoise(color, aovs: dict, iterations: int = 5, *, device=None):
    """SVGF-flavored wrapper taking an AOV dict (albedo/normal/depth); runs
    where `atrous_denoise` runs."""
    return atrous_denoise(
        color,
        albedo=aovs.get("albedo"),
        normal=aovs.get("normal"),
        depth=aovs.get("depth"),
        iterations=iterations,
        device=device,
    )


def oidn_denoise(color, **kwargs):
    """OIDN is not available in this build; fail closed with a typed error
    so callers can choose another denoiser."""
    raise NotImplementedError(
        "OIDN is not available in this build; use atrous_denoise/svgf_denoise"
    )
