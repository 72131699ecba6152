# forge3d_tpu_torch/ops/shading.py
# Shading math of the terrain path tracer: luminance, cosine-hemisphere
# sampling, environment radiance and the sun direction, in float32 with the
# operation order of forge3d_tpu/ops/shading.py.
#
# Divisions go through `fdiv`: PyTorch computes `scalar / tensor` as
# reciprocal-times-scalar, and on CUDA `tensor / cpu_scalar` as
# tensor-times-reciprocal. Both round twice, where the kernels (and JAX)
# round once.

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

_PI = 3.14159265358979323846
_F32 = torch.float32


def fdiv(a, b):
    """Correctly rounded float32 a / b where either side may be a Python
    number."""
    if not isinstance(a, torch.Tensor):
        a = b.new_tensor(a, dtype=_F32)
    elif not isinstance(b, torch.Tensor):
        b = a.new_tensor(b, dtype=_F32)
    return a / b


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (the kernels' `sqrtf`). PyTorch's
    vectorized float32 sqrt on AVX-512 CPUs is off by one ulp on about 1%
    of inputs; the square root of the float64 value, rounded to float32,
    is exact."""
    return torch.sqrt(x.to(torch.float64)).to(_F32)


def fma32(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once (the kernels' fmaf), where XLA fuses a
    multiply into the add that consumes it. The float64 product of two
    float32 values is exact; the float64 sum is rounded to odd (TwoSum gives
    its error, and an inexact sum with an even last bit moves one ulp toward
    the error), and a value rounded to odd with 29 spare bits rounds to
    float32 as the exact sum does. Python numbers are taken as float32."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (x if isinstance(x, torch.Tensor) else ref.new_tensor(x, dtype=_F32)
               for x in (a, b, c))
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even & torch.isfinite(s), torch.nextafter(s, toward), s)
    return s.float()


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) with both steps correctly rounded (the kernels'
    `1.0f / sqrtf(x)`)."""
    return fdiv(1.0, sqrt32(x))


def luminance(r, g, b):
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def cosine_dir(nx, ny, nz, u1, u2):
    """Cosine-weighted hemisphere direction about n (branchless Duff et al.
    orthonormal basis)."""
    sign = torch.where(nz < 0.0, -1.0, 1.0).to(_F32)
    a = fdiv(-1.0, sign + nz)
    b = nx * ny * a
    tx = 1.0 + sign * nx * nx * a
    ty = sign * b
    tz = -sign * nx
    bx = b
    by = sign + ny * ny * a
    bz = -ny
    r = sqrt32(u1)
    phi = 2.0 * _PI * u2
    lx = r * torch.cos(phi)
    ly = r * torch.sin(phi)
    lz = sqrt32(torch.clamp(1.0 - u1, min=0.0))
    dx = lx * tx + ly * bx + lz * nx
    dy = lx * ty + ly * by + lz * ny
    dz = lx * tz + ly * bz + lz * nz
    inv = rsqrt(dx * dx + dy * dy + dz * dz)
    return dx * inv, dy * inv, dz * inv


@dataclass(frozen=True)
class EnvMap:
    """Equirect environment map, or the constant-white fallback when `rgb`
    is None. `intensity` is a float32 value."""

    rgb: Optional[torch.Tensor]  # (eh, ew, 3) f32, contiguous
    intensity: float


def env_map(rgb, intensity: float, device="cpu") -> EnvMap:
    t = None
    if rgb is not None:
        t = torch.as_tensor(np.ascontiguousarray(np.asarray(rgb, np.float32)),
                            device=device)
    return EnvMap(rgb=t, intensity=float(np.float32(intensity)))


def env_radiance(env: EnvMap, dx, dy, dz):
    """Equirect nearest-texel lookup by direction; constant white scaled by
    the intensity when no map is bound."""
    if env.rgb is None:
        c = torch.full_like(dx, env.intensity)
        return c, c, c
    eh, ew, _ = env.rgb.shape
    inv = rsqrt(dx * dx + dy * dy + dz * dz)
    nxd, nyd, nzd = dx * inv, dy * inv, dz * inv
    uu = fdiv(torch.atan2(nzd, nxd), 2.0 * _PI) + 0.5
    vv = fdiv(torch.acos(torch.clamp(nyd, -1.0, 1.0)), _PI)
    px = torch.clamp((uu * ew).to(torch.int32), max=ew - 1)
    py = torch.clamp((vv * eh).to(torch.int32), max=eh - 1)
    flat = (py * ew + px).to(torch.int64)
    tex = env.rgb.reshape(-1, 3)
    r = tex[:, 0][flat]
    g = tex[:, 1][flat]
    b = tex[:, 2][flat]
    return r * env.intensity, g * env.intensity, b * env.intensity


def sun_direction(azimuth_deg: float, elevation_deg: float):
    """Unit vector from the surface toward the sun, evaluated in float32
    (degrees times float32(pi/180), then cos/sin), as three floats."""
    k = torch.tensor(math.pi / 180.0, dtype=_F32)
    az = torch.tensor(azimuth_deg, dtype=_F32) * k
    el = torch.tensor(elevation_deg, dtype=_F32) * k
    return (
        float(torch.cos(az) * torch.cos(el)),
        float(torch.sin(el)),
        float(torch.sin(az) * torch.cos(el)),
    )
