# forge3d_tpu_torch/sky.py
# The Hosek-Wilkie RGB sky of forge3d_tpu/sky.py (the part the terrain
# renderer's IBL bakes): the coefficient cooking on the host in numpy, the
# per-direction radiance (kernel E5, csrc/post.cuh:hosek_texel, launched by
# csrc/post.cu:hosek_kernel; plain version `hosek_radiance_plain`), and the
# equirect environment bake. The Preetham sky (`sky_radiance`) is not
# ported yet.
#
# Coefficients are the published Hosek/Wilkie RGB dataset
# (ArHosekSkyModelData_RGB.h, (c) 2012-2013 Lukas Hosek & Alexander Wilkie,
# BSD 3-clause), in the port's own copy of the asset, assets/hosek_rgb.npz.
# Layout per channel: config 1080 = 2 albedos x 10 turbidities x 6
# elevation-Bezier knots x 9 coefficients; radiance 120 = 2 x 10 x 6.

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from . import _kernels
from .ops.shading import fdiv, rsqrt, sqrt32

__all__ = ["HosekSky", "make_hosek_sky", "hosek_radiance", "hosek_radiance_plain",
           "hosek_environment_map"]

_F32 = torch.float32


@dataclass(frozen=True)
class HosekSky:
    """Cooked Hosek-Wilkie state for one (turbidity, albedo, sun), float32."""

    sun_dir: np.ndarray      # (3,) unit, y up
    configs: np.ndarray      # (3, 9) per-channel coefficients
    radiances: np.ndarray    # (3,) expected-value scale
    exposure: np.float32

    def kernel_args(self) -> _kernels.HosekArgs:
        return _kernels.HosekArgs(
            _kernels._F3(*map(float, self.sun_dir)),
            (_kernels._F * 27)(*map(float, self.configs.ravel())),
            _kernels._F3(*map(float, self.radiances)), float(self.exposure))


_HOSEK_DATA = None


def _hosek_data():
    global _HOSEK_DATA
    if _HOSEK_DATA is None:
        z = np.load(Path(__file__).parent / "assets" / "hosek_rgb.npz")
        _HOSEK_DATA = ([z[f"rgb{c}"] for c in (1, 2, 3)],
                       [z[f"rad{c}"] for c in (1, 2, 3)])
    return _HOSEK_DATA


def _elevation_basis(solar_elevation: float) -> np.ndarray:
    """Quintic Bezier basis over cbrt-warped normalized solar elevation."""
    s = min(max(solar_elevation / (math.pi / 2), 0.0), 1.0) ** (1.0 / 3.0)
    o = 1.0 - s
    return np.array([o ** 5, 5 * o ** 4 * s, 10 * o ** 3 * s * s,
                     10 * o * o * s ** 3, 5 * o * s ** 4, s ** 5])


def _cook_channel(cfg: np.ndarray, rad: np.ndarray, turbidity: float,
                  albedo: float, elev: float):
    """Quad-linear blend over (albedo, turbidity) of Bezier-mixed elevation
    blocks."""
    t = min(max(turbidity, 1.0), 10.0)
    it = int(min(math.floor(t), 10.0))
    rem = 0.0 if it == 10 else t - it
    a = min(max(albedo, 0.0), 1.0)
    basis = _elevation_basis(elev)

    cfg = cfg.reshape(2, 10, 6, 9)
    rad = rad.reshape(2, 10, 6)

    def mix(arr, ai, ti):
        return np.tensordot(basis, arr[ai, ti], axes=(0, 0))

    out_c = ((1 - a) * (1 - rem) * mix(cfg, 0, it - 1)
             + a * (1 - rem) * mix(cfg, 1, it - 1))
    out_r = ((1 - a) * (1 - rem) * mix(rad, 0, it - 1)
             + a * (1 - rem) * mix(rad, 1, it - 1))
    if it != 10:
        out_c += ((1 - a) * rem * mix(cfg, 0, it)
                  + a * rem * mix(cfg, 1, it))
        out_r += ((1 - a) * rem * mix(rad, 0, it)
                  + a * rem * mix(rad, 1, it))
    return out_c, float(out_r)


def make_hosek_sky(sun_azimuth_deg: float, sun_elevation_deg: float, *,
                   turbidity: float = 3.0, ground_albedo: float = 0.3,
                   exposure: float = 1.0) -> HosekSky:
    """Cook the Hosek-Wilkie RGB sky for a sun position (host, float64,
    rounded once to float32)."""
    cfgs, rads = _hosek_data()
    elev = math.radians(max(sun_elevation_deg, 0.0))
    configs = []
    radiances = []
    for c in range(3):
        cc, rr = _cook_channel(cfgs[c], rads[c], turbidity, ground_albedo,
                               elev)
        configs.append(cc)
        radiances.append(rr)
    az = math.radians(sun_azimuth_deg)
    el = math.radians(sun_elevation_deg)
    sun = np.array([math.cos(az) * math.cos(el), math.sin(el),
                    math.sin(az) * math.cos(el)], np.float32)
    return HosekSky(
        sun_dir=sun,
        configs=np.stack(configs).astype(np.float32),
        radiances=np.asarray(radiances).astype(np.float32),
        exposure=np.float32(exposure),
    )


def hosek_radiance_plain(sky: HosekSky, dx, dy, dz):
    """Plain PyTorch version of E5: per-direction RGB radiance; directions
    below the horizon clamp to the horizon value."""
    f = np.float32
    sd = [f(v) for v in sky.sun_dir]
    inv = rsqrt(dx * dx + dy * dy + dz * dz)
    dxn, dyn, dzn = dx * inv, dy * inv, dz * inv
    cos_theta = torch.clamp(dyn, min=0.0)
    cos_gamma = torch.clamp(dxn * float(sd[0]) + dyn * float(sd[1]) + dzn * float(sd[2]),
                            -1.0, 1.0)
    gamma = torch.acos(cos_gamma)
    ray_m = cos_gamma * cos_gamma
    zenith = sqrt32(cos_theta)
    out = []
    for c in range(3):
        cf = [f(v) for v in sky.configs[c]]
        exp_m = torch.exp(gamma * float(cf[4]))
        # float32 scalars: 1 + cf8 * cf8 and 2 * cf8, as JAX forms them
        mie_denom = torch.clamp(float(f(1.0) + cf[8] * cf[8]) - float(f(2.0) * cf[8]) * cos_gamma,
                                min=1e-4)
        mie_m = (1.0 + ray_m) / (mie_denom * sqrt32(mie_denom))
        val = ((1.0 + float(cf[0]) * torch.exp(fdiv(float(cf[1]), cos_theta + 0.01)))
               * (float(cf[2]) + float(cf[3]) * exp_m + float(cf[5]) * ray_m
                  + float(cf[6]) * mie_m + float(cf[7]) * zenith))
        out.append(val * float(sky.radiances[c]) * float(sky.exposure))
    return out[0], out[1], out[2]


def _hosek_kernel(sky: HosekSky, dx, dy, dz):
    comps = [c.contiguous() for c in (dx, dy, dz)]
    _kernels.require_cuda("hosek_radiance", *comps)
    n = comps[0].numel()
    rgb = torch.empty((n, 3), dtype=_F32, device=comps[0].device)
    err = _kernels.lib().f3d_hosek_radiance(
        sky.kernel_args(), *(_kernels.ptr(c) for c in comps), n, _kernels.ptr(rgb),
        _kernels.stream_ptr(rgb.device))
    _kernels.check(err, "E5 hosek_radiance")
    hosek_radiance.launches += 1
    shape = dx.shape
    return tuple(rgb[:, c].reshape(shape) for c in range(3))


def hosek_radiance(sky: HosekSky, dx, dy, dz):
    """Per-direction RGB radiance (kernel E5) of float32 direction tensors
    of one shape. CPU tensors run the plain version; CUDA tensors launch the
    kernel."""
    if dx.device.type == "cpu":
        return hosek_radiance_plain(sky, dx, dy, dz)
    return _hosek_kernel(sky, dx, dy, dz)


hosek_radiance.launches = 0


def bake_directions(width: int, height: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The texel-centre directions of an equirect (height, width) map in
    env_radiance's convention (u = atan2(z, x)/2pi + 0.5, v = acos(y)/pi),
    in float64, rounded once to float32."""
    us = (np.arange(width) + 0.5) / width
    vs = (np.arange(height) + 0.5) / height
    phi = (us - 0.5) * 2 * math.pi
    theta = vs * math.pi
    P, Th = np.meshgrid(phi, theta)
    return tuple(np.asarray(v, np.float32) for v in
                 (np.sin(Th) * np.cos(P), np.cos(Th), np.sin(Th) * np.sin(P)))


def hosek_environment_tensor(sun_azimuth_deg: float, sun_elevation_deg: float, *,
                             turbidity: float = 3.0, ground_albedo: float = 0.3,
                             exposure: float = 1.0, width: int = 256, height: int = 128,
                             device="cuda") -> torch.Tensor:
    """The (height, width, 3) float32 Hosek bake as a tensor on `device`
    (through E5 on CUDA)."""
    sky = make_hosek_sky(sun_azimuth_deg, sun_elevation_deg, turbidity=turbidity,
                         ground_albedo=ground_albedo, exposure=exposure)
    d = [torch.as_tensor(v, device=device) for v in bake_directions(width, height)]
    return torch.stack(hosek_radiance(sky, *d), dim=-1).contiguous()


def hosek_environment_map(sun_azimuth_deg: float, sun_elevation_deg: float,
                          *, turbidity: float = 3.0,
                          ground_albedo: float = 0.3,
                          exposure: float = 1.0,
                          width: int = 256, height: int = 128,
                          device="cuda") -> np.ndarray:
    """Bake an equirect (H, W, 3) float32 env map in the convention
    consumed by env_radiance. `device="cuda"` (the default) runs E5 on the
    card; "cpu" runs the plain version."""
    from .pt.terrain_ref import resolve_device

    return hosek_environment_tensor(
        sun_azimuth_deg, sun_elevation_deg, turbidity=turbidity, ground_albedo=ground_albedo,
        exposure=exposure, width=width, height=height,
        device=resolve_device(device)).cpu().numpy()
