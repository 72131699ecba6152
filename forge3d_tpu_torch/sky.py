# forge3d_tpu_torch/sky.py
# The analytic daylight skies of forge3d_tpu/sky.py:
# - the Preetham sky: the Perez coefficients on the host in float64, the
#   per-direction radiance (kernel E5 Preetham, csrc/leaf.cuh:preetham_texel,
#   launched by csrc/leaf.cu:preetham_kernel; plain version
#   `sky_radiance_plain`), its equirect bake, and the sun's position from
#   the port's copy of astro.py;
# - the Hosek-Wilkie RGB sky (the part the terrain renderer's IBL bakes): the
#   coefficient cooking on the host in numpy, the per-direction radiance
#   (kernel E5, csrc/post.cuh:hosek_texel, launched by
#   csrc/post.cu:hosek_kernel; plain version `hosek_radiance_plain`), and the
#   equirect environment bake.
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
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _kernels
from .ops.shading import fdiv, rsqrt, sqrt32

__all__ = ["PreethamSky", "make_sky", "sky_radiance", "sky_radiance_plain", "sun_position_at",
           "sky_environment_map", "HosekSky", "make_hosek_sky", "hosek_radiance",
           "hosek_radiance_plain", "hosek_environment_map"]

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Preetham (sky.py:28-163). JAX runs sky_radiance eagerly, one rounded
# float32 operation at a time; the plain version does the same operations
# in the same order (divisions through `fdiv`, the square root through
# `sqrt32`), and so does the kernel. XLA's exp and arccos on the CPU are
# not the C library's, so against JAX the radiance holds to 1e-5 (1 + |ref|).


class PreethamSky(NamedTuple):
    """Precomputed Perez coefficients for one (turbidity, sun) state, as
    float32 numpy values."""

    sun_dir: np.ndarray         # (3,) unit, y up
    perez_Y: np.ndarray         # (5,)
    perez_x: np.ndarray
    perez_y: np.ndarray
    zenith_Y: np.ndarray        # ()
    zenith_x: np.ndarray
    zenith_y: np.ndarray
    exposure: np.ndarray


def _perez_coeffs(T: float):
    """Preetham's published linear fits of the Perez parameters vs
    turbidity T."""
    pY = np.array([0.1787 * T - 1.4630, -0.3554 * T + 0.4275,
                   -0.0227 * T + 5.3251, 0.1206 * T - 2.5771,
                   -0.0670 * T + 0.3703])
    px = np.array([-0.0193 * T - 0.2592, -0.0665 * T + 0.0008,
                   -0.0004 * T + 0.2125, -0.0641 * T - 0.8989,
                   -0.0033 * T + 0.0452])
    py = np.array([-0.0167 * T - 0.2608, -0.0950 * T + 0.0092,
                   -0.0079 * T + 0.2102, -0.0441 * T - 1.6537,
                   -0.0109 * T + 0.0529])
    return pY, px, py


def _zenith_values(T: float, theta_s: float):
    chi = (4.0 / 9.0 - T / 120.0) * (math.pi - 2 * theta_s)
    Yz = (4.0453 * T - 4.9710) * math.tan(chi) - 0.2155 * T + 2.4192  # kcd/m2
    ts = theta_s
    tv = np.array([ts ** 3, ts ** 2, ts, 1.0])
    Tv = np.array([T * T, T, 1.0])
    Mx = np.array([[0.00166, -0.00375, 0.00209, 0.0],
                   [-0.02903, 0.06377, -0.03202, 0.00394],
                   [0.11693, -0.21196, 0.06052, 0.25886]])
    My = np.array([[0.00275, -0.00610, 0.00317, 0.0],
                   [-0.04214, 0.08970, -0.04153, 0.00516],
                   [0.15346, -0.26756, 0.06670, 0.26688]])
    xz = float(Tv @ (Mx @ tv))
    yz = float(Tv @ (My @ tv))
    return max(Yz, 1e-3), xz, yz


def make_sky(sun_azimuth_deg: float, sun_elevation_deg: float, *,
             turbidity: float = 3.0, exposure: float = 0.05) -> PreethamSky:
    """Build the sky state for a sun position (reference seam: the
    hosek_sky constructor); float64 on the host, rounded once to float32."""
    T = float(np.clip(turbidity, 1.7, 10.0))
    el = math.radians(sun_elevation_deg)
    az = math.radians(sun_azimuth_deg)
    sun = np.array([math.cos(el) * math.sin(az), math.sin(el),
                    math.cos(el) * math.cos(az)])
    theta_s = math.pi / 2 - el
    pY, px, py = _perez_coeffs(T)
    Yz, xz, yz = _zenith_values(T, theta_s)
    f = np.float32
    return PreethamSky(
        sun_dir=np.asarray(sun, f), perez_Y=np.asarray(pY, f), perez_x=np.asarray(px, f),
        perez_y=np.asarray(py, f), zenith_Y=np.asarray(Yz, f), zenith_x=np.asarray(xz, f),
        zenith_y=np.asarray(yz, f), exposure=np.asarray(exposure, f))


def _perez(coeff, cos_theta, gamma, cos_gamma):
    """_perez (94) over float32 tensors; coeff holds five float32 values."""
    A, B, C, D, E = (float(c) for c in coeff)
    ct = torch.clamp(cos_theta, min=float(np.float32(0.01)))
    return ((1.0 + A * torch.exp(fdiv(B, ct)))
            * ((1.0 + C * torch.exp(D * gamma)) + (E * cos_gamma) * cos_gamma))


def _channels(sky: PreethamSky):
    return ((sky.perez_Y, sky.zenith_Y), (sky.perez_x, sky.zenith_x),
            (sky.perez_y, sky.zenith_y))


def _sun_denominators(sky: PreethamSky) -> Tuple[float, float, float]:
    """Each channel's max(_perez(coeff, 1, gamma_s, cos theta_s), 1e-6), in
    eager float32 scalar operations on the host, as sky_radiance forms it
    (113-119); the plain version and the kernel both read these."""
    sct = torch.clamp(torch.tensor(sky.sun_dir[1], dtype=_F32), min=float(np.float32(0.01)))
    gamma_s = torch.acos(torch.clamp(sct, -1.0, 1.0))
    one = sct * 0 + 1.0
    return tuple(float(torch.clamp(_perez(c, one, gamma_s, sct), min=float(np.float32(1e-6))))
                 for c, _ in _channels(sky))


def sky_radiance_plain(sky: PreethamSky, dx, dy, dz):
    """Plain PyTorch version of E5 Preetham over float32 direction tensors
    of one shape: (r, g, b)."""
    sd = [float(v) for v in sky.sun_dir]
    dy_c = torch.clamp(dy, min=0.0)
    norm = sqrt32(dx * dx + dy_c * dy_c + dz * dz) + float(np.float32(1e-9))
    vx, vy, vz = fdiv(dx, norm), fdiv(dy_c, norm), fdiv(dz, norm)
    cos_gamma = torch.clamp(vx * sd[0] + vy * sd[1] + vz * sd[2], -1.0, 1.0)
    gamma = torch.acos(cos_gamma)
    ch = [fdiv(float(z) * _perez(c, vy, gamma, cos_gamma), den)
          for (c, z), den in zip(_channels(sky), _sun_denominators(sky))]
    Y, x, y = ch
    ys = torch.clamp(y, min=float(np.float32(1e-4)))
    X = fdiv(x, ys) * Y
    Z = fdiv((1.0 - x) - y, ys) * Y
    f = lambda v: float(np.float32(v))  # noqa: E731
    r = f(3.2406) * X - f(1.5372) * Y - f(0.4986) * Z
    g = f(-0.9689) * X + f(1.8758) * Y + f(0.0415) * Z
    b = f(0.0557) * X - f(0.2040) * Y + f(1.0570) * Z
    e = float(sky.exposure)
    return (torch.clamp(r, min=0.0) * e, torch.clamp(g, min=0.0) * e,
            torch.clamp(b, min=0.0) * e)


def _preetham_args(sky: PreethamSky) -> _kernels.PreethamArgs:
    perez = np.concatenate([sky.perez_Y, sky.perez_x, sky.perez_y])
    return _kernels.PreethamArgs(
        _kernels._F3(*map(float, sky.sun_dir)), (_kernels._F * 15)(*map(float, perez)),
        _kernels._F3(*(float(z) for _, z in _channels(sky))),
        _kernels._F3(*_sun_denominators(sky)), float(sky.exposure))


def _preetham_kernel(sky: PreethamSky, dx, dy, dz, args=None):
    """E5 Preetham over CUDA direction tensors; `args`, when given, is
    _preetham_args(sky) formed once by the caller."""
    comps = [c.contiguous() for c in (dx, dy, dz)]
    _kernels.require_cuda("E5 sky_radiance", *comps)
    n = comps[0].numel()
    rgb = torch.empty((3, n), dtype=_F32, device=comps[0].device)
    args = _preetham_args(sky) if args is None else args
    err = _kernels.lib().f3d_preetham(args, *(_kernels.ptr(c) for c in comps), n,
                                      _kernels.ptr(rgb), _kernels.stream_ptr(rgb.device))
    _kernels.check(err, "E5 sky_radiance")
    sky_radiance.launches += 1
    return tuple(rgb[c].reshape(dx.shape) for c in range(3))


def sky_radiance(sky: PreethamSky, dx, dy, dz, device=None):
    """Linear RGB radiance toward view direction (any array shape);
    below-horizon directions fade to the horizon color. Tensors stay on
    their device; numpy or scalar input goes to `device` (the card unless
    device="cpu"). CPU tensors run the plain version; CUDA tensors launch
    kernel E5 Preetham."""
    from .pt.terrain_ref import device_for

    dev = device_for(dx, device)
    d = torch.broadcast_tensors(*(torch.as_tensor(v, dtype=_F32, device=dev)
                                  for v in (dx, dy, dz)))
    if dev.type == "cpu":
        return sky_radiance_plain(sky, *d)
    return _preetham_kernel(sky, *d)


sky_radiance.launches = 0


def sun_position_at(jd: float, latitude_deg: float, longitude_deg: float
                    ) -> Tuple[float, float]:
    """(azimuth_deg, elevation_deg) of the sun for an observer — the NOAA
    ephemeris seam, served by the Meeus solar series in astro.py."""
    from .astro import astro_body_position, equatorial_to_altaz

    sun = astro_body_position("sun", jd)
    alt, az = equatorial_to_altaz(sun["ra_deg"], sun["dec_deg"], jd,
                                  latitude_deg, longitude_deg, refract=True)
    return az, alt


def preetham_directions(width: int, height: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The texel-centre directions of sky_environment_map's (height, width)
    bake: phi = (2u - 1) pi, x = sin(theta) sin(phi), z = sin(theta) cos(phi)
    (not Hosek's convention, `bake_directions`), in float64, rounded once to
    float32."""
    us = (np.arange(width) + 0.5) / width
    vs = (np.arange(height) + 0.5) / height
    phi = (us * 2 - 1) * math.pi
    theta = vs * math.pi
    P, Th = np.meshgrid(phi, theta)
    return tuple(np.asarray(v, np.float32) for v in
                 (np.sin(Th) * np.sin(P), np.cos(Th), np.sin(Th) * np.cos(P)))


def sky_environment_map(sky: PreethamSky, width: int = 256,
                        height: int = 128, device="cuda") -> np.ndarray:
    """Bake an equirect environment map (H, W, 3) float32 for IBL, through
    E5 Preetham on the card unless device="cpu"."""
    from .pt.terrain_ref import resolve_device

    dev = resolve_device(device)
    d = [torch.as_tensor(v, device=dev) for v in preetham_directions(width, height)]
    return torch.stack(sky_radiance(sky, *d), dim=-1).cpu().numpy().astype(np.float32)


# ---------------------------------------------------------------------------
# Hosek-Wilkie


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
