# forge3d_tpu_torch/ops/sweep.py
# Directional shadow-line sweeps over a heightfield and the camera-aligned
# rotated grid they run on (forge3d_tpu/ops/sweep.py), on PyTorch.
#
# For a fixed direction w, occlusion of every texel at once is a shadow-line
# propagation along the light's travel direction,
#       z[row] = max(h[row], shift(z[row-1], tau) - delta),
# and the sky irradiance E_sky(x) = int env(w) V(x,w) max(0, n.w)/pi dw is
# the sum of one propagation per jittered (azimuth x elevation) bin. The sun
# rides in its quadrant's group as bin 0 with zero sky weight and emits its
# incoming shadow height z_sun.
#
# Kernels (csrc/sweep.cuh, launched from csrc/sweep.cu):
#   K1 `rotate_heights`  -- the DEM's bilinear surface and exact patch slopes
#                           at the rotated grid's nodes;
#   K2 `sweep_lighting`  -- the propagations of all bins of one frame.
# Each wrapper runs its plain PyTorch version for CPU tensors and launches
# its kernel for CUDA tensors; nothing falls back.
#
# The per-frame bin directions (`jitter_bins`, threefry uniforms) and the
# per-bin propagation constants (`sweep_bins`) are a few hundred numbers,
# computed on the host in float32 and shared by both versions of K2.

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .. import _kernels
from . import rng
from .shading import EnvMap, env_radiance, fdiv, rsqrt, sqrt32
from .traversal import f32

_F32 = torch.float32
NEG32 = f32(-1.0e30)


# ---------------------------------------------------------------------------
# Stratification (static structure; per-frame jitter on the host)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SkyStrata:
    """Static stratification of the direction sphere in grid frame: azimuth
    strata uniform in grid azimuth, with edges at 45 deg + k*90 deg so each
    stratum lies inside one marching quadrant; elevations equal-area in
    sin(theta) over [sin_lo, 1]."""

    na: int
    ne: int
    sin_lo: float

    @property
    def n_bins(self) -> int:
        return self.na * self.ne

    @property
    def solid_angle_per_bin(self) -> float:
        return 2.0 * math.pi * (1.0 - self.sin_lo) / (self.na * self.ne)

    def quadrant_of(self, stratum: int) -> int:
        """0: march +v, 1: march -v, 2: march +u, 3: march -u."""
        center = self.alpha_center(stratum)
        tv = -math.cos(center)
        tu = -math.sin(center)
        if abs(tv) >= abs(tu):
            return 0 if tv >= 0 else 1
        return 2 if tu >= 0 else 3

    def alpha_center(self, stratum: int) -> float:
        width = 2.0 * math.pi / self.na
        return math.pi / 4.0 + (stratum + 0.5) * width

    def groups(self) -> List[List[int]]:
        """Strata of each marching quadrant, in stratum order."""
        out: List[List[int]] = [[], [], [], []]
        for s in range(self.na):
            out[self.quadrant_of(s)].append(s)
        return out


def make_strata(na: int = 32, ne: int = 12, sin_lo: float = -0.55) -> SkyStrata:
    if na % 4 != 0:
        raise ValueError("sky azimuth strata count must be a multiple of 4")
    if ne < 1 or not (-1.0 < sin_lo < 1.0):
        raise ValueError("bad sky elevation stratification")
    return SkyStrata(na=na, ne=ne, sin_lo=sin_lo)


def _quadrant_of_dir(wu: float, wv: float) -> int:
    tu, tv = -wu, -wv
    if abs(tv) >= abs(tu):
        return 0 if tv >= 0 else 1
    return 2 if tu >= 0 else 3


def jitter_bins(strata: SkyStrata, key) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame jittered bin directions in grid frame: (alpha, sin_el), each
    (na, ne) float32, uniformly jittered within its stratum. `key` is a
    threefry key (ops/rng.py)."""
    ka, ke = rng.split(key)
    ua = rng.uniform(ka, (strata.na, strata.ne))
    ue = rng.uniform(ke, (strata.na, strata.ne))
    width = np.float32(2.0 * math.pi / strata.na)
    a0 = np.float32(math.pi / 4.0) + width * np.arange(strata.na, dtype=np.float32)[:, None]
    alpha = a0 + ua * width
    ds = np.float32((1.0 - strata.sin_lo) / strata.ne)
    s0 = np.float32(strata.sin_lo) + ds * np.arange(strata.ne, dtype=np.float32)[None, :]
    sin_el = np.clip(s0 + ue * ds, np.float32(-0.999), np.float32(0.999))
    return alpha.astype(np.float32), sin_el.astype(np.float32)


# ---------------------------------------------------------------------------
# Camera-aligned rotated grid
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RotGridStatic:
    """Static geometry of the camera-aligned grid (Python floats)."""

    n_v: int
    n_u: int
    spacing: float
    u0: float          # world-u of column 0 (relative to camera ground pt)
    v0: float          # world-v of row 0
    e_u: Tuple[float, float, float]
    e_v: Tuple[float, float, float]
    cam_iu: float      # camera ground position in (fractional) grid index
    cam_iv: float


def plan_rot_grid(dem_w_cells: int, dem_h_cells: int,
                  origin_xz: Tuple[float, float],
                  spacing_xz: Tuple[float, float],
                  cam_xz: Tuple[float, float],
                  fwd_xz: Tuple[float, float],
                  margin_cells: int = 2,
                  round_to: int = 8) -> RotGridStatic:
    """+v along the camera's horizontal forward, +u along its right; covers
    the DEM's bounding box (the camera ground point may lie outside)."""
    fx, fz = fwd_xz
    norm = math.hypot(fx, fz)
    if norm < 1e-9:
        raise ValueError("camera looks straight down; no horizontal forward")
    fx, fz = fx / norm, fz / norm
    rx, rz = -fz, fx
    e_v = (fx, 0.0, fz)
    e_u = (rx, 0.0, rz)
    sp = float(min(spacing_xz))
    ox, oz = origin_xz
    xs = (ox, ox + dem_w_cells * spacing_xz[0])
    zs = (oz, oz + dem_h_cells * spacing_xz[1])
    us, vs = [], []
    for x in xs:
        for z in zs:
            us.append((x - cam_xz[0]) * rx + (z - cam_xz[1]) * rz)
            vs.append((x - cam_xz[0]) * fx + (z - cam_xz[1]) * fz)
    m = margin_cells * sp
    u0, u1 = min(us) - m, max(us) + m
    v0, v1 = min(vs) - m, max(vs) + m
    n_u = int(math.ceil((u1 - u0) / sp)) + 1
    n_v = int(math.ceil((v1 - v0) / sp)) + 1
    n_u = ((n_u + round_to - 1) // round_to) * round_to
    n_v = ((n_v + round_to - 1) // round_to) * round_to
    return RotGridStatic(
        n_v=n_v, n_u=n_u, spacing=sp, u0=float(u0), v0=float(v0),
        e_u=e_u, e_v=e_v, cam_iu=float(-u0 / sp), cam_iv=float(-v0 / sp))


@dataclass(frozen=True)
class RotateArgs:
    """float32 constants of K1, rounded where the JAX version rounds them."""

    n_v: int
    n_u: int
    u0: float
    v0: float
    spacing: float
    cam_x: float
    cam_z: float
    eu0: float
    eu2: float
    ev0: float
    ev2: float
    ox: float
    oz: float
    sx: float
    sz: float
    ex: float
    ex_sx: float   # float32(exaggeration / spacing_x), divided in double
    ex_sz: float

    @staticmethod
    def make(rg: RotGridStatic, origin_xz, spacing_xz, cam_xz, exaggeration=1.0):
        return RotateArgs(
            n_v=rg.n_v, n_u=rg.n_u, u0=f32(rg.u0), v0=f32(rg.v0), spacing=f32(rg.spacing),
            cam_x=f32(cam_xz[0]), cam_z=f32(cam_xz[1]),
            eu0=f32(rg.e_u[0]), eu2=f32(rg.e_u[2]), ev0=f32(rg.e_v[0]), ev2=f32(rg.e_v[2]),
            ox=f32(origin_xz[0]), oz=f32(origin_xz[1]),
            sx=f32(spacing_xz[0]), sz=f32(spacing_xz[1]), ex=f32(exaggeration),
            ex_sx=f32(exaggeration / spacing_xz[0]), ex_sz=f32(exaggeration / spacing_xz[1]))


def rotate_heights_plain(heights: torch.Tensor, ra: RotateArgs):
    """Plain PyTorch version of K1: (h_rot, du, dv), each (n_v, n_u) f32;
    h_rot is -1e30 and the slopes 0 at nodes outside the DEM."""
    H, W = heights.shape
    dev = heights.device
    iu = torch.arange(ra.n_u, dtype=_F32, device=dev)
    iv = torch.arange(ra.n_v, dtype=_F32, device=dev)
    u = ra.u0 + iu[None, :] * ra.spacing
    v = ra.v0 + iv[:, None] * ra.spacing
    x = ra.cam_x + u * ra.eu0 + v * ra.ev0
    z = ra.cam_z + u * ra.eu2 + v * ra.ev2
    fx = fdiv(x - ra.ox, ra.sx)
    fz = fdiv(z - ra.oz, ra.sz)
    valid = (fx >= 0.0) & (fx <= W - 1) & (fz >= 0.0) & (fz <= H - 1)
    ix = torch.clamp(torch.floor(fx), 0, W - 2)
    iz = torch.clamp(torch.floor(fz), 0, H - 2)
    ax = fx - ix
    az = fz - iz
    flat = heights.reshape(-1)
    base = (iz.to(torch.int64) * W + ix.to(torch.int64))
    h00 = flat[base]
    h10 = flat[base + 1]
    h01 = flat[base + W]
    h11 = flat[base + W + 1]
    hv = (h00 * (1 - ax) * (1 - az) + h10 * ax * (1 - az)
          + h01 * (1 - ax) * az + h11 * ax * az) * ra.ex
    h_rot = torch.where(valid, hv, NEG32)
    dydx = ((h10 - h00) * (1 - az) + (h11 - h01) * az) * ra.ex_sx
    dydz = ((h01 - h00) * (1 - ax) + (h11 - h10) * ax) * ra.ex_sz
    dydx = torch.where(valid, dydx, 0.0)
    dydz = torch.where(valid, dydz, 0.0)
    du = dydx * ra.eu0 + dydz * ra.eu2
    dv = dydx * ra.ev0 + dydz * ra.ev2
    return h_rot, du, dv


def _rotate_kernel(heights: torch.Tensor, ra: RotateArgs):
    heights = heights.contiguous()
    _kernels.require_cuda("rotate_heights", heights)
    if heights.dtype != _F32 or heights.dim() != 2:
        raise ValueError("rotate_heights: heights must be a 2D float32 tensor")
    dev = heights.device
    out = [torch.empty((ra.n_v, ra.n_u), dtype=_F32, device=dev) for _ in range(3)]
    H, W = heights.shape
    args = _kernels.RotArgs(
        _kernels.ptr(heights), W, H, ra.n_v, ra.n_u, ra.u0, ra.v0, ra.spacing, ra.cam_x,
        ra.cam_z, ra.eu0, ra.eu2, ra.ev0, ra.ev2, ra.ox, ra.oz, ra.sx, ra.sz, ra.ex,
        ra.ex_sx, ra.ex_sz)
    err = _kernels.lib().f3d_rotate_heights(args, *(_kernels.ptr(t) for t in out),
                                            _kernels.stream_ptr(dev))
    _kernels.check(err, "K1 rotate_heights")
    rotate_heights.launches += 1
    return tuple(out)


def rotate_heights(heights: torch.Tensor, ra: RotateArgs):
    """K1: sample the bilinear height surface (and its exact patch slopes
    d y/d u, d y/d v) at the rotated grid's nodes. Returns (h_rot, du, dv)."""
    if heights.device.type == "cpu":
        return rotate_heights_plain(heights, ra)
    return _rotate_kernel(heights, ra)


rotate_heights.launches = 0


# ---------------------------------------------------------------------------
# Per-frame bin table
# ---------------------------------------------------------------------------


class Group(NamedTuple):
    """One marching quadrant's bins (the sun first when it rides here)."""

    q: int
    substeps: int
    has_sun: bool
    strata: Tuple[int, ...]   # sky strata of the group, in order
    w_u: torch.Tensor         # (B,) f32, CPU
    w_v: torch.Tensor
    w_y: torch.Tensor
    tau: torch.Tensor         # lateral cells per row, clipped to [-1, 1]
    delta: torch.Tensor       # shadow-line drop per row
    env_w: torch.Tensor       # (B, 3) env radiance times the quadrature weight


class SweepBins(NamedTuple):
    groups: Tuple[Group, ...]
    ne: int                   # elevation bins per sky stratum


def sweep_bins(*, strata: SkyStrata, key, env: EnvMap, e_u, e_v, sun_world,
               spacing: float, sun_only: bool = False, substeps: int = 2,
               sky_substeps: int = 1) -> SweepBins:
    """The bins of one frame, grouped by marching quadrant as
    forge3d_tpu/ops/sweep.py:sweep_lighting groups them, with each bin's
    propagation constants. Runs on the host in float32."""
    e_u = tuple(float(c) for c in np.asarray(e_u, np.float64))
    e_v = tuple(float(c) for c in np.asarray(e_v, np.float64))
    sun_world = tuple(float(c) for c in np.asarray(sun_world, np.float64))
    alpha, sin_el = (torch.from_numpy(a) for a in jitter_bins(strata, key))
    cos_el = sqrt32(torch.clamp(1.0 - sin_el * sin_el, min=f32(1e-12)))
    wu = (torch.sin(alpha) * cos_el).reshape(-1)
    wv = (torch.cos(alpha) * cos_el).reshape(-1)
    wy = sin_el.reshape(-1)
    dx = wu * f32(e_u[0]) + wv * f32(e_v[0])
    dz = wu * f32(e_u[2]) + wv * f32(e_v[2])
    env_cpu = env if env.rgb is None else EnvMap(rgb=env.rgb.cpu(), intensity=env.intensity)
    er, eg, eb = env_radiance(env_cpu, dx, wy, dz)
    env_w = torch.stack([er, eg, eb], dim=-1) * f32(strata.solid_angle_per_bin / math.pi)

    su = sun_world[0] * e_u[0] + sun_world[1] * e_u[1] + sun_world[2] * e_u[2]
    sv = sun_world[0] * e_v[0] + sun_world[1] * e_v[1] + sun_world[2] * e_v[2]
    sy = sun_world[1]
    sun_q = _quadrant_of_dir(float(su), float(sv))
    sp = f32(spacing)

    groups = []
    for q, members in enumerate(strata.groups()):
        has_sun = q == sun_q
        if sun_only and not has_sun:
            continue
        idx = torch.tensor([s * strata.ne + e for s in members for e in range(strata.ne)],
                           dtype=torch.int64)
        if not len(members) and not has_sun:
            continue
        g_wu, g_wv, g_wy, g_env = wu[idx], wv[idx], wy[idx], env_w[idx]
        if has_sun:
            g_wu = torch.cat([torch.tensor([su], dtype=_F32), g_wu])
            g_wv = torch.cat([torch.tensor([sv], dtype=_F32), g_wv])
            g_wy = torch.cat([torch.tensor([sy], dtype=_F32), g_wy])
            g_env = torch.cat([torch.zeros((1, 3), dtype=_F32), g_env])
        if sun_only:
            g_wu, g_wv, g_wy, g_env = g_wu[:1], g_wv[:1], g_wy[:1], g_env[:1]
            members = []
        if q == 0:
            l_row, l_col = -g_wv, -g_wu
        elif q == 1:
            l_row, l_col = g_wv, -g_wu
        elif q == 2:
            l_row, l_col = -g_wu, -g_wv
        else:
            l_row, l_col = g_wu, -g_wv
        l_row = torch.clamp(l_row, min=f32(1e-6))
        tau = torch.clamp(l_col / l_row, -1.0, 1.0)
        delta = torch.clamp(sp * g_wy / l_row, f32(-1e7), f32(1e7))
        groups.append(Group(q=q, substeps=int(substeps if has_sun else sky_substeps),
                            has_sun=has_sun, strata=tuple(members), w_u=g_wu, w_v=g_wv,
                            w_y=g_wy, tau=tau, delta=delta, env_w=g_env))
    return SweepBins(groups=tuple(groups), ne=strata.ne)


def _orient(a: torch.Tensor, q: int) -> torch.Tensor:
    """View the (V, U, ...) grid so that the group's march runs along +rows."""
    if q == 0:
        return a
    if q == 1:
        return a.flip(0)
    if q == 2:
        return a.transpose(0, 1)
    return a.transpose(0, 1).flip(0)


def _unorient(a: torch.Tensor, q: int) -> torch.Tensor:
    if q == 0:
        return a
    if q == 1:
        return a.flip(0)
    if q == 2:
        return a.transpose(0, 1)
    return a.flip(0).transpose(0, 1)


def _step_constants(tau, delta, substeps: int):
    """Per-bin constants of one propagation step (tau and delta divided
    over the substeps)."""
    ss = f32(substeps)
    taub = fdiv(tau, ss)
    return (1.0 - torch.abs(taub), torch.clamp(taub, min=0.0), torch.clamp(-taub, min=0.0),
            fdiv(delta, ss))


def _propagate_group_plain(h, du, dv, g: Group):
    """forge3d_tpu/ops/sweep.py:_propagate_group on the oriented grid:
    returns (e_sky (V, U, 3), z_in of bin 0 (V, U))."""
    V, U = h.shape
    dev = h.device
    B = g.tau.shape[0]
    one_m, tpos, tneg, deltab = (c.to(dev)[:, None] for c in _step_constants(g.tau, g.delta,
                                                                              g.substeps))
    w_u, w_v, w_y = (c.to(dev)[:, None] for c in (g.w_u, g.w_v, g.w_y))
    env_w = g.env_w.to(dev)
    invn = rsqrt(1.0 + du * du + dv * dv)
    neg = torch.full((B, 1), NEG32, dtype=_F32, device=dev)

    def shift_drop(z):
        zp = torch.cat([neg, z[:, :-1]], dim=1)
        zm = torch.cat([z[:, 1:], neg], dim=1)
        return z * one_m + tpos * zp + tneg * zm - deltab

    z = torch.full((B, U), NEG32, dtype=_F32, device=dev)
    h_prev = h[0]
    e_rows, z_rows = [], []
    for r in range(V):
        h_row = h[r]
        for j in range(1, g.substeps):
            h_mid = h_prev + f32(j / g.substeps) * (h_row - h_prev)
            z = torch.maximum(h_mid[None, :], shift_drop(z))
        z_in = shift_drop(z)
        lit = (h_row[None, :] >= z_in).to(_F32)
        cosb = (w_y - w_u * du[r][None, :] - w_v * dv[r][None, :]) * invn[r][None, :]
        contrib = lit * torch.clamp(cosb, min=0.0)
        e_rows.append(contrib.transpose(0, 1) @ env_w)
        z_rows.append(z_in[0])
        z = torch.maximum(h_row[None, :], z_in)
        h_prev = h_row
    return torch.stack(e_rows), torch.stack(z_rows)


class SweepMaps(NamedTuple):
    """Per-frame texel-space lighting maps on the rotated grid."""

    e_sky: torch.Tensor   # (V, U, 3) sky irradiance term (no albedo)
    z_sun: torch.Tensor   # (V, U) incoming sun shadow height (world y)


def sweep_lighting_plain(h, du, dv, bins: SweepBins) -> SweepMaps:
    """Plain PyTorch version of K2."""
    V, U = h.shape
    e_total = torch.zeros((V, U, 3), dtype=_F32, device=h.device)
    z_sun = torch.full((V, U), NEG32, dtype=_F32, device=h.device)
    for g in bins.groups:
        e_g, z0 = _propagate_group_plain(_orient(h, g.q), _orient(du, g.q), _orient(dv, g.q), g)
        e_total = e_total + _unorient(e_g, g.q)
        if g.has_sun:
            z_sun = _unorient(z0, g.q).contiguous()
    return SweepMaps(e_sky=e_total, z_sun=z_sun)


def sweep_lighting_stratum_order(h, du, dv, bins: SweepBins) -> SweepMaps:
    """K2's own summation order in plain PyTorch: the recurrence of
    `sweep_lighting_plain`, but each sky stratum's bins summed in bin order
    into the stratum's plane and the planes added in the order of
    `kernel_tables`, as the kernel sums them (sweep_lighting_plain sums a
    quadrant's bins as one matrix product, so its e_sky differs in the last
    bits). The kernel equals this bit for bit, whatever its decomposition."""
    V, U = h.shape
    dev = h.device
    planes = []
    z_sun = torch.full((V, U), NEG32, dtype=_F32, device=dev)
    for g in bins.groups:
        hq, duq, dvq = _orient(h, g.q), _orient(du, g.q), _orient(dv, g.q)
        R, Cw = hq.shape
        B = g.tau.shape[0]
        one_m, tpos, tneg, deltab = (c.to(dev)[:, None] for c in _step_constants(
            g.tau, g.delta, g.substeps))
        w_u, w_v, w_y = (c.to(dev)[:, None] for c in (g.w_u, g.w_v, g.w_y))
        sky = slice(1 if g.has_sun else 0, B)
        env = g.env_w.to(dev)[sky].reshape(len(g.strata), bins.ne, 1, 3)
        neg = torch.full((B, 1), NEG32, dtype=_F32, device=dev)

        def shift_drop(z):
            zp = torch.cat([neg, z[:, :-1]], dim=1)
            zm = torch.cat([z[:, 1:], neg], dim=1)
            return z * one_m + tpos * zp + tneg * zm - deltab

        z = torch.full((B, Cw), NEG32, dtype=_F32, device=dev)
        e_rows, z_rows = [], []
        for r in range(R):
            h_row, h_prev = hq[r], hq[max(r - 1, 0)]
            for j in range(1, g.substeps):
                h_mid = h_prev + f32(j / g.substeps) * (h_row - h_prev)
                z = torch.maximum(h_mid[None, :], shift_drop(z))
            z_in = shift_drop(z)
            invn = rsqrt(1.0 + duq[r] * duq[r] + dvq[r] * dvq[r])
            lit = (h_row[None, :] >= z_in).to(_F32)
            cosb = (w_y - w_u * duq[r][None, :] - w_v * dvq[r][None, :]) * invn[None, :]
            contrib = (lit * torch.clamp(cosb, min=0.0))[sky].reshape(len(g.strata), bins.ne,
                                                                      Cw, 1)
            e = torch.zeros((len(g.strata), Cw, 3), dtype=_F32, device=dev)
            for k in range(bins.ne):
                e = e + contrib[:, k] * env[:, k]
            e_rows.append(e)
            z_rows.append(z_in[0])
            z = torch.maximum(h_row[None, :], z_in)
        if g.strata:
            planes += list(_unorient(torch.stack(e_rows, 1).permute(1, 2, 0, 3), g.q)
                           .permute(2, 0, 1, 3))
        if g.has_sun:
            z_sun = _unorient(torch.stack(z_rows), g.q).contiguous()
    e_sky = torch.zeros((V, U, 3), dtype=_F32, device=dev)
    for p in planes:
        e_sky = e_sky + p
    return SweepMaps(e_sky=e_sky, z_sun=z_sun)


# Columns of a K2 bin-table row (csrc/sweep.cuh:SweepBin).
_BIN_FIELDS = 10


def kernel_tables(bins: SweepBins):
    """The K2 launch tables: one task per CTA (the sun alone, or one sky
    stratum's elevation bins) as int32 rows (q, substeps, first bin, bin
    count, partial plane or -1, emits z_sun), and the float32 bin table
    (w_u, w_v, w_y, 1-|tau/ss|, max(tau/ss,0), max(-tau/ss,0), delta/ss,
    env_w rgb). Partial planes are numbered in the order the e_sky sum
    takes them: groups by quadrant, strata in order."""
    tasks, rows = [], []
    n_planes = 0
    for g in bins.groups:
        one_m, tpos, tneg, deltab = _step_constants(g.tau, g.delta, g.substeps)
        tab = torch.stack([g.w_u, g.w_v, g.w_y, one_m, tpos, tneg, deltab,
                           g.env_w[:, 0], g.env_w[:, 1], g.env_w[:, 2]], dim=1)
        base = sum(r.shape[0] for r in rows)
        rows.append(tab)
        first = 0
        if g.has_sun:
            tasks.append((g.q, g.substeps, base, 1, -1, 1))
            first = 1
        for i in range(len(g.strata)):
            tasks.append((g.q, g.substeps, base + first + i * bins.ne, bins.ne, n_planes, 0))
            n_planes += 1
    table = torch.cat(rows).contiguous() if rows else torch.zeros((0, _BIN_FIELDS))
    return torch.tensor(tasks, dtype=torch.int32).reshape(-1, 6), table, n_planes


# K2's thread block clusters: a task's columns split into bands, one CTA
# each, a cluster of K2_CLUSTERS[i] CTAs a task: the fewest whose bands are
# at most K2_BAND columns wide, else the most (16, a non-portable size past
# 8, which an H100 allows) while a band's threads fit a CTA. Measured on an
# H100 (PERF.md): 1 CTA a task runs a narrow grid with no exchange; 7 keeps
# the 32 strata of bench.py's 1032-column grid resident at once
# (cudaOccupancyMaxActiveClusters 32; 4 and 8 leave 30, 11 or 14 fewer),
# the sun's task queued last; 16 is the fastest past that width.
K2_CLUSTERS = (1, 7, 16)
K2_BAND = 148
# A device-memory task's bins in this many groups, its one CTA's threads
# looping over the (group, column) pairs (the fastest of 1-4 on an H100).
K2_GLOBAL_GROUPS = 2
# Shared memory of K2's input ring a band column: kRingSlots (3) chunks of
# kRingRows + 1 (5) floats for h, du, dv and the normal's 1/length
# (csrc/sweep.cu).
_RING_FLOATS_PER_COLUMN = 3 * 4 * 5
_BINS_PER_THREAD = 4    # kBinsPerThread
_SMEM_THREADS = 800     # kSweepSmemThreads


def _even_bands(width: int, n: int) -> List[int]:
    """Band widths of `width` columns over n CTAs: ceil(width / n) each, the
    last ones narrower or empty."""
    band = -(-width // n)
    return [max(0, min(band, width - k * band)) for k in range(n)]


class K2Plan(NamedTuple):
    """K2's launch: one (task, c0, w) row a CTA, a task's CTAs consecutive
    inside one cluster; the CTA scheduler places clusters in this order, so
    the tasks with the most steps come first and the sun's (one bin, the
    least work a step) last, where it waits if the card holds no more."""

    ctas: torch.Tensor    # (n_ctas, 3) int32
    cluster: int
    band: int             # the widest band
    zs: int               # z rows' pitch: band + 2 ghost columns
    threads: int
    groups: int           # a task's bins split into this many groups, a thread a group
    use_global: bool      # z rows in device memory, one CTA a task
    smem: int             # dynamic shared memory bytes a CTA


def _k2_layout(V: int, U: int, tasks: torch.Tensor, n: int, use_global: bool,
               groups: int) -> K2Plan:
    """Each task's columns in n bands (`_even_bands`), its bins in `groups`
    groups, a thread a (group, column)."""
    nb_max = int(tasks[:, 3].max()) if tasks.numel() else 0
    steps = [(V if q < 2 else U) * ss for q, ss in tasks[:, :2].tolist()]
    order = sorted(range(len(steps)), key=lambda ti: (int(tasks[ti, 3]) < 2, -steps[ti]))
    rows = []
    for ti in order:
        width = U if int(tasks[ti, 0]) < 2 else V
        c0 = 0
        for w in _even_bands(width, n):
            rows.append((ti, c0, w))
            c0 += w
    band = max([w for _, _, w in rows], default=1)
    zs = band + 2
    smem = ((nb_max * _BIN_FIELDS + 3) & ~3) * 4
    if not use_global:
        smem += (2 * nb_max * (zs + band) + _RING_FLOATS_PER_COLUMN * band) * 4
    threads = max(32, min(1024, -(-groups * band // 32) * 32))
    ctas = torch.tensor(rows, dtype=torch.int32).reshape(-1, 3)
    return K2Plan(ctas, n, band, zs, threads, groups, use_global, smem)


def k2_plan(V: int, U: int, tasks: torch.Tensor) -> K2Plan:
    """K2's launch for a (V, U) grid: a task's bins in the fewest groups of
    at most _BINS_PER_THREAD, a thread a (group, column), its columns in
    bands over a cluster of K2_CLUSTERS' size (see there). Where no size
    fits a band's threads in _SMEM_THREADS, or a CTA passes
    _kernels.SMEM_LIMIT, each task runs as one CTA with its z rows in device
    memory."""
    nb_max = int(tasks[:, 3].max()) if tasks.numel() else 0
    g = max(1, -(-nb_max // _BINS_PER_THREAD))
    width = max(V, U, 1)
    fits = [c for c in K2_CLUSTERS if g * -(-width // c) <= _SMEM_THREADS]
    if fits:
        n = next((c for c in fits if -(-width // c) <= K2_BAND), fits[-1])
        p = _k2_layout(V, U, tasks, n, False, g)
        if p.smem <= _kernels.SMEM_LIMIT:
            return p
    return _k2_layout(V, U, tasks, 1, True, K2_GLOBAL_GROUPS)


# (V, U, task table, K2's settings) -> (plan, the task, CTA and plane tables
# on the card): a grid and stratification keep their launch from frame to
# frame, so its tables are built and copied once (at most _K2_KEEP kept).
_K2_LAUNCHES = {}
_K2_KEEP = 64


def _k2_launch(V: int, U: int, tasks: torch.Tensor, n_planes: int, dev):
    key = (V, U, tasks.numpy().tobytes(), n_planes, K2_CLUSTERS, K2_BAND, K2_GLOBAL_GROUPS,
           _kernels.SMEM_LIMIT, str(dev))
    hit = _K2_LAUNCHES.get(key)
    if hit is None:
        if len(_K2_LAUNCHES) >= _K2_KEEP:
            _K2_LAUNCHES.clear()
        p = k2_plan(V, U, tasks)
        plane_q = torch.zeros(n_planes, dtype=torch.int32)
        for q, plane in tasks[:, [0, 4]].tolist():
            if plane >= 0:
                plane_q[plane] = q
        ints = torch.cat([tasks.reshape(-1), p.ctas.reshape(-1), plane_q]).to(dev)
        hit = _K2_LAUNCHES[key] = (p, ints)
    return hit


def _sweep_kernel(h, du, dv, bins: SweepBins) -> SweepMaps:
    h, du, dv = (t.contiguous() for t in (h, du, dv))
    _kernels.require_cuda("sweep_lighting", h, du, dv)
    dev = h.device
    V, U = h.shape
    tasks, table, n_planes = kernel_tables(bins)
    nb_max = int(tasks[:, 3].max()) if tasks.numel() else 0
    p, ints = _k2_launch(V, U, tasks, n_planes, dev)
    emit = [q for q, e in tasks[:, [0, 5]].tolist() if e]
    sun_q = emit[0] if emit else -1
    t_ptr, c_ptr, q_ptr = (_kernels.ptr(ints[a:]) for a in
                           (0, tasks.numel(), tasks.numel() + p.ctas.numel()))
    zbuf = torch.empty(p.ctas.shape[0] * 2 * nb_max * (p.zs + p.band) if p.use_global else 0,
                       dtype=_F32, device=dev)
    # partial planes and the sun's z rows in the oriented layout of their task
    partial = torch.empty((n_planes, V, U, 3), dtype=_F32, device=dev)
    z_orient = torch.empty((V * U) if emit else (0,), dtype=_F32, device=dev)
    invn = torch.empty((V, U), dtype=_F32, device=dev)
    e_sky = torch.empty((V, U, 3), dtype=_F32, device=dev)
    z_sun = torch.full((V, U), NEG32, dtype=_F32, device=dev)
    table_d = table.to(dev)
    err = _kernels.lib().f3d_sweep_lighting(
        _kernels.ptr(h), _kernels.ptr(du), _kernels.ptr(dv), V, U, t_ptr, int(tasks.shape[0]),
        c_ptr, int(p.ctas.shape[0]), p.cluster, p.threads, _kernels.ptr(table_d), nb_max, p.zs,
        p.band, p.groups, _kernels.ptr(invn), _kernels.ptr(zbuf) if p.use_global else None,
        _kernels.ptr(partial), _kernels.ptr(z_orient), q_ptr, n_planes, sun_q,
        _kernels.ptr(e_sky), _kernels.ptr(z_sun), _kernels.stream_ptr(dev))
    _kernels.check(err, "K2 sweep_lighting")
    sweep_lighting.launches += 1
    return SweepMaps(e_sky=e_sky, z_sun=z_sun)


def k2_resident_clusters(V: int, U: int, bins: SweepBins) -> Tuple[int, K2Plan]:
    """(cudaOccupancyMaxActiveClusters, plan) of K2's launch for these bins
    on a (V, U) grid: the most clusters of its shape the card holds at
    once."""
    tasks, _, _ = kernel_tables(bins)
    p = k2_plan(V, U, tasks)
    n = ctypes.c_int(0)
    nb_max = int(tasks[:, 3].max()) if tasks.numel() else 0
    err = _kernels.lib().f3d_sweep_clusters(p.cluster, p.threads, nb_max, p.zs, p.band,
                                            int(p.use_global), ctypes.addressof(n))
    _kernels.check(err, "K2 sweep_lighting (occupancy)")
    return n.value, p


def sweep_lighting(h, du, dv, bins: SweepBins) -> SweepMaps:
    """K2: run all direction-bin propagations of one frame (the bins of
    `sweep_bins`)."""
    if h.device.type == "cpu":
        return sweep_lighting_plain(h, du, dv, bins)
    return _sweep_kernel(h, du, dv, bins)


sweep_lighting.launches = 0
