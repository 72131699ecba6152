# forge3d_tpu_torch/pt/terrain_sweep.py
# The sweep estimator (forge3d_tpu/pt/terrain_sweep.py), on PyTorch: the
# production terrain renderer behind hybrid_render_terrain_reference(...,
# traversal="sweep") and hybrid_render_terrain_sequence.
#
# One render:
#   K1 rotate the DEM onto the camera-aligned grid (once);
#   per frame i (key_i = fold_in(PRNGKey(seed), i), split four ways):
#     K2 shadow-line sweeps of the sun and 32 x 12 jittered sky bins;
#     K3 the polar first-hit scan, shaded from the sweep maps, added into
#        the (E, A, 9) accumulator;
#   K4 warp the mean polar image to the screen, finalize the AOVs and pack
#      them into one u8 buffer, read back once and decoded on the host.
# The frames run one after another: the JAX version's vmapped batches and
# HBM-budget chunking exist for the TPU; only their frame-count rule is
# kept, because the frame keys fold over the rounded-up count.
#
# `device` is explicit: "cuda" launches the kernels and raises if CUDA is
# absent or a kernel fails; "cpu" runs the plain PyTorch versions.

from __future__ import annotations

import ctypes
import functools
import math
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..camera import camera_basis
from ..errors import RenderError
from ..mem import global_tracker
from ..ops import polarscan as pscan
from ..ops import rng
from ..ops import sweep as sw
from ..ops.shading import EnvMap, env_map, env_radiance, fdiv, rsqrt, sqrt32, sun_direction
from ..ops.traversal import f32

_F32 = torch.float32

# The JAX version's per-lane memory rule, kept for its frame count only:
# frames run in batches of at most batch_n, and the count rounds up to
# n_batches * BATCH (terrain_sweep.py:362-371, 564-567).
_HBM_BUDGET = 8 * 1024 ** 3
_CHUNK = 128


class SweepUnsupported(RenderError):
    """The camera cannot be expressed by the polar scan (rolled camera or
    near-vertical frustum rays); callers fall back to traversal engines."""


def _sweep_frames(desc) -> int:
    return int(min(32, max(6, desc.spp * 2, desc.min_frames // 4)))


@dataclass(frozen=True)
class SweepPlan:
    """Static geometry of one scene: cached per camera, DEM size,
    stratification and sun, as the JAX pipeline is."""

    rg: sw.RotGridStatic
    ps: pscan.PolarStatic
    strata: sw.SkyStrata
    rot: sw.RotateArgs
    cam_xz: Tuple[float, float]
    spacing: Tuple[float, float]
    exaggeration: float
    dem_shape: Tuple[int, int]
    sun_w: Tuple[float, float, float]   # float32 values
    shadows: bool
    width: int
    height: int
    batch_n: int

    def frame_layout(self, n_frames: int) -> Tuple[int, int]:
        """(n_batches, BATCH) for a requested frame count; the render runs
        n_batches * BATCH frames."""
        n_batches = max((n_frames + self.batch_n - 1) // self.batch_n, 1)
        return n_batches, (n_frames + n_batches - 1) // n_batches


@functools.lru_cache(maxsize=8)
def sweep_plan(dem_shape: Tuple[int, int], spacing: Tuple[float, float], exaggeration: float,
               cam_origin, cam_look_at, cam_up, fov_y_deg: float, width: int, height: int,
               na: int, ne: int, sin_lo: float, sun_az: float, sun_el: float,
               shadows: bool) -> SweepPlan:
    dem_h, dem_w = dem_shape
    right, up_v, fwd = camera_basis(cam_origin, cam_look_at, cam_up)
    if abs(float(right[1])) > 1e-3:
        raise SweepUnsupported("sweep renderer requires a roll-free camera")
    if math.hypot(float(fwd[0]), float(fwd[2])) < 1e-6:
        raise SweepUnsupported("sweep renderer: camera looks straight down")
    cam_xz = (float(cam_origin[0]), float(cam_origin[2]))
    rg = sw.plan_rot_grid(dem_w - 1, dem_h - 1, origin_xz=(0.0, 0.0), spacing_xz=spacing,
                          cam_xz=cam_xz, fwd_xz=(float(fwd[0]), float(fwd[2])))
    row_ss = 2 if width * height <= 600_000 else 1
    try:
        density = float(os.environ.get("FORGE3D_SWEEP_DENSITY", "1.3"))
        ps = pscan.plan_polar(
            width=width, height=height, fov_y_deg=fov_y_deg, right=right, up=up_v, fwd=fwd,
            cam_y=float(cam_origin[1]), rg_n_v=rg.n_v, rg_n_u=rg.n_u,
            rg_spacing=rg.spacing, e_u=rg.e_u, e_v=rg.e_v, cam_iu=rg.cam_iu,
            cam_iv=rg.cam_iv, row_ss=row_ss, density=density)
    except ValueError as e:
        raise SweepUnsupported(str(e)) from None
    per_lane = (ps.e_count * ps.k_count * _CHUNK * 8
                + _CHUNK * rg.n_u * ps.a_count * 4
                + ps.k_count * ps.a_count * 9 * 4 * 3)
    batch_n = max(min(_HBM_BUDGET // max(per_lane, 1), 4), 1)
    return SweepPlan(
        rg=rg, ps=ps, strata=sw.make_strata(na, ne, sin_lo),
        rot=sw.RotateArgs.make(rg, (0.0, 0.0), spacing, cam_xz, exaggeration),
        cam_xz=cam_xz, spacing=spacing, exaggeration=exaggeration, dem_shape=dem_shape,
        sun_w=sun_direction(sun_az, sun_el), shadows=bool(shadows), width=width,
        height=height, batch_n=int(batch_n))


def plan_for(desc, sky_azimuths: int = 32, sky_elevations: int = 12,
             sky_sin_lo: float = -0.55) -> SweepPlan:
    heights = np.asarray(desc.heights)
    return sweep_plan(
        tuple(heights.shape), tuple(map(float, desc.spacing)), float(desc.exaggeration),
        tuple(map(float, desc.cam_origin)), tuple(map(float, desc.cam_look_at)),
        tuple(map(float, desc.cam_up)), float(desc.fov_y_deg), int(desc.width),
        int(desc.height), int(sky_azimuths), int(sky_elevations), float(sky_sin_lo),
        float(desc.sun_azimuth_deg), float(desc.sun_elevation_deg),
        bool(desc.shadows_enabled))


@dataclass(frozen=True)
class SweepScene:
    """Per-render content on the device: the DEM, its cell-corner pack
    (h00, h10, h01, h11 per cell), the env map (and a host copy for the bin
    table), and the shading constants as float32 values."""

    heights: torch.Tensor      # (dem_h, dem_w)
    corners: torch.Tensor      # ((dem_h-1)*(dem_w-1), 4)
    env: EnvMap
    env_host: EnvMap
    lc: Tuple[float, float, float]
    albedo: Tuple[float, float, float]
    shadow_eps: float


def corner_pack(heights: torch.Tensor) -> torch.Tensor:
    return torch.stack([heights[:-1, :-1], heights[:-1, 1:], heights[1:, :-1],
                        heights[1:, 1:]], dim=-1).reshape(-1, 4).contiguous()


def make_scene(desc, device) -> SweepScene:
    heights = np.asarray(desc.heights, np.float32)
    hd = torch.as_tensor(heights, device=device)
    h_rng = float(heights.max() - heights.min()) * desc.exaggeration
    return SweepScene(
        heights=hd, corners=corner_pack(hd),
        env=env_map(desc.env_map, desc.env_intensity, device),
        env_host=env_map(desc.env_map, desc.env_intensity, "cpu"),
        lc=tuple(f32(desc.sun_intensity * c) for c in desc.sun_color),
        albedo=tuple(f32(a) for a in desc.albedo),
        shadow_eps=f32(1e-4 * (h_rng + 1.0)))


class FrameJitter:
    """One frame's random numbers, from key_i = fold_in(PRNGKey(seed), i):
    the sky key and the radial, azimuth and elevation jitters."""

    def __init__(self, key):
        self.k_sky, k_jv, k_ja, k_je = rng.split(key, 4)
        self.xi = float(rng.uniform(k_jv))
        self.ja = float(rng.uniform(k_ja) - np.float32(0.5))
        self.je = float(rng.uniform(k_je) - np.float32(0.5))


def frame_jitters(seed: int, n_frames: int) -> List[FrameJitter]:
    key = rng.prng_key(seed)
    return [FrameJitter(rng.fold_in(key, i)) for i in range(n_frames)]


def frame_bins(plan: SweepPlan, scene: SweepScene, jit: FrameJitter) -> sw.SweepBins:
    return sw.sweep_bins(strata=plan.strata, key=jit.k_sky, env=scene.env_host,
                         e_u=plan.rg.e_u, e_v=plan.rg.e_v, sun_world=plan.sun_w,
                         spacing=plan.rg.spacing)


# ---------------------------------------------------------------------------
# K3: one frame of the polar scan (frame_one minus the sweep)
# ---------------------------------------------------------------------------


def _slab(p0, d, lim):
    dd = torch.where(torch.abs(d) > 1e-12, d, f32(1e-12))
    t1 = fdiv(0.0 - p0, dd)
    t2 = fdiv(lim - p0, dd)
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    inside = (p0 >= 0.0) & (p0 <= lim)
    deg = torch.abs(d) <= 1e-12
    lo = torch.where(deg, torch.where(inside, -1e9, 1e9), lo)
    hi = torch.where(deg, torch.where(inside, 1e9, -1e9), hi)
    return lo, hi


def frame_polar_plain(plan: SweepPlan, scene: SweepScene, h_rot, maps: sw.SweepMaps,
                      xi: float, ja: float, je: float) -> torch.Tensor:
    """Plain PyTorch version of K3: one frame's (E, A, 9) polar image."""
    ps, rg = plan.ps, plan.rg
    dev = h_rot.device
    dem_h, dem_w = plan.dem_shape
    K, A = ps.k_count, ps.a_count
    sx, sz = f32(plan.spacing[0]), f32(plan.spacing[1])
    ex_sx, ex_sz = f32(plan.exaggeration / plan.spacing[0]), f32(plan.exaggeration /
                                                                  plan.spacing[1])
    sun = plan.sun_w
    eps = scene.shadow_eps
    alb = torch.tensor(scene.albedo, dtype=_F32, device=dev)
    lc = torch.tensor(scene.lc, dtype=_F32, device=dev)
    corners = scene.corners

    rotbuf = torch.cat([h_rot[..., None], maps.e_sky, maps.z_sun[..., None]], dim=-1)
    prof = pscan.extract_profiles(rotbuf, ps, xi=xi, ja=ja)
    h_p, e_sky_p, z_sun_p = prof[..., 0], prof[..., 1:4], prof[..., 4]

    t_az = pscan.azimuth_tangents(ps, ja, dev)
    kidx = torch.arange(K, dtype=_F32, device=dev)
    koff = kidx + pscan.radial_base(ps) + xi
    p_col = f32(ps.cam_iu) + koff[:, None] * t_az[None, :]
    row = (f32(ps.k0 + 1.0) + xi + kidx)[:, None]
    u_w = f32(rg.u0) + p_col * f32(rg.spacing)
    v_w = f32(rg.v0) + row * f32(rg.spacing)
    x_w = f32(plan.cam_xz[0]) + u_w * f32(rg.e_u[0]) + v_w * f32(rg.e_v[0])
    z_w = f32(plan.cam_xz[1]) + u_w * f32(rg.e_u[2]) + v_w * f32(rg.e_v[2])

    def patch(fx, fz):
        x0 = torch.clamp(torch.floor(fx), 0, dem_w - 2)
        z0 = torch.clamp(torch.floor(fz), 0, dem_h - 2)
        tx = torch.clamp(fx - x0, 0.0, 1.0)
        tz = torch.clamp(fz - z0, 0.0, 1.0)
        cell = corners[(z0.to(torch.int64) * (dem_w - 1) + x0.to(torch.int64))]
        h00, h10, h01, h11 = cell.unbind(-1)
        gx = ((h10 - h00) * (1.0 - tz) + (h11 - h01) * tz) * ex_sx
        gz = ((h01 - h00) * (1.0 - tx) + (h11 - h10) * tx) * ex_sz
        invn = rsqrt(1.0 + gx * gx + gz * gz)
        h = ((h00 * (1 - tx) + h10 * tx) * (1 - tz) + (h01 * (1 - tx) + h11 * tx) * tz) \
            * f32(plan.exaggeration)
        return -gx * invn, invn, -gz * invn, h

    def shade(nx, ny, nz, h, es, zs):
        ndotl = torch.clamp(nx * sun[0] + ny * sun[1] + nz * sun[2], min=0.0)
        vis = (h + eps >= zs).to(_F32) if plan.shadows else torch.ones_like(h)
        lit = ndotl * vis
        return alb * (lc * lit[..., None] + es)

    nx, ny, nz, _ = patch(fdiv(x_w, sx), fdiv(z_w, sz))
    rgb = shade(nx, ny, nz, h_p, e_sky_p, z_sun_p)
    q_prof, t_dist = pscan.profile_hit_tangents(h_p, ps, xi=xi, ja=ja)
    ones = torch.ones_like(h_p)
    valid = h_p > -1e20
    valid_prev = torch.cat([torch.zeros_like(valid[:1]), valid[:-1]], dim=0)
    entry = (valid & ~valid_prev).to(_F32)

    # exact boundary-entry sample
    k_entry = torch.argmax(valid.to(torch.int32), dim=0)
    has_valid = valid.any(dim=0)
    sp = f32(rg.spacing)
    eu0, eu2, ev0, ev2 = (f32(c) for c in (rg.e_u[0], rg.e_u[2], rg.e_v[0], rg.e_v[2]))
    u_c = f32(rg.u0) + (f32(ps.cam_iu) - f32(ps.cam_iv) * t_az) * sp
    x0w = f32(plan.cam_xz[0]) + u_c * eu0 + f32(f32(rg.v0) * ev0)
    z0w = f32(plan.cam_xz[1]) + u_c * eu2 + f32(f32(rg.v0) * ev2)
    dxr = sp * (t_az * eu0 + ev0)
    dzr = sp * (t_az * eu2 + ev2)
    lox, hix = _slab(x0w, dxr, f32((dem_w - 1) * plan.spacing[0]))
    loz, hiz = _slab(z0w, dzr, f32((dem_h - 1) * plan.spacing[1]))
    r_in = torch.maximum(lox, loz)
    r_out = torch.minimum(hix, hiz)
    koff_e = r_in - f32(ps.cam_iv)
    can_edge = has_valid & (k_entry >= 1) & (koff_e > 0.25) & (r_in < r_out)
    xe = x0w + r_in * dxr
    ze = z0w + r_in * dzr
    fxe = torch.clamp(fdiv(xe, sx), 0.0, dem_w - 1.0)
    fze = torch.clamp(fdiv(ze, sz), 0.0, dem_h - 1.0)
    nxe, nye, nze, h_edge = patch(fxe, fze)
    take = lambda arr: arr.gather(0, k_entry.reshape(1, A, *([1] * (arr.dim() - 2)))  # noqa: E731
                                  .expand(1, A, *arr.shape[2:]))[0]
    rgb_e = shade(nxe, nye, nze, h_edge, take(e_sky_p), take(z_sun_p))
    s_edge = torch.clamp(koff_e, min=f32(1e-6)) * sp
    s_e = torch.clamp(s_edge, min=f32(1e-6))
    q_edge = torch.clamp(fdiv(h_edge - f32(ps.cam_y), s_e), -1e4, 1e4)
    t_edge = s_e * sqrt32(1.0 + t_az * t_az + q_edge * q_edge)
    slot = torch.where(can_edge, k_entry - 1, K)
    selb = torch.arange(K, device=dev)[:, None] == slot[None, :]
    q_prof = torch.where(selb, q_edge[None, :], q_prof)
    t_dist = torch.where(selb, t_edge[None, :], t_dist)
    rgb = torch.where(selb[..., None], rgb_e[None], rgb)
    nx = torch.where(selb, nxe[None], nx)
    ny = torch.where(selb, nye[None], ny)
    nz = torch.where(selb, nze[None], nz)
    entry = torch.where(can_edge[None, :], selb.to(_F32), entry)

    values = torch.cat([rgb, t_dist[..., None], nx[..., None], ny[..., None], nz[..., None],
                        ones[..., None], entry[..., None]], dim=-1)
    dx, dy, dz, _, _ = pscan.polar_directions(ps, ja=ja, je=je, device=dev)
    mr, mg, mb = env_radiance(scene.env, dx, dy, dz)
    zero = torch.zeros_like(mr)
    miss = torch.stack([mr, mg, mb] + [zero] * 6, dim=-1)
    polar = pscan.synthesize_polar(values, q_prof, miss, ps, je=je)

    h_entry = take(h_p)
    s_ent = (k_entry.to(_F32) + pscan.radial_base(ps) + xi) * f32(ps.spacing)
    h_ent = torch.where(can_edge, h_edge, h_entry)
    s_ent = torch.where(can_edge, s_edge, s_ent)
    z_ray = f32(ps.cam_y) + ps.q_rows(je, dev)[:, None] * s_ent[None, :]
    under = z_ray < (h_ent[None, :] - eps)
    phantom = (polar[..., 8] > 0.98) & under
    return torch.where(phantom[..., None], miss, polar)


def polar_args(plan: SweepPlan, scene: SweepScene, xi: float, ja: float,
               je: float) -> _kernels.PolarArgs:
    ps, rg = plan.ps, plan.rg
    dem_h, dem_w = plan.dem_shape
    r1, r2 = pscan.source_rows(ps, rg.n_v)
    rgb = scene.env.rgb
    F3 = ctypes.c_float * 3
    v0 = f32(rg.v0)
    return _kernels.PolarArgs(
        None if rgb is None else rgb.data_ptr(), 0 if rgb is None else rgb.shape[1],
        0 if rgb is None else rgb.shape[0], scene.env.intensity,
        rg.n_v, rg.n_u, ps.k_count, ps.a_count, ps.e_count, r1, r2, dem_w, dem_h,
        int(plan.shadows),
        *(f32(c) for c in (ps.t_lo, ps.t_step, ps.y_step, ps.fv, ps.uvhh, ps.fy, ps.uyhh,
                           ps.cam_y, ps.cam_iu, ps.cam_iv, ps.spacing)),
        pscan.radial_base(ps), f32(ps.k0 + 1.0),
        f32(rg.u0), v0, f32(plan.cam_xz[0]), f32(plan.cam_xz[1]),
        f32(rg.e_u[0]), f32(rg.e_u[2]), f32(rg.e_v[0]), f32(rg.e_v[2]),
        f32(v0 * f32(rg.e_v[0])), f32(v0 * f32(rg.e_v[2])),
        f32(plan.spacing[0]), f32(plan.spacing[1]), f32(plan.exaggeration),
        f32(plan.exaggeration / plan.spacing[0]), f32(plan.exaggeration / plan.spacing[1]),
        f32((dem_w - 1) * plan.spacing[0]), f32((dem_h - 1) * plan.spacing[1]),
        F3(*plan.sun_w), F3(*scene.lc), F3(*scene.albedo), scene.shadow_eps,
        f32(xi), f32(ja), f32(je))


#: K3's azimuth columns a CTA (csrc/sweep.cuh:F3D_K3_COLUMNS, which
#: f3d_polar_attrs reports): what a CTA's profiles take
POLAR_COLUMNS = 2


def polar_profile_floats(k_count: int) -> int:
    """Floats of one column's profile in K3 (csrc/sweep.cuh:PolarColumn):
    q, seven channels and a validity byte a row."""
    return 8 * k_count + (k_count + 3) // 4


def polar_uses_scratch(k_count: int) -> bool:
    """Whether K3 keeps a CTA's column profiles in a device scratch buffer:
    where they pass _kernels.SMEM_LIMIT."""
    return POLAR_COLUMNS * polar_profile_floats(k_count) * 4 > _kernels.SMEM_LIMIT


def _polar_kernel(plan, scene, acc, h_rot, maps, xi, ja, je):
    ps = plan.ps
    tensors = [h_rot.contiguous(), maps.e_sky.contiguous(), maps.z_sun.contiguous(),
               scene.corners]
    _kernels.require_cuda("polar_frame", acc, *tensors)
    if tuple(acc.shape) != (ps.e_count, ps.a_count, 9):
        raise ValueError("polar_frame: acc must be (E, A, 9)")
    if scene.env.rgb is not None:
        _kernels.require_cuda("env_map", scene.env.rgb)
    dev = acc.device
    use_global = polar_uses_scratch(ps.k_count)
    ctas = -(-ps.a_count // POLAR_COLUMNS)
    scratch = torch.empty((ctas * POLAR_COLUMNS * polar_profile_floats(ps.k_count),)
                          if use_global else (0,), dtype=_F32, device=dev)
    args = polar_args(plan, scene, xi, ja, je)
    err = _kernels.lib().f3d_polar_frame(
        args, *(_kernels.ptr(t) for t in tensors), _kernels.ptr(acc),
        _kernels.ptr(scratch) if use_global else None, _kernels.stream_ptr(dev))
    _kernels.check(err, "K3 polar_frame")
    polar_frame.launches += 1
    return acc


def polar_frame(plan: SweepPlan, scene: SweepScene, acc, h_rot, maps: sw.SweepMaps,
                xi: float, ja: float, je: float):
    """K3: add one frame's polar image into the accumulator acc (E, A, 9),
    in place. CPU tensors run the plain version; CUDA tensors the kernel."""
    if acc.device.type == "cpu":
        return acc.add_(frame_polar_plain(plan, scene, h_rot, maps, xi, ja, je))
    return _polar_kernel(plan, scene, acc, h_rot, maps, xi, ja, je)


polar_frame.launches = 0


# ---------------------------------------------------------------------------
# K4: resolve (warp to screen, AOV finalize, packing)
# ---------------------------------------------------------------------------


def resolve_plain(plan: SweepPlan, acc, n_frames: int) -> torch.Tensor:
    """Plain PyTorch version of K4: the packed u8 buffer (9 bytes/pixel:
    vis, octahedral normal x2, f16 depth bytes x2, RGBE x4, plane by
    plane)."""
    ps, W, H = plan.ps, plan.width, plan.height
    mean = fdiv(acc, f32(n_frames))
    hdr = pscan.warp_to_screen(mean[..., :3], ps, width=W, height=H, supersample=2)
    aov = pscan.warp_to_screen(mean[..., 3:8], ps, width=W, height=H, supersample=1)
    vis = aov[..., 4]
    hitm = vis >= 0.5
    nrm = aov[..., 1:4]
    nlen = sqrt32(nrm[..., 0] * nrm[..., 0] + nrm[..., 1] * nrm[..., 1]
                  + nrm[..., 2] * nrm[..., 2])[..., None]
    up = torch.tensor([0.0, 1.0, 0.0], dtype=_F32, device=acc.device)
    normal = torch.where(hitm[..., None], fdiv(nrm, torch.clamp(nlen, min=f32(1e-9))), up)
    n0, n1, n2 = normal.unbind(-1)
    s1 = torch.abs(n0) + torch.abs(n1) + torch.abs(n2)
    px, pz = fdiv(n0, s1), fdiv(n2, s1)
    neg = n1 < 0.0
    fx = torch.where(neg, (1.0 - torch.abs(pz)) * torch.sign(px), px)
    fz = torch.where(neg, (1.0 - torch.abs(px)) * torch.sign(pz), pz)
    oct_u8 = torch.stack([torch.clamp((fx * 0.5 + 0.5) * 255.0 + 0.5, 0, 255),
                          torch.clamp((fz * 0.5 + 0.5) * 255.0 + 0.5, 0, 255)],
                         dim=-1).to(torch.uint8)
    depth = torch.where(hitm, torch.clamp(fdiv(aov[..., 0], torch.clamp(vis, min=f32(1e-6))),
                                          max=6.0e4), float("nan"))
    vis_u8 = torch.clamp(vis * 255.0 + 0.5, 0, 255).to(torch.uint8)
    # misses ship the NaN bits 0x7E00 (numpy's and XLA's; PyTorch on CUDA
    # converts NaN to 0x7FFF)
    d16 = torch.where(hitm, depth.to(torch.float16).view(torch.int16), 0x7E00)
    d8 = d16.to(torch.int16).view(torch.uint8)
    m = torch.maximum(torch.maximum(hdr[..., 0], hdr[..., 1]), hdr[..., 2])
    _, ex = torch.frexp(torch.clamp(m, min=f32(1e-30)))
    scale = ((135 - ex) << 23).view(_F32)           # exactly 2 ** (8 - ex)
    mant = torch.clamp(torch.floor(hdr * scale[..., None]), 0, 255).to(torch.uint8)
    e_u8 = torch.clamp(ex + 128, 0, 255).to(torch.uint8)
    live = m > 1e-30
    rgbe = torch.where(live[..., None], torch.cat([mant, e_u8[..., None]], dim=-1),
                       torch.zeros((), dtype=torch.uint8, device=acc.device))
    return torch.cat([vis_u8.reshape(-1), oct_u8.reshape(-1), d8.reshape(-1),
                      rgbe.reshape(-1)])


def resolve_args(plan: SweepPlan, n_frames: int) -> _kernels.ResolveArgs:
    ps = plan.ps
    return _kernels.ResolveArgs(ps.a_count, ps.e_count, ps.row_ss, plan.width, plan.height,
                                f32(ps.hw), f32(ps.t_lo), f32(ps.t_step), f32(n_frames),
                                ps.fv, ps.uvhh, ps.y_step)


def _resolve_kernel(plan: SweepPlan, acc, n_frames: int) -> torch.Tensor:
    ps = plan.ps
    acc = acc.contiguous()
    _kernels.require_cuda("resolve", acc)
    if tuple(acc.shape) != (ps.e_count, ps.a_count, 9):
        raise ValueError("resolve: acc must be (E, A, 9)")
    dev = acc.device
    out = torch.empty(plan.width * plan.height * 9, dtype=torch.uint8, device=dev)
    err = _kernels.lib().f3d_resolve(resolve_args(plan, n_frames), _kernels.ptr(acc),
                                     _kernels.ptr(out), _kernels.stream_ptr(dev))
    _kernels.check(err, "K4 resolve")
    resolve.launches += 1
    return out


def resolve(plan: SweepPlan, acc, n_frames: int) -> torch.Tensor:
    """K4: the mean polar image (acc / n_frames) to the packed u8 buffer."""
    if acc.device.type == "cpu":
        return resolve_plain(plan, acc, n_frames)
    return _resolve_kernel(plan, acc, n_frames)


resolve.launches = 0


# ---------------------------------------------------------------------------
# Host flow
# ---------------------------------------------------------------------------


def accumulate(plan: SweepPlan, scene: SweepScene, rot, jitters) -> torch.Tensor:
    """The frames `jitters` summed in order into one (E, A, 9) polar
    accumulator (K2 and K3 a frame), from the rotated grid `rot` = (h_rot,
    du, dv)."""
    ps = plan.ps
    h_rot, du, dv = rot
    acc = torch.zeros((ps.e_count, ps.a_count, 9), dtype=_F32, device=h_rot.device)
    for jit in jitters:
        maps = sw.sweep_lighting(h_rot, du, dv, frame_bins(plan, scene, jit))
        polar_frame(plan, scene, acc, h_rot, maps, jit.xi, jit.ja, jit.je)
    return acc


def render_packed(plan: SweepPlan, scene: SweepScene, rot, seed: int, n_total: int):
    """All frames of one render from the rotated grid `rot`; returns the
    packed buffer on the device."""
    return resolve(plan, accumulate(plan, scene, rot, frame_jitters(seed, n_total)), n_total)


def render_terrain_sweep(desc, frames: Optional[int] = None, sky_azimuths: int = 32,
                         sky_elevations: int = 12, sky_sin_lo: float = -0.55, *,
                         device="cuda") -> dict:
    """Render the converged terrain frame with the sweep estimator; the
    same dict as render_terrain_reference. Raises SweepUnsupported for
    cameras outside the polar parameterization."""
    return render_terrain_sweep_sequence(desc, [desc.seed], frames, sky_azimuths,
                                         sky_elevations, sky_sin_lo, device=device)[0]


def render_terrain_sweep_sequence(desc, seeds, frames: Optional[int] = None,
                                  sky_azimuths: int = 32, sky_elevations: int = 12,
                                  sky_sin_lo: float = -0.55, *, device="cuda") -> list:
    """Render one converged frame per seed over a fixed scene: the rotation
    runs once, the renders run in order, each output bit-identical to
    render_terrain_sweep with that seed."""
    from .terrain_ref import _validate, resolve_device

    _validate(desc)
    dev = resolve_device(device)
    plan = plan_for(desc, sky_azimuths, sky_elevations, sky_sin_lo)
    n_batches, batch = plan.frame_layout(int(frames) if frames else _sweep_frames(desc))
    n_total = n_batches * batch
    scene = make_scene(desc, dev)
    tracker = global_tracker()
    rg, ps = plan.rg, plan.ps
    rot_bytes = rg.n_v * rg.n_u * 4 * 10
    polar_bytes = ps.e_count * ps.a_count * 4 * 9
    rids = [tracker.track("terrain-sweep.rotgrid", rot_bytes, "buffer"),
            tracker.track("terrain-sweep.polar", polar_bytes, "buffer")]
    try:
        rot = sw.rotate_heights(scene.heights, plan.rot)
        outs = []
        for s in seeds:
            packed = render_packed(plan, scene, rot, int(s) & 0xFFFFFFFF, n_total)
            out = _unpack_render(desc, packed.cpu().numpy(), n_total)
            out["peak_host_visible_bytes"] = int(tracker.metrics()["peak_tracked_bytes"])
            out["gpu_resource_bytes"] = int(rot_bytes + polar_bytes)
            outs.append(out)
        return outs
    finally:
        for rid in rids:
            tracker.free(rid)


def _unpack_render(desc, buf: np.ndarray, n_frames: int, extra: dict | None = None) -> dict:
    """Unpack the resolve's u8 buffer into the render dict (the numpy decode
    of forge3d_tpu/pt/terrain_sweep.py:_unpack_render, lazy per output)."""
    W, H = desc.width, desc.height
    hw = H * W
    vis_u8 = buf[:hw].reshape(H, W)
    oct_u8 = buf[hw:hw * 3].reshape(H, W, 2)
    depth_raw = buf[hw * 3:hw * 5]
    rgbe = buf[hw * 5:hw * 9].reshape(H, W, 4)

    class _LazyRender(dict):
        """Render dict with on-demand AOV decoding."""

        _LAZY = ("rgba", "hdr", "depth", "normal", "albedo")

        def __init__(self):
            super().__init__()
            self._hdr_cache = None

        def _hdr_img(self):
            if self._hdr_cache is None:
                exp = rgbe[..., 3].astype(np.int32)
                hscale = np.ldexp(1.0, exp - 136).astype(np.float32)
                self._hdr_cache = np.where(
                    exp[..., None] > 0,
                    (rgbe[..., :3].astype(np.float32) + 0.5) * hscale[..., None],
                    0.0).astype(np.float32)
            return self._hdr_cache

        def __missing__(self, key):
            if key == "hdr":
                val = self._hdr_img()
            elif key == "rgba":
                xexp = self._hdr_img() * float(desc.exposure)
                ldr = (xexp / (1.0 + xexp)).astype(np.float16).astype(np.float32)
                rgb_u8 = np.clip(ldr * 255.0 + 0.5, 0, 255).astype(np.uint8)
                val = np.concatenate([rgb_u8, np.full((H, W, 1), 255, np.uint8)], axis=-1)
            elif key == "depth":
                val = depth_raw.copy().view(np.float16).astype(np.float32).reshape(H, W)
            elif key == "normal":
                hitm = vis_u8 >= 128
                f = oct_u8.astype(np.float32) / 255.0 * 2.0 - 1.0
                ny = 1.0 - np.abs(f[..., 0]) - np.abs(f[..., 1])
                t_fold = np.clip(-ny, 0.0, 1.0)
                nx = f[..., 0] + np.where(f[..., 0] >= 0, -t_fold, t_fold)
                nz = f[..., 1] + np.where(f[..., 1] >= 0, -t_fold, t_fold)
                nvec = np.stack([nx, ny, nz], axis=-1)
                nlen = np.linalg.norm(nvec, axis=-1, keepdims=True)
                val = np.where(hitm[..., None], nvec / np.maximum(nlen, 1e-9),
                               0.0).astype(np.float32)
            elif key == "albedo":
                hitm = vis_u8 >= 128
                val = np.where(hitm[..., None], np.asarray(desc.albedo, np.float32),
                               0.0).astype(np.float32)
            else:
                raise KeyError(key)
            self[key] = val
            return val

        def _force(self):
            for k in self._LAZY:
                self[k]

        def keys(self):  # noqa: D102
            self._force()
            return super().keys()

        def items(self):  # noqa: D102
            self._force()
            return super().items()

        def values(self):  # noqa: D102
            self._force()
            return super().values()

        def __iter__(self):
            self._force()
            return super().__iter__()

        def __contains__(self, key):
            return key in self._LAZY or super().__contains__(key)

        def get(self, key, default=None):  # noqa: D102
            try:
                return self[key]
            except KeyError:
                return default

    out = _LazyRender()
    out.update({
        "frames": n_frames,
        "variance": 0.0,
        "converged": True,
        "peak_host_visible_bytes": 0,
        "minmax_pyramid_bytes": 0,
        "gpu_resource_bytes": 0,
        "method": "sweep",
    })
    if extra:
        out.update(extra)
    return out
