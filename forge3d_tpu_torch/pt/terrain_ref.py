# forge3d_tpu_torch/pt/terrain_ref.py
# The converged path-traced terrain reference (forge3d_tpu/pt/terrain_ref.py)
# on PyTorch: the per-ray estimator (traversal="dda") here, and the
# dispatch of traversal="sweep" and hybrid_render_terrain_sequence to the
# sweep estimator (pt/terrain_sweep.py).
#
# One render: the center-ray G-buffer (K5 trace + K8 resolve), then per
# frame the frame kernel K6 (all spp samples of every pixel: jittered
# primary ray, sun NEE through the ReSTIR reservoir, one cosine env ray,
# sun and env occlusion rays, the fresh candidate reservoir merged with the
# history, accumulation and the windowed Welford) and the spatial reuse
# kernel K7. A scene with a triangle mesh traces every ray through its BVH
# as well and keeps the nearer hit (K9's body inside K6 and K8); typed
# lights add one alias-table light sample and its occlusion ray per camera
# sample (K10's body inside K6). The host reads one scalar, the maximum
# windowed variance, at each 32-frame window boundary, and resolves
# Reinhard -> float16 -> u8 at the end.
#
# `device` is explicit: "cuda" launches the kernels and raises if CUDA is
# absent or a kernel fails; "cpu" runs the plain PyTorch versions. Nothing
# falls back from one to the other.

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..camera import camera_basis
from ..errors import ContractViolation, ConvergenceError, DeviceError, RenderError, UploadError
from ..mem import global_tracker
from ..ops import restir as rst
from ..ops import tonemap as tm
from ..ops.pyramid import build_pyramid
from ..ops.rng import MASK32, derive_seed_lo, seed_state, tent_offset, xorshift32
from ..ops.shading import (EnvMap, cosine_dir, env_map, env_radiance, fdiv, luminance,
                           rsqrt, sun_direction)
from ..ops.bvh import trace_mesh_plain
from ..ops.lightsample import sample_light_nee_plain
from ..ops.traversal import (TerrainScene, f32, normal_at, scene_from_pyramid, trace,
                             trace_plain)

_F32 = torch.float32

WELFORD_WINDOW = 32
_MISS_T = 3.0e38    # the t of a missed ray where the nearer of two hits is taken
_MESH_ALBEDO = (0.7, 0.7, 0.8)   # mesh hits keep this constant albedo


@dataclass(frozen=True)
class TerrainRefDesc:
    """Full scene description (the fields of the JAX TerrainRefDesc)."""

    heights: np.ndarray
    spacing: Tuple[float, float] = (1.0, 1.0)
    exaggeration: float = 1.0
    albedo: Tuple[float, float, float] = (0.6, 0.6, 0.6)
    cam_origin: Tuple[float, float, float] = (0.0, 50.0, 120.0)
    cam_look_at: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    cam_up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_y_deg: float = 45.0
    exposure: float = 1.0
    sun_azimuth_deg: float = 315.0
    sun_elevation_deg: float = 45.0
    sun_intensity: float = 2.5
    sun_color: Tuple[float, float, float] = (1.0, 0.97, 0.92)
    env_map: Optional[np.ndarray] = None
    env_intensity: float = 0.35
    width: int = 512
    height: int = 512
    seed: int = 7
    spp: int = 1
    max_frames: int = 512
    min_frames: int = 32
    variance_threshold: float = 1e-3
    shadows_enabled: bool = True
    #: "dda" = the max-mip DDA (kernel K5); "mxu" names the JAX package's
    #: TPU matmul form of the same traversal and maps to K5 here.
    traversal: str = "dda"
    #: Shade the sun through the ReSTIR temporal+spatial reuse chain; False
    #: = plain sun NEE with unit weight.
    restir: bool = True
    #: Typed lights (lighting.Light), integrated by alias-table NEE: one
    #: light sample per camera sample, selection weighted by emitted power.
    lights: Optional[tuple] = None
    #: A triangle mesh ((N, 3) f32 vertices, (M, 3) u32 indices) traced
    #: beside the terrain for primary and shadow rays; the nearer hit wins.
    mesh: Optional[tuple] = None


def _validate(desc: TerrainRefDesc) -> None:
    """Trust-boundary validation before any device work."""
    if desc.width <= 0 or desc.height <= 0 or desc.max_frames <= 0:
        raise RenderError("terrain reference requires non-zero width/height/max_frames")
    if desc.spp <= 0:
        raise RenderError("spp must be >= 1")
    hm = np.asarray(desc.heights)
    if hm.ndim != 2 or hm.shape[0] < 2 or hm.shape[1] < 2:
        raise UploadError("heightmap must be a 2D array of at least 2x2 texels")
    if not np.isfinite(hm).all():
        raise UploadError("terrain heightfield contains non-finite samples")
    if not (desc.spacing[0] > 0 and desc.spacing[1] > 0):
        raise RenderError("spacing must be positive")
    if not math.isfinite(desc.exaggeration) or desc.exaggeration <= 0:
        raise RenderError("exaggeration must be finite and > 0")
    if not (math.isfinite(desc.sun_azimuth_deg) and math.isfinite(desc.sun_elevation_deg)):
        raise RenderError("sun azimuth/elevation must be finite")
    for name, vec in (("cam_origin", desc.cam_origin),
                      ("cam_look_at", desc.cam_look_at),
                      ("cam_up", desc.cam_up)):
        if len(vec) != 3 or not all(math.isfinite(float(c)) for c in vec):
            raise RenderError(f"{name} must be a finite 3-vector")
    fwd = tuple(float(b) - float(a)
                for a, b in zip(desc.cam_origin, desc.cam_look_at))
    if sum(c * c for c in fwd) <= 1e-20:
        raise RenderError("camera origin and look_at coincide")
    if not (math.isfinite(desc.fov_y_deg) and 0.0 < desc.fov_y_deg < 180.0):
        raise RenderError("fov_y must be finite and in (0, 180)")
    if not (math.isfinite(desc.variance_threshold) and desc.variance_threshold > 0):
        raise RenderError("variance threshold must be finite and > 0")
    if desc.env_map is not None:
        em = np.asarray(desc.env_map)
        if em.ndim != 3 or em.shape[2] != 3:
            raise UploadError("env_map must have shape (H, W, 3)")
    for c in desc.sun_color:
        if not math.isfinite(c) or c < 0:
            raise RenderError("sun_color must be finite and non-negative")


def resolve_device(device) -> torch.device:
    """'cuda' needs a CUDA device; 'cpu' selects the plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError("device='cuda' requested but CUDA is not available; "
                              "pass device='cpu' to run the plain PyTorch versions")
    elif dev.type != "cpu":
        raise DeviceError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def device_for(x, device) -> torch.device:
    """Where a function that takes numpy or tensors runs: `device` when
    given, else a tensor's own device, else (numpy or array-like input) the
    card."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device("cuda" if device is None else device)


def _vec3(v) -> Tuple[float, float, float]:
    return tuple(f32(c) for c in v)


@dataclass(frozen=True)
class FrameContext:
    """Per-render constants (float32 values) plus the scene and env map.
    Shared by the kernels and the plain versions, so both see the same
    inputs."""

    width: int
    height: int
    spp: int
    seed_hi: int
    seed_lo: int
    shadows: bool
    restir: bool
    cam_o: Tuple[float, float, float]
    right: Tuple[float, float, float]
    up: Tuple[float, float, float]
    fwd: Tuple[float, float, float]
    half_w: float
    half_h: float
    sun: Tuple[float, float, float]
    alb: Tuple[float, float, float]   # float32(albedo)
    alc: Tuple[float, float, float]   # float32(albedo * sun radiance), rounded once
    lum_lc: float                     # luminance of float32(sun radiance)
    inv_spp: float
    lc: Tuple[float, float, float]    # float32(sun radiance)
    scene: TerrainScene
    env: EnvMap
    mesh: Optional["MeshTracerScene"] = None   # pt/mesh_render.py
    lights: Optional[tuple] = None             # (LightBuffer, AliasTable)

    def frame_args(self, frame_index: int, row0: int = 0,
                   rows: Optional[int] = None) -> _kernels.FrameArgs:
        """K6's constants for one frame on the band of rows row0 .. row0 +
        rows - 1 (the whole frame by default)."""
        rgb = self.env.rgb
        if rgb is not None:
            _kernels.require_cuda("env_map", rgb)
        eh, ew = (0, 0) if rgb is None else rgb.shape[:2]
        F3 = ctypes.c_float * 3
        return _kernels.FrameArgs(
            None if rgb is None else rgb.data_ptr(),
            self.width, self.height, self.spp, ew, eh, int(self.shadows),
            int(self.restir), int(frame_index) & MASK32, self.seed_hi, self.seed_lo,
            F3(*self.cam_o), F3(*self.right), F3(*self.up), F3(*self.fwd),
            self.half_w, self.half_h, F3(*self.sun), F3(*self.alb), F3(*self.alc),
            self.lum_lc, self.env.intensity, self.inv_spp, F3(*self.lc),
            int(row0), self.height if rows is None else int(rows),
        )

    def mesh_args(self) -> _kernels.MeshArgs:
        """The BVH as K6 and K8 read it; all zero without a mesh."""
        return _kernels.MeshArgs() if self.mesh is None else self.mesh.kernel_args()

    def light_args(self) -> _kernels.LightArgs:
        """The typed lights as K6 reads them; all zero without lights."""
        if self.lights is None:
            return _kernels.LightArgs()
        from ..ops.lightsample import light_args

        return light_args(*self.lights)


def make_context(desc: TerrainRefDesc, scene: TerrainScene, env: EnvMap) -> FrameContext:
    """The per-render constants of `desc`, with its mesh (SAH BVH built on
    the host) and typed lights (alias table by emitted power) on the
    scene's device."""
    W, H = desc.width, desc.height
    right, up, fwd = camera_basis(desc.cam_origin, desc.cam_look_at, desc.cam_up)
    half_h = math.tan(math.radians(desc.fov_y_deg) * 0.5)
    half_w = (W / H) * half_h
    lc = tuple(desc.sun_intensity * c for c in desc.sun_color)
    lc32 = [np.float32(c) for c in lc]
    lum_lc = np.float32(0.2126) * lc32[0] + np.float32(0.7152) * lc32[1] \
        + np.float32(0.0722) * lc32[2]
    return FrameContext(
        width=W, height=H, spp=int(desc.spp),
        seed_hi=int(desc.seed) & MASK32, seed_lo=derive_seed_lo(desc.seed),
        shadows=bool(desc.shadows_enabled), restir=bool(desc.restir),
        cam_o=_vec3(desc.cam_origin), right=_vec3(right), up=_vec3(up), fwd=_vec3(fwd),
        half_w=f32(half_w), half_h=f32(half_h),
        sun=_vec3(sun_direction(desc.sun_azimuth_deg, desc.sun_elevation_deg)),
        alb=_vec3(desc.albedo),
        alc=tuple(f32(a * c) for a, c in zip(desc.albedo, lc)),
        lum_lc=f32(lum_lc), inv_spp=f32(1.0 / desc.spp), lc=_vec3(lc),
        scene=scene, env=env, mesh=_mesh(desc, scene.device), lights=_lights(desc, scene.device),
    )


def _mesh(desc: TerrainRefDesc, device):
    if desc.mesh is None:
        return None
    from .mesh_render import MeshTracerScene

    return MeshTracerScene(desc.mesh[0], desc.mesh[1], device)


def _lights(desc: TerrainRefDesc, device):
    if not desc.lights:
        return None
    from ..lighting import LightBuffer
    from ..ops.lightsample import alias_table_build, light_power_weights

    buf = LightBuffer.from_lights(list(desc.lights), device)
    return buf, alias_table_build(light_power_weights(buf), device)


def camera_rays(ctx: FrameContext, jx, jy, row0: int = 0):
    """Primary ray directions for pixel jitters (jx, jy) of shape (rows, W):
    the rows row0 .. row0 + rows - 1 of the frame (all of it by default)."""
    W, H = ctx.width, ctx.height
    rows = jx.shape[0]
    dev = jx.device
    xs = torch.arange(W, dtype=_F32, device=dev).expand(rows, W)
    ys = torch.arange(row0, row0 + rows, dtype=_F32, device=dev)[:, None].expand(rows, W)
    ndc_x = fdiv(xs + 0.5 + jx, float(W)) * 2.0 - 1.0
    ndc_y = (1.0 - fdiv(ys + 0.5 + jy, float(H))) * 2.0 - 1.0
    cx = ndc_x * ctx.half_w
    cy = ndc_y * ctx.half_h
    inv = rsqrt(cx * cx + cy * cy + 1.0)
    cx, cy, mcz = cx * inv, cy * inv, inv  # mcz = -cz with cz = -1 * inv
    r, u, f = ctx.right, ctx.up, ctx.fwd
    dx = cx * r[0] + cy * u[0] + mcz * f[0]
    dy = cx * r[1] + cy * u[1] + mcz * f[1]
    dz = cx * r[2] + cy * u[2] + mcz * f[2]
    inv2 = rsqrt(dx * dx + dy * dy + dz * dz)
    return dx * inv2, dy * inv2, dz * inv2


def _origin(ctx: FrameContext, shape, dev):
    return tuple(torch.full(shape, c, dtype=_F32, device=dev) for c in ctx.cam_o)


def _nearest_t(ctx: FrameContext, o, d):
    """(any hit, nearer t with _MISS_T for a miss) of rays against the
    terrain and, with a mesh, its BVH (terrain_ref.py:_occl_any)."""
    th = trace_plain(ctx.scene, o, d)
    hit, t = th.hit, torch.where(th.hit, th.t, _MISS_T)
    if ctx.mesh is not None:
        mh = trace_mesh_plain(ctx.mesh.scene, ctx.mesh.n_nodes, o, d)
        hit, t = hit | mh.hit, torch.minimum(t, torch.where(mh.hit, mh.t, _MISS_T))
    return hit, t


def _occlusion(ctx: FrameContext, hitmask, oro, sun_dir, env_dir):
    """(sun occluded, env occluded) masks. Only the hit pixels' rays are
    traced (the others' results are never read), and the sun and env rays
    go through one batched trace: per-ray results do not depend on the
    batch."""
    sel = torch.nonzero(hitmask.reshape(-1)).squeeze(1)
    k = sel.numel()
    pick = lambda c: c.reshape(-1)[sel]  # noqa: E731
    o = [pick(c) for c in oro]
    if ctx.shadows:
        hits = _nearest_t(ctx, [torch.cat([c, c]) for c in o],
                          [torch.cat([pick(s), pick(e)]) for s, e in zip(sun_dir, env_dir)])[0]
    else:
        hits = torch.cat([torch.zeros(k, dtype=torch.bool, device=sel.device),
                          _nearest_t(ctx, o, [pick(e) for e in env_dir])[0]])
    occ = torch.zeros(2, hitmask.numel(), dtype=torch.bool, device=sel.device)
    occ[0, sel] = hits[:k]
    occ[1, sel] = hits[k:]
    return occ[0].reshape(hitmask.shape), occ[1].reshape(hitmask.shape)


def _light_occlusion(ctx: FrameContext, hitmask, oro, ldir, limit):
    """Whether each hit pixel's light ray is blocked before `limit` (the
    nearer of the terrain's and the mesh's t, terrain_ref.py:359-360)."""
    sel = torch.nonzero(hitmask.reshape(-1)).squeeze(1)
    pick = lambda c: c.reshape(-1)[sel]  # noqa: E731
    _, t = _nearest_t(ctx, [pick(c) for c in oro], [pick(c) for c in ldir])
    occ = torch.zeros(hitmask.numel(), dtype=torch.bool, device=sel.device)
    occ[sel] = t < pick(limit)
    return occ.reshape(hitmask.shape)


def _merge_mesh(ctx: FrameContext, o, d, th):
    """(t, hit, mesh_won, mesh normals) of rays whose terrain hit record is
    `th`: the nearer of the terrain and the mesh, the mesh's face normal
    turned against the ray (terrain_ref.py:_hyb_primary)."""
    mh = trace_mesh_plain(ctx.mesh.scene, ctx.mesh.n_nodes, o, d)
    mesh_won = mh.hit & (mh.t < torch.where(th.hit, th.t, _MISS_T))
    return (torch.where(mesh_won, mh.t, th.t), th.hit | mh.hit, mesh_won,
            ctx.mesh.hit_normals(mh.prim, *d))


def _hybrid_primary(ctx: FrameContext, o, d):
    """(t, hit, hit point, normal, mesh_won) of primary rays: the terrain
    alone (mesh_won None), or merged with the mesh."""
    th = trace_plain(ctx.scene, o, d)
    t, hitmask, mesh_won = th.t, th.hit, None
    if ctx.mesh is not None:
        t, hitmask, mesh_won, mn = _merge_mesh(ctx, o, d, th)
    p = tuple(o[k] + t * d[k] for k in range(3))
    n = normal_at(ctx.scene, p, th.cell_x, th.cell_z)
    if mesh_won is not None:
        n = tuple(torch.where(mesh_won, a, b) for a, b in zip(mn, n))
    return t, hitmask, p, n, mesh_won


def _sample_radiance(ctx: FrameContext, st, pdir, pw, prev_ok, row0: int = 0):
    """One jittered camera sample per pixel of the band starting at row
    row0; returns (st, rgb, cand_pdf)."""
    sun = ctx.sun
    st, u1 = xorshift32(st)
    st, u2 = xorshift32(st)
    jx = tent_offset(u1) * 0.5
    jy = tent_offset(u2) * 0.5
    dx, dy, dz = camera_rays(ctx, jx, jy, row0)
    o = _origin(ctx, dx.shape, dx.device)
    t, hitmask, (hx, hy, hz), (nx, ny, nz), mesh_won = _hybrid_primary(ctx, o, (dx, dy, dz))
    if mesh_won is None:
        alb, alc = ctx.alb, ctx.alc
    else:
        # float32 per pixel: mesh hits keep the constant albedo, and the
        # product with the sun radiance is a float32 product (with no mesh
        # it is rounded once on the host)
        alb = [torch.where(mesh_won, f32(m), a) for m, a in zip(_MESH_ALBEDO, ctx.alb)]
        alc = [a * c for a, c in zip(alb, ctx.lc)]

    mr, mg, mb = env_radiance(ctx.env, dx, dy, dz)

    ndotl = torch.clamp(nx * sun[0] + ny * sun[1] + nz * sun[2], min=0.0)
    tpdf = luminance(alc[0] * ndotl, alc[1] * ndotl, alc[2] * ndotl)
    cand_pdf = torch.where(hitmask, tpdf, 0.0)

    sdx = torch.where(prev_ok, pdir[0], sun[0])
    sdy = torch.where(prev_ok, pdir[1], sun[1])
    sdz = torch.where(prev_ok, pdir[2], sun[2])
    rw = torch.where(prev_ok, torch.clamp(pw, 0.0, 4.0), 1.0)
    nd = torch.clamp(nx * sdx + ny * sdy + nz * sdz, min=0.0)

    st2, u3 = xorshift32(st)
    st2, u4 = xorshift32(st2)
    st = torch.where(hitmask, st2, st)  # misses do not draw u3/u4
    ex, ey, ez = cosine_dir(nx, ny, nz, u3, u4)

    oro = (hx + nx * 1e-3, hy + ny * 1e-3, hz + nz * 1e-3)
    occ, eocc = _occlusion(ctx, hitmask, oro, (sdx, sdy, sdz), (ex, ey, ez))
    vis = torch.where(occ, 0.0, 1.0)  # all ones without shadows
    lit = nd * vis * rw
    er, eg, eb = env_radiance(ctx.env, ex, ey, ez)
    evis = torch.where(eocc, 0.0, 1.0)
    lrgb = (0.0, 0.0, 0.0)
    if ctx.lights is not None:
        # every lane draws its three words, misses included
        st, u5 = xorshift32(st)
        st, u6 = xorshift32(st)
        st, u7 = xorshift32(st)
        ldx, ldy, ldz, ldist, wr, wg, wb = sample_light_nee_plain(
            *ctx.lights, hx, hy, hz, nx, ny, nz, u5, u6, u7)
        locc = _light_occlusion(ctx, hitmask, oro, (ldx, ldy, ldz), ldist * 0.999)
        lvis = torch.where(locc, 0.0, 1.0)
        lrgb = tuple(a * w * lvis for a, w in zip(alb, (wr, wg, wb)))
    r = torch.where(hitmask, alc[0] * lit + alb[0] * er * evis + lrgb[0], mr)
    g = torch.where(hitmask, alc[1] * lit + alb[1] * eg * evis + lrgb[1], mg)
    b = torch.where(hitmask, alc[2] * lit + alb[2] * eb * evis + lrgb[2], mb)
    return st, (r, g, b), cand_pdf


def frame_step_plain(ctx: FrameContext, accum, welford, res_prev: rst.Reservoirs,
                     frame_index: int, row0: int = 0):
    """Plain PyTorch version of K6. accum: (H, W, 4); welford: (H, W, 2);
    res_prev: the reservoirs after the previous frame's spatial reuse.
    Returns (accum, welford, merged) where merged is the M-clamped history
    temporally merged with this frame's candidates. On a band of rows
    (row0 .. row0 + accum.shape[0] - 1) every argument and result is the
    band's (H = its rows)."""
    W, H = ctx.width, accum.shape[0]
    dev = accum.device
    xs = torch.arange(W, device=dev).expand(H, W)
    ys = torch.arange(row0, row0 + H, device=dev)[:, None].expand(H, W)
    st = seed_state(ctx.seed_hi, ctx.seed_lo, xs, ys, 0) ^ (
        (int(frame_index) * 92837111) & MASK32)

    res_prev = rst.m_clamp(res_prev)
    pv = ((res_prev.m > 0) & (res_prev.weight > 0.0) & (res_prev.target_pdf > 0.0)
          & (res_prev.light_type == 1))
    if not (ctx.restir and frame_index > 0):
        pv = torch.zeros_like(pv)
    prev_ok = pv.reshape(H, W)
    pd = [c.reshape(H, W) for c in (res_prev.dir_x, res_prev.dir_y, res_prev.dir_z)]
    pinv = rsqrt(pd[0] * pd[0] + pd[1] * pd[1] + pd[2] * pd[2] + 1e-30)
    pdir = (pd[0] * pinv, pd[1] * pinv, pd[2] * pinv)
    pw = res_prev.weight.reshape(H, W)

    z = torch.zeros((H, W), dtype=_F32, device=dev)
    fr, fg, fb, c_wsum, c_pdf = z, z, z, z, z
    c_m = torch.zeros((H, W), dtype=torch.int32, device=dev)
    for _ in range(ctx.spp):
        st, (r, g, b), cand_pdf = _sample_radiance(ctx, st, pdir, pw, prev_ok, row0)
        good = cand_pdf > 0.0
        c_wsum = c_wsum + torch.where(good, cand_pdf, 0.0)
        c_m = c_m + good.to(torch.int32)
        c_pdf = torch.where(good, cand_pdf, c_pdf)
        fr, fg, fb = fr + r, fg + g, fb + b
    fr, fg, fb = fr * ctx.inv_spp, fg * ctx.inv_spp, fb * ctx.inv_spp

    # fresh candidate reservoir, merged with the history
    fin = (c_m > 0) & (c_wsum > 0.0) & (c_pdf > 0.0)
    c_weight = torch.where(
        fin, c_wsum / (c_m.to(_F32) * torch.clamp(c_pdf, min=1e-30)), 0.0)
    anyc = c_m > 0
    anyf = anyc.to(_F32)
    curr = rst.Reservoirs(
        dir_x=(ctx.sun[0] * anyf).reshape(-1),
        dir_y=(ctx.sun[1] * anyf).reshape(-1),
        dir_z=(ctx.sun[2] * anyf).reshape(-1),
        intensity=torch.where(anyc, ctx.lum_lc, 0.0).reshape(-1),
        light_type=anyc.to(torch.int32).reshape(-1),
        light_index=torch.zeros(H * W, dtype=torch.int32, device=dev),
        w_sum=c_wsum.reshape(-1),
        m=c_m.reshape(-1),
        weight=c_weight.reshape(-1),
        target_pdf=c_pdf.reshape(-1),
    )
    merged = rst.temporal_merge(res_prev, curr)

    acc = accum + torch.stack([fr, fg, fb, torch.ones_like(fr)], dim=-1)

    # windowed Welford over the running-mean luminance
    in_window = int(frame_index) % WELFORD_WINDOW
    wf = torch.zeros_like(welford) if in_window == 0 else welford
    mean_lum = luminance(acc[..., 0], acc[..., 1], acc[..., 2]) / acc[..., 3]
    delta = mean_lum - wf[..., 0]
    mean = wf[..., 0] + fdiv(delta, float(in_window) + 1.0)
    m2 = wf[..., 1] + delta * (mean_lum - mean)
    return acc, torch.stack([mean, m2], dim=-1), merged


def _frame_step_kernel(ctx: FrameContext, accum, welford, res_prev: rst.Reservoirs,
                       frame_index: int, row0: int = 0, counter=None):
    H, W = accum.shape[0], ctx.width
    if not 0 <= row0 <= row0 + H <= ctx.height:
        raise ValueError(f"frame_step: rows {row0} .. {row0 + H - 1} outside the frame's "
                         f"{ctx.height}")
    if tuple(accum.shape) != (H, W, 4) or tuple(welford.shape) != (H, W, 2):
        raise ValueError(f"frame_step: accum must be (H, W, 4) and welford (H, W, 2) "
                         f"for H, W = {H}, {W}")
    if res_prev.m.numel() != H * W:
        raise ValueError("frame_step: reservoirs must hold H*W pixels")
    _kernels.require_cuda("frame_step", accum, welford)
    dev = accum.device
    acc_out = torch.empty_like(accum)
    wf_out = torch.empty_like(welford)
    merged = rst.Reservoirs.empty(H * W, dev)
    err = _kernels.lib().f3d_frame_step(
        ctx.scene.kernel_args(), ctx.frame_args(frame_index, row0, H), ctx.mesh_args(),
        ctx.light_args(), _kernels.ptr(accum), _kernels.ptr(welford), res_prev.kernel_args(),
        _kernels.ptr(acc_out), _kernels.ptr(wf_out), merged.kernel_args(),
        _kernels.stream_ptr(dev))
    _kernels.check(err, "K6 frame_step")
    counter = frame_step if counter is None else counter
    counter.launches += 1
    if counter is frame_step:
        frame_step.mesh_launches += ctx.mesh is not None
        frame_step.light_launches += ctx.lights is not None
    return acc_out, wf_out, merged


def frame_step(ctx: FrameContext, accum, welford, res_prev: rst.Reservoirs,
               frame_index: int):
    """One accumulation frame (kernel K6). CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    if accum.device.type == "cpu":
        return frame_step_plain(ctx, accum, welford, res_prev, frame_index)
    return _frame_step_kernel(ctx, accum, welford, res_prev, frame_index)


frame_step.launches = 0
# the launches that walked a mesh BVH (K9's body) and sampled typed lights
# (K10's body)
frame_step.mesh_launches = 0
frame_step.light_launches = 0


def frame_step_band(ctx: FrameContext, accum, welford, res_prev: rst.Reservoirs,
                    frame_index: int, row0: int):
    """One accumulation frame on the band of rows row0 .. row0 +
    accum.shape[0] - 1 (K6 band, a rank's rows of a sharded render): the
    band's accum, welford and reservoirs in, the band's out; each pixel's
    seeds and camera ray are those of its place in the frame, so the bands
    of a frame together equal frame_step's frame bit for bit. CPU tensors
    run the plain version; CUDA tensors launch the kernel."""
    if accum.device.type == "cpu":
        return frame_step_plain(ctx, accum, welford, res_prev, frame_index, row0)
    return _frame_step_kernel(ctx, accum, welford, res_prev, frame_index, row0,
                              counter=frame_step_band)


frame_step_band.launches = 0


def _center_rays(ctx: FrameContext):
    z = torch.zeros((ctx.height, ctx.width), dtype=_F32, device=ctx.scene.device)
    d = camera_rays(ctx, z, z)
    return _origin(ctx, z.shape, z.device), d


def gbuffer_resolve_plain(ctx: FrameContext, d, th):
    """Plain PyTorch version of K8: AOVs and ReSTIR receiver normals from
    the center rays' hit record; with a mesh, the center rays are traced
    through its BVH too and the nearer hit wins."""
    H, W = ctx.height, ctx.width
    dev = d[0].device
    hitmask = th.hit
    t = th.t
    o = ctx.cam_o
    hx, hy, hz = o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]
    nx, ny, nz = normal_at(ctx.scene, (hx, hy, hz), th.cell_x, th.cell_z)
    alb = torch.tensor(ctx.alb, dtype=_F32, device=dev).expand(H, W, 3)
    if ctx.mesh is not None:
        t, hitmask, mesh_won, mn = _merge_mesh(ctx, _origin(ctx, t.shape, dev), d, th)
        nx, ny, nz = (torch.where(mesh_won, a, b) for a, b in zip(mn, (nx, ny, nz)))
        alb = torch.where(mesh_won[..., None],
                          torch.tensor(_MESH_ALBEDO, dtype=_F32, device=dev), alb)
    nx = torch.where(hitmask, nx, 0.0)
    ny = torch.where(hitmask, ny, 0.0)
    nz = torch.where(hitmask, nz, 1.0)  # sky record kept finite
    zero3 = torch.zeros(3, dtype=_F32, device=dev)
    return {
        "albedo": torch.where(hitmask[..., None], alb, zero3),
        "normal": torch.where(hitmask[..., None], torch.stack([nx, ny, nz], dim=-1), zero3),
        "depth": torch.where(hitmask, t, float("nan")),
        "visibility": torch.where(hitmask, 1.0, 0.0),
        "gb_n": (nx.reshape(-1), ny.reshape(-1), nz.reshape(-1)),
    }


def _gbuffer_resolve_kernel(ctx: FrameContext, d, th):
    H, W = ctx.height, ctx.width
    n = H * W
    d = [c.contiguous() for c in d]
    th_c = [th.hit.contiguous(), th.t.contiguous(), th.cell_x.contiguous(),
            th.cell_z.contiguous()]
    _kernels.require_cuda("center_gbuffer", *d, *th_c)
    dev = d[0].device
    albedo = torch.empty((H, W, 3), dtype=_F32, device=dev)
    normal = torch.empty((H, W, 3), dtype=_F32, device=dev)
    depth = torch.empty((H, W), dtype=_F32, device=dev)
    vis = torch.empty((H, W), dtype=_F32, device=dev)
    gb = [torch.empty(n, dtype=_F32, device=dev) for _ in range(3)]
    F3 = ctypes.c_float * 3
    err = _kernels.lib().f3d_center_gbuffer(
        ctx.scene.kernel_args(), ctx.mesh_args(), n, F3(*ctx.cam_o), F3(*ctx.alb),
        *(_kernels.ptr(c) for c in d), *(_kernels.ptr(c) for c in th_c),
        _kernels.ptr(albedo), _kernels.ptr(normal), _kernels.ptr(depth), _kernels.ptr(vis),
        *(_kernels.ptr(c) for c in gb), _kernels.stream_ptr(dev))
    _kernels.check(err, "K8 center_gbuffer")
    center_gbuffer.launches += 1
    return {"albedo": albedo, "normal": normal, "depth": depth, "visibility": vis,
            "gb_n": tuple(gb)}


def center_gbuffer_plain(ctx: FrameContext):
    """Plain PyTorch version of the center G-buffer (plain trace + plain
    resolve)."""
    o, d = _center_rays(ctx)
    return gbuffer_resolve_plain(ctx, d, trace_plain(ctx.scene, o, d))


def center_gbuffer(ctx: FrameContext):
    """Unjittered center-ray hit record: AOVs + ReSTIR receiver normals.
    The rays go through K5 (`trace`); on CUDA the resolve is kernel K8."""
    o, d = _center_rays(ctx)
    th = trace(ctx.scene, o, d)
    if d[0].device.type == "cpu":
        return gbuffer_resolve_plain(ctx, d, th)
    return _gbuffer_resolve_kernel(ctx, d, th)


center_gbuffer.launches = 0


def _contract(name: str, arr: np.ndarray, lo: float, hi: float) -> None:
    finite = arr[np.isfinite(arr)]
    if finite.size == 0:
        return
    amin, amax = float(finite.min()), float(finite.max())
    if amin < lo or amax > hi:
        raise ContractViolation(
            f"runtime contract violated: {name} range [{amin:.6g}, {amax:.6g}] "
            f"outside [{lo:.6g}, {hi:.6g}]"
        )


def render_terrain_reference(desc: TerrainRefDesc, *, device="cuda") -> dict:
    """Render the converged terrain reference; raises ConvergenceError
    rather than returning a non-converged image."""
    if desc.traversal == "sweep":
        # the sweep estimator (pt/terrain_sweep.py): the same converged
        # integral as restir=False per-ray NEE
        if desc.lights:
            raise RenderError(
                "traversal='sweep' integrates sun+env only; typed lights "
                "need traversal='dda'/'mxu' (alias-table NEE)")
        if desc.mesh is not None:
            raise RenderError(
                "traversal='sweep' cannot trace mesh geometry; use "
                "traversal='dda'/'mxu' for hybrid terrain+mesh scenes")
        from .terrain_sweep import render_terrain_sweep

        return render_terrain_sweep(desc, device=device)
    _validate(desc)
    if desc.traversal not in ("dda", "mxu"):
        raise ValueError(f"unknown traversal {desc.traversal!r}")
    dev = resolve_device(device)
    tracker = global_tracker()
    W, H = desc.width, desc.height
    n_pix = W * H

    pyr = build_pyramid(np.asarray(desc.heights, np.float32))
    scene = scene_from_pyramid(pyr, origin_xz=(0.0, 0.0), spacing_xz=desc.spacing,
                               exaggeration=desc.exaggeration, device=dev)
    env = env_map(desc.env_map, desc.env_intensity, dev)

    # Resource ledger, charged as the JAX package charges it.
    pyramid_bytes = pyr.nbytes
    accum_bytes = n_pix * 16
    welford_bytes = n_pix * 8
    reservoir_bytes = 3 * n_pix * 40
    env_bytes = 0 if desc.env_map is None else int(np.asarray(desc.env_map).nbytes)
    ctx = make_context(desc, scene, env)
    mesh_bytes = 0 if ctx.mesh is None else int(ctx.mesh.bvh.nbytes)
    rids = [
        tracker.track("terrain-pt.pyramid", pyramid_bytes, "pyramid"),
        tracker.track("terrain-pt.accum", accum_bytes, "buffer"),
        tracker.track("terrain-pt.welford", welford_bytes, "buffer"),
        tracker.track("terrain-pt.reservoirs", reservoir_bytes, "buffer"),
        tracker.track("terrain-pt.env", env_bytes, "texture"),
    ]
    if mesh_bytes:
        rids.append(tracker.track("terrain-pt.mesh-bvh", mesh_bytes, "buffer"))
    if ctx.lights is not None:   # K6's packed light table (not in the JAX package's sum)
        from ..ops.lightsample import LIGHT_WORDS

        rids.append(tracker.track("terrain-pt.lights", ctx.lights[1].count * LIGHT_WORDS * 4,
                                  "buffer"))
    gpu_resource_bytes = (pyramid_bytes + accum_bytes + welford_bytes
                          + reservoir_bytes + env_bytes + mesh_bytes)

    try:
        gbuf = center_gbuffer(ctx)
        gb_n = gbuf["gb_n"]

        accum = torch.zeros((H, W, 4), dtype=_F32, device=dev)
        welford = torch.zeros((H, W, 2), dtype=_F32, device=dev)
        res_prev = rst.Reservoirs.zeros(n_pix, dev)

        frames = 0
        variance = float("inf")
        converged = False
        while frames < desc.max_frames:
            accum, welford, merged = frame_step(ctx, accum, welford, res_prev, frames)
            res_prev = rst.spatial_reuse(merged, gb_n[0], gb_n[1], gb_n[2], W, H,
                                         frames, ctx.seed_hi)
            frames += 1

            window_full = frames % WELFORD_WINDOW == 0
            if window_full or frames == desc.max_frames:
                n_window = ((frames - 1) % WELFORD_WINDOW) + 1
                if n_window >= 2:
                    m2max = float(welford[..., 1].max())
                    if not math.isfinite(m2max):
                        raise RenderError(
                            "terrain PT produced non-finite variance (NaN in accumulation)")
                    variance = m2max / (n_window - 1)
                    if frames >= desc.min_frames and variance < desc.variance_threshold:
                        converged = True
                        break

        if not converged:
            raise ConvergenceError(
                f"terrain PT did not converge: per-pixel luminance variance "
                f"{variance:.3e} over the last {WELFORD_WINDOW}-frame window after "
                f"{frames} frames (threshold {desc.variance_threshold:.1e}); raise "
                f"max_frames or simplify the scene — refusing to return a fake "
                f"reference",
                frames=frames,
                variance=variance,
            )

        # resolve running mean -> Reinhard -> f16 round trip -> u8
        mean = accum[..., :3] / accum[..., 3:4]
        ldr = tm.f16_round(tm.reinhard(mean, desc.exposure))
        rgba = tm.to_u8(ldr).cpu().numpy().astype(np.uint8)
        rgba = np.concatenate([rgba, np.full((H, W, 1), 255, np.uint8)], axis=-1)

        accum_np = accum.cpu().numpy()
        welford_np = welford.cpu().numpy()
        ldr_np = ldr.cpu().numpy()

        _contract("accum.samples", accum_np[..., 3], 0.0, 131026.0)
        _contract("out_tex.samples", ldr_np, 0.0, 1.0)
        if not np.isfinite(welford_np).all():
            raise ContractViolation("terrain_welford contains non-finite values")

        return {
            "rgba": rgba,
            "albedo": gbuf["albedo"].cpu().numpy().astype(np.float32),
            "normal": gbuf["normal"].cpu().numpy().astype(np.float32),
            "depth": gbuf["depth"].cpu().numpy().astype(np.float32),
            "frames": frames,
            "variance": variance,
            "converged": True,
            "peak_host_visible_bytes": int(tracker.metrics()["peak_tracked_bytes"]),
            "minmax_pyramid_bytes": int(pyramid_bytes),
            "gpu_resource_bytes": int(gpu_resource_bytes),
            "hdr": mean.cpu().numpy().astype(np.float32),
        }
    finally:
        for rid in rids:
            tracker.free(rid)


def hybrid_render_terrain_reference(
    heightmap,
    width: int,
    height: int,
    cam: dict,
    spacing=(1.0, 1.0),
    exaggeration: float = 1.0,
    albedo=(0.6, 0.6, 0.6),
    sun_azimuth_deg: float = 315.0,
    sun_elevation_deg: float = 45.0,
    sun_intensity: float = 2.5,
    env_map=None,
    env_intensity: float = 0.35,
    mesh_vertices=None,
    mesh_indices=None,
    spp: int = 1,
    max_frames: int = 512,
    min_frames: int = 32,
    variance_threshold: float = 1e-3,
    seed: int = 7,
    certificate=None,
    sun_color=None,
    cache=None,
    traversal: str = "dda",
    *,
    device="cuda",
) -> dict:
    """Public entry: the signature, defaults and output dict of
    forge3d_tpu's hybrid_render_terrain_reference, plus the keyword
    `device` ("cuda" runs the kernels, "cpu" the plain versions). A scene
    with a mesh falls back from traversal="sweep" to the per-ray engine, as
    in the JAX package."""
    if (mesh_vertices is None) != (mesh_indices is None):
        raise ValueError("mesh_vertices and mesh_indices must be provided together")
    mesh = None
    if mesh_vertices is not None:
        mv = np.asarray(mesh_vertices, np.float32)
        mi = np.asarray(mesh_indices)
        if mv.ndim != 2 or mv.shape[1] != 3 or mv.shape[0] == 0:
            raise ValueError("mesh_vertices must have shape (N, 3)")
        if mi.ndim != 2 or mi.shape[1] != 3 or mi.shape[0] == 0:
            raise ValueError("mesh_indices must have shape (M, 3)")
        if not np.isfinite(mv).all():
            raise ValueError("mesh vertices contain non-finite values")
        if mi.min() < 0 or int(mi.max()) >= mv.shape[0]:
            raise ValueError("mesh indices reference out-of-bounds vertices")
        mesh = (mv, mi.astype(np.uint32))
        if traversal == "sweep":
            traversal = "dda"
    if sun_color is None:
        sun_color = (1.0, 0.97, 0.92)
    else:
        sc = [float(c) for c in sun_color]
        if len(sc) != 3 or any((not math.isfinite(c)) or c < 0 for c in sc):
            raise ValueError("sun_color must be exactly three finite, non-negative numbers")
        sun_color = tuple(sc)

    desc = TerrainRefDesc(
        heights=np.asarray(heightmap, np.float32),
        spacing=(float(spacing[0]), float(spacing[1])),
        exaggeration=float(exaggeration),
        albedo=tuple(float(a) for a in albedo),
        cam_origin=tuple(float(v) for v in cam.get("origin", (0.0, 50.0, 120.0))),
        cam_look_at=tuple(float(v) for v in cam.get("look_at", (0.0, 0.0, 0.0))),
        cam_up=tuple(float(v) for v in cam.get("up", (0.0, 1.0, 0.0))),
        fov_y_deg=float(cam.get("fov_y", 45.0)),
        exposure=float(cam.get("exposure", 1.0)),
        sun_azimuth_deg=float(sun_azimuth_deg),
        sun_elevation_deg=float(sun_elevation_deg),
        sun_intensity=float(sun_intensity),
        sun_color=sun_color,
        env_map=None if env_map is None else np.asarray(env_map, np.float32),
        env_intensity=float(env_intensity),
        width=int(width),
        height=int(height),
        seed=int(seed) & MASK32,
        spp=int(spp),
        max_frames=int(max_frames),
        min_frames=int(min_frames),
        variance_threshold=float(variance_threshold),
        traversal=str(traversal),
        mesh=mesh,
    )
    out = render_terrain_reference(desc, device=device)
    if certificate is not None:
        from ..assurance.certificate import emit_certificate

        emit_certificate(certificate, "hybrid_render_terrain_reference", out)
    return out


def hybrid_render_terrain_sequence(heightmap, width: int, height: int, cam: dict, seeds,
                                   *, device="cuda", **kwargs) -> "list[dict]":
    """One converged sweep render per seed over a fixed scene (the JAX
    package's hybrid_render_terrain_sequence), rendered in order; each
    output dict is bit-identical to the single call with that seed.
    Accepts the same keyword arguments as the JAX function, plus `device`."""
    kwargs.pop("traversal", None)
    sun_color = kwargs.pop("sun_color", None) or (1.0, 0.97, 0.92)
    spacing = kwargs.pop("spacing", (1.0, 1.0))
    desc = TerrainRefDesc(
        heights=np.asarray(heightmap, np.float32),
        spacing=(float(spacing[0]), float(spacing[1])),
        exaggeration=float(kwargs.pop("exaggeration", 1.0)),
        albedo=tuple(float(a) for a in kwargs.pop("albedo", (0.6, 0.6, 0.6))),
        cam_origin=tuple(float(v) for v in cam.get("origin", (0.0, 50.0, 120.0))),
        cam_look_at=tuple(float(v) for v in cam.get("look_at", (0.0, 0.0, 0.0))),
        cam_up=tuple(float(v) for v in cam.get("up", (0.0, 1.0, 0.0))),
        fov_y_deg=float(cam.get("fov_y", 45.0)),
        exposure=float(cam.get("exposure", 1.0)),
        sun_azimuth_deg=float(kwargs.pop("sun_azimuth_deg", 315.0)),
        sun_elevation_deg=float(kwargs.pop("sun_elevation_deg", 45.0)),
        sun_intensity=float(kwargs.pop("sun_intensity", 2.5)),
        sun_color=tuple(float(c) for c in sun_color),
        env_map=None,
        env_intensity=float(kwargs.pop("env_intensity", 0.35)),
        width=int(width),
        height=int(height),
        seed=int(seeds[0]) & MASK32 if len(seeds) else 7,
        spp=int(kwargs.pop("spp", 1)),
        traversal="sweep",
    )
    if kwargs:
        raise TypeError(f"unsupported sequence kwargs: {sorted(kwargs)}")
    from .terrain_sweep import render_terrain_sweep_sequence

    return render_terrain_sweep_sequence(desc, list(seeds), device=device)
