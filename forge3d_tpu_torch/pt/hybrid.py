# forge3d_tpu_torch/pt/hybrid.py
# Kernel P3: the hybrid tracer of forge3d_tpu/pt/hybrid.py. A scene is any
# subset of {terrain heightfield, triangle mesh, SDF}; `hybrid_render`
# traces each pixel's camera ray against every enabled kind (the mode picks
# them), keeps the nearest hit (a strict `<` in the order terrain, mesh,
# SDF, so the terrain wins a tie), shades it with the sun (a union shadow
# ray through every enabled kind from p + n * 1e-3) and the sky ambient,
# and writes u8 rgba and the depth, normal, visibility, kind and albedo
# AOVs. And the AEQUITAS adjudication pair over a terrain:
# `render_adjudication_pair` renders it through the per-ray path tracer
# and the TerrainRenderer and compares the two.
#
# On the card `hybrid_render` is one launch of csrc/pt.cu:hybrid_kernel
# (counted in `hybrid_pixels.launches`), over K5's trace, normal_at, K9's
# walk and P6's march and normal; on the CPU it runs `_trace_all` and
# `_occluded_all` (the plain versions of those kernels) and the shading in
# PyTorch. The camera rays are PyTorch glue on either device: JAX builds
# them eagerly, each operation rounded, and its jitted norm reduces as
# x*x + two multiply-adds.

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _kernels
from ..camera import camera_basis
from ..ops.shading import fdiv, fma32, sqrt32, sun_direction

_F32 = torch.float32

TRAVERSAL_MODES = ("hybrid", "sdf_only", "mesh_only", "terrain_only")


class HybridScene(NamedTuple):
    terrain_scene: Optional[object]
    terrain_static: Optional[object]
    mesh_scene: Optional[object]
    mesh_nodes: int
    mesh_normals: Optional[torch.Tensor]
    sdf_scene: Optional[object]


def build_hybrid_scene(*, heightmap: Optional[np.ndarray] = None, terrain_spacing=(1.0, 1.0),
                       terrain_exaggeration: float = 1.0, mesh_vertices=None, mesh_indices=None,
                       sdf_scene=None, device="cuda") -> HybridScene:
    """Assemble any subset of {terrain, mesh, sdf} into one scene on
    `device` (the card unless device="cpu"): the host pyramid and BVH
    builds, the face normals from the BVH's edges (float32 numpy, as JAX).
    `terrain_static` holds the terrain scene too (the port's TerrainScene
    carries both halves of JAX's pair)."""
    from .terrain_ref import resolve_device

    device = resolve_device(device)
    tscene = None
    if heightmap is not None:
        from ..ops.pyramid import build_pyramid
        from ..ops.traversal import scene_from_pyramid

        pyr = build_pyramid(np.asarray(heightmap, np.float32))
        tscene = scene_from_pyramid(pyr, spacing_xz=terrain_spacing,
                                    exaggeration=terrain_exaggeration, device=device)
    mscene = None
    nnodes = 0
    mnormals = None
    if mesh_vertices is not None:
        from ..ops.bvh import build_sah_bvh, mesh_scene

        bvh = build_sah_bvh(np.asarray(mesh_vertices, np.float32),
                            np.asarray(mesh_indices, np.uint32))
        mscene, nnodes = mesh_scene(bvh, device=device)
        fn = np.cross(bvh.tri_e1, bvh.tri_e2)
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
        mnormals = torch.as_tensor(np.ascontiguousarray(fn, np.float32), device=device)
    if sdf_scene is not None and sdf_scene.device != device:
        sdf_scene = sdf_scene.to(device)
    return HybridScene(terrain_scene=tscene, terrain_static=tscene, mesh_scene=mscene,
                       mesh_nodes=nnodes, mesh_normals=mnormals, sdf_scene=sdf_scene)


def _uses(hs: HybridScene, mode: str):
    return (hs.terrain_scene is not None and mode in ("hybrid", "terrain_only"),
            hs.mesh_scene is not None and mode in ("hybrid", "mesh_only"),
            hs.sdf_scene is not None and mode in ("hybrid", "sdf_only"))


def _trace_all(hs: HybridScene, mode: str, ro3, rd3, tmin, tmax):
    """Nearest hit across enabled kinds (plain versions, flat or shaped
    float32 tensors). Returns (hit, t, nx, ny, nz, kind) with kind
    0=terrain 1=mesh 2=sdf."""
    from ..ops.bvh import trace_mesh_plain
    from ..ops.sdf import sdf_march_plain, sdf_normal_plain
    from ..ops.traversal import normal_at, trace_plain

    rox, roy, roz = ro3
    rdx, rdy, rdz = rd3
    shape = torch.broadcast_shapes(rox.shape, rdx.shape)
    dev = rdx.device
    tmx = float(np.float32(tmax))
    best_t = torch.full(shape, tmx, dtype=_F32, device=dev)
    hit = torch.zeros(shape, dtype=torch.bool, device=dev)
    nx = torch.zeros(shape, dtype=_F32, device=dev)
    ny = torch.ones(shape, dtype=_F32, device=dev)
    nz = torch.zeros(shape, dtype=_F32, device=dev)
    kind = torch.full(shape, -1, dtype=torch.int32, device=dev)
    use_terrain, use_mesh, use_sdf = _uses(hs, mode)

    if use_terrain:
        r = trace_plain(hs.terrain_scene, ro3, rd3, tmin=tmin, tmax=tmax)
        closer = r.hit & (r.t < best_t)
        p = (rox + r.t * rdx, roy + r.t * rdy, roz + r.t * rdz)
        tn = normal_at(hs.terrain_scene, p, r.cell_x, r.cell_z)
        best_t = torch.where(closer, r.t, best_t)
        hit = hit | closer
        nx, ny, nz = (torch.where(closer, a, b) for a, b in zip(tn, (nx, ny, nz)))
        kind = torch.where(closer, 0, kind)
    if use_mesh:
        r = trace_mesh_plain(hs.mesh_scene, hs.mesh_nodes, (rox, roy, roz), (rdx, rdy, rdz),
                             tmin=tmin, tmax=tmax)
        closer = r.hit & (r.t < best_t)
        pid = torch.clamp(r.prim, min=0).to(torch.int64)
        mn = [hs.mesh_normals[:, c][pid] for c in range(3)]
        flip = (mn[0] * rdx + mn[1] * rdy + mn[2] * rdz) > 0
        mn = [torch.where(flip, -c, c) for c in mn]
        best_t = torch.where(closer, r.t, best_t)
        hit = hit | closer
        nx, ny, nz = (torch.where(closer, a, b) for a, b in zip(mn, (nx, ny, nz)))
        kind = torch.where(closer, 1, kind)
    if use_sdf:
        flat = [c.expand(shape).reshape(-1).contiguous() for c in (*ro3, *rd3)]
        sh = sdf_march_plain(hs.sdf_scene, flat[:3], flat[3:], tmin=tmin, tmax=1e6)
        shit, st = sh.hit.reshape(shape), sh.t.reshape(shape)
        closer = shit & (st < best_t)
        p = [(o + st * d).reshape(-1) for o, d in zip(ro3, rd3)]
        sn = [c.reshape(shape) for c in sdf_normal_plain(hs.sdf_scene, *p)]
        best_t = torch.where(closer, st, best_t)
        hit = hit | closer
        nx, ny, nz = (torch.where(closer, a, b) for a, b in zip(sn, (nx, ny, nz)))
        kind = torch.where(closer, 2, kind)
    return hit, best_t, nx, ny, nz, kind


def _occluded_all(hs: HybridScene, mode: str, ro3, rd3, max_dist):
    h, t, *_ = _trace_all(hs, mode, ro3, rd3, 1e-3, max_dist)
    return h


def camera_rays(width: int, height: int, cam: dict, device):
    """hybrid_render's rays: (origin (3,) float32, (rdx, rdy, rdz) (H, W))."""
    origin = np.asarray(cam.get("origin", (0.0, 10.0, 30.0)), np.float32)
    look_at = np.asarray(cam.get("look_at", (0.0, 0.0, 0.0)), np.float32)
    fov_y = math.radians(float(cam.get("fov_y", 45.0)))
    right, upv, fwd = camera_basis(origin, look_at,
                                   np.asarray(cam.get("up", (0, 1, 0)), np.float32))
    H, W = height, width
    xs = torch.arange(W, dtype=_F32, device=device).expand(H, W)
    ys = torch.arange(H, dtype=_F32, device=device)[:, None].expand(H, W)
    ndc_x = fdiv(2.0 * (xs + 0.5), float(W)) - 1.0
    ndc_y = 1.0 - fdiv(2.0 * (ys + 0.5), float(H))
    tan_half = float(np.float32(math.tan(fov_y / 2)))
    a = ndc_x * float(np.float32(W / H)) * tan_half
    b = ndc_y * tan_half
    d = [float(fwd[k]) + a * float(right[k]) + b * float(upv[k]) for k in range(3)]
    norm = sqrt32(fma32(d[2], d[2], fma32(d[1], d[1], d[0] * d[0])))
    return origin, tuple(c / norm for c in d)


def _shade_plain(hs, mode, origin, rd3, sun, albedo, env_intensity, exposure):
    """hybrid_render's trace, shadow ray and shading (plain versions)."""
    H, W = rd3[0].shape
    dev = rd3[0].device
    ro3 = tuple(torch.full((H, W), float(origin[i]), dtype=_F32, device=dev) for i in range(3))
    hit, t, nx, ny, nz, kind = _trace_all(hs, mode, ro3, rd3, 1e-3, 1e6)
    sd = sun_direction(float(sun.get("azimuth", 135.0)), float(sun.get("elevation", 45.0)))
    sun_i = float(np.float32(sun.get("intensity", 3.0)))
    p = (ro3[0] + t * rd3[0] + nx * 1e-3, ro3[1] + t * rd3[1] + ny * 1e-3,
         ro3[2] + t * rd3[2] + nz * 1e-3)
    sel = torch.nonzero(hit.reshape(-1)).squeeze(1)   # a miss's shadow ray is never read
    sh = torch.zeros(H * W, dtype=torch.bool, device=dev)
    if sel.numel():
        sh[sel] = _occluded_all(hs, mode, tuple(c.reshape(-1)[sel] for c in p),
                                tuple(torch.full((sel.numel(),), s, dtype=_F32, device=dev)
                                      for s in sd), 1e6)
    sh = sh.reshape(H, W)
    ndl = torch.clamp(nx * sd[0] + ny * sd[1] + nz * sd[2], min=0.0)
    vis = torch.where(sh, 0.0, 1.0)
    amb = float(np.float32(env_intensity)) * (0.5 + 0.5 * ny)
    alb = torch.as_tensor(np.asarray(albedo, np.float32), device=dev)
    ka = alb[torch.clamp(kind, 0, 2).to(torch.int64)]
    radiance = ka * (fdiv(sun_i * ndl * vis, float(np.float32(math.pi))) + amb)[..., None]
    k = torch.clamp(rd3[1], 0, 1)
    sky = torch.stack([0.45 + 0.35 * k, 0.62 + 0.25 * k, 0.85 + 0.1 * k], -1)
    color = torch.where(hit[..., None], radiance, sky)
    exposed = color * float(np.float32(exposure))
    ldr = exposed / (exposed + 1.0)
    rgba = torch.full((H, W, 4), 255, dtype=torch.uint8, device=dev)
    rgba[..., :3] = (torch.clamp(ldr, 0, 1) * 255 + 0.5).to(torch.uint8)
    planes = {"depth": torch.where(hit, t, 0.0), "normal": torch.stack([nx, ny, nz], -1),
              "visibility": hit.to(_F32), "kind": kind, "albedo": ka}
    return rgba, planes


def hybrid_args(hs, mode, origin, width, height, sun, albedo, env_intensity, exposure):
    use = _uses(hs, mode)
    sd = sun_direction(float(sun.get("azimuth", 135.0)), float(sun.get("elevation", 45.0)))
    a = _kernels.HybridArgs()
    a.width, a.height = width, height
    a.use_terrain, a.use_mesh, a.use_sdf = (int(u) for u in use)
    a.cam_o[:] = [float(v) for v in origin]
    a.sun[:] = list(sd)
    a.sun_i = float(np.float32(sun.get("intensity", 3.0)))
    a.env_intensity = float(np.float32(env_intensity))
    a.exposure = float(np.float32(exposure))
    a.albedo[:] = [float(v) for v in np.asarray(albedo, np.float32).reshape(-1)]
    return a


def _shade_kernel(hs, mode, origin, rd3, sun, albedo, env_intensity, exposure):
    H, W = rd3[0].shape
    dev = rd3[0].device
    rd3 = [c.contiguous() for c in rd3]
    _kernels.require_cuda("hybrid_render", *rd3)
    use_terrain, use_mesh, use_sdf = _uses(hs, mode)
    scene = hs.terrain_scene.kernel_args() if use_terrain else _kernels.SceneArgs()
    mesh = (hs.mesh_scene.kernel_args(face_normals=hs.mesh_normals) if use_mesh
            else _kernels.MeshArgs())
    sdf = hs.sdf_scene.kernel_args() if use_sdf else _kernels.SdfArgs()
    rgba = torch.empty(H, W, 4, dtype=torch.uint8, device=dev)
    planes = {"depth": torch.empty(H, W, dtype=_F32, device=dev),
              "normal": torch.empty(H, W, 3, dtype=_F32, device=dev),
              "visibility": torch.empty(H, W, dtype=_F32, device=dev),
              "kind": torch.empty(H, W, dtype=torch.int32, device=dev),
              "albedo": torch.empty(H, W, 3, dtype=_F32, device=dev)}
    out = _kernels.HybridOut(*(_kernels.ptr(x) for x in (
        rgba, planes["depth"], planes["normal"], planes["visibility"], planes["kind"],
        planes["albedo"])))
    err = _kernels.lib().f3d_hybrid_render(
        scene, mesh, sdf, hybrid_args(hs, mode, origin, W, H, sun, albedo, env_intensity,
                                      exposure),
        *(_kernels.ptr(c) for c in rd3), out, _kernels.stream_ptr(dev))
    _kernels.check(err, "P3 hybrid_render")
    hybrid_pixels.launches += 1
    hybrid_pixels.sdf_launches += int(use_sdf)
    return rgba, planes


def hybrid_pixels(hs, mode, origin, rd3, sun, albedo, env_intensity, exposure):
    """Trace, shade and encode every pixel: kernel P3 on CUDA rays, the plain
    versions on CPU rays. Returns (rgba, AOV planes) on the rays' device."""
    if rd3[0].device.type == "cpu":
        return _shade_plain(hs, mode, origin, rd3, sun, albedo, env_intensity, exposure)
    return _shade_kernel(hs, mode, origin, rd3, sun, albedo, env_intensity, exposure)


hybrid_pixels.launches = 0
# the launches that marched the SDF (P6's body inside P3)
hybrid_pixels.sdf_launches = 0


def _scene_device(hs: HybridScene) -> torch.device:
    for part in (hs.terrain_scene, hs.mesh_scene, hs.sdf_scene):
        if part is not None:
            return part.device
    return torch.device("cpu")


def hybrid_render(width: int, height: int, scene: HybridScene, cam=None, *,
                  mode: str = "hybrid", sun=None,
                  albedo=((0.55, 0.52, 0.48), (0.7, 0.7, 0.72), (0.8, 0.3, 0.25)),
                  env_intensity: float = 0.35, exposure: float = 1.0, aovs=()) -> dict:
    """Render the hybrid scene (reference seam: hybrid_render) on the
    scene's device.

    Per-kind albedo triple (terrain, mesh, sdf); sun NEE with a union
    shadow query; cosine-weighted sky ambient."""
    if mode not in TRAVERSAL_MODES:
        raise ValueError(f"unknown traversal mode {mode!r}; "
                         f"expected one of {TRAVERSAL_MODES}")
    width, height = int(width), int(height)
    dev = _scene_device(scene)
    origin, rd3 = camera_rays(width, height, cam or {}, dev)
    rgba, planes = hybrid_pixels(scene, mode, origin, rd3, sun or {}, albedo, env_intensity,
                                 exposure)
    out = {"rgba": rgba.cpu().numpy()}
    for name in aovs or ():
        if name in planes:
            out[name] = planes[name].cpu().numpy()
    return out


def render_adjudication_pair(heightmap, width: int = 256, height: int = 192, *, cam=None,
                             sun=None, spp: int = 4, max_frames: int = 48,
                             variance_threshold: float = 0.05, device="cuda") -> dict:
    """AEQUITAS: render the same terrain through the path-traced reference
    AND the raster-equivalent renderer, return both frames + agreement
    metrics (exposure-normalised: both frames scaled to a common mean
    luminance before the metrics; the raw frames are returned)."""
    from ..metrics import image_metrics
    from ..terrain.params import make_terrain_params
    from ..terrain.renderer import TerrainRenderer
    from .terrain_ref import hybrid_render_terrain_reference, resolve_device

    dev = resolve_device(device)
    heightmap = np.asarray(heightmap, np.float32)
    h, w = heightmap.shape
    cam = cam or {"origin": (w / 2, heightmap.max() + 0.45 * w, h * 1.7),
                  "look_at": (w / 2, 0.0, h / 2)}
    sun = sun or {"azimuth": 135.0, "elevation": 50.0, "intensity": 3.0}

    pt = hybrid_render_terrain_reference(
        heightmap, width, height, cam, spp=spp, min_frames=2,
        max_frames=max_frames, variance_threshold=variance_threshold,
        sun_azimuth_deg=sun["azimuth"], sun_elevation_deg=sun["elevation"],
        sun_intensity=sun["intensity"], device=dev)

    p = make_terrain_params()
    p.size_px = (width, height)
    # both lanes shade the PT reference's constant grey, through its
    # Reinhard output transform and env ambient
    p.albedo_mode = "constant"
    p.constant_albedo = (0.6, 0.6, 0.6)
    p.tonemap.mode = "reinhard"
    p.output_srgb_eotf = False
    p.ibl.intensity = 0.35
    o = np.asarray(cam["origin"], np.float64)
    tgt = np.asarray(cam["look_at"], np.float64)
    dv = o - tgt
    r = float(np.linalg.norm(dv))
    p.cam_target = tuple(map(float, tgt))
    p.cam_radius = r
    p.cam_theta_deg = math.degrees(math.asin(max(-1, min(1, dv[1] / r))))
    p.cam_phi_deg = math.degrees(math.atan2(dv[2], dv[0]))
    p.light.azimuth_deg = sun["azimuth"]
    p.light.elevation_deg = sun["elevation"]
    p.light.intensity = sun["intensity"]
    raster = TerrainRenderer(device=dev).render_terrain_pbr_pom(params=p, heightmap=heightmap)

    a = pt["rgba"][..., :3].astype(np.float64)
    b = raster.rgba[..., :3].astype(np.float64)
    target = 120.0
    an = np.clip(a * (target / max(a.mean(), 1e-6)), 0, 255).astype(np.uint8)
    bn = np.clip(b * (target / max(b.mean(), 1e-6)), 0, 255).astype(np.uint8)
    metrics = image_metrics(an, bn)
    metrics["pt_mean"] = float(a.mean())
    metrics["raster_mean"] = float(b.mean())
    return {"pt": pt["rgba"], "raster": raster.rgba, "metrics": metrics}
