# forge3d_tpu_torch/pt/mesh_render.py
# Mesh path tracing (forge3d_tpu/pt/mesh_render.py): the SAH BVH of a
# triangle mesh with its face normals, and the deterministic mesh engine:
# pixel-center primary rays through the BVH, two-sided face normals, the
# sphere engine's PBR shading, sun NEE with a BVH shadow ray, and the AOVs.
#
# `render_mesh` is the wrapper of kernel P2 (csrc/engines.cu:mesh_kernel
# over csrc/pbr.cuh:mesh_pixel): on CUDA it launches the kernel, on the CPU
# it runs `render_mesh_plain`. `MeshTracerScene` is also the mesh of the
# hybrid terrain render (pt/terrain_ref.py), whose kernels K6 and K8 walk
# the same BVH.

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..ops.bvh import build_sah_bvh, mesh_scene, trace_mesh_plain
from ..ops.shading import fdiv, sun_direction
from .megakernel import (AOV_NAMES, EngineCamera, _empty_planes, _f32, _planes, aov_args,
                         dot3, engine_rays, env_color, shade_pbr, to_u8)
from .terrain_ref import resolve_device

_F32 = torch.float32


@dataclass(frozen=True)
class MeshMaterial:
    """One material for the whole mesh, float32 values."""

    albedo: Tuple[float, float, float]
    metallic: float
    roughness: float
    emissive: Tuple[float, float, float]

    def kernel_args(self, sun_dir, sun_intensity: float) -> _kernels.MaterialArgs:
        F3 = _kernels._F3
        return _kernels.MaterialArgs(F3(*self.albedo), self.metallic, self.roughness,
                                     F3(*self.emissive), F3(*sun_dir), sun_intensity)


def _material_from_dict(mat: Optional[dict]) -> MeshMaterial:
    mat = mat or {}
    t3 = lambda v: tuple(_f32(c) for c in v)  # noqa: E731
    return MeshMaterial(albedo=t3(mat.get("albedo", (0.75, 0.72, 0.68))),
                        metallic=_f32(float(mat.get("metallic", 0.0))),
                        roughness=_f32(float(mat.get("roughness", 0.55))),
                        emissive=t3(mat.get("emissive", (0.0, 0.0, 0.0))))


class MeshTracerScene:
    """Builds the SAH BVH once on the host and keeps its arrays and the
    face normals (in BVH primitive order) on one device: "cuda" (the
    default, DeviceError without CUDA) or "cpu"."""

    def __init__(self, vertices, indices, device="cuda"):
        device = resolve_device(device)
        vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        indices = np.asarray(indices, np.uint32).reshape(-1, 3)
        self.bvh = build_sah_bvh(vertices, indices)
        self.scene, self.n_nodes = mesh_scene(self.bvh, device)
        fn = np.cross(self.bvh.tri_e1, self.bvh.tri_e2)
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
        self.face_normals = torch.as_tensor(fn.astype(np.float32), device=device)

    @property
    def triangle_count(self) -> int:
        return self.bvh.triangle_count

    @property
    def device(self) -> torch.device:
        return self.face_normals.device

    def kernel_args(self) -> _kernels.MeshArgs:
        return self.scene.kernel_args(self.face_normals)

    def hit_normals(self, prim, dx, dy, dz):
        """Face normals of the hit primitives, turned against the rays
        (two-sided shading); prim -1 reads primitive 0."""
        n = self.face_normals[torch.clamp(prim, min=0).to(torch.int64)].unbind(-1)
        flip = dot3(n, (dx, dy, dz)) > 0
        return tuple(torch.where(flip, -c, c) for c in n)


def render_mesh_plain(cam: EngineCamera, mts: MeshTracerScene, mat: MeshMaterial,
                      sun_dir, sun_intensity: float) -> dict:
    """Plain PyTorch version of P2: the planes of megakernel._planes."""
    dev = mts.device
    rd = engine_rays(cam, dev)
    ro = tuple(torch.full_like(rd[0], c) for c in cam.origin)
    hit = trace_mesh_plain(mts.scene, mts.n_nodes, ro, rd)
    n = mts.hit_normals(hit.prim, *rd)
    v = tuple(-c for c in rd)
    color, albedo, direct, indirect = shade_pbr(v, n, mat.albedo, mat.metallic, mat.roughness,
                                                mat.emissive, mat.roughness, mat.roughness)
    # sun NEE with a BVH shadow ray
    sp = tuple((ro[k] + hit.t * rd[k]) + n[k] * 1e-3 for k in range(3))
    sd = tuple(torch.full_like(rd[0], c) for c in sun_dir)
    sh = trace_mesh_plain(mts.scene, mts.n_nodes, sp, sd, tmax=1e6)
    ndl = torch.clamp(dot3(n, sun_dir), min=0.0)
    w = sun_intensity * ndl * torch.where(sh.hit, 0.0, 1.0)
    sun = [fdiv(torch.tensor(mat.albedo[k], dtype=_F32, device=dev), math.pi) * w
           for k in range(3)]
    color = tuple(color[k] + sun[k] for k in range(3))
    direct = tuple(direct[k] + sun[k] for k in range(3))

    env = env_color(rd[1])
    hm = hit.hit
    zero, one = torch.zeros_like(rd[0]), torch.ones_like(rd[0])
    pick = lambda a, b: tuple(torch.where(hm, x, y) for x, y in zip(a, b))  # noqa: E731
    return _planes(pick(color, env), pick(albedo, (zero,) * 3), pick(n, (zero, one, zero)),
                   torch.where(hm, hit.t, 1.0), pick(direct, (zero,) * 3), pick(indirect, env),
                   torch.where(hm, 1.0, 0.0), cam.exposure)


def _render_mesh_kernel(cam: EngineCamera, mts: MeshTracerScene, mat: MeshMaterial,
                        sun_dir, sun_intensity: float) -> dict:
    dev = mts.device
    planes = _empty_planes(cam, dev)
    err = _kernels.lib().f3d_render_mesh(cam.kernel_args(), mts.kernel_args(),
                                         mat.kernel_args(sun_dir, sun_intensity),
                                         aov_args(planes), _kernels.stream_ptr(dev))
    _kernels.check(err, "P2 render_mesh")
    render_mesh.launches += 1
    return planes


def render_mesh(cam: EngineCamera, mts: MeshTracerScene, mat: MeshMaterial, sun_dir,
                sun_intensity: float) -> dict:
    """One image of the mesh engine (kernel P2). A scene on the CPU runs the
    plain version; a scene on CUDA launches the kernel."""
    if mts.device.type == "cpu":
        return render_mesh_plain(cam, mts, mat, sun_dir, sun_intensity)
    return _render_mesh_kernel(cam, mts, mat, sun_dir, sun_intensity)


render_mesh.launches = 0


def pt_render_gpu_mesh(width, height, vertices, indices, cam=None, *, material=None, sun=None,
                       seed=1, frames=1, aovs=(), scene: Optional[MeshTracerScene] = None,
                       device="cuda") -> dict:
    """Render a triangle mesh; returns {"rgba": u8, <aov>: f32}.
    Deterministic (pixel-center rays); `seed`/`frames` are accepted for
    signature parity. `device` is "cuda" (kernel P2) or "cpu" (the plain
    version); a given `scene` must lie on that device."""
    width, height = int(width), int(height)
    if width <= 0 or height <= 0:
        raise ValueError("width/height must be positive")
    dev = resolve_device(device)
    if scene is None:
        scene = MeshTracerScene(vertices, indices, dev)
    elif scene.device.type != dev.type:
        raise ValueError(f"scene lies on {scene.device}, not on {dev}")
    ecam = EngineCamera.make(width, height, cam, (0.0, 1.5, 4.0), (0.0, 0.5, 0.0))
    sun = sun or {}
    sd = sun_direction(float(sun.get("azimuth", 135.0)), float(sun.get("elevation", 45.0)))
    planes = render_mesh(ecam, scene, _material_from_dict(material), sd,
                         _f32(float(sun.get("intensity", 3.0))))
    out = {k: v.cpu().numpy() for k, v in planes.items()}
    result = {"rgba": to_u8(out["ldr"])}
    vis = out["vis"]
    extra = {"visibility": vis,
             "emission": np.asarray(_material_from_dict(material).emissive, np.float32)
             * vis[..., None]}
    for name in aovs:
        if name in AOV_NAMES:
            result[name] = np.asarray(extra.get(name, out.get(name)), np.float32)
    return result
