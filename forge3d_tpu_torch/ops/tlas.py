# forge3d_tpu_torch/ops/tlas.py
# Kernel P5: the two-level acceleration structure of forge3d_tpu/ops/tlas.py,
# transformed instances over shared BLASes.
#
# `build_tlas` is host code: each BLAS is built on the host SAH path (or
# taken as built) and put on the device; each instance keeps its
# object-to-world matrix and the float64 inverses JAX computes.
# `trace_tlas` visits the instances in index order: the ray moves into
# object space by the float32 world-to-object matrix (direction not
# renormalised, so t stays world-scaled), walks that instance's BLAS (K9's
# walk) and replaces the best hit only when strictly nearer. On CUDA
# tensors it launches csrc/pt.cu:tlas_kernel (one thread a ray, the
# instance loop inside), counted in `trace_tlas.launches`; on CPU tensors
# it runs `trace_tlas_plain`, which is JAX's loop over K9's plain version.
# JAX runs the transforms as eager array operations, each one rounded, and
# so do both versions here.

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from .bvh import BvhArrays, MeshScene, build_sah_bvh, mesh_scene, trace_mesh_plain
from .shading import fdiv, sqrt32

_F32 = torch.float32


@dataclass(frozen=True)
class Instance:
    """One placement of a BLAS: object->world 4x4 (numpy, host-static)."""

    blas_index: int
    transform: np.ndarray

    def __post_init__(self):
        m = np.asarray(self.transform, np.float64)
        if m.shape != (4, 4):
            raise ValueError("instance transform must be 4x4")
        object.__setattr__(self, "transform", m)


class Tlas(NamedTuple):
    """Host-built two-level structure: shared device BLASes + per-instance
    static transforms (object->world, world->object, normal matrix)."""

    scenes: Tuple[Tuple[MeshScene, int], ...]   # (scene, n_nodes) per BLAS
    instances: Tuple[Instance, ...]
    inv_mats: Tuple[np.ndarray, ...]            # world->object
    nrm_mats: Tuple[np.ndarray, ...]            # inverse-transpose linear


class TlasHit(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor          # world-scaled ray parameter
    instance: torch.Tensor   # i32 instance index (-1 = miss)
    prim: torch.Tensor       # i32 reordered-primitive id in that instance's BLAS
    u: torch.Tensor
    v: torch.Tensor


def build_tlas(blases: Sequence, instances: Sequence[Instance], *, device="cuda") -> Tlas:
    """Assemble a TLAS from BLASes (BvhArrays or (vertices, indices) pairs
    built on the host SAH path) and instance placements, on `device` (the
    card unless device="cpu")."""
    scenes = []
    for b in blases:
        if not isinstance(b, BvhArrays):
            b = build_sah_bvh(np.asarray(b[0], np.float32), np.asarray(b[1], np.uint32))
        scenes.append(mesh_scene(b, device=device))
    inv_mats = []
    nrm_mats = []
    for inst in instances:
        if not 0 <= inst.blas_index < len(scenes):
            raise ValueError(f"instance blas_index {inst.blas_index} out of "
                             f"range ({len(scenes)} BLASes)")
        inv_mats.append(np.linalg.inv(inst.transform))
        nrm_mats.append(np.linalg.inv(inst.transform[:3, :3]).T)
    return Tlas(scenes=tuple(scenes), instances=tuple(instances),
                inv_mats=tuple(inv_mats), nrm_mats=tuple(nrm_mats))


def _xform_table(tlas: Tlas) -> np.ndarray:
    """(n_inst, 12) float32: each world->object matrix's 3x3 (row-major),
    then its translation."""
    rows = [np.concatenate([inv[:3, :3].reshape(-1), inv[:3, 3]]) for inv in tlas.inv_mats]
    return np.asarray(rows, np.float32).reshape(-1, 12)


def _rays(ro, rd, device):
    comps = torch.broadcast_tensors(*(torch.as_tensor(c, device=device).to(_F32)
                                      for c in (*ro, *rd)))
    return comps[0].shape, [c.reshape(-1).contiguous() for c in comps]


def _to_object(m, x, y, z, t=None):
    """m[0]*x + m[1]*y + m[2]*z (+ t), each operation rounded."""
    out = m[0] * x + m[1] * y + m[2] * z
    return out if t is None else out + t


def trace_tlas_plain(tlas: Tlas, ro, rd, tmin: float = 1e-4, tmax: float = 1e30) -> TlasHit:
    """Plain version of P5: JAX's static instance loop over K9's plain walk
    (flat float32 ray tensors)."""
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    dev = rox.device
    n = rox.numel()
    best_t = torch.full((n,), float(np.float32(tmax)), dtype=_F32, device=dev)
    best_hit = torch.zeros(n, dtype=torch.bool, device=dev)
    best_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_prim = torch.zeros(n, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=_F32, device=dev)
    best_v = torch.zeros(n, dtype=_F32, device=dev)
    xf = _xform_table(tlas)
    for idx, inst in enumerate(tlas.instances):
        lin = [[float(v) for v in xf[idx, 3 * r:3 * r + 3]] for r in range(3)]
        trans = [float(v) for v in xf[idx, 9:12]]
        o = tuple(_to_object(lin[r], rox, roy, roz, trans[r]) for r in range(3))
        d = tuple(_to_object(lin[r], rdx, rdy, rdz) for r in range(3))
        scene, n_nodes = tlas.scenes[inst.blas_index]
        h = trace_mesh_plain(scene, n_nodes, o, d, tmin=tmin, tmax=tmax)
        closer = h.hit & (h.t < best_t)
        best_t = torch.where(closer, h.t, best_t)
        best_hit = best_hit | closer
        best_inst = torch.where(closer, idx, best_inst)
        best_prim = torch.where(closer, h.prim, best_prim)
        best_u = torch.where(closer, h.u, best_u)
        best_v = torch.where(closer, h.v, best_v)
    return TlasHit(best_hit, best_t, best_inst, best_prim, best_u, best_v)


def tlas_args(tlas: Tlas, device) -> "_kernels.TlasArgs":
    """The kernel's view of the TLAS: a device table of the BLASes'
    MeshArgs, the float32 transforms and each instance's BLAS."""
    blas = (_kernels.MeshArgs * len(tlas.scenes))(
        *(scene.kernel_args() for scene, _ in tlas.scenes))
    table = torch.frombuffer(bytearray(bytes(blas)), dtype=torch.uint8).to(device)
    xform = torch.as_tensor(_xform_table(tlas), device=device).contiguous()
    inst_blas = torch.as_tensor(np.asarray([i.blas_index for i in tlas.instances], np.int32),
                                device=device)
    _kernels.require_cuda("tlas", table, xform, inst_blas)
    args = _kernels.TlasArgs(_kernels.ptr(table), _kernels.ptr(xform), _kernels.ptr(inst_blas),
                             len(tlas.instances))
    args._keep = (table, xform, inst_blas)
    return args


def _trace_tlas_kernel(tlas: Tlas, ro, rd, tmin, tmax) -> TlasHit:
    _kernels.require_cuda("trace_tlas", *ro, *rd)
    dev = ro[0].device
    n = ro[0].numel()
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=_F32, device=dev)
    inst = torch.empty(n, dtype=torch.int32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=_F32, device=dev)
    v = torch.empty(n, dtype=_F32, device=dev)
    args = tlas_args(tlas, dev)
    err = _kernels.lib().f3d_trace_tlas(
        args, *(_kernels.ptr(c) for c in (*ro, *rd)), n, float(np.float32(tmin)),
        float(np.float32(tmax)), *(_kernels.ptr(x) for x in (hit, t, inst, prim, u, v)),
        _kernels.stream_ptr(dev))
    _kernels.check(err, "P5 trace_tlas")
    trace_tlas.launches += 1
    return TlasHit(hit, t, inst, prim, u, v)


def trace_tlas(tlas: Tlas, ro, rd, tmin: float = 1e-4, tmax: float = 1e30) -> TlasHit:
    """Closest hit over all instances. ro/rd: world-space ray arrays
    (3-tuples of any broadcastable shape), on the TLAS's device."""
    device = tlas.scenes[0][0].device if tlas.scenes else torch.device("cpu")
    shape, comps = _rays(ro, rd, device)
    ro_, rd_ = comps[:3], comps[3:]
    if device.type == "cpu" or not tlas.instances:
        h = trace_tlas_plain(tlas, ro_, rd_, tmin, tmax)
    else:
        h = _trace_tlas_kernel(tlas, ro_, rd_, tmin, tmax)
    return TlasHit(*(x.reshape(shape) for x in h))


trace_tlas.launches = 0


def instance_normal(tlas: Tlas, hit: TlasHit, object_normals) -> tuple:
    """Object-space normals per lane into world space by each hit
    instance's inverse-transpose matrix (eager float32, as JAX's)."""
    nx, ny, nz = (torch.as_tensor(a, device=hit.t.device).to(_F32) for a in object_normals)
    wx = torch.zeros_like(nx)
    wy = torch.zeros_like(ny)
    wz = torch.zeros_like(nz)
    for idx in range(len(tlas.instances)):
        m = np.asarray(tlas.nrm_mats[idx], np.float32)
        sel = hit.instance == idx
        wx = torch.where(sel, _to_object([float(v) for v in m[0]], nx, ny, nz), wx)
        wy = torch.where(sel, _to_object([float(v) for v in m[1]], nx, ny, nz), wy)
        wz = torch.where(sel, _to_object([float(v) for v in m[2]], nx, ny, nz), wz)
    inv = fdiv(1.0, sqrt32(torch.clamp(wx * wx + wy * wy + wz * wz, min=1e-20)))
    return wx * inv, wy * inv, wz * inv
