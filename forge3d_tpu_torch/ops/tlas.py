# forge3d_tpu_torch/ops/tlas.py
# Kernel P5: the two-level acceleration structure of forge3d_tpu/ops/tlas.py,
# transformed instances over shared BLASes.
#
# `build_tlas` is host code: each BLAS is built on the host SAH path (or
# taken as built) and put on the device; each instance keeps its
# object-to-world matrix and the float64 inverses JAX computes, and the
# kernel's table (`instance_table`: per instance the float32
# world-to-object transform, the BLAS's MeshArgs and the cull's world-space
# box with its margin, `cull_margin`) is formed and uploaded once.
# `trace_tlas` visits the instances in index order: the ray moves into
# object space by the float32 world-to-object matrix (direction not
# renormalised, so t stays world-scaled), walks that instance's BLAS (K9's
# walk) and replaces the best hit only when strictly nearer. On CUDA
# tensors it launches csrc/pt.cu:tlas_kernel (one thread a ray, the table
# staged in shared memory, an instance walked only where the ray meets its
# box: csrc/pt.cuh:tlas_cull, which never rejects one whose root box the
# walk would enter), counted in `trace_tlas.launches`; on CPU tensors it
# runs `trace_tlas_plain`, which is JAX's loop over K9's plain version.
# JAX runs the transforms as eager array operations, each one rounded, and
# so do both versions here.

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from .bvh import BvhArrays, MeshScene, build_sah_bvh, mesh_args, mesh_scene, trace_mesh_plain
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
    static transforms (object->world, world->object, normal matrix), and
    the kernel's table of the instances on the BLASes' device."""

    scenes: Tuple[Tuple[MeshScene, int], ...]   # (scene, n_nodes) per BLAS
    instances: Tuple[Instance, ...]
    inv_mats: Tuple[np.ndarray, ...]            # world->object
    nrm_mats: Tuple[np.ndarray, ...]            # inverse-transpose linear
    table: torch.Tensor                         # instance_table's bytes


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
    return assemble_tlas(scenes, instances, inv_mats, nrm_mats)


def assemble_tlas(scenes, instances, inv_mats, nrm_mats) -> Tlas:
    """The Tlas of device BLASes ((scene, n_nodes) pairs), instances and
    their matrices, with its kernel table formed once on the BLASes'
    device."""
    scenes, instances = tuple(scenes), tuple(instances)
    inv_mats, nrm_mats = tuple(inv_mats), tuple(nrm_mats)
    return Tlas(scenes=scenes, instances=instances, inv_mats=inv_mats, nrm_mats=nrm_mats,
                table=instance_table(scenes, instances, _xform_rows(inv_mats)))


def _xform_rows(inv_mats) -> np.ndarray:
    """(n_inst, 12) float32: each world->object matrix's 3x3 (row-major),
    then its translation."""
    rows = [np.concatenate([inv[:3, :3].reshape(-1), inv[:3, 3]]) for inv in inv_mats]
    return np.asarray(rows, np.float32).reshape(-1, 12)


# The cull's rays (csrc/pt.cuh:tlas_cull): it applies to a ray with
# |rd|_inf >= DIR_MIN and |ro|_inf <= ORG_MAX, the bounds cull_margin's
# argument takes; other rays visit every instance. The kernel reads them
# from each instance's row of the table.
DIR_MIN = 2.0 ** -10
ORG_MAX = 2.0 ** 40
_U = 2.0 ** -24          # float32's unit roundoff
_U64 = 2.0 ** -52        # twice float64's, for the host's own products
_NEVER = (np.zeros(3), np.zeros(3), 0.0, 0.0, np.inf, 0.0)   # an instance never culled


def _round(x, up: bool):
    """float64 x as float32 rounded up (or down)."""
    x = np.asarray(x, np.float64)
    f = x.astype(np.float32)
    step = np.nextafter(f, np.float32(np.inf if up else -np.inf))
    return np.where(f < x if up else f > x, step, f).astype(np.float32)


def cull_margin(transform, xform, lo, hi):
    """The cull's world-space box of one instance and its margin, in
    float64 (csrc/pt.cuh:tlas_cull states the argument): `transform` the
    float64 object-to-world matrix, `xform` its float32 world-to-object row
    (3x3 row-major, translation), `lo`, `hi` the BLAS root's box. Returns
    (lo, hi) of the world box of the root's eight corners, grown by the
    float64 products' rounding and rounded outward to float32, (g0, g1) the
    margin g0 + g1 |ro|_inf (the bound, doubled, rounded up), and
    (dir_min, org_max), the rays it holds for; an instance the argument
    cannot hold for is never culled (dir_min infinite)."""
    A = np.asarray(transform, np.float64)[:3, :3]
    c = np.asarray(transform, np.float64)[:3, 3]
    M = np.asarray(xform[:9], np.float64).reshape(3, 3)
    m = np.asarray(xform[9:12], np.float64)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    if not all(np.isfinite(v).all() for v in (A, c, M, m, lo, hi)) or (lo > hi).any():
        return _NEVER
    try:
        Minv = np.linalg.inv(M)
    except np.linalg.LinAlgError:
        return _NEVER
    norm = lambda X: float(np.abs(X).sum(axis=-1).max())  # noqa: E731  (the inf-norm)
    a, N, mm = norm(A), norm(M), float(np.abs(m).max())
    Ahat = norm(Minv) * (1.0 + 1e-9)
    b = float(max(np.abs(lo).max(), np.abs(hi).max()))
    # mesh_inv's limits (csrc/mesh.cuh): a clamped reciprocal is that of a
    # direction within z of the component it stands for
    clamp = _kernels.csrc_constant("F3D_MESH_INV_CLAMP")
    z = (_kernels.csrc_constant("F3D_MESH_INV_MIN") + 1.0 / clamp) * (1.0 + 1e-9)
    if not (np.isfinite(Ahat) and 4.05 * _U * N * Ahat <= 0.01
            and z * Ahat / DIR_MIN <= 0.01
            and (b + N * ORG_MAX + mm) * clamp < 1e37):
        return _NEVER
    Fn = norm(A @ M - np.eye(3)) + 4 * _U64 * norm(np.abs(A) @ np.abs(M))
    hn = float(np.abs(A @ m + c).max()) + 4 * _U64 * (norm(np.abs(A) @ np.abs(m)[:, None])
                                                      + float(np.abs(c).max()))
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])])
    world = corners @ A.T + c
    dw = 4 * _U64 * (a * b + float(np.abs(c).max()))
    wlo, whi = _round(world.min(0) - dw, up=False), _round(world.max(0) + dw, up=True)
    Bw = float(max(np.abs(wlo).max(), np.abs(whi).max()))
    if not Bw <= ORG_MAX:
        return _NEVER

    def reach(r):
        # how far outside the world box the exact ray's point at the root
        # test's t may lie, for |ro|_inf = r
        o_max = (N * r + mm) * (1 + 5 * _U)
        e = 2.1 * _U * (b + o_max)
        t0 = (b + e + o_max) * Ahat / 0.98
        return (a * e + a * 4.01 * _U * (N * r + mm) + a * t0 * (4.05 * _U * N + z / DIR_MIN)
                + Fn * (r + t0) + hn)

    ks = 3.2 * _U + 1.025 * z / DIR_MIN    # the world slabs' slack, per unit of |box| + g + |ro|
    den = 1.0 - ks - _U
    g0 = (reach(0.0) + (ks + _U) * Bw) / den
    g1 = (reach(1.0) - reach(0.0) + ks) / den
    return (wlo, whi, float(_round(2 * g0 * (1 + 1e-9), up=True)),
            float(_round(2 * g1 * (1 + 1e-9), up=True)), DIR_MIN, ORG_MAX)


def instance_table(scenes, instances, xform: np.ndarray) -> torch.Tensor:
    """P5's table (csrc/pt.cuh:TlasInst, 128 bytes an instance) on the
    BLASes' device: each instance's float32 world-to-object row, its BLAS's
    MeshArgs and the cull's box and margin (cull_margin) from its BLAS's
    root (nodes[0]; a root whose miss link is not the tree's end is never
    culled). Formed on the host and uploaded in one copy."""
    rows = (_kernels.TlasInst * max(len(instances), 1))()
    roots = [scene.nodes[0].cpu().numpy() if n_nodes > 0 else None for scene, n_nodes in scenes]
    for i, inst in enumerate(instances):
        scene, n_nodes = scenes[inst.blas_index]
        root = roots[inst.blas_index]
        whole = root is not None and int(root[3:4].view(np.int32)[0]) >= n_nodes
        lo, hi, g0, g1, dir_min, org_max = (
            cull_margin(inst.transform, xform[i], root[0:3], root[4:7]) if whole else _NEVER)
        rows[i] = _kernels.TlasInst(
            _kernels._F3(*lo), _kernels._F3(*hi), g0, g1, dir_min, org_max,
            (ctypes.c_float * 12)(*xform[i].tolist()), mesh_args(scene))
    data = np.frombuffer(bytes(rows), np.uint8)[:len(instances) * ctypes.sizeof(rows[0])]
    device = scenes[0][0].device if scenes else torch.device("cpu")
    return torch.from_numpy(data.copy()).to(device)


def tlas_attrs() -> dict:
    """P5's kernel (csrc/pt.cu:f3d_tlas_attrs): registers and local bytes a
    thread, resident blocks an SM, shared bytes a block, the instances a
    block stages at a time, and mesh_inv's limits as the library was built
    (the cull's margin takes them). Its chunk has one home,
    csrc/pt.cuh:F3D_TLAS_CHUNK, and the limits theirs, csrc/mesh.cuh."""
    out = (ctypes.c_int * 7)()
    _kernels.check(_kernels.lib().f3d_tlas_attrs(out), "P5 trace_tlas (attributes)")
    inv_min, inv_clamp = np.array(out[5:7], np.int32).view(np.float32).tolist()
    return {"registers": out[0], "local_bytes": out[1], "blocks": out[2], "shared_bytes": out[3],
            "chunk": out[4], "inv_min": inv_min, "inv_clamp": inv_clamp}


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
    xf = _xform_rows(tlas.inv_mats)
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


def tlas_args(tlas: Tlas) -> "_kernels.TlasArgs":
    """The kernel's view of the TLAS: its table, formed with the TLAS."""
    _kernels.require_cuda("tlas", tlas.table)
    return _kernels.TlasArgs(_kernels.ptr(tlas.table), len(tlas.instances))


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
    args = tlas_args(tlas)
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
