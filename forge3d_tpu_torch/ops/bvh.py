# forge3d_tpu_torch/ops/bvh.py
# Triangle-mesh BVH (forge3d_tpu/ops/bvh.py): the host binned-SAH build,
# copied word for word (numpy; its output equals the JAX package's array for
# array), and the stackless threaded-BVH traversal.
#
# The tree is flattened depth first and threaded: every node stores
# `miss_link`, the DFS successor that skips its subtree. A ray's state is one
# node index: an interior box hit goes to node + 1 (the first child), a miss
# or a finished leaf to `miss_link`.
#
# `trace_mesh` is the wrapper of kernel K9's standalone launcher
# (csrc/kernels.cu:trace_mesh_kernel over csrc/mesh.cuh:trace_mesh_ray): on
# CUDA tensors it launches the kernel, on CPU tensors it runs
# `trace_mesh_plain`. On the render paths the same device function runs
# inside the frame kernel K6, the G-buffer kernel K8, the mesh engine P2, the
# TLAS walk P5 and the hybrid tracer P3. The kernel reads the BVH as packed
# records (pack_nodes, pack_tris), formed on the host where the scene is put
# on the device (MeshScene.from_arrays); the plain version reads the arrays.

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import _kernels
from .shading import fdiv

_LEAF_SIZE = 4
_N_BINS = 12


@dataclass(frozen=True)
class BvhArrays:
    """Flattened threaded BVH (host numpy; upload once for traversal)."""

    bounds_min: np.ndarray   # (n_nodes, 3) f32
    bounds_max: np.ndarray   # (n_nodes, 3) f32
    first: np.ndarray        # (n_nodes,) i32: first prim (leaf) | unused
    count: np.ndarray        # (n_nodes,) i32: prim count (0 = interior)
    miss_link: np.ndarray    # (n_nodes,) i32: DFS successor skipping subtree
    prim_index: np.ndarray   # (n_prims,) i32: permutation into triangles
    tri_v0: np.ndarray       # (n_prims, 3) f32 (reordered by prim_index)
    tri_e1: np.ndarray       # (n_prims, 3) f32: v1 - v0
    tri_e2: np.ndarray       # (n_prims, 3) f32: v2 - v0
    triangle_count: int
    node_count: int
    world_aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]]
    stats: dict

    @property
    def nbytes(self) -> int:
        return sum(
            a.nbytes
            for a in (self.bounds_min, self.bounds_max, self.first, self.count,
                      self.miss_link, self.prim_index, self.tri_v0, self.tri_e1,
                      self.tri_e2)
        )


def build_sah_bvh(vertices: np.ndarray, indices: np.ndarray) -> BvhArrays:
    """Binned-SAH top-down build (host). vertices (V,3) f32, indices (T,3)."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.uint32)
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError("vertices must be (V, 3)")
    if indices.ndim != 2 or indices.shape[1] != 3:
        raise ValueError("indices must be (T, 3)")
    if indices.size and int(indices.max()) >= len(vertices):
        raise ValueError("triangle index out of range")
    T = len(indices)
    if T == 0:
        raise ValueError("mesh has no triangles")

    v0 = vertices[indices[:, 0]]
    v1 = vertices[indices[:, 1]]
    v2 = vertices[indices[:, 2]]
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tmin + tmax) * 0.5

    order = np.arange(T, dtype=np.int32)

    # Nodes accumulated in DFS order: (min, max, first, count, parent_end)
    nmin, nmax, nfirst, ncount = [], [], [], []
    # children resolved by construction: interior node's first child is the
    # next DFS node; we record subtree sizes to thread miss links after.
    subtree_size = []

    def sah_split(lo: int, hi: int):
        """Return (axis, split_pos such that [lo,split) left) or None."""
        n = hi - lo
        idx = order[lo:hi]
        cmin = centroid[idx].min(0)
        cmax = centroid[idx].max(0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            return None
        # binned SAH along axis
        scale = _N_BINS * (1.0 - 1e-6) / ext[axis]
        bins = np.minimum(
            ((centroid[idx, axis] - cmin[axis]) * scale).astype(np.int32),
            _N_BINS - 1,
        )
        bin_counts = np.bincount(bins, minlength=_N_BINS)
        bmin = np.full((_N_BINS, 3), np.inf, np.float32)
        bmax = np.full((_N_BINS, 3), -np.inf, np.float32)
        for bi in range(_N_BINS):
            m = bins == bi
            if m.any():
                bmin[bi] = tmin[idx[m]].min(0)
                bmax[bi] = tmax[idx[m]].max(0)

        # prefix/suffix areas
        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

        lmin = np.minimum.accumulate(bmin, 0)
        lmax = np.maximum.accumulate(bmax, 0)
        rmin = np.minimum.accumulate(bmin[::-1], 0)[::-1]
        rmax = np.maximum.accumulate(bmax[::-1], 0)[::-1]
        lcnt = np.cumsum(bin_counts)
        rcnt = np.cumsum(bin_counts[::-1])[::-1]
        cost = np.full(_N_BINS - 1, np.inf)
        for s in range(_N_BINS - 1):
            if lcnt[s] == 0 or rcnt[s + 1] == 0:
                continue
            cost[s] = lcnt[s] * area(lmin[s], lmax[s]) + rcnt[s + 1] * area(
                rmin[s + 1], rmax[s + 1]
            )
        leaf_cost = n * area(tmin[idx].min(0), tmax[idx].max(0))
        s = int(np.argmin(cost))
        if not np.isfinite(cost[s]) or (n <= _LEAF_SIZE and cost[s] >= leaf_cost):
            return None
        sel = bins <= s
        left = idx[sel]
        right = idx[~sel]
        if len(left) == 0 or len(right) == 0:
            return None
        order[lo:lo + len(left)] = left
        order[lo + len(left):hi] = right
        return lo + len(left)

    max_depth = 0

    def build(lo: int, hi: int, depth: int) -> int:
        """Emit node for range [lo, hi); return subtree node count."""
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        my = len(nmin)
        idx = order[lo:hi]
        nmin.append(tmin[idx].min(0))
        nmax.append(tmax[idx].max(0))
        nfirst.append(lo)
        ncount.append(0)
        subtree_size.append(0)
        n = hi - lo
        split = None
        if n > _LEAF_SIZE or n > 1:
            split = sah_split(lo, hi)
        if split is None and n > _LEAF_SIZE:
            split = lo + n // 2  # median fallback keeps depth bounded
        if split is None:
            ncount[my] = n
            subtree_size[my] = 1
            return 1
        left = build(lo, split, depth + 1)
        right = build(split, hi, depth + 1)
        subtree_size[my] = 1 + left + right
        return subtree_size[my]

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        build(0, T, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    n_nodes = len(nmin)
    miss = np.zeros(n_nodes, np.int32)

    def thread(node: int, succ: int) -> None:
        miss[node] = succ
        if ncount[node] == 0:
            left = node + 1
            right = left + subtree_size[left]
            thread(left, right)
            thread(right, succ)

    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        thread(0, n_nodes)
    finally:
        sys.setrecursionlimit(old_limit)

    perm = order.copy()
    rv0 = v0[perm]
    leaf_count = int(sum(1 for c in ncount if c > 0))
    return BvhArrays(
        bounds_min=np.asarray(nmin, np.float32),
        bounds_max=np.asarray(nmax, np.float32),
        first=np.asarray(nfirst, np.int32),
        count=np.asarray(ncount, np.int32),
        miss_link=miss,
        prim_index=perm,
        tri_v0=rv0,
        tri_e1=(v1 - v0)[perm],
        tri_e2=(v2 - v0)[perm],
        triangle_count=T,
        node_count=n_nodes,
        world_aabb=(tuple(map(float, tmin.min(0))), tuple(map(float, tmax.max(0)))),
        stats={"max_depth": int(max_depth), "leaf_count": leaf_count,
               "max_leaf_size": int(max(ncount) if ncount else 0)},
    )


def refit_bvh(bvh: BvhArrays, vertices: np.ndarray, indices: np.ndarray) -> BvhArrays:
    """Refit node bounds to moved vertices, keeping topology (host, numpy:
    forge3d_tpu/ops/bvh.py:refit_bvh)."""
    vertices = np.asarray(vertices, np.float32)
    v0 = vertices[indices[:, 0]][bvh.prim_index]
    v1 = vertices[indices[:, 1]][bvh.prim_index]
    v2 = vertices[indices[:, 2]][bvh.prim_index]
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    n = bvh.node_count
    bmin = bvh.bounds_min.copy()
    bmax = bvh.bounds_max.copy()
    # DFS order puts children after their parent: walk backwards, leaves
    # from their triangles, interiors from their two children (the right
    # child is where the left subtree's miss link lands)
    child_of = {}
    for i in range(n):
        if bvh.count[i] == 0:
            left = i + 1
            right = bvh.miss_link[left] if bvh.miss_link[left] != bvh.miss_link[i] else left
            child_of[i] = (left, right)
    for i in range(n - 1, -1, -1):
        c = bvh.count[i]
        if c > 0:
            f = bvh.first[i]
            bmin[i] = tmin[f:f + c].min(0)
            bmax[i] = tmax[f:f + c].max(0)
        else:
            l, r = child_of[i]
            bmin[i] = np.minimum(bmin[l], bmin[r])
            bmax[i] = np.maximum(bmax[l], bmax[r])
    return BvhArrays(
        bounds_min=bmin, bounds_max=bmax, first=bvh.first, count=bvh.count,
        miss_link=bvh.miss_link, prim_index=bvh.prim_index,
        tri_v0=v0, tri_e1=v1 - v0, tri_e2=v2 - v0,
        triangle_count=bvh.triangle_count, node_count=bvh.node_count,
        world_aabb=(tuple(map(float, tmin.min(0))), tuple(map(float, tmax.max(0)))),
        stats=bvh.stats,
    )


# ---------------------------------------------------------------------------
# The kernel's records: packed nodes and triangles (csrc/mesh.cuh)
# ---------------------------------------------------------------------------

_MAX_FIRST = 1 << 28   # `first` shares its word with the count's 3 bits


def _bits(a) -> np.ndarray:
    """int32 values as the float32 words that hold their bits."""
    return np.ascontiguousarray(a, np.int32).view(np.float32)


def pack_nodes(bmin, bmax, first, count, miss) -> np.ndarray:
    """(n_nodes, 8) float32, a node's 32-byte record: lo.xyz and the miss
    link's bits, hi.xyz and the bits of first << 3 | min(count, 4) (the
    walk tests at most F3D_LEAF_SIZE (4) triangles of a leaf; count 0 marks
    an interior node)."""
    n = len(count)
    if n and int(np.max(first)) >= _MAX_FIRST:
        raise ValueError(f"a leaf's first primitive must be below {_MAX_FIRST}")
    out = np.empty((n, 8), np.float32)
    out[:, 0:3] = bmin
    out[:, 3] = _bits(miss)
    out[:, 4:7] = bmax
    out[:, 7] = _bits(np.asarray(first, np.int64) << 3 | np.minimum(count, _LEAF_SIZE))
    return out


def pack_tris(v0, e1, e2) -> np.ndarray:
    """(n_prims, 12) float32, a triangle's 48-byte record: v0, e1, e2, each
    padded to 16 bytes."""
    out = np.zeros((len(v0), 12), np.float32)
    out[:, 0:3], out[:, 4:7], out[:, 8:11] = v0, e1, e2
    return out


# ---------------------------------------------------------------------------
# Device traversal
# ---------------------------------------------------------------------------

_I32 = torch.int32


@dataclass(frozen=True)
class MeshScene:
    """Flattened BVH and triangles on one device: the JAX MeshScene's
    fields, which the plain version reads, and the kernel's records `nodes`
    (pack_nodes) and `tris` (pack_tris)."""

    bounds_min: torch.Tensor  # (n_nodes, 3) f32
    bounds_max: torch.Tensor
    first: torch.Tensor       # (n_nodes,) i32
    count: torch.Tensor
    miss_link: torch.Tensor
    tri_v0: torch.Tensor      # (n_prims, 3) f32
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    nodes: torch.Tensor       # (n_nodes, 8) f32
    tris: torch.Tensor        # (n_prims, 12) f32

    @classmethod
    def from_arrays(cls, device, **a) -> "MeshScene":
        """The scene of the BVH arrays `a` (bounds_min, bounds_max, first,
        count, miss_link, tri_v0, tri_e1, tri_e2; numpy) on `device`, the
        records packed on the host."""
        a = {k: np.array(a[k], np.int32 if k in ("first", "count", "miss_link") else np.float32,
                         copy=True) for k in _SOA}
        nodes = pack_nodes(a["bounds_min"], a["bounds_max"], a["first"], a["count"],
                           a["miss_link"])
        tris = pack_tris(a["tri_v0"], a["tri_e1"], a["tri_e2"])
        t = {k: torch.as_tensor(v, device=device) for k, v in a.items()}
        return cls(**t, nodes=torch.as_tensor(nodes, device=device),
                   tris=torch.as_tensor(tris, device=device))

    @property
    def n_nodes(self) -> int:
        return int(self.first.shape[0])

    @property
    def n_prims(self) -> int:
        return int(self.tri_v0.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    @property
    def kernel_nbytes(self) -> int:
        """Bytes of the records the kernel reads."""
        return sum(t.numel() * t.element_size() for t in (self.nodes, self.tris))

    def to(self, device) -> "MeshScene":
        return MeshScene(*(getattr(self, f).to(device) for f in self.__dataclass_fields__))

    def kernel_args(self, face_normals=None, max_iters: int = 0) -> "_kernels.MeshArgs":
        """The kernels' view of the BVH; `face_normals` (n_prims, 3) in BVH
        order where the kernel shades the hit."""
        fields = [self.nodes, self.tris]
        if face_normals is not None:
            fields.append(face_normals)
        _kernels.require_cuda("mesh", *fields)
        return mesh_args(self, face_normals, max_iters)


def mesh_args(scene: MeshScene, face_normals=None, max_iters: int = 0) -> "_kernels.MeshArgs":
    """MeshScene.kernel_args on the scene's own device, unchecked: the TLAS's
    table holds its BLASes' views whatever the device (the CPU's for the
    kernels' host build)."""
    return _kernels.MeshArgs(
        _kernels.ptr(scene.nodes), _kernels.ptr(scene.tris),
        None if face_normals is None else _kernels.ptr(face_normals),
        scene.n_nodes, scene.n_prims, max_iters if max_iters > 0 else 4 * scene.n_nodes + 64)


_SOA = ("bounds_min", "bounds_max", "first", "count", "miss_link", "tri_v0", "tri_e1", "tri_e2")


def mesh_scene(bvh: BvhArrays, device="cuda") -> Tuple[MeshScene, int]:
    """The BVH's arrays and the kernel's records on `device`, the card
    unless device="cpu"."""
    from ..pt.terrain_ref import resolve_device

    device = resolve_device(device)
    scene = MeshScene.from_arrays(
        device, bounds_min=bvh.bounds_min, bounds_max=bvh.bounds_max, first=bvh.first,
        count=bvh.count, miss_link=bvh.miss_link, tri_v0=bvh.tri_v0, tri_e1=bvh.tri_e1,
        tri_e2=bvh.tri_e2)
    return scene, bvh.node_count


class MeshHit(NamedTuple):
    hit: torch.Tensor   # bool
    t: torch.Tensor     # f32 (tmax where missed)
    prim: torch.Tensor  # i32 (reordered-primitive id; map back via prim_index), -1 on a miss
    u: torch.Tensor     # f32 barycentric
    v: torch.Tensor


def _moller_trumbore(scene: MeshScene, pid, ro, rd, tmin, tmax):
    """Moller-Trumbore for one gathered triangle per lane."""
    p = pid.to(torch.int64)
    v0 = scene.tri_v0[p].unbind(-1)
    e1 = scene.tri_e1[p].unbind(-1)
    e2 = scene.tri_e2[p].unbind(-1)
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    px = rdy * e2[2] - rdz * e2[1]
    py = rdz * e2[0] - rdx * e2[2]
    pz = rdx * e2[1] - rdy * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    big = det.abs() > 1e-12
    inv_det = torch.where(big, fdiv(1.0, torch.where(big, det, 1.0)), 0.0)
    sx, sy, sz = rox - v0[0], roy - v0[1], roz - v0[2]
    u = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1[2] - sz * e1[1]
    qy = sz * e1[0] - sx * e1[2]
    qz = sx * e1[1] - sy * e1[0]
    v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    ok = big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < tmax)
    return ok, t, u, v


def _inv(d):
    """Sign-keeping reciprocal with +-1e12 for |d| <= 1e-12."""
    big = d.abs() > 1e-12
    return torch.where(big, fdiv(1.0, torch.where(big, d, 1.0)),
                       torch.where(d >= 0, 1e12, -1e12))


def _as_rays(ro, rd):
    comps = torch.broadcast_tensors(*(torch.as_tensor(c).to(torch.float32)
                                      for c in (*ro, *rd)))
    return comps[0].shape, [c.reshape(-1) for c in comps]


def trace_mesh_plain(scene: MeshScene, n_nodes: int, ro, rd, tmin=1e-4, tmax=1e30,
                     max_leaf_size: int = _LEAF_SIZE, max_iters: int = 0) -> MeshHit:
    """Plain PyTorch version of K9. Steps all live rays in lock step like
    the JAX version and drops rays from the batch as they leave the tree;
    per-ray results do not depend on the batch."""
    shape, (rox, roy, roz, rdx, rdy, rdz) = _as_rays(ro, rd)
    dev = rox.device
    n = rox.numel()
    if max_iters <= 0:
        max_iters = 4 * n_nodes + 64
    tmin = float(np.float32(tmin))
    best_out = torch.full((n,), float(np.float32(tmax)), dtype=torch.float32, device=dev)
    prim_out = torch.full((n,), -1, dtype=_I32, device=dev)
    u_out = torch.zeros(n, dtype=torch.float32, device=dev)
    v_out = torch.zeros(n, dtype=torch.float32, device=dev)
    last = scene.n_prims - 1

    idx = torch.arange(n, device=dev)
    cols = torch.stack([rox, roy, roz, rdx, rdy, rdz, _inv(rdx), _inv(rdy), _inv(rdz)], 1)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    best, prim, uu, vv = best_out.clone(), prim_out.clone(), u_out.clone(), v_out.clone()
    for _ in range(max_iters):
        if idx.numel() == 0:
            break
        trace_mesh_plain.node_visits += idx.numel()
        r_ox, r_oy, r_oz, r_dx, r_dy, r_dz, ix, iy, iz = cols.unbind(1)
        bmin = scene.bounds_min[node].unbind(-1)
        bmax = scene.bounds_max[node].unbind(-1)
        t0x, t1x = (bmin[0] - r_ox) * ix, (bmax[0] - r_ox) * ix
        t0y, t1y = (bmin[1] - r_oy) * iy, (bmax[1] - r_oy) * iy
        t0z, t1z = (bmin[2] - r_oz) * iz, (bmax[2] - r_oz) * iz
        t_enter = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                                torch.clamp(torch.minimum(t0z, t1z), min=tmin))
        t_exit = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                               torch.minimum(torch.maximum(t0z, t1z), best))
        box_hit = t_enter <= t_exit
        cnt = scene.count[node]
        fst = scene.first[node]
        is_leaf = cnt > 0
        for k in range(max_leaf_size):
            active = box_hit & is_leaf & (k < cnt)
            n_active = int(active.sum())
            if n_active == 0:
                break
            trace_mesh_plain.tri_tests += n_active
            pid = torch.clamp(fst + k, max=last)
            ok, t, tu, tv = _moller_trumbore(scene, pid, (r_ox, r_oy, r_oz), (r_dx, r_dy, r_dz),
                                             tmin, best)
            take = active & ok
            best = torch.where(take, t, best)
            prim = torch.where(take, pid, prim)
            uu = torch.where(take, tu, uu)
            vv = torch.where(take, tv, vv)
        node = torch.where(box_hit & ~is_leaf, node + 1,
                           scene.miss_link[node].to(torch.int64))
        done = node >= n_nodes
        if bool(done.any()):
            d = idx[done]
            best_out[d], prim_out[d], u_out[d], v_out[d] = best[done], prim[done], uu[done], vv[done]
            keep = ~done
            idx, cols, node = idx[keep], cols[keep], node[keep]
            best, prim, uu, vv = best[keep], prim[keep], uu[keep], vv[keep]
    # rays still in the tree at the iteration cap keep their state
    best_out[idx], prim_out[idx], u_out[idx], v_out[idx] = best, prim, uu, vv
    return MeshHit(hit=(prim_out >= 0).reshape(shape), t=best_out.reshape(shape),
                   prim=prim_out.reshape(shape), u=u_out.reshape(shape), v=v_out.reshape(shape))


# The work the data needed, summed over calls (rays x nodes visited, and
# triangles tested): read by chip_smoke.py for the kernels' bounds.
trace_mesh_plain.node_visits = 0
trace_mesh_plain.tri_tests = 0


def _trace_mesh_kernel(scene: MeshScene, n_nodes: int, ro, rd, tmin, tmax,
                       max_iters: int = 0) -> MeshHit:
    shape, comps = _as_rays(ro, rd)
    comps = [c.contiguous() for c in comps]
    _kernels.require_cuda("trace_mesh", *comps)
    dev = comps[0].device
    n = comps[0].numel()
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=_I32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    err = _kernels.lib().f3d_trace_mesh(
        scene.kernel_args(max_iters=max_iters), *(_kernels.ptr(c) for c in comps), n,
        float(np.float32(tmin)), float(np.float32(tmax)), _kernels.ptr(hit), _kernels.ptr(t),
        _kernels.ptr(prim), _kernels.ptr(u), _kernels.ptr(v), _kernels.stream_ptr(dev))
    _kernels.check(err, "K9 trace_mesh")
    trace_mesh.launches += 1
    return MeshHit(hit.reshape(shape), t.reshape(shape), prim.reshape(shape),
                   u.reshape(shape), v.reshape(shape))


def trace_mesh(scene: MeshScene, n_nodes: int, ro, rd, tmin=1e-4, tmax=1e30,
               max_iters: int = 0) -> MeshHit:
    """Closest hit of each ray against the mesh (kernel K9). CPU tensors run
    `trace_mesh_plain`; CUDA tensors launch the kernel."""
    if n_nodes != scene.n_nodes:
        raise ValueError(f"n_nodes {n_nodes} does not match the scene's {scene.n_nodes}")
    if rd[0].device.type == "cpu":
        return trace_mesh_plain(scene, n_nodes, ro, rd, tmin, tmax, max_iters=max_iters)
    return _trace_mesh_kernel(scene, n_nodes, ro, rd, tmin, tmax, max_iters)


trace_mesh.launches = 0
