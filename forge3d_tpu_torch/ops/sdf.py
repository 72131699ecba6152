# forge3d_tpu_torch/ops/sdf.py
# Kernel P6: signed-distance-field primitives, CSG trees and the sphere
# tracer (forge3d_tpu/ops/sdf.py): the builder's node ids and errors, the
# post-order tape with its stack depth, and `evaluate`, `normal` and
# `raymarch` over point and ray batches of any shape.
#
# A scene lives on one device. On CPU tensors `evaluate` and `raymarch` run
# their plain PyTorch versions; on CUDA tensors they launch the kernels
# (csrc/pt.cu: sdf_eval_kernel, sdf_normal_kernel, sdf_march_kernel over
# csrc/sdf.cuh), counted in `sdf_eval.launches` and `sdf_march.launches`.
#
# The plain versions step the tape once per batch, computing only the
# primitive or operation of each instruction (JAX computes every branch of
# its lax.switch and keeps one; the untaken branches never reach the
# result). XLA compiles the tape loop with each a*b + c fused into one
# multiply-add; the plain versions round those sums once too (`fma32`) and
# take the correctly rounded square root (`sqrt32`), as the kernel's fmaf
# and sqrtf do.
#
# The kernels read the tape packed (`pack_tape`, made when the scene is
# compiled), from shared memory up to SHARED_TAPE entries; `kernel_instance`
# names the instantiation a tape takes, and the wrappers count launches by
# it.

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field, replace
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from .shading import fdiv, fma32, sqrt32

_F32 = torch.float32
_I32 = torch.int32

# primitive kinds
SPHERE, BOX, CYLINDER, PLANE, TORUS, CAPSULE = range(6)
# op kinds
UNION, INTERSECTION, SUBTRACTION, SMOOTH_UNION, SMOOTH_INTERSECTION, SMOOTH_SUBTRACTION = range(6)

#: the deepest value stack the kernels hold (csrc/sdf.cuh:F3D_SDF_STACK); the
#: builder refuses trees deeper than 64, whose tapes need at most 66
MAX_STACK = 66

#: the longest tape the kernels copy to shared memory
#: (csrc/sdf.cuh:F3D_SDF_SHARED); longer ones are read from global memory
SHARED_TAPE = 1024

#: the march's hit threshold that the cull box is derived for (the hybrid
#: tracer's, csrc/pt.cuh:F3D_SDF_HIT)
CULL_THRESHOLD = 1e-3


def pack_tape(is_op, kind, params, smoothing, material) -> np.ndarray:
    """(T, 12) float32: the kernels' packed tape (csrc/sdf.cuh), an entry a
    row of three 16-byte words: is_op, kind and material as int32 bits and
    the smoothing, then the 8 params."""
    n = len(kind)
    out = np.zeros((n, 12), np.float32)
    ints = out.view(np.int32)
    ints[:, 0] = np.asarray(is_op, np.int32)
    ints[:, 1] = np.asarray(kind, np.int32)
    ints[:, 2] = np.asarray(material, np.int32)
    out[:, 3] = np.asarray(smoothing, np.float32)
    out[:, 4:] = np.asarray(params, np.float32).reshape(n, 8)
    return out


@dataclass
class _Prim:
    kind: int
    params: Tuple[float, ...]   # packed, kind-specific (8 floats)
    material_id: int


@dataclass
class _Op:
    kind: int
    left: int
    right: int
    smoothing: float
    material_id: int


@dataclass
class SdfSceneBuilder:
    """Builder with the reference's add_*/union/... node-id contract:
    primitives are ids 0..P-1 in add order, operations follow."""

    _prims: List[_Prim] = field(default_factory=list)
    _ops: List[_Op] = field(default_factory=list)

    def add_sphere(self, center, radius, material_id=0) -> int:
        if radius <= 0:
            raise ValueError("radius must be > 0")
        self._prims.append(_Prim(SPHERE, (*center, radius, 0, 0, 0, 0), material_id))
        return len(self._prims) - 1

    def add_box(self, center, half_extents, material_id=0) -> int:
        self._prims.append(_Prim(BOX, (*center, *half_extents, 0, 0), material_id))
        return len(self._prims) - 1

    def add_cylinder(self, center, radius, half_height, material_id=0) -> int:
        self._prims.append(_Prim(CYLINDER, (*center, radius, half_height, 0, 0, 0), material_id))
        return len(self._prims) - 1

    def add_plane(self, normal, distance, material_id=0) -> int:
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)
        self._prims.append(_Prim(PLANE, (*n, distance, 0, 0, 0, 0), material_id))
        return len(self._prims) - 1

    def add_torus(self, center, major_radius, minor_radius, material_id=0) -> int:
        self._prims.append(_Prim(TORUS, (*center, major_radius, minor_radius, 0, 0, 0),
                                 material_id))
        return len(self._prims) - 1

    def add_capsule(self, point_a, point_b, radius, material_id=0) -> int:
        self._prims.append(_Prim(CAPSULE, (*point_a, *point_b, radius, 0), material_id))
        return len(self._prims) - 1

    def _op(self, kind, left, right, smoothing, material_id) -> int:
        n = len(self._prims) + len(self._ops)
        if left >= n or right >= n or left < 0 or right < 0:
            raise ValueError("operation references unknown node id")
        self._ops.append(_Op(kind, left, right, smoothing, material_id))
        return len(self._prims) + len(self._ops) - 1

    def union(self, left, right, material_id=0) -> int:
        return self._op(UNION, left, right, 0.0, material_id)

    def intersect(self, left, right, material_id=0) -> int:
        return self._op(INTERSECTION, left, right, 0.0, material_id)

    def subtract(self, left, right, material_id=0) -> int:
        return self._op(SUBTRACTION, left, right, 0.0, material_id)

    def smooth_union(self, left, right, smoothing, material_id=0) -> int:
        return self._op(SMOOTH_UNION, left, right, smoothing, material_id)

    def smooth_intersect(self, left, right, smoothing, material_id=0) -> int:
        return self._op(SMOOTH_INTERSECTION, left, right, smoothing, material_id)

    def smooth_subtract(self, left, right, smoothing, material_id=0) -> int:
        return self._op(SMOOTH_SUBTRACTION, left, right, smoothing, material_id)

    def build(self, root: Optional[int] = None, *, device="cuda") -> "SdfScene":
        """The compiled scene on `device`, the card unless device="cpu"."""
        if not self._prims:
            raise ValueError("SDF scene has no primitives")
        n = len(self._prims) + len(self._ops)
        root = n - 1 if root is None else root
        return SdfScene._compile(self._prims, self._ops, root, device=device)


class SdfTape(NamedTuple):
    """Post-order instruction tape (tensors on the scene's device)."""

    is_op: torch.Tensor       # (T,) bool
    kind: torch.Tensor        # (T,) i32 (prim kind or op kind)
    params: torch.Tensor      # (T, 8) f32
    smoothing: torch.Tensor   # (T,) f32
    material: torch.Tensor    # (T,) i32


class SdfHit(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor
    material: torch.Tensor


@dataclass(frozen=True)
class SdfScene:
    """Compiled SDF scene: evaluate/normal/raymarch over point batches."""

    tape: SdfTape
    tape_len: int
    stack_depth: int
    primitive_count: int
    node_count: int
    bounds: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None
    # the tape on the host, read by the plain versions' Python loop
    host: Optional[tuple] = field(default=None, repr=False, compare=False)
    # the hybrid tracer's cull box (cull_box): (0 none, 1 box, 2 never a hit; lo; hi)
    cull: tuple = field(default=(0, (0.0,) * 3, (0.0,) * 3), repr=False, compare=False)
    # the kernels' packed tape (pack_tape) on the scene's device
    packed: Optional[torch.Tensor] = field(default=None, repr=False, compare=False)

    @staticmethod
    def _compile(prims: List[_Prim], ops: List[_Op], root: int, device="cuda") -> "SdfScene":
        from ..pt.terrain_ref import resolve_device

        n_p = len(prims)
        # post-order DFS from the root over the DAG (shared subtrees are
        # re-emitted, so the tape needs no random access)
        post: List[Tuple[bool, int]] = []

        def walk(node: int, depth: int = 0):
            if depth > 64:
                raise ValueError("CSG tree too deep (cycle?)")
            if node < n_p:
                post.append((False, node))
            else:
                op = ops[node - n_p]
                walk(op.left, depth + 1)
                walk(op.right, depth + 1)
                post.append((True, node - n_p))

        walk(root)
        device = resolve_device(device)
        is_op, kind, params, smoothing, material = [], [], [], [], []
        depth = max_depth = 0
        for o, i in post:
            if o:
                op = ops[i]
                is_op.append(True)
                kind.append(op.kind)
                params.append([0.0] * 8)
                smoothing.append(op.smoothing)
                material.append(op.material_id)
                depth -= 1  # two pops, one push
            else:
                p = prims[i]
                is_op.append(False)
                kind.append(p.kind)
                params.append(list(p.params) + [0.0] * (8 - len(p.params)))
                smoothing.append(0.0)
                material.append(p.material_id)
                depth += 1
                max_depth = max(max_depth, depth)
        return SdfScene.from_arrays(np.asarray(is_op, bool), np.asarray(kind, np.int32),
                                    np.asarray(params, np.float32),
                                    np.asarray(smoothing, np.float32),
                                    np.asarray(material, np.int32), max(max_depth, 1), n_p,
                                    n_p + len(ops), device=device)

    @staticmethod
    def from_arrays(is_op, kind, params, smoothing, material, stack_depth: int,
                    primitive_count: int, node_count: int, bounds=None,
                    device="cuda") -> "SdfScene":
        """A scene from its tape arrays (numpy), as `_compile` makes them."""
        if stack_depth > MAX_STACK:
            raise ValueError(f"SDF tape needs a stack of {stack_depth}, above {MAX_STACK}")
        arrs = (np.array(is_op, bool), np.array(kind, np.int32),
                np.array(params, np.float32).reshape(-1, 8),
                np.array(smoothing, np.float32), np.array(material, np.int32))
        tape = SdfTape(*(torch.as_tensor(a, device=device) for a in arrs))
        host = tuple((bool(o), int(k), [float(v) for v in prm], float(s), int(m))
                     for o, k, prm, s, m in zip(*arrs))
        return SdfScene(tape=tape, tape_len=len(host), stack_depth=int(stack_depth),
                        primitive_count=int(primitive_count), node_count=int(node_count),
                        bounds=bounds, host=host, cull=cull_box(host),
                        packed=torch.as_tensor(pack_tape(*arrs), device=device))

    def with_bounds(self, bmin, bmax) -> "SdfScene":
        return replace(self, bounds=(tuple(float(v) for v in bmin),
                                     tuple(float(v) for v in bmax)))

    @property
    def device(self) -> torch.device:
        return self.tape.kind.device

    def to(self, device) -> "SdfScene":
        return replace(self, tape=SdfTape(*(t.to(device) for t in self.tape)),
                       packed=self.packed.to(device))

    def kernel_args(self) -> "_kernels.SdfArgs":
        _kernels.require_cuda("sdf", self.packed)
        return _kernels.SdfArgs(_kernels.ptr(self.packed), self.tape_len, self.stack_depth,
                                self.cull[0], _kernels._F3(*self.cull[1]),
                                _kernels._F3(*self.cull[2]), _f32(CULL_THRESHOLD))

    def _points(self, *comps):
        comps = torch.broadcast_tensors(*(torch.as_tensor(c, device=self.device).to(_F32)
                                          for c in comps))
        return comps[0].shape, [c.reshape(-1).contiguous() for c in comps]

    # -- evaluation --------------------------------------------------------
    def evaluate(self, px, py, pz):
        """Distance (+ material of the winning leaf/op) at points of any
        shape. Returns (distance, material_id)."""
        shape, (x, y, z) = self._points(px, py, pz)
        d, m = sdf_eval(self, x, y, z)
        return d.reshape(shape), m.reshape(shape)

    def normal(self, px, py, pz, eps: float = 1e-4):
        """Central-difference gradient normal."""
        shape, (x, y, z) = self._points(px, py, pz)
        n = sdf_normal(self, x, y, z, eps)
        return tuple(c.reshape(shape) for c in n)

    def raymarch(self, ro, rd, tmin=1e-3, tmax=100.0, max_steps: int = 128,
                 hit_eps: float = 1e-3):
        """Sphere tracing. Returns (hit, t, material_id)."""
        shape, comps = self._points(*ro, *rd)
        h = sdf_march(self, comps[:3], comps[3:], tmin, tmax, max_steps, hit_eps)
        return tuple(c.reshape(shape) for c in h)


# ---------------------------------------------------------------------------
# The hybrid tracer's cull box (csrc/sdf.cuh states the argument)
# ---------------------------------------------------------------------------

_ALL, _EMPTY = "all", "empty"   # unbounded; below the level nowhere
_MAX_COORD = 2.0 ** 40          # sdf.cuh:sdf_cull_span culls no ray beyond it


def _prim_box(kind: int, prm, c: float):
    """The box outside which primitive `kind` (float64 params) is >= c."""
    pos = lambda v: max(v, 0.0)  # noqa: E731
    if kind == PLANE:
        return _ALL
    if kind == SPHERE:
        half = [pos(prm[3]) + c] * 3
    elif kind == BOX:
        half = [pos(prm[3 + k]) + c for k in range(3)]
    elif kind == CYLINDER:
        half = [pos(prm[3]) + c, pos(prm[4]) + c, pos(prm[3]) + c]
    elif kind == TORUS:
        r = pos(prm[3]) + pos(prm[4]) + c
        half = [r, pos(prm[4]) + c, r]
    else:   # capsule: the segment's box
        r = pos(prm[6]) + c
        return ([min(prm[k], prm[3 + k]) - r for k in range(3)],
                [max(prm[k], prm[3 + k]) + r for k in range(3)])
    return [prm[k] - half[k] for k in range(3)], [prm[k] + half[k] for k in range(3)]


def _join(kind: int, a, b):
    """A node's box from its operands' (union / intersection / left)."""
    if kind in (SUBTRACTION, SMOOTH_SUBTRACTION):
        return a
    if kind in (UNION, SMOOTH_UNION):
        if _ALL in (a, b):
            return _ALL
        if a == _EMPTY or b == _EMPTY:
            return b if a == _EMPTY else a
        return ([min(x, y) for x, y in zip(a[0], b[0])], [max(x, y) for x, y in zip(a[1], b[1])])
    if _EMPTY in (a, b):
        return _EMPTY
    if a == _ALL or b == _ALL:
        return b if a == _ALL else a
    lo = [max(x, y) for x, y in zip(a[0], b[0])]
    hi = [min(x, y) for x, y in zip(a[1], b[1])]
    return _EMPTY if any(x > y for x, y in zip(lo, hi)) else (lo, hi)


def cull_box(host) -> tuple:
    """The hybrid tracer's cull box of a tape (`SdfScene.host`): (1, lo,
    hi), float32 bounds outside which the tape's float32 value is >=
    CULL_THRESHOLD at every point; (2, ...) if it is nowhere below it; (0,
    ...) if no box holds (an unbounded root, or parameters beyond 2^40).
    Derived top-down in float64, each node's level c from its parent's
    (csrc/sdf.cuh gives the rules and the margin), then rounded outward."""
    none = (0, (0.0,) * 3, (0.0,) * 3)
    n = len(host)
    kids, stack = [None] * n, []
    for i, (is_op, *_rest) in enumerate(host):
        if is_op:
            if len(stack) < 2:
                return none
            r, l = stack.pop(), stack.pop()
            kids[i] = (l, r)
        stack.append(i)
    if len(stack) != 1:
        return none
    f32 = np.float32
    S = sum(abs(float(k)) for is_op, _, _, k, _ in host if is_op) + max(
        [abs(float(v)) for is_op, _, prm, _, _ in host if not is_op for v in prm] + [0.0])
    if not np.isfinite(S) or S > _MAX_COORD:
        return none
    eps = 2.0 ** -16 * (4.0 * S + 1.0)
    level = [0.0] * n
    level[stack[0]] = float(f32(CULL_THRESHOLD))
    for i in reversed(range(n)):       # a parent precedes its operands here
        is_op, kind, _, k, _ = host[i]
        if not is_op:
            continue
        k, c = float(k), level[i]
        if kind == SMOOTH_UNION:
            c = c + max(k, 0.0) / 4.0 + eps
        elif kind in (SMOOTH_INTERSECTION, SMOOTH_SUBTRACTION):
            c = c + eps + (0.0 if k >= float(f32(1e-6)) else 1e-6 + max(-k, 0.0) / 4.0)
        level[kids[i][0]] = level[kids[i][1]] = c
    box = [None] * n
    for i, (is_op, kind, prm, _, _) in enumerate(host):
        if is_op:
            box[i] = _join(kind, box[kids[i][0]], box[kids[i][1]])
        else:
            box[i] = _prim_box(kind, [float(v) for v in prm], level[i] + eps)
    root = box[stack[0]]
    if root == _ALL:
        return none
    if root == _EMPTY:
        return (2, (0.0,) * 3, (0.0,) * 3)
    lo = np.asarray(root[0], np.float64)
    hi = np.asarray(root[1], np.float64)
    if np.abs(np.concatenate([lo, hi])).max() > _MAX_COORD:
        return none
    lo32, hi32 = lo.astype(f32), hi.astype(f32)
    lo32 = np.where(lo32.astype(np.float64) > lo, np.nextafter(lo32, f32(-np.inf)), lo32)
    hi32 = np.where(hi32.astype(np.float64) < hi, np.nextafter(hi32, f32(np.inf)), hi32)
    return (1, tuple(float(v) for v in lo32), tuple(float(v) for v in hi32))


def sdf_cull_span_plain(scene: SdfScene, ro, rd, tmin: float, tmax, hit_eps: float = 1e-3):
    """Plain version of csrc/sdf.cuh:sdf_cull_span on flat float32 rays and
    a march with threshold `hit_eps`: (march, tmax) -- whether each ray's
    march runs, and its tmax lowered to the cull box's exit (float32)."""
    dev = rd[0].device
    n = rd[0].numel()
    tm = torch.as_tensor(tmax, dtype=_F32, device=dev).expand(n).clone()
    flag, blo, bhi = scene.cull
    if flag == 0 or not _f32(hit_eps) <= _f32(CULL_THRESHOLD):
        return torch.ones(n, dtype=torch.bool, device=dev), tm
    if flag == 2:
        return torch.zeros(n, dtype=torch.bool, device=dev), tm
    o = [c.reshape(-1) for c in ro]
    d = [c.reshape(-1) for c in rd]
    sane = torch.ones(n, dtype=torch.bool, device=dev)
    for a in range(3):
        sane &= (o[a].abs() <= _MAX_COORD) & (d[a].abs() <= 256.0)
    f64 = torch.float64
    t0 = torch.full((n,), -np.inf, dtype=f64, device=dev)
    t1 = torch.full((n,), np.inf, dtype=f64, device=dev)
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    for a in range(3):
        oa, da = o[a].to(f64), d[a].to(f64)
        zero = da == 0.0
        out |= zero & ((oa < blo[a]) | (oa > bhi[a]))
        inv = 1.0 / torch.where(zero, torch.ones_like(da), da)
        ta, tb = (blo[a] - oa) * inv, (bhi[a] - oa) * inv
        lo_t, hi_t = torch.minimum(ta, tb), torch.maximum(ta, tb)
        t0 = torch.where(zero, t0, torch.maximum(t0, lo_t))
        t1 = torch.where(zero, t1, torch.minimum(t1, hi_t))
    t0 = t0 - t0.abs() * 2.0 ** -40
    t1 = t1 + t1.abs() * 2.0 ** -40
    out |= (t0 > t1) | (t1 < float(np.float32(tmin))) | (t0 > tm.to(f64))
    exit_ = t1.to(_F32)
    up = torch.nextafter(exit_, torch.full_like(exit_, np.inf))
    exit_ = torch.where(exit_.to(f64) < t1, up, exit_)
    march = ~(sane & out)
    tm = torch.where(sane & ~out, torch.minimum(exit_, tm), tm)
    return march, tm


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _dot3(a1, b1, a2, b2, a3, b3):
    """a1*b1 + a2*b2 + a3*b3 as XLA fuses it (a search over the contraction
    trees matched JAX on every point): a2*b2 rounded, a1*b1 added to it in
    one multiply-add, then a3*b3 in another."""
    return fma32(a3, b3, fma32(a1, b1, a2 * b2))


def _hypot3(a, b, c):
    return sqrt32(_dot3(a, a, b, b, c, c))


def _hypot2(a, b):
    """sqrt(a^2 + b^2): a^2 fused into the add, b^2 rounded."""
    return sqrt32(fma32(a, a, b * b))


def prim_dist(kind: int, prm, px, py, pz):
    """ops/sdf.py:prim_dist for one primitive of `kind` with params `prm`
    (float32 values)."""
    if kind == SPHERE:
        return _hypot3(px - prm[0], py - prm[1], pz - prm[2]) - prm[3]
    if kind == BOX:
        qx = (px - prm[0]).abs() - prm[3]
        qy = (py - prm[1]).abs() - prm[4]
        qz = (pz - prm[2]).abs() - prm[5]
        mx, my, mz = qx.clamp(min=0.0), qy.clamp(min=0.0), qz.clamp(min=0.0)
        # here XLA fuses the later square of each sum
        outer = sqrt32(fma32(mz, mz, fma32(my, my, mx * mx)))
        inner = torch.clamp(torch.maximum(qx, torch.maximum(qy, qz)), max=0.0)
        return outer + inner
    if kind == CYLINDER:
        dxz = _hypot2(px - prm[0], pz - prm[2]) - prm[3]
        dy = (py - prm[1]).abs() - prm[4]
        return (torch.clamp(torch.maximum(dxz, dy), max=0.0)
                + _hypot2(dxz.clamp(min=0.0), dy.clamp(min=0.0)))
    if kind == PLANE:
        return _dot3(px, prm[0], py, prm[1], pz, prm[2]) - prm[3]
    if kind == TORUS:
        tq = _hypot2(px - prm[0], pz - prm[2]) - prm[3]
        return _hypot2(tq, py - prm[1]) - prm[4]
    if kind == CAPSULE:
        pax, pay, paz = px - prm[0], py - prm[1], pz - prm[2]
        ba = [_f32(prm[3] - prm[0]), _f32(prm[4] - prm[1]), _f32(prm[5] - prm[2])]
        b0 = torch.tensor(ba[0], dtype=_F32)
        den = max(float(_dot3(b0, ba[0], ba[1], ba[1], ba[2], ba[2])), _f32(1e-12))
        dot = _dot3(pax, ba[0], pay, ba[1], paz, ba[2])
        h = torch.clamp(fdiv(dot, den), 0.0, 1.0)
        ex = fma32(h, -ba[0], pax)
        ey = fma32(h, -ba[1], pay)
        ez = fma32(h, -ba[2], paz)
        return _hypot3(ex, ey, ez) - prm[6]
    raise ValueError(f"unknown SDF primitive kind {kind}")


def _f32(x) -> float:
    return float(np.float32(x))


def apply_op(kind: int, k: float, d1, m1, d2, m2):
    """ops/sdf.py:apply_op for one operation of `kind` (d1 left, d2 right)."""
    if kind == UNION:
        return torch.minimum(d1, d2), torch.where(d1 <= d2, m1, m2)
    if kind == INTERSECTION:
        return torch.maximum(d1, d2), torch.where(d1 >= d2, m1, m2)
    if kind == SUBTRACTION:
        return torch.maximum(d1, -d2), m1
    kk = max(_f32(k), _f32(1e-6))
    if kind == SMOOTH_UNION:
        h = torch.clamp(0.5 + fdiv(0.5 * (d2 - d1), kk), 0.0, 1.0)
        return (fma32(-(k * h), 1.0 - h, fma32(d1 - d2, h, d2)),
                torch.where(d1 <= d2, m1, m2))
    if kind == SMOOTH_INTERSECTION:
        h = torch.clamp(0.5 - fdiv(0.5 * (d2 - d1), kk), 0.0, 1.0)
        return (fma32(k * h, 1.0 - h, fma32(d1 - d2, h, d2)),
                torch.where(d1 >= d2, m1, m2))
    if kind == SMOOTH_SUBTRACTION:
        h = torch.clamp(0.5 - fdiv(0.5 * (d2 + d1), kk), 0.0, 1.0)
        return fma32(k * h, 1.0 - h, fma32(-d2 - d1, h, d1)), m1
    raise ValueError(f"unknown SDF operation kind {kind}")


def sdf_eval_plain(scene: SdfScene, px, py, pz):
    """Plain PyTorch version of the tape evaluation (flat point tensors)."""
    dstack, mstack = [], []
    for is_op, kind, prm, k, mat in scene.host:
        if is_op:
            d2, m2 = dstack.pop(), mstack.pop()
            d1, m1 = dstack.pop(), mstack.pop()
            d, m = apply_op(kind, _f32(k), d1, m1, d2, m2)
        else:
            d = prim_dist(kind, [_f32(v) for v in prm], px, py, pz)
            m = torch.full(px.shape, mat, dtype=_I32, device=px.device)
        dstack.append(d)
        mstack.append(m)
    return dstack[0], mstack[0]


def sdf_normal_plain(scene: SdfScene, px, py, pz, eps: float = 1e-4):
    """SdfScene.normal: six evaluations, then the normalisation in JAX's
    eager float32 order (each operation rounded)."""
    e = _f32(eps)

    def d(x, y, z):
        return sdf_eval_plain(scene, x, y, z)[0]

    nx = d(px + e, py, pz) - d(px - e, py, pz)
    ny = d(px, py + e, pz) - d(px, py - e, pz)
    nz = d(px, py, pz + e) - d(px, py, pz - e)
    return _normalise(nx, ny, nz)


def _normalise(nx, ny, nz):
    inv = fdiv(1.0, sqrt32(nx * nx + ny * ny + nz * nz + 1e-20))
    return nx * inv, ny * inv, nz * inv


def sdf_march_plain(scene: SdfScene, ro, rd, tmin=1e-3, tmax=100.0, max_steps: int = 128,
                    hit_eps: float = 1e-3) -> SdfHit:
    """Plain version of the sphere tracer: all live rays in lock step, as
    JAX steps them, dropping rays from the batch once done (a done lane
    never changes in JAX's loop, so this changes no value)."""
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    n = rox.numel()
    dev = rox.device
    t_out = torch.full((n,), _f32(tmin), dtype=_F32, device=dev)
    hit_out = torch.zeros(n, dtype=torch.bool, device=dev)
    mat_out = torch.full((n,), -1, dtype=_I32, device=dev)
    idx = torch.arange(n, device=dev)
    t = t_out.clone()
    eps, half = _f32(hit_eps), _f32(hit_eps * 0.5)
    # a tensor tmax is a ray's own (the hybrid tracer's culled marches)
    tmx = tmax.to(dev).clone() if torch.is_tensor(tmax) else _f32(tmax)
    cols = torch.stack([rox, roy, roz, rdx, rdy, rdz], 1)
    for _ in range(int(max_steps)):
        if idx.numel() == 0:
            break
        sdf_march_plain.steps += idx.numel()
        ox, oy, oz, dx, dy, dz = cols.unbind(1)
        d, m = sdf_eval_plain(scene, fma32(t, dx, ox), fma32(t, dy, oy), fma32(t, dz, oz))
        got = d < eps
        over = t > tmx
        t = torch.where(got, t, t + torch.clamp(d, min=half))
        done = got | over
        if bool(done.any()):
            sel = idx[done]
            t_out[sel] = t[done]
            hit_out[sel] = got[done]
            mat_out[sel] = torch.where(got, m, -1)[done]
            keep = ~done
            idx, cols, t = idx[keep], cols[keep], t[keep]
            if torch.is_tensor(tmx):
                tmx = tmx[keep]
    t_out[idx] = t
    return SdfHit(hit_out, t_out, mat_out)


# The work the data needed, summed over calls (rays x march steps): read by
# chip_smoke.py for the kernels' bounds.
sdf_march_plain.steps = 0


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def kernel_instance(scene: SdfScene) -> str:
    """The instantiation P6's kernels take for `scene`'s tape (csrc/pt.cu:
    F3D_SDF_PICK): where the tape is read from."""
    return "shared tape" if scene.tape_len <= SHARED_TAPE else "global tape"


def _sdf_eval_kernel(scene: SdfScene, px, py, pz):
    _kernels.require_cuda("sdf_eval", px, py, pz)
    n = px.numel()
    d = torch.empty(n, dtype=_F32, device=px.device)
    m = torch.empty(n, dtype=_I32, device=px.device)
    err = _kernels.lib().f3d_sdf_eval(scene.kernel_args(), _kernels.ptr(px), _kernels.ptr(py),
                                      _kernels.ptr(pz), n, _kernels.ptr(d), _kernels.ptr(m),
                                      _kernels.stream_ptr(px.device))
    _kernels.check(err, "P6 sdf_eval")
    sdf_eval.launches += 1
    sdf_eval.instances[kernel_instance(scene)] += 1
    return d, m


def sdf_eval(scene: SdfScene, px, py, pz):
    """The tape at flat float32 points (kernel P6 on CUDA tensors, the plain
    version on CPU tensors)."""
    if px.device.type == "cpu":
        return sdf_eval_plain(scene, px, py, pz)
    return _sdf_eval_kernel(scene, px, py, pz)


sdf_eval.launches = 0
sdf_eval.instances = Counter()   # launches (eval and normal) by kernel_instance


def _sdf_normal_kernel(scene: SdfScene, px, py, pz, eps):
    _kernels.require_cuda("sdf_normal", px, py, pz)
    n = px.numel()
    out = torch.empty(3, n, dtype=_F32, device=px.device)
    err = _kernels.lib().f3d_sdf_normal(scene.kernel_args(), _kernels.ptr(px), _kernels.ptr(py),
                                        _kernels.ptr(pz), n, _f32(eps), _kernels.ptr(out),
                                        _kernels.stream_ptr(px.device))
    _kernels.check(err, "P6 sdf_normal")
    sdf_eval.launches += 1
    sdf_eval.instances[kernel_instance(scene)] += 1
    return out[0], out[1], out[2]


def sdf_normal(scene: SdfScene, px, py, pz, eps: float = 1e-4):
    """The central-difference normal at flat points (kernel P6's normal on
    CUDA tensors, counted with `sdf_eval`)."""
    if px.device.type == "cpu":
        return sdf_normal_plain(scene, px, py, pz, eps)
    return _sdf_normal_kernel(scene, px, py, pz, eps)


def _sdf_march_kernel(scene: SdfScene, ro, rd, tmin, tmax, max_steps, hit_eps):
    _kernels.require_cuda("sdf_march", *ro, *rd)
    dev = ro[0].device
    n = ro[0].numel()
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=_F32, device=dev)
    m = torch.empty(n, dtype=_I32, device=dev)
    err = _kernels.lib().f3d_sdf_march(
        scene.kernel_args(), *(_kernels.ptr(c) for c in (*ro, *rd)), n, _f32(tmin), _f32(tmax),
        int(max_steps), _f32(hit_eps), _kernels.ptr(hit), _kernels.ptr(t), _kernels.ptr(m),
        _kernels.stream_ptr(dev))
    _kernels.check(err, "P6 sdf_march")
    sdf_march.launches += 1
    sdf_march.instances[kernel_instance(scene)] += 1
    return SdfHit(hit, t, m)


def sdf_march(scene: SdfScene, ro, rd, tmin=1e-3, tmax=100.0, max_steps: int = 128,
              hit_eps: float = 1e-3) -> SdfHit:
    """Sphere tracing of flat ray tensors (kernel P6's march on CUDA tensors,
    the plain version on CPU tensors)."""
    if ro[0].device.type == "cpu":
        return sdf_march_plain(scene, ro, rd, tmin, tmax, max_steps, hit_eps)
    return _sdf_march_kernel(scene, ro, rd, tmin, tmax, max_steps, hit_eps)


sdf_march.launches = 0
sdf_march.instances = Counter()  # launches by kernel_instance
