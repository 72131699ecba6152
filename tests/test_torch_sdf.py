# The port's SDF tracer (forge3d_tpu_torch/ops/sdf.py, kernel P6's plain
# versions) against the JAX package's (forge3d_tpu/ops/sdf.py) on the CPU:
# the builder's node ids and errors, the compiled post-order tape and its
# stack depth, with_bounds, and evaluate / normal / raymarch on seeded
# points and rays.
#
# Gates:
# - evaluate: distances and materials bit-equal to JAX per primitive kind
#   and per operation kind (the plain version rounds XLA's fused sums once,
#   in the contraction order a search over the trees found);
# - normal: |d| <= 1e-5 * (1 + |ref|) on every element. Not bit-equal:
#   JAX normalises through lax.rsqrt, which XLA's CPU backend does not
#   round correctly (86% of float32 inputs), where the port divides by the
#   correctly rounded square root;
# - raymarch: hit masks equal on >= 99.9% of rays and |dt|/t <= 1e-4 where
#   both hit (the CPU shows every t and material equal).
import numpy as np
import pytest
import torch

from forge3d_tpu.ops import sdf as jsdf

from forge3d_tpu_torch.convert import sdf_scene_from_numpy
from forge3d_tpu_torch.errors import DeviceError
from forge3d_tpu_torch.ops import sdf as tsdf

torch.set_num_threads(1)

N = 20000


def both(fn):
    bj, bt = jsdf.SdfSceneBuilder(), tsdf.SdfSceneBuilder()
    assert fn(bj) == fn(bt)            # the same node ids
    return bj.build(), bt.build(device="cpu")


def points(seed=0, n=N):
    return np.random.default_rng(seed).uniform(-3, 3, (3, n)).astype(np.float32)


def evaluate_both(sj, st, p):
    dj, mj = (np.asarray(a) for a in sj.evaluate(*p))
    dt, mt = (a.numpy() for a in st.evaluate(*(torch.as_tensor(c) for c in p)))
    return dj, mj, dt, mt


PRIMS = {
    "sphere": lambda b: b.add_sphere((0.3, -0.2, 0.1), 1.3, 2),
    "box": lambda b: b.add_box((0.2, 0.1, -0.3), (1.0, 0.7, 1.3), 3),
    "cylinder": lambda b: b.add_cylinder((0.2, 0.1, -0.3), 0.9, 1.1, 4),
    "plane": lambda b: b.add_plane((0.3, 1.0, -0.2), 0.4, 5),
    "torus": lambda b: b.add_torus((0.2, 0.1, -0.3), 1.2, 0.4, 6),
    "capsule": lambda b: b.add_capsule((-1.0, 0.2, 0.3), (1.1, -0.4, 0.7), 0.5, 7),
}
OPS = {"union": None, "intersect": None, "subtract": None, "smooth_union": 0.6,
       "smooth_intersect": 0.6, "smooth_subtract": 0.6}


@pytest.mark.parametrize("kind", sorted(PRIMS))
def test_evaluate_primitive_bit_equal(kind):
    sj, st = both(PRIMS[kind])
    dj, mj, dt, mt = evaluate_both(sj, st, points(1))
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(mt, mj)


@pytest.mark.parametrize("op", sorted(OPS))
def test_evaluate_operation_bit_equal(op):
    def build(b):
        a = b.add_sphere((0.3, -0.2, 0.1), 1.3, 1)
        c = b.add_torus((0.9, 0.1, -0.3), 1.0, 0.45, 2)
        args = (a, c) if OPS[op] is None else (a, c, OPS[op])
        return getattr(b, op)(*args, material_id=3)

    sj, st = both(build)
    dj, mj, dt, mt = evaluate_both(sj, st, points(2))
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(mt, mj)
    if "subtract" not in op:       # a subtraction keeps the left material
        assert len(np.unique(mj)) >= 2


def landmark(b):
    """A CSG tree over every kind, shared subtrees and a deep stack."""
    s = b.add_sphere((0.3, 0.2, 0.1), 1.1, 1)
    bx = b.add_box((1.0, 0.1, -0.3), (0.8, 0.6, 1.0), 2)
    c = b.add_cylinder((-1.2, 0.0, 0.4), 0.5, 1.2, 3)
    p = b.add_plane((0.1, 1.0, -0.2), -1.0, 4)
    t = b.add_torus((0.0, 0.6, -1.0), 1.0, 0.25, 5)
    k = b.add_capsule((-1.5, -0.5, -1.0), (1.5, 0.8, 1.2), 0.3, 6)
    u = b.smooth_union(s, bx, 0.4, 7)
    i = b.intersect(u, b.add_sphere((0.4, 0.0, 0.0), 2.0), 8)
    d = b.subtract(i, c, 9)
    si = b.smooth_intersect(t, b.add_box((0.0, 0.6, -1.0), (1.2, 0.5, 1.2)), 0.3, 10)
    ss = b.smooth_subtract(b.union(d, si, 11), k, 0.2, 12)
    return b.union(b.smooth_union(ss, u, 0.3), p, 13)


def test_builder_ids_tape_and_bounds():
    sj, st = both(landmark)
    assert (st.tape_len, st.stack_depth, st.primitive_count, st.node_count) == (
        sj.tape_len, sj.stack_depth, sj.primitive_count, sj.node_count)
    for name in jsdf.SdfTape._fields:
        np.testing.assert_array_equal(getattr(st.tape, name).numpy(),
                                      np.asarray(getattr(sj.tape, name)), err_msg=name)
    bj, bt = sj.with_bounds((-3, -2, -3), (3, 2.5, 3)), st.with_bounds((-3, -2, -3), (3, 2.5, 3))
    assert bt.bounds == bj.bounds and bt.tape_len == bj.tape_len
    dj, mj, dt, mt = evaluate_both(sj, st, points(3))
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(mt, mj)
    # a root inside the tree
    rj = jsdf.SdfSceneBuilder()
    rt = tsdf.SdfSceneBuilder()
    landmark(rj), landmark(rt)
    assert rt.build(root=8, device="cpu").tape_len == rj.build(root=8).tape_len


def test_builder_errors():
    for b in (jsdf.SdfSceneBuilder(), tsdf.SdfSceneBuilder()):
        with pytest.raises(ValueError, match="radius must be > 0"):
            b.add_sphere((0, 0, 0), 0.0)
        with pytest.raises(ValueError, match="unknown node id"):
            b.union(0, 1)
        with pytest.raises(ValueError, match="no primitives"):
            b.build(**({} if isinstance(b, jsdf.SdfSceneBuilder) else {"device": "cpu"}))
        ids = [b.add_sphere((0.1 * i, 0, 0), 1.0) for i in range(67)]
        last = ids[0]
        for i in ids[1:]:               # a left-deep chain of 66 unions
            last = b.union(last, i)
        with pytest.raises(ValueError, match="too deep"):
            b.build(**({} if isinstance(b, jsdf.SdfSceneBuilder) else {"device": "cpu"}))


def test_normal_float_rule():
    sj, st = both(landmark)
    p = points(4, 8000)
    nj = [np.asarray(a) for a in sj.normal(*p)]
    nt = [a.numpy() for a in st.normal(*(torch.as_tensor(c) for c in p))]
    for a, b in zip(nj, nt):
        assert np.all(np.abs(b - a) <= 1e-5 * (1 + np.abs(a)))


def rays(n, seed=5):
    rng = np.random.default_rng(seed)
    ro = rng.uniform([-3, 1, 5], [3, 3, 7], (n, 3)).astype(np.float32)
    rd = rng.uniform([-2, -1.5, -2], [2, 1.5, 2], (n, 3)).astype(np.float32) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return tuple(ro.T.copy()), tuple(rd.T.copy())


@pytest.mark.parametrize("kw", [dict(), dict(tmax=6.0, max_steps=24, hit_eps=5e-3)],
                         ids=["defaults", "short_far_coarse"])
def test_raymarch_trace_rule(kw):
    sj, st = both(landmark)
    ro, rd = rays(4000)
    hj, tj, mj = (np.asarray(a) for a in sj.raymarch(ro, rd, **kw))
    ht, tt, mt = (a.numpy() for a in st.raymarch(tuple(map(torch.as_tensor, ro)),
                                                  tuple(map(torch.as_tensor, rd)), **kw))
    assert (hj == ht).mean() >= 0.999
    both_ = hj & ht
    assert np.all(np.abs(tt[both_] - tj[both_]) / tj[both_] <= 1e-4)
    np.testing.assert_array_equal(mt[both_], mj[both_])
    assert 0.05 < hj.mean() < 0.95
    # what the CPU shows: every lane equal, the frozen misses included
    np.testing.assert_array_equal(tt, tj)


def test_scene_from_numpy():
    sj, _ = both(landmark)
    fields = {name: np.asarray(getattr(sj.tape, name)) for name in jsdf.SdfTape._fields}
    fields.update(tape_len=sj.tape_len, stack_depth=sj.stack_depth,
                  primitive_count=sj.primitive_count, node_count=sj.node_count,
                  bounds=sj.bounds)
    st = sdf_scene_from_numpy(fields)
    dj, mj, dt, mt = evaluate_both(sj, st, points(6, 4000))
    np.testing.assert_array_equal(dt, dj)


def test_sdf_defaults_to_cuda():
    """SdfSceneBuilder.build as the JAX package calls it puts the tape on
    the card: without CUDA it raises DeviceError."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    b = tsdf.SdfSceneBuilder()
    b.add_sphere((0, 0, 0), 1.0)
    with pytest.raises(DeviceError, match="CUDA is not available"):
        b.build()
