# The port's TLAS (forge3d_tpu_torch/ops/tlas.py, kernel P5's plain
# version) and refit_bvh against the JAX package's on the CPU: the two
# cases of tests/test_mesh_geometry.py::TestTlas, a three-instance case
# with rotations and a non-uniform scale over two BLASes, instance_normal,
# tlas_from_numpy, P5's table formed once by build_tlas, and refit_bvh's
# arrays.
#
# Gates: hit masks, instances and primitives equal on >= 99.9% of rays,
# |dt|/t <= 1e-4 where both hit and u, v within 1e-5 * (1 + |ref|) on
# >= 99.9% of those rays (the trace rule; t and u, v are not bit-equal
# because JAX's K9 walk is one jitted program whose Moller-Trumbore sums
# XLA fuses, which the port's walk does not); normals |d| <= 1e-5 *
# (1 + |ref|) (JAX's lax.rsqrt is not correctly rounded on the CPU);
# refit_bvh byte-equal.
import numpy as np
import pytest
import torch

from forge3d_tpu.geometry import primitive_mesh
from forge3d_tpu.ops import bvh as jbvh
from forge3d_tpu.ops import tlas as jt
from forge3d_tpu.transforms import rotate_y, scale, translate

from forge3d_tpu_torch.convert import tlas_from_numpy
from forge3d_tpu_torch.errors import DeviceError
from forge3d_tpu_torch.ops import bvh as tbvh
from forge3d_tpu_torch.ops import tlas as tt

torch.set_num_threads(1)


def box():
    m = primitive_mesh("box")
    return np.asarray(m.vertices, np.float32), np.asarray(m.indices, np.uint32)


def soup(seed=3, n=20):
    v = np.random.default_rng(seed).uniform(-1, 1, (3 * n, 3)).astype(np.float32)
    return v, np.arange(3 * n, dtype=np.uint32).reshape(n, 3)


def both(blases, placements):
    j = jt.build_tlas(blases, [jt.Instance(b, m) for b, m in placements])
    t = tt.build_tlas(blases, [tt.Instance(b, m) for b, m in placements], device="cpu")
    return j, t


def trace_both(j, t, ro, rd, **kw):
    hj = jt.trace_tlas(j, ro, rd, **kw)
    ht = tt.trace_tlas(t, tuple(torch.as_tensor(np.asarray(c)) for c in ro),
                       tuple(torch.as_tensor(np.asarray(c)) for c in rd), **kw)
    return hj, ht


def assert_trace_rule(hj, ht):
    hit = np.asarray(hj.hit)
    assert (ht.hit.numpy() == hit).mean() >= 0.999
    both_ = hit & ht.hit.numpy()
    for name in ("instance", "prim"):
        assert (getattr(ht, name).numpy()[both_] == np.asarray(getattr(hj, name))[both_]).mean() \
            >= 0.999, name
    tj, tt_ = np.asarray(hj.t)[both_], ht.t.numpy()[both_]
    assert np.all(np.abs(tt_ - tj) / tj <= 1e-4)
    for name in ("u", "v"):
        a, b = np.asarray(getattr(hj, name))[both_], getattr(ht, name).numpy()[both_]
        assert (np.abs(b - a) <= 1e-5 * (1 + np.abs(a))).mean() >= 0.999, name
    return both_


def test_instances_match_jax():
    """TestTlas.test_instances_match_merged_mesh's instances and rays."""
    v, f = box()
    j, t = both([(v, f)], [(0, translate(-2.0, 0.0, 0.0) @ rotate_y(30.0)),
                           (0, translate(2.5, 0.5, 0.0) @ scale(1.5, 0.7, 1.0))])
    n = 48
    ys, xs = np.mgrid[0:n, 0:n].astype(np.float32)
    ro = (xs / n * 10 - 5, np.full((n, n), 0.2, np.float32), np.full((n, n), 8.0, np.float32))
    rd = (np.zeros((n, n), np.float32), np.zeros((n, n), np.float32),
          np.full((n, n), -1.0, np.float32))
    hj, ht = trace_both(j, t, ro, rd)
    both_ = assert_trace_rule(hj, ht)
    assert both_.sum() > 20 and ht.t.shape == (n, n)
    inst = ht.instance.numpy()[both_]
    assert (inst[ro[0][both_] < 0] == 0).all() and (inst[ro[0][both_] > 1.0] == 1).all()


def test_instance_normals_match_jax():
    """TestTlas.test_instance_normals_world_space's non-uniform scale."""
    v, f = box()
    j, t = both([(v, f)], [(0, scale(4.0, 1.0, 1.0))])
    ro = (np.float32(0.0), np.float32(0.0), np.float32(8.0))
    rd = (np.float32(0.0), np.float32(0.0), np.float32(-1.0))
    hj, ht = trace_both(j, t, ro, rd)
    assert bool(ht.hit) and bool(hj.hit)
    wj = jt.instance_normal(j, hj, (0.0, 0.0, 1.0))
    wt = tt.instance_normal(t, ht, (0.0, 0.0, 1.0))
    for a, b in zip(wj, wt):
        assert abs(float(b) - float(a)) <= 1e-5 * (1 + abs(float(a)))
    assert abs(float(wt[2]) - 1.0) < 1e-6 and abs(float(wt[0])) < 1e-6


def three_instances():
    return ([box(), soup()],
            [(0, translate(0.0, 0.0, 0.0)), (1, translate(2.0, 0.5, 0.0) @ rotate_y(40.0)),
             (0, translate(-2.0, 0.0, 1.0) @ scale(1.5, 0.7, 1.2) @ rotate_y(-23.0))])


def camera_rays(n, seed=6):
    rng = np.random.default_rng(seed)
    ro = rng.uniform([-3, 1, 5], [3, 3, 7], (n, 3)).astype(np.float32)
    rd = rng.uniform([-2.5, -1, -1.5], [2.5, 1.5, 1.5], (n, 3)).astype(np.float32) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return tuple(ro.T.copy()), tuple(rd.T.copy())


@pytest.mark.parametrize("kw", [dict(), dict(tmin=0.5, tmax=7.0)], ids=["defaults", "tmin_tmax"])
def test_three_instances_rotated(kw):
    j, t = both(*three_instances())
    ro, rd = camera_rays(6000)
    hj, ht = trace_both(j, t, ro, rd, **kw)
    both_ = assert_trace_rule(hj, ht)
    assert set(ht.instance.numpy()[both_].tolist()) == {0, 1, 2}
    obj = [np.asarray(c) for c in np.random.default_rng(1).standard_normal((3, 6000))
           .astype(np.float32)]
    wj = jt.instance_normal(j, hj, obj)
    wt = tt.instance_normal(t, ht, [torch.as_tensor(c) for c in obj])
    for a, b in zip(wj, wt):
        a = np.asarray(a)
        assert np.all(np.abs(b.numpy() - a) <= 1e-5 * (1 + np.abs(a)))


def test_build_tlas_matrices_and_from_numpy():
    blases, placements = three_instances()
    j, t = both(blases, placements)
    for a, b in zip(j.inv_mats + j.nrm_mats, t.inv_mats + t.nrm_mats):
        np.testing.assert_array_equal(a, b)
    fields = [{k: np.asarray(getattr(s, k)) for k in s._fields} for s, _ in j.scenes]
    carried = tlas_from_numpy(fields, [(i.blas_index, i.transform) for i in j.instances],
                              j.inv_mats, j.nrm_mats)
    ro, rd = camera_rays(2000, seed=7)
    ha = tt.trace_tlas(t, ro, rd)
    hb = tt.trace_tlas(carried, ro, rd)
    assert all(torch.equal(a, b) for a, b in zip(ha, hb))
    with pytest.raises(ValueError, match="out of range"):
        tt.build_tlas([box()], [tt.Instance(1, np.eye(4))], device="cpu")
    with pytest.raises(ValueError, match="4x4"):
        tt.Instance(0, np.eye(3))


def test_kernel_table_built_once():
    """build_tlas forms P5's table once, 128 bytes an instance on the
    BLASes' device: each instance's float32 world-to-object row (JAX's
    inverse rounded), its BLAS's records and a cull box holding the BLAS
    root's corners in world space; tlas_from_numpy carries the same table,
    and the kernel's view of the TLAS copies nothing."""
    import ctypes

    from forge3d_tpu_torch import _kernels

    blases, placements = three_instances()
    j, t = both(blases, placements)
    assert t.table.dtype == torch.uint8 and t.table.numel() == 128 * len(t.instances)
    rows = (_kernels.TlasInst * len(t.instances)).from_buffer_copy(t.table.numpy().tobytes())
    for row, inv, (b, m) in zip(rows, j.inv_mats, placements):
        want = np.concatenate([inv[:3, :3].reshape(-1), inv[:3, 3]]).astype(np.float32)
        assert np.array_equal(np.asarray(row.xform[:], np.float32), want)
        scene, n_nodes = t.scenes[b]
        assert (row.blas.nodes, row.blas.tris) == (scene.nodes.data_ptr(), scene.tris.data_ptr())
        assert (row.blas.n_nodes, row.blas.max_iters) == (n_nodes, 4 * n_nodes + 64)
        lo, hi = scene.bounds_min[0].numpy(), scene.bounds_max[0].numpy()
        corners = np.array([[x, y, z, 1.0] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                            for z in (lo[2], hi[2])]) @ np.asarray(m, np.float64).T
        assert (corners[:, :3] >= row.lo[:]).all() and (corners[:, :3] <= row.hi[:]).all()
        assert row.g0 > 0 and row.g1 > 0 and row.dir_min == tt.DIR_MIN
    fields = [{k: np.asarray(getattr(s, k)) for k in s._fields} for s, _ in j.scenes]
    carried = tlas_from_numpy(fields, [(i.blas_index, i.transform) for i in j.instances],
                              j.inv_mats, j.nrm_mats)
    head = [bytes(r)[:88] for r in rows]   # all but the BLAS's pointers
    got = (_kernels.TlasInst * 3).from_buffer_copy(carried.table.numpy().tobytes())
    assert [bytes(r)[:88] for r in got] == head
    with pytest.raises(ValueError, match="CUDA"):
        tt.tlas_args(t)   # the kernel's view needs the table on the card: a CPU one is refused
    assert ctypes.sizeof(_kernels.TlasInst) == 128


def test_refit_bvh_byte_equal():
    v, f = soup(seed=9, n=64)
    bvh_j = jbvh.build_sah_bvh(v, f)
    bvh_t = tbvh.build_sah_bvh(v, f)
    moved = v + np.random.default_rng(2).normal(0, 0.05, v.shape).astype(np.float32)
    rj = jbvh.refit_bvh(bvh_j, moved, f)
    rt = tbvh.refit_bvh(bvh_t, moved, f)
    for name in ("bounds_min", "bounds_max", "first", "count", "miss_link", "prim_index",
                 "tri_v0", "tri_e1", "tri_e2"):
        a, b = getattr(rj, name), getattr(rt, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert rt.world_aabb == rj.world_aabb and rt.stats == rj.stats
    assert rt.node_count == rj.node_count and rt.triangle_count == rj.triangle_count


def test_tlas_defaults_to_cuda():
    """build_tlas as the JAX package calls it puts the BLASes on the card:
    without CUDA it raises DeviceError."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        tt.build_tlas([box()], [tt.Instance(0, np.eye(4))])
