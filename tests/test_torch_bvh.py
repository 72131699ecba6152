# The port's triangle-mesh BVH (forge3d_tpu_torch.ops.bvh) against
# forge3d_tpu.ops.bvh on the CPU: the host binned-SAH build, array for array
# and bit for bit, and the plain threaded-BVH traversal (K9's plain version)
# on random rays through the JAX package's own tables.
#
# Tolerances: hits and primitive ids equal on every ray; t within
# 1e-6 * (1 + t) on >= 99.9% of rays and within 1e-5 * (1 + t) on all; the
# barycentrics u and v within 1e-4 (the same float32 operations, but XLA on
# the CPU may contract a product and a sum into one rounding, and the
# cancellations of a thin, tilted triangle of the soup amplify that: ~1.6e-6
# relative in t on one ray of 4096, up to ~1e-5 in u).
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from forge3d_tpu.ops import bvh as jbvh  # noqa: E402

from forge3d_tpu_torch import convert  # noqa: E402
from forge3d_tpu_torch.ops import bvh as tbvh  # noqa: E402

_BOX_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1],
                         [0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1]], np.float32)
_BOX_FACES = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                       [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]],
                      np.uint32)


def box_town(n_side=6, seed=7):
    """An n_side^2 grid of boxes of random footprint and height over
    x, z in [0, 60]: (vertices f32, indices u32)."""
    rng = np.random.default_rng(seed)
    verts, tris = [], []
    for i in range(n_side):
        for j in range(n_side):
            fx, fz = rng.uniform(3.0, 6.0, 2)
            h = rng.uniform(4.0, 15.0)
            tris.append(_BOX_FACES + 8 * len(verts))
            verts.append(_BOX_CORNERS * np.array([fx, h, fz], np.float32)
                         + np.array([10.0 * i + 2.0, -1.0, 10.0 * j + 2.0], np.float32))
    return np.concatenate(verts).astype(np.float32), np.concatenate(tris).astype(np.uint32)


def triangle_soup(n=300, seed=11):
    """n random triangles of random size and orientation in a 40^3 box."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 40.0, (n, 1, 3))
    v = (c + rng.normal(0.0, 2.0, (n, 3, 3))).reshape(-1, 3).astype(np.float32)
    return v, np.arange(3 * n, dtype=np.uint32).reshape(n, 3)


MESHES = {"box_town": box_town, "soup": triangle_soup,
          "one_triangle": lambda: (np.array([[0, 0, 0], [4, 0, 0], [0, 4, 1]], np.float32),
                                   np.array([[0, 1, 2]], np.uint32))}

ARRAYS = ("bounds_min", "bounds_max", "first", "count", "miss_link", "prim_index", "tri_v0",
          "tri_e1", "tri_e2")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_build_sah_bvh_bit_equal(name):
    v, i = MESHES[name]()
    ref = jbvh.build_sah_bvh(v, i)
    got = tbvh.build_sah_bvh(v, i)
    for k in ARRAYS:
        a, b = getattr(ref, k), getattr(got, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (ref.triangle_count, ref.node_count) == (got.triangle_count, got.node_count)
    assert ref.world_aabb == got.world_aabb and ref.stats == got.stats
    assert ref.nbytes == got.nbytes


@pytest.mark.parametrize("v, i, msg", [
    (np.zeros((4, 2), np.float32), np.array([[0, 1, 2]]), "vertices must be"),
    (np.zeros((4, 3), np.float32), np.array([0, 1, 2]), "indices must be"),
    (np.zeros((4, 3), np.float32), np.array([[0, 1, 7]]), "out of range"),
    (np.zeros((4, 3), np.float32), np.zeros((0, 3), np.uint32), "no triangles"),
], ids=["vertices", "indices", "range", "empty"])
def test_build_sah_bvh_refusals(v, i, msg):
    for build in (jbvh.build_sah_bvh, tbvh.build_sah_bvh):
        with pytest.raises(ValueError, match=msg):
            build(v, i)


def random_rays(v, n, seed):
    """n rays: half aimed at random points of the mesh's triangles from
    outside, half in random directions from inside the mesh's box."""
    rng = np.random.default_rng(seed)
    lo, hi = v.min(0), v.max(0)
    pad = 0.2 * (hi - lo) + 1.0
    ro = rng.uniform(lo - pad, hi + pad, (n, 3)).astype(np.float32)
    target = v[rng.integers(0, len(v), n)] + rng.normal(0, 0.3, (n, 3))
    rd = np.where(np.arange(n)[:, None] < n // 2, target - ro, rng.normal(size=(n, 3)))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd.astype(np.float32)


@pytest.mark.parametrize("name", ["box_town", "soup"])
def test_trace_mesh_plain_matches_jax(name):
    v, i = MESHES[name]()
    jscene, n_nodes = jbvh.mesh_scene(jbvh.build_sah_bvh(v, i))
    scene, n = convert.bvh_from_numpy({k: np.asarray(getattr(jscene, k))
                                       for k in jscene._fields})
    assert n == n_nodes
    ro, rd = random_rays(v, 4096, seed=3)
    ref = jbvh.trace_mesh(jscene, n_nodes, tuple(ro.T), tuple(rd.T))
    got = tbvh.trace_mesh(scene, n, tuple(torch.as_tensor(ro.T.copy())),
                          tuple(torch.as_tensor(rd.T.copy())))   # CPU: the plain version
    hit = np.asarray(ref.hit)
    assert 0.2 < hit.mean() < 0.95
    np.testing.assert_array_equal(hit, got.hit.numpy())
    np.testing.assert_array_equal(np.asarray(ref.prim), got.prim.numpy())
    t = np.asarray(ref.t, np.float64)
    d = np.abs(t - got.t.numpy()) / (1.0 + np.abs(t))
    assert (d <= 1e-6).mean() >= 0.999 and d.max() <= 1e-5, float(d.max())
    for k in ("u", "v"):
        assert np.abs(np.asarray(getattr(ref, k)) - getattr(got, k).numpy()).max() <= 1e-4, k


def test_trace_mesh_against_brute_force_and_caps():
    # the plain traversal finds each ray's nearest triangle (the JAX package's
    # brute-force oracle), a short tmax hides hits beyond it, and the
    # wrapper checks its node count
    v, i = box_town(3)
    bvh = tbvh.build_sah_bvh(v, i)
    scene, n = tbvh.mesh_scene(bvh, device="cpu")
    ro, rd = random_rays(v, 512, seed=9)
    hit_bf, t_bf = jbvh.trace_mesh_bruteforce_numpy(v, i, ro, rd)
    got = tbvh.trace_mesh_plain(scene, n, tuple(torch.as_tensor(ro.T.copy())),
                                tuple(torch.as_tensor(rd.T.copy())))
    np.testing.assert_array_equal(hit_bf, got.hit.numpy())
    assert np.allclose(t_bf[hit_bf], got.t.numpy()[hit_bf], rtol=1e-4)
    # the hit triangle, mapped back through prim_index, is one at that t
    tri = bvh.prim_index[got.prim.numpy()[hit_bf]]
    assert np.all(tri >= 0) and np.all(tri < len(i))
    short = tbvh.trace_mesh_plain(scene, n, tuple(torch.as_tensor(ro.T.copy())),
                                  tuple(torch.as_tensor(rd.T.copy())), tmax=5.0)
    np.testing.assert_array_equal(short.hit.numpy(), hit_bf & (t_bf < 5.0))
    with pytest.raises(ValueError, match="n_nodes"):
        tbvh.trace_mesh(scene, n + 1, tuple(torch.as_tensor(ro.T.copy())),
                        tuple(torch.as_tensor(rd.T.copy())))


def test_mesh_scene_defaults_to_cuda():
    """mesh_scene called as the JAX package's puts the BVH on the card:
    without CUDA it raises DeviceError."""
    from forge3d_tpu_torch.errors import DeviceError

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    v, i = box_town(2)
    with pytest.raises(DeviceError, match="CUDA is not available"):
        tbvh.mesh_scene(tbvh.build_sah_bvh(v, i))


# K9's records (ops/bvh.py: pack_nodes, pack_tris): the packed nodes and
# triangles hold the arrays' values bit for bit, packed again after a refit.

@pytest.mark.parametrize("name", sorted(MESHES))
def test_packed_records_hold_the_arrays(name):
    v, i = MESHES[name]()
    bvh = tbvh.build_sah_bvh(v, i)
    scene, n = tbvh.mesh_scene(bvh, device="cpu")
    nodes = scene.nodes.numpy()
    words = nodes.view(np.int32)
    np.testing.assert_array_equal(nodes[:, 0:3], bvh.bounds_min)
    np.testing.assert_array_equal(nodes[:, 4:7], bvh.bounds_max)
    np.testing.assert_array_equal(words[:, 3], bvh.miss_link)
    leaf = bvh.count > 0
    np.testing.assert_array_equal((words[:, 7] >> 3)[leaf], bvh.first[leaf])
    np.testing.assert_array_equal(words[:, 7] & 7, np.minimum(bvh.count, 4))
    tris = scene.tris.numpy()
    for k, a in enumerate((bvh.tri_v0, bvh.tri_e1, bvh.tri_e2)):
        np.testing.assert_array_equal(tris[:, 4 * k:4 * k + 3], a)
        assert not tris[:, 4 * k + 3].any()
    assert n == bvh.node_count and scene.kernel_nbytes == 32 * n + 48 * len(i)


def test_records_are_packed_again_after_a_refit():
    v, i = box_town(4)
    bvh = tbvh.build_sah_bvh(v, i)
    moved = (v * np.float32(1.5) + np.float32(3.0)).astype(np.float32)
    re = tbvh.refit_bvh(bvh, moved, i)
    a, _ = tbvh.mesh_scene(bvh, device="cpu")
    b, _ = tbvh.mesh_scene(re, device="cpu")
    np.testing.assert_array_equal(b.nodes[:, 0:3].numpy(), re.bounds_min)
    np.testing.assert_array_equal(b.nodes[:, 4:7].numpy(), re.bounds_max)
    np.testing.assert_array_equal(b.tris[:, 0:3].numpy(), re.tri_v0)
    # the same topology (miss links, leaves), the moved boxes
    for k in (3, 7):
        np.testing.assert_array_equal(a.nodes[:, k].numpy().view(np.int32),
                                      b.nodes[:, k].numpy().view(np.int32))
    assert not torch.equal(a.nodes[:, 0:3], b.nodes[:, 0:3])


def test_packed_nodes_refuse_a_first_primitive_past_28_bits():
    """`first` shares its word with the count: a mesh of 2^28 primitives or
    more is refused when it is packed."""
    z = np.zeros((1, 3), np.float32)
    with pytest.raises(ValueError, match="first primitive"):
        tbvh.pack_nodes(z, z, np.array([1 << 28]), np.array([2]), np.array([1]))
    ok = tbvh.pack_nodes(z, z, np.array([(1 << 28) - 1]), np.array([9]), np.array([1]))
    assert ok[0, 7:].view(np.int32)[0] == ((1 << 28) - 1) << 3 | 4
