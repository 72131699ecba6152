# The port's AEQUITAS adjudication scene (forge3d_tpu_torch/pt/
# adjudication.py: kernel P4's plain versions) against the JAX package's
# (forge3d_tpu/pt/adjudication.py) on the CPU: every helper, the raster
# twin's HDR frame, the tensor threefry stream under the builtin's keys,
# and render_adjudication_builtin through both lanes.
#
# Gates:
# - helpers: integer outputs (hit kinds, occlusion) equal on >= 99.9% of
#   lanes, float outputs within 1e-5 * (1 + |ref|) on >= 99.5%. Called
#   eagerly, JAX rounds each product of a dot product; the port rounds them
#   as XLA does inside the jitted lanes (x*x, then two multiply-adds);
# - _raster_frame at 48x32: within 1e-5 * (1 + |ref|) on >= 99.5% of
#   elements and 1e-3 * (1 + |ref|) on all (the float rule; the 1,152-term
#   sums carry JAX's other fused sums and its cos and sin);
# - threefry: uniforms bit-equal to jax.random.uniform for every key of a
#   sample of the builtin's stream;
# - render_adjudication_builtin(48, 48, spp=4): both lanes within one u8
#   step on >= 99.5% of pixels (the whole-render rule; the CPU shows both
#   byte-equal), meta equal.
import jax
import numpy as np
import pytest
import torch

from forge3d_tpu.pt import adjudication as ja

from forge3d_tpu_torch.errors import DeviceError
from forge3d_tpu_torch.ops import rng
from forge3d_tpu_torch.pt import adjudication as ta

torch.set_num_threads(1)

N = 6000


def T(a):
    return torch.as_tensor(np.array(a, np.float32))


def float_ok(ref, got, frac=0.995):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return (np.abs(got - ref) <= 1e-5 * (1 + np.abs(ref))).mean() >= frac


def unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def lanes():
    """Seeded rays from around the camera into the scene, their hits, and
    surface frames at the hit points."""
    rng_ = np.random.default_rng(8)
    ro = (np.asarray(ja.CAM_ORIGIN, np.float32)
          + rng_.normal(0, 0.3, (N, 3))).astype(np.float32)
    tgt = rng_.uniform([-3, 0, -3], [3, 2.5, 2], (N, 3)).astype(np.float32)
    rd = unit(tgt - ro)
    return ro, rd


def test_nearest_hit_and_occluded(lanes):
    ro, rd = lanes
    tj, kj = (np.asarray(a) for a in ja._nearest_hit(ro, rd))
    tt, kt = (a.numpy() for a in ta._nearest_hit(T(ro), T(rd)))
    assert (kj == kt).mean() >= 0.999 and len(np.unique(kj)) == 5
    hit = (kj >= 0) & (kt >= 0)
    assert float_ok(tj[hit], tt[hit])
    oj = np.asarray(ja._occluded(ro, rd))
    ot = ta._occluded(T(ro), T(rd)).numpy()
    assert (oj == ot).mean() >= 0.999


def surfaces(lanes):
    ro, rd = lanes
    t, k = ja._nearest_hit(ro, rd)
    keep = np.asarray(k) >= 0
    return ro[keep], rd[keep], np.asarray(t)[keep], np.asarray(k)[keep]


def test_surface_and_frames(lanes):
    ro, rd, t, k = surfaces(lanes)
    sj = [np.asarray(a) for a in ja._surface(ro, rd, t, k)]
    st = [a.numpy() for a in ta._surface(T(ro), T(rd), T(t), torch.as_tensor(k))]
    for a, b in zip(sj, st):
        assert float_ok(a, b)
    n = sj[1]
    for a, b in zip(ja._tangent_basis(n), ta._tangent_basis(T(n))):
        assert float_ok(a, b.numpy())
    u = np.random.default_rng(2).random((2, len(n))).astype(np.float32)
    cj = ja._cosine_local(u[0], u[1])
    ct = ta._cosine_local(T(u[0]), T(u[1]))
    for a, b in zip(cj, ct):
        assert float_ok(a, b.numpy())
    assert float_ok(ja._to_world(n, *cj), ta._to_world(T(n), *ct).numpy())


def test_bsdf_and_pdfs(lanes):
    ro, rd, t, k = surfaces(lanes)
    pos, n, alb, rough = (np.asarray(a) for a in ja._surface(ro, rd, t, k))
    wo = -rd
    wi = unit(np.random.default_rng(3).normal(0, 1, n.shape) + n)
    fj, pj = (np.asarray(a) for a in ja._bsdf_eval_pdf(wo, wi, n, alb, rough))
    ft, pt = (a.numpy() for a in ta._bsdf_eval_pdf(T(wo), T(wi), T(n), T(alb), T(rough)))
    assert float_ok(fj, ft) and float_ok(pj, pt)
    assert float_ok(ja._power_cosine_pdf_up(wi), ta._power_cosine_pdf_up(T(wi)).numpy())
    assert float_ok(ja._env_mixture_pdf(n, wi), ta._env_mixture_pdf(T(n), T(wi)).numpy())
    sj = np.asarray(ja._sun_nee(pos, n, wo, alb, rough))
    st = ta._sun_nee(T(pos), T(n), T(wo), T(alb), T(rough)).numpy()
    assert float_ok(sj, st) and (sj > 0).any()


def test_plane_exit_and_secondary(lanes):
    q = np.random.default_rng(4).uniform(-6, 6, (2, N)).astype(np.float32)
    assert float_ok(ja._plane_exit_radiance(q[0], q[1]),
                    ta._plane_exit_radiance(T(q[0]), T(q[1])).numpy())
    np.testing.assert_allclose(ta._sphere_plane_exit().numpy(),
                               np.asarray(ja._sphere_plane_exit()), rtol=1e-5, atol=1e-6)
    ro, rd, t, k = surfaces(lanes)
    pos, n, _, _ = (np.asarray(a) for a in ja._surface(ro, rd, t, k))
    sj = np.asarray(ja._secondary_radiance(pos, n, k, -rd))
    st = ta._secondary_radiance(T(pos), T(n), torch.as_tensor(k), T(-rd)).numpy()
    assert float_ok(sj, st)


def test_camera_rays_and_tonemap():
    jx = np.random.default_rng(5).random((2, 24, 40)).astype(np.float32)
    for a, b in zip(ja._camera_rays(40, 24, jx[0], jx[1]), ta._camera_rays(40, 24, T(jx[0]),
                                                                           T(jx[1]))):
        assert float_ok(a, b.numpy())
    hdr = np.random.default_rng(6).gamma(1.0, 0.6, (32, 40, 3)).astype(np.float32)
    np.testing.assert_array_equal(ta._tonemap(T(hdr)).numpy(), np.asarray(ja._tonemap(hdr)))


def test_raster_frame_float_rule():
    ref = np.asarray(jax.jit(lambda: ja._raster_frame(48, 32))())
    got = ta._raster_frame(48, 32).numpy()
    assert float_ok(ref, got) and np.all(np.abs(got - ref) <= 1e-3 * (1 + np.abs(ref)))


def test_threefry_uniform_bit_equal():
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    table = ta._sample_keys(rng.fold_in(rng.prng_key(7), 3))
    kj, kpath = jax.random.split(key)
    keys = [jax.random.fold_in(kj, 0), jax.random.fold_in(kj, 1)]
    for depth in range(ta.MAX_DEPTH):
        kd = jax.random.fold_in(kpath, depth)
        keys += [jax.random.fold_in(kd, j) for j in range(6)]
    assert table.shape == (98, 2)
    for i in (0, 1, 2, 7, 50, 97):
        np.testing.assert_array_equal(table[i], np.asarray(jax.random.key_data(keys[i])))
        np.testing.assert_array_equal(rng.uniform_tensor(table[i], (33, 47)).numpy(),
                                      np.asarray(jax.random.uniform(keys[i], (33, 47))))
    np.testing.assert_array_equal(rng.random_bits_tensor(table[5], (9, 7)).numpy(),
                                  rng.random_bits(table[5], (9, 7)).astype(np.int64))


def test_builtin_both_lanes():
    pj, rj, mj = ja.render_adjudication_builtin(48, 48, spp=4)
    pt, rt, mt = ta.render_adjudication_builtin(48, 48, spp=4, device="cpu")
    for a, b in ((pj, pt), (rj, rt)):
        assert a.shape == b.shape == (48, 48, 4) and a.dtype == b.dtype
        du = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
        assert (du <= 1).mean() >= 0.995
    assert mt == mj


def test_builtin_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        ta.render_adjudication_builtin(8, 8, spp=1)
