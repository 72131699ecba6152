# The port's sweep estimator (forge3d_tpu_torch: ops/rng.py threefry,
# ops/sweep.py, pt/terrain_sweep.py) against the JAX package on the CPU:
# the key stream, the static plans, K1 and K2's plain versions on JAX's own
# inputs and keys, whole renders through the public entries, the sequence,
# and the error paths.
#
# Tolerances:
# - threefry keys, bits and uniforms, plan fields, frame counts: exact.
# - K1 (rotate_heights): |d| <= 1e-5 * (1 + |ref|) everywhere, equal -1e30
#   masks.
# - K2 (sweep_lighting) on the same key: z_sun on >= 99.9% and e_sky on
#   >= 99.5% of texels at 1e-5 * (1 + |ref|); a last-ulp difference in a
#   bin direction can flip a grazing lit test.
# - Whole renders: rgba within 1 u8 step on >= 99.5% of pixels, depth NaN
#   masks equal on >= 99.9%, `frames` and `method` equal.
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import forge3d_tpu as f3d
from forge3d_tpu.ops import sweep as jsw
from forge3d_tpu.ops.shading import EnvMap as JEnvMap
from forge3d_tpu.pt import terrain_sweep as jts
from forge3d_tpu.pt.terrain_ref import TerrainRefDesc as JDesc

import forge3d_tpu_torch as f3t
from forge3d_tpu_torch import convert
from forge3d_tpu_torch import errors as terr
from forge3d_tpu_torch.ops import rng
from forge3d_tpu_torch.ops import sweep as tsw
from forge3d_tpu_torch.ops.shading import env_map
from forge3d_tpu_torch.pt import terrain_ref as ttr
from forge3d_tpu_torch.pt import terrain_sweep as tts

torch.set_num_threads(1)

FLOAT_TOL = 1e-5


def close_frac(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    ok = np.abs(got - ref) <= FLOAT_TOL * (1.0 + np.abs(ref))
    return float(ok.mean())


def sine_dem(n, amp, fx, fy):
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    return (amp * np.sin(x * fx) * np.cos(y * fy)).astype(np.float32)


# The scenes of the sizing table: (DEM, width, height, camera)
SCENES = {
    "33_64x48": (sine_dem(33, 4.0, 0.2, 0.17), 64, 48,
                 dict(origin=(16.0, 14.0, 46.0), look_at=(16.0, 0.0, 16.0), fov_y=42.0)),
    "65_128x96": (sine_dem(65, 6.0, 0.15, 0.12), 128, 96,
                  dict(origin=(32.0, 22.0, 90.0), look_at=(32.0, 0.0, 32.0), fov_y=42.0)),
    "129_256x128": (sine_dem(129, 12.0, 0.075, 0.06), 256, 128,
                    dict(origin=(64.0, 44.0, 180.0), look_at=(64.0, 0.0, 64.0), fov_y=42.0)),
    "bench_1025_1920x1080": (np.zeros((1025, 1025), np.float32), 1920, 1080,
                             dict(origin=(512.0, 260.0, 1400.0), look_at=(512.0, 0.0, 512.0),
                                  fov_y=45.0)),
}


def descs(scene, **kw):
    dem, W, H, cam = SCENES[scene]
    common = dict(heights=dem, width=W, height=H, cam_origin=cam["origin"],
                  cam_look_at=cam["look_at"], fov_y_deg=cam["fov_y"], **kw)
    return JDesc(**common), ttr.TerrainRefDesc(**common)


# ---------------------------------------------------------------------------
# threefry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 3, 2 ** 31 + 5, 2 ** 32 - 1])
def test_threefry_matches_jax(seed):
    key = jax.random.PRNGKey(np.uint32(seed))
    k = rng.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(key), k)
    for i in (0, 1, 7, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(key, np.uint32(i))),
                                      rng.fold_in(k, i))
    np.testing.assert_array_equal(np.asarray(jax.random.split(key, 4)), rng.split(k, 4))
    np.testing.assert_array_equal(np.asarray(jax.random.split(key)), rng.split(k))
    for shape in ((), (32, 12), (4, 1)):
        a = np.asarray(jax.random.uniform(key, shape, jnp.float32))
        b = rng.uniform(k, shape)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_jitter_bins_match_jax():
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    strata = jsw.make_strata(32, 12, -0.55)
    ja, je = jsw.jitter_bins(strata, key)
    ta, te = tsw.jitter_bins(tsw.make_strata(32, 12, -0.55), np.asarray(key))
    assert np.asarray(ja).tobytes() == ta.tobytes()
    assert np.asarray(je).tobytes() == te.tobytes()


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plans_match_jax(scene):
    jd, td = descs(scene, spp=2)
    rg, ps, _, _, _, render_all = jts._build_pipeline(
        jd.heights.shape, tuple(map(float, jd.spacing)), float(jd.exaggeration),
        tuple(map(float, jd.cam_origin)), tuple(map(float, jd.cam_look_at)),
        tuple(map(float, jd.cam_up)), float(jd.fov_y_deg), jd.width, jd.height,
        32, 12, -0.55, float(jd.sun_azimuth_deg), float(jd.sun_elevation_deg),
        bool(jd.shadows_enabled), None)
    plan = tts.plan_for(td)
    assert plan.rg.__dict__ == rg.__dict__
    assert plan.ps.__dict__ == ps.__dict__
    assert plan.strata.__dict__ == jsw.make_strata().__dict__
    assert plan.strata.groups() == [[s for s in range(32) if jsw.make_strata().quadrant_of(s)
                                      == q] for q in range(4)]
    assert plan.batch_n == render_all.batch_n
    for frames in (None, 5, 7):
        n = frames or jts._sweep_frames(jd)
        batch_max = max(render_all.batch_n, 1)
        n_batches = max((n + batch_max - 1) // batch_max, 1)
        n_total = n_batches * ((n + n_batches - 1) // n_batches)
        nb, b = plan.frame_layout(frames or tts._sweep_frames(td))
        assert nb * b == n_total


def test_bench_plan_batches_two():
    """bench.py's scene: per_lane 3.27 GB, so batch_n = 2 and spp=2's eight
    frames run as 4 x 2."""
    _, td = descs("bench_1025_1920x1080", spp=2)
    plan = tts.plan_for(td)
    assert (plan.rg.n_v, plan.rg.n_u) == (1032, 1032)
    assert (plan.ps.e_count, plan.ps.a_count, plan.ps.k_count) == (1080, 3328, 1029)
    assert plan.batch_n == 2 and plan.frame_layout(tts._sweep_frames(td)) == (4, 2)


# ---------------------------------------------------------------------------
# K1 and K2 plain versions on JAX's inputs
# ---------------------------------------------------------------------------


def rotated(scene):
    jd, td = descs(scene)
    plan = tts.plan_for(td)
    rg = plan.rg
    cam_xz = plan.cam_xz
    ref = jsw.rotate_heights(jnp.asarray(jd.heights), rg, origin_xz=(0.0, 0.0),
                             spacing_xz=jd.spacing, cam_xz=cam_xz, exaggeration=1.0,
                             with_derivatives=True)
    return plan, td, ref


@pytest.mark.parametrize("scene", ["33_64x48", "129_256x128"])
def test_rotate_heights_matches_jax(scene):
    plan, td, (h, valid, du, dv) = rotated(scene)
    got = tsw.rotate_heights(torch.as_tensor(td.heights), plan.rot)
    np.testing.assert_array_equal(np.asarray(h) < -1e20, got[0].numpy() < -1e20)
    assert (~np.asarray(valid) == (got[0].numpy() < -1e20)).all()
    for a, b in zip((h, du, dv), got):
        assert close_frac(a, b.numpy()) == 1.0


@pytest.mark.parametrize("scene,seed,frame", [("33_64x48", 3, 0), ("65_128x96", 7, 5)])
def test_sweep_lighting_matches_jax(scene, seed, frame):
    plan, td, (h, _, du, dv) = rotated(scene)
    k_sky = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), frame), 4)[0]
    ref = jsw.sweep_lighting(h, du, dv, strata=jsw.make_strata(), key=k_sky,
                             env=JEnvMap(rgb=None, intensity=jnp.float32(0.35)),
                             e_u=plan.rg.e_u, e_v=plan.rg.e_v, sun_world=plan.sun_w,
                             spacing=plan.rg.spacing)
    t = [convert.tensor(a) for a in (h, du, dv)]
    got = tsw.sweep_lighting(*t, tsw.sweep_bins(
        strata=plan.strata, key=np.asarray(k_sky), env=env_map(None, 0.35), e_u=plan.rg.e_u,
        e_v=plan.rg.e_v, sun_world=plan.sun_w, spacing=plan.rg.spacing))
    assert close_frac(ref.z_sun, got.z_sun.numpy()) >= 0.999
    # e_sky is held on the DEM's texels. Outside the DEM (h = -1e30) the lit
    # test compares -1e30 with -1e30 +- rounding, which depends on how XLA
    # fuses the shift: JAX's own eager and jitted results disagree there.
    valid = np.asarray(h) > -1e20
    assert close_frac(np.asarray(ref.e_sky)[valid], got.e_sky.numpy()[valid]) >= 0.995


def _brute_visibility(h, w_dir, spacing=1.0, n_steps=400, step=0.25):
    """tests/test_sweep.py's dense ray march with bilinear heights."""
    V, U = h.shape
    wu, wv, wy = w_dir
    lit = np.ones((V, U), bool)
    iu, iv = np.meshgrid(np.arange(U, dtype=np.float64), np.arange(V, dtype=np.float64))
    horiz = math.hypot(wu, wv)
    for s in range(1, n_steps + 1):
        d = s * step
        pu = iu + d * wu / horiz
        pv = iv + d * wv / horiz
        py = h + (d * spacing) * (wy / horiz)
        inside = (pu >= 0) & (pu <= U - 1) & (pv >= 0) & (pv <= V - 1)
        i0 = np.clip(np.floor(pu).astype(int), 0, U - 2)
        j0 = np.clip(np.floor(pv).astype(int), 0, V - 2)
        au, av = pu - i0, pv - j0
        hv = (h[j0, i0] * (1 - au) * (1 - av) + h[j0, i0 + 1] * au * (1 - av)
              + h[j0 + 1, i0] * (1 - au) * av + h[j0 + 1, i0 + 1] * au * av)
        lit &= ~(inside & (hv > py + 1e-6))
    return lit


@pytest.mark.parametrize("azimuth,elevation,rough,gate", [
    (315.0, 45.0, True, 0.94), (10.0, 30.0, True, 0.94), (120.0, 60.0, True, 0.94),
    (200.0, 20.0, True, 0.94), (80.0, 75.0, True, 0.94),
    (315.0, 35.0, False, 0.97), (200.0, 25.0, False, 0.97),
])
def test_sun_sweep_matches_brute_force(azimuth, elevation, rough, gate):
    """tests/test_sweep.py's sun cases through the port (sun_only, identity
    grid), against the dense march and against the JAX version."""
    if rough:
        n = 48
        yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
        h = (8.0 * np.exp(-((xx - 20) ** 2 + (yy - 25) ** 2) / 60.0)
             + 0.5 * np.random.default_rng(3).normal(size=(n, n))).astype(np.float32)
    else:
        h = sine_dem(64, 6.0, 0.2, 0.17)
    n = h.shape[0]
    az, el = math.radians(azimuth), math.radians(elevation)
    sun = (math.cos(az) * math.cos(el), math.sin(el), math.sin(az) * math.cos(el))
    kw = dict(e_u=(1.0, 0.0, 0.0), e_v=(0.0, 0.0, 1.0), sun_world=sun, spacing=1.0,
              sun_only=True)
    zeros = torch.zeros((n, n))
    got = tsw.sweep_lighting(torch.as_tensor(h), zeros, zeros, tsw.sweep_bins(
        strata=tsw.make_strata(4, 1), key=rng.prng_key(0), env=env_map(None, 0.0), **kw))
    ref = jsw.sweep_lighting(jnp.asarray(h), jnp.zeros((n, n)), jnp.zeros((n, n)),
                             strata=jsw.make_strata(4, 1), key=jax.random.PRNGKey(0),
                             env=JEnvMap(rgb=None, intensity=jnp.float32(0.0)), **kw)
    assert close_frac(ref.z_sun, got.z_sun.numpy()) >= 0.999
    lit = h >= got.z_sun.numpy() - 1e-4
    lit_ref = _brute_visibility(h, (sun[0], sun[2], sun[1]), n_steps=300 if rough else 400)
    assert (lit == lit_ref).mean() > gate


# ---------------------------------------------------------------------------
# whole renders
# ---------------------------------------------------------------------------

RENDERS = {"33_64x48": dict(frames=4, seed=3), "65_128x96": dict(frames=16, seed=7)}


@pytest.fixture(scope="module", params=sorted(RENDERS))
def render_pair(request):
    scene = request.param
    kw = RENDERS[scene]
    jd, td = descs(scene, spp=1, seed=kw["seed"])
    a = jts.render_terrain_sweep(jd, frames=kw["frames"])
    b = tts.render_terrain_sweep(td, frames=kw["frames"], device="cpu")
    return scene, a, b


def test_render_matches_jax(render_pair):
    _, a, b = render_pair
    assert a["frames"] == b["frames"] and a["method"] == b["method"] == "sweep"
    du = np.abs(a["rgba"].astype(np.int32) - b["rgba"].astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= 0.995
    assert (np.isnan(a["depth"]) == np.isnan(b["depth"])).mean() >= 0.999
    assert set(a.keys()) == set(b.keys())
    for k in ("variance", "converged", "minmax_pyramid_bytes", "gpu_resource_bytes"):
        assert a[k] == b[k], k


def test_render_aovs_match_jax(render_pair):
    _, a, b = render_pair
    both = ~np.isnan(a["depth"]) & ~np.isnan(b["depth"])
    assert (np.abs(a["depth"][both] - b["depth"][both])
            <= 2e-3 * np.abs(a["depth"][both])).mean() >= 0.995
    assert (np.abs(a["normal"] - b["normal"]).max(-1) <= 0.02).mean() >= 0.995
    assert (a["albedo"] == b["albedo"]).all(-1).mean() >= 0.995


def test_public_entry_sweep_matches_render():
    dem, W, H, cam = SCENES["33_64x48"]
    # spp=5 asks for 10 frames; batches of at most 4 round that up to 3 x 4
    a = f3d.hybrid_render_terrain_reference(dem, W, H, cam, traversal="sweep", spp=5)
    b = f3t.hybrid_render_terrain_reference(dem, W, H, cam, traversal="sweep", spp=5,
                                            device="cpu")
    assert a["frames"] == b["frames"] == 12 and b["method"] == "sweep"
    du = np.abs(a["rgba"].astype(np.int32) - b["rgba"].astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= 0.995
    c = ttr.render_terrain_reference(ttr.TerrainRefDesc(
        heights=dem, width=W, height=H, cam_origin=cam["origin"], cam_look_at=cam["look_at"],
        fov_y_deg=cam["fov_y"], spp=5, traversal="sweep"), device="cpu")
    np.testing.assert_array_equal(b["rgba"], c["rgba"])


def test_sequence_bitwise_matches_single_calls():
    dem, W, H, cam = SCENES["33_64x48"]
    seq = f3t.hybrid_render_terrain_sequence(dem, W, H, cam, [3, 9], spp=1, device="cpu")
    assert len(seq) == 2
    for seed, out in zip((3, 9), seq):
        one = f3t.hybrid_render_terrain_reference(dem, W, H, cam, traversal="sweep", spp=1,
                                                  seed=seed, device="cpu")
        assert out["frames"] == one["frames"]
        np.testing.assert_array_equal(out["rgba"], one["rgba"])
        np.testing.assert_array_equal(out["depth"], one["depth"])
        np.testing.assert_array_equal(out["hdr"], one["hdr"])
    with pytest.raises(TypeError, match="unsupported sequence kwargs"):
        f3t.hybrid_render_terrain_sequence(dem, W, H, cam, [1], bogus=1, device="cpu")


def test_sweep_error_paths():
    dem, W, H, cam = SCENES["33_64x48"]
    with pytest.raises(terr.RenderError, match="typed lights"):
        ttr.render_terrain_reference(ttr.TerrainRefDesc(heights=dem, traversal="sweep",
                                                         lights=("sun",)), device="cpu")
    with pytest.raises(terr.RenderError, match="mesh geometry"):
        ttr.render_terrain_reference(ttr.TerrainRefDesc(heights=dem, traversal="sweep",
                                                        mesh=("v", "i")), device="cpu")
    # the public entry falls back to the per-ray engine for meshes
    quad_v = np.array([[10, 8, 20], [28, 8, 20], [28, 16, 20]], np.float32)
    kw = dict(mesh_vertices=quad_v, mesh_indices=np.array([[0, 1, 2]]), spp=1, max_frames=2,
              min_frames=2, variance_threshold=1e9, device="cpu")
    sw = f3t.hybrid_render_terrain_reference(dem, W, H, cam, traversal="sweep", **kw)
    dda = f3t.hybrid_render_terrain_reference(dem, W, H, cam, traversal="dda", **kw)
    assert "method" not in sw
    np.testing.assert_array_equal(sw["rgba"], dda["rgba"])
    down = dict(origin=(16.0, 40.0, 16.0), look_at=(16.0, 0.0, 16.001), fov_y=42.0)
    for fn in (f3d.hybrid_render_terrain_reference, f3t.hybrid_render_terrain_reference):
        extra = {} if fn is f3d.hybrid_render_terrain_reference else {"device": "cpu"}
        with pytest.raises(jts.SweepUnsupported if not extra else tts.SweepUnsupported):
            fn(dem, W, H, down, traversal="sweep", **extra)
    assert issubclass(tts.SweepUnsupported, terr.RenderError)
