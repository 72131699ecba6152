# The plain versions of the sweep estimator's per-frame polar scan (K3:
# forge3d_tpu_torch.pt.terrain_sweep.frame_polar_plain and the
# ops/polarscan.py pieces) and of its resolve (K4: resolve_plain) against
# the JAX package on the CPU, each on the JAX side's own intermediates
# (rotated grid, sweep maps, polar accumulator) passed over as numpy.
#
# Tolerances:
# - polar images and the polarscan pieces: |d| <= 1e-5 * (1 + |ref|) on
#   >= 99.5% of elements (a last-ulp difference in a running max can move a
#   crossing's lerp fraction on a few texels);
# - the packed resolve: vis and octahedral bytes within 1 step, depth
#   within float16 rounding (1e-3 relative) with equal NaN masks, hdr within
#   RGBE rounding (1/128 of the pixel's largest channel), each on >= 99.9%
#   of pixels.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forge3d_tpu.ops import polarscan as jps
from forge3d_tpu.ops import sweep as jsw
from forge3d_tpu.ops.shading import EnvMap as JEnvMap
from forge3d_tpu.pt import terrain_sweep as jts
from forge3d_tpu.pt.terrain_ref import TerrainRefDesc as JDesc

from forge3d_tpu_torch import convert
from forge3d_tpu_torch.ops import polarscan as tps
from forge3d_tpu_torch.pt import terrain_ref as ttr
from forge3d_tpu_torch.pt import terrain_sweep as tts

torch.set_num_threads(1)

ENV = np.random.default_rng(4).uniform(0, 2, (8, 16, 3)).astype(np.float32)


def close_frac(ref, got, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float((np.abs(got - ref) <= tol * (1.0 + np.abs(ref))).mean())


class JaxSide:
    """The JAX pipeline of one scene and its per-render arguments."""

    def __init__(self, env):
        n = 33
        y, x = np.mgrid[0:n, 0:n].astype(np.float32)
        dem = (4.0 * np.sin(x * 0.2) * np.cos(y * 0.17)).astype(np.float32)
        common = dict(heights=dem, width=64, height=48, cam_origin=(16.0, 14.0, 46.0),
                      cam_look_at=(16.0, 0.0, 16.0), fov_y_deg=42.0, env_map=env,
                      env_intensity=0.6 if env is not None else 0.35)
        self.jd, self.td = JDesc(**common), ttr.TerrainRefDesc(**common)
        jd = self.jd
        (self.rg, self.ps, prepare, self.frame_fn, self.resolve,
         _) = jts._build_pipeline(
            dem.shape, tuple(map(float, jd.spacing)), float(jd.exaggeration),
            tuple(map(float, jd.cam_origin)), tuple(map(float, jd.cam_look_at)),
            tuple(map(float, jd.cam_up)), float(jd.fov_y_deg), jd.width, jd.height,
            32, 12, -0.55, float(jd.sun_azimuth_deg), float(jd.sun_elevation_deg),
            bool(jd.shadows_enabled), None if env is None else env.shape)
        self.hj = jnp.asarray(dem)
        self.rot = prepare(self.hj)
        self.env = JEnvMap(rgb=None if env is None else jnp.asarray(env),
                           intensity=jnp.float32(jd.env_intensity))
        self.args = (self.env, jnp.asarray([jd.sun_intensity * c for c in jd.sun_color],
                                           jnp.float32),
                     jnp.asarray(jd.albedo, jnp.float32),
                     jnp.float32(1e-4 * (float(dem.max() - dem.min()) + 1.0)))
        self.plan = convert.sweep_plan_from_jax_fields(tts.plan_for(self.td),
                                                       self.rg.__dict__, self.ps.__dict__)
        self.scene = tts.make_scene(self.td, "cpu")

    def key(self, seed, i):
        return jax.random.fold_in(jax.random.PRNGKey(seed), i)

    def polar(self, keys):
        """Sum over the frames of `keys` of the JAX frame program."""
        return self.frame_fn(self.hj, *self.rot, *self.args, jnp.stack(keys))

    def maps(self, key):
        k_sky = jax.random.split(key, 4)[0]
        strata = jsw.make_strata()
        return jax.jit(lambda h, du, dv, k: jsw.sweep_lighting(
            h, du, dv, strata=strata, key=k, env=self.env, e_u=self.rg.e_u, e_v=self.rg.e_v,
            sun_world=self.plan.sun_w, spacing=self.rg.spacing))(*self.rot, k_sky)


@pytest.fixture(scope="module", params=["constant_env", "env_map"])
def side(request):
    return JaxSide(None if request.param == "constant_env" else ENV)


@pytest.mark.parametrize("seed,frame", [(3, 0), (7, 5)])
def test_frame_polar_matches_jax(side, seed, frame):
    """K3's plain version on JAX's rotated grid and sweep maps, against the
    JAX frame program (whose own sweep runs inside it)."""
    key = side.key(seed, frame)
    ref = np.asarray(side.polar([key]))
    maps = side.maps(key)
    jit = tts.FrameJitter(np.asarray(key))
    got = tts.frame_polar_plain(side.plan, side.scene, convert.tensor(side.rot[0]),
                                convert.sweep_maps(maps.e_sky, maps.z_sun),
                                jit.xi, jit.ja, jit.je)
    assert got.shape == ref.shape == (side.plan.ps.e_count, side.plan.ps.a_count, 9)
    assert close_frac(ref, got.numpy()) >= 0.995
    assert 0.2 < float(got[..., 7].mean()) < 1.0   # the frame hits terrain and sky


def test_resolve_matches_jax(side):
    """K4's plain version on JAX's mean polar image."""
    mean = side.polar([side.key(5, 0), side.key(5, 1)]) / jnp.float32(2)
    ref = np.asarray(side.resolve(mean, jnp.float32(1.0)))
    got = tts.resolve_plain(side.plan, convert.tensor(mean), 1).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    W, H = side.td.width, side.td.height
    n = W * H
    steps = np.abs(ref.astype(np.int32) - got.astype(np.int32))
    assert (steps[:3 * n] <= 1).mean() >= 0.999                 # vis, octahedral
    a = tts._unpack_render(side.td, ref, 2)
    b = tts._unpack_render(side.td, got, 2)
    np.testing.assert_array_equal(np.isnan(a["depth"]), np.isnan(b["depth"]))
    hit = ~np.isnan(a["depth"])
    assert (np.abs(a["depth"][hit] - b["depth"][hit])
            <= 1e-3 * np.abs(a["depth"][hit])).mean() >= 0.999
    tol = np.abs(a["hdr"]).max(-1, keepdims=True) / 128
    assert (np.abs(a["hdr"] - b["hdr"]) <= tol).mean() >= 0.999
    assert (ref[3 * n:5 * n] == got[3 * n:5 * n]).mean() >= 0.999   # f16 bits, NaN included


def test_polarscan_pieces_match_jax(side):
    """extract_profiles, profile_hit_tangents, synthesize_polar,
    polar_directions and warp_to_screen on random inputs."""
    ps = side.ps
    assert side.plan.ps == tps.PolarStatic(**ps.__dict__)
    rng = np.random.default_rng(9)
    n_v, n_u = side.rg.n_v, side.rg.n_u
    rotbuf = rng.normal(size=(n_v, n_u, 3)).astype(np.float32)
    rotbuf[:3, :, 0] = -1e30
    xi, ja, je = np.float32(0.3), np.float32(-0.2), np.float32(0.1)
    pj = jps.extract_profiles(jnp.asarray(rotbuf), ps, xi=xi, ja=ja)
    pt = tps.extract_profiles(torch.as_tensor(rotbuf), side.plan.ps, xi=float(xi),
                              ja=float(ja))
    assert close_frac(pj, pt.numpy()) >= 0.995
    h = np.array(pj[..., 0])
    qj, tj = jps.profile_hit_tangents(jnp.asarray(h), ps, xi=xi, ja=ja)
    qt, tt = tps.profile_hit_tangents(torch.as_tensor(h), side.plan.ps, xi=float(xi),
                                      ja=float(ja))
    assert close_frac(qj, qt.numpy()) >= 0.995 and close_frac(tj, tt.numpy()) >= 0.995
    K, A = h.shape
    values = rng.normal(size=(K, A, 4)).astype(np.float32)
    miss = rng.normal(size=(ps.e_count, A, 4)).astype(np.float32)
    sj = jps.synthesize_polar(jnp.asarray(values), qj, jnp.asarray(miss), ps, je=je)
    st = tps.synthesize_polar(torch.as_tensor(values), convert.tensor(qj),
                              torch.as_tensor(miss), side.plan.ps, je=float(je))
    assert close_frac(sj, st.numpy()) >= 0.995
    dj = jps.polar_directions(ps, ja=ja, je=je)
    dt = tps.polar_directions(side.plan.ps, ja=float(ja), je=float(je))
    for a, b in zip(dj, dt):
        assert close_frac(a, b.numpy()) >= 0.995
    pol = rng.uniform(size=(ps.e_count, A, 3)).astype(np.float32)
    for ss in (1, 2):
        wj = jps.warp_to_screen(jnp.asarray(pol), ps, width=64, height=48, supersample=ss)
        wt = tps.warp_to_screen(torch.as_tensor(pol), side.plan.ps, width=64, height=48,
                                supersample=ss)
        assert close_frac(wj, wt.numpy()) >= 0.995
