# The port's perspective TerrainRenderer (forge3d_tpu_torch.terrain, kernel
# R1's plain version on the CPU) against the JAX package's TerrainRenderer:
# one `make_terrain_params(...)` built in JAX is rendered by both, the port
# receiving it through convert.terrain_params_from_dict, over a 65^2 DEM at
# 96x64 (a quarter to half of the frame is sky).
#
# Gates: rgba within one u8 step on >= 99.5% of pixels; hdr and the albedo,
# normal, depth and visibility AOVs within 1e-5 * (1 + |ref|) on >= 99.5% of
# elements; hit masks (depth NaN) equal on >= 99.9%; the consumed and
# ignored settings groups equal. Both sides round every float32 operation
# once in the same order, so they differ only where XLA's pow/exp/acos/
# atan2 differ from PyTorch's by an ulp.
import numpy as np
import pytest
import torch

from forge3d_tpu.terrain.params import make_terrain_params
from forge3d_tpu.terrain.renderer import IBL as JIBL
from forge3d_tpu.terrain.renderer import TerrainRenderer as JRenderer

from forge3d_tpu_torch.convert import terrain_params_from_dict
from forge3d_tpu_torch.errors import DeviceError, RenderError
from forge3d_tpu_torch.terrain import renderer as rr

torch.set_num_threads(1)

W, H = 96, 64
ENV = np.random.default_rng(3).uniform(0.0, 2.0, (16, 32, 3)).astype(np.float32)

CASES = {
    "defaults": {},
    "aa4": dict(sampling=dict(aa_samples=4, aa_seed=11)),
    "soft_shadows": dict(shadows=dict(softness=3.0, samples=3, intensity=0.8)),
    "fog": dict(fog=dict(enabled=True, density=0.02, height_falloff=0.05, start_distance=20.0)),
    "water": dict(water=dict(enabled=True, level=0.0)),
    "water_reflection": dict(water=dict(enabled=True, level=-1.0, reflectivity=0.8),
                             reflection=dict(enabled=True, intensity=0.7)),
    "clouds": dict(clouds=dict(enabled=True, scale=0.05, coverage=0.6)),
    "height_ao": dict(height_ao=dict(enabled=True, samples=3, radius=12.0), ao_weight=0.5),
    "material_layers": dict(material_layers=dict(enabled=True, snow_height=0.6,
                                                 rock_slope_deg=25.0)),
    "detail_triplanar_pom": dict(detail=dict(enabled=True), triplanar=dict(enabled=True),
                                 pom=dict(enabled=True, scale=0.5)),
    "tonemap_off": dict(tonemap=dict(mode="off", exposure=0.7)),
    "tonemap_reinhard_extended": dict(tonemap=dict(mode="reinhard_extended", white_point=2.0)),
    "tonemap_filmic": dict(tonemap=dict(mode="filmic")),
    "tonemap_aces": dict(tonemap=dict(mode="aces"), exposure=1.3),
    "srgb_out": dict(output_srgb_eotf=True),
    "debug_normals": dict(debug_mode="normals"),
    "constant_albedo": dict(albedo_mode="constant", constant_albedo=(0.3, 0.5, 0.2),
                            gamma=1.8),
    "curve_pow": dict(height_curve_mode="pow", height_curve_power=1.8,
                      colormap_strength=0.7),
    "curve_smoothstep": dict(height_curve_mode="smoothstep", height_curve_strength=0.8,
                             lambert_contrast=0.4),
    "ibl_env_map": dict(ibl=dict(enabled=True, intensity=0.6, env_map=ENV)),
    "ibl_hosek": dict(ibl=dict(enabled=True, turbidity=5.0)),
    "render_scale_roll": dict(render_scale=0.5, cam_gamma_deg=12.0,
                              light=dict(azimuth_deg=120.0, elevation_deg=25.0)),
    "ignored_groups": dict(reflection=dict(enabled=True), sun_visibility=dict(enabled=True)),
}


def dem65() -> np.ndarray:
    y, x = np.mgrid[0:65, 0:65].astype(np.float32)
    return (6.0 * np.sin(x * 0.15) * np.cos(y * 0.12) + 3.0 * np.sin(x * 0.4 + y * 0.3)
            ).astype(np.float32)


def jax_params(**kw):
    return make_terrain_params(size_px=(W, H), cam_radius=75.0, cam_theta_deg=30.0, **kw)


def port_params(p):
    return terrain_params_from_dict(p.to_dict(), env_map=p.ibl.env_map,
                                    height_curve_lut=p.height_curve_lut)


def within(ref, got, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return (np.abs(got - ref) <= tol * (1.0 + np.abs(ref))) | (np.isnan(ref) & np.isnan(got))


@pytest.fixture(scope="module")
def renderers():
    return JRenderer(), rr.TerrainRenderer(device="cpu")


@pytest.fixture(scope="module")
def default_rgba(renderers):
    return renderers[1].render_terrain_pbr_pom(params=port_params(jax_params()),
                                               heightmap=dem65()).rgba


@pytest.mark.parametrize("case", list(CASES))
def test_render_with_aov_matches_jax(renderers, default_rgba, case):
    jr, tr = renderers
    p = jax_params(**CASES[case])
    t = 2.5 if case == "clouds" else 0.0
    fj, aj = jr.render_with_aov(params=p, heightmap=dem65(), time_seconds=t)
    ft, at = tr.render_with_aov(params=port_params(p), heightmap=dem65(), time_seconds=t)
    assert ft.rgba.shape == fj.rgba.shape and ft.rgba.dtype == np.uint8
    du = np.abs(fj.rgba.astype(np.int32) - ft.rgba.astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= 0.995, case
    for k in ("hdr", "albedo", "normal", "depth", "visibility"):
        assert at[k].dtype == np.float32 and at[k].shape == aj[k].shape, k
        assert within(aj[k], at[k]).mean() >= 0.995, (case, k)
    hit_j, hit_t = np.isfinite(aj["depth"]), np.isfinite(at["depth"])
    assert (hit_j == hit_t).mean() >= 0.999
    assert 0.2 < hit_j.mean() < 0.9   # terrain and sky both in frame
    assert tr.last_consumed_settings == jr.last_consumed_settings
    assert tr.last_ignored_settings == jr.last_ignored_settings
    assert set(tr.last_gpu_timings) == set(jr.last_gpu_timings)
    assert {k: v for k, v in ft.metadata.items() if not k.endswith(("_ms", "timings"))} == \
        {k: v for k, v in fj.metadata.items() if not k.endswith(("_ms", "timings"))}
    if case not in ("defaults", "ignored_groups"):   # the setting changed the image
        assert ft.rgba.shape != default_rgba.shape or not np.array_equal(ft.rgba, default_rgba)


def test_beauty_render_equals_the_aov_render(renderers):
    _, tr = renderers
    p = port_params(jax_params(**CASES["soft_shadows"]))
    f = tr.render_terrain_pbr_pom(params=p, heightmap=dem65(), certificate={})
    fa, _ = tr.render_with_aov(params=p, heightmap=dem65())
    np.testing.assert_array_equal(f.rgba, fa.rgba)


def _error(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the type and message are compared
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("what", ["no_heightmap", "heightmap_1d", "heightmap_nan",
                                  "water_mask_shape", "target", "bad_env_map", "bad_params",
                                  "offline_twice", "render_during_offline",
                                  "accumulate_without_session", "resolve_before_samples",
                                  "accumulate_zero"])
def test_error_paths_match_jax(renderers, what):
    jr, tr = renderers
    dem = dem65()
    p = jax_params()

    def run(r, pp, ibl):
        if what == "no_heightmap":
            return lambda: r.render_with_aov(params=pp)
        if what == "heightmap_1d":
            return lambda: r.render_with_aov(params=pp, heightmap=dem[0])
        if what == "heightmap_nan":
            bad = dem.copy()
            bad[3, 4] = np.nan
            return lambda: r.render_with_aov(params=pp, heightmap=bad)
        if what == "water_mask_shape":
            return lambda: r.render_with_aov(params=pp, heightmap=dem,
                                             water_mask=np.zeros((4, 4)))
        if what == "target":
            return lambda: r.render_terrain_pbr_pom(params=pp, heightmap=dem, target=object())
        if what == "bad_env_map":
            return lambda: ibl(np.zeros((4, 4), np.float32))
        if what == "bad_params":
            pp.sampling.aa_samples = 0
            return lambda: r.render_with_aov(params=pp, heightmap=dem)
        if what == "accumulate_without_session":
            return lambda: r.accumulate_batch(1)

        def session():
            r.begin_offline_accumulation(params=pp, heightmap=dem)
            try:
                if what == "offline_twice":
                    r.begin_offline_accumulation(params=pp, heightmap=dem)
                elif what == "render_during_offline":
                    r.render_terrain_pbr_pom(params=pp, heightmap=dem)
                elif what == "resolve_before_samples":
                    r.resolve_offline_hdr()
                else:
                    r.accumulate_batch(0)
            finally:
                r.end_offline_accumulation()
        return session

    ref = _error(run(jr, jax_params(), JIBL))
    got = _error(run(tr, port_params(p), rr.IBL))
    assert ref is not None and got == ref


def test_unported_options_raise(renderers, tmp_path):
    _, tr = renderers
    dem = dem65()
    # a VT store no longer raises (ROADMAP item 7 is ported): the render runs
    # through R1's VT branch and reports the store's statistics
    from forge3d_tpu_torch.terrain import vt as tvt

    page = np.full((tvt.PAGE_SIZE, tvt.PAGE_SIZE, 4), 180, np.uint8)
    tvt.vt_pack(tmp_path / "s.f3dvt", {("albedo", 0, x, y): page for x in (0, 1) for y in (0, 1)})
    frame, _ = tr.render_with_aov(material_set=rr.MaterialSet(vt_store=tmp_path / "s.f3dvt"),
                                  params=port_params(jax_params()), heightmap=dem)
    assert frame.rgba.shape == (H, W, 4) and "vt" in tr.last_consumed_settings
    assert tr.last_vt_stats["pages_in_store"] == 4
    with pytest.raises(NotImplementedError, match="item 13"):
        tr.render_terrain_pbr_pom(params=port_params(jax_params()), heightmap=dem,
                                  cache="store")
    with pytest.raises(RenderError):
        tr.resolve_offline_hdr()


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        rr.TerrainRenderer()


def test_r1_on_a_64_km_terrain():
    """R1 on a terrain 64 km wide (MapScene over a 65^2 DEM with spacing
    (1000, 0), 96x64, shadows on with bias 0.001): the case ROADMAP queue 3
    logged. At 32 km the float32 spacing of a world coordinate (~0.004)
    exceeds the shadow bias, so a shadow ray starts inside the rounding of
    the surface and its first-hit decision turns on the last bit of the
    hit position. Held here:
    - the AOVs: hit masks and visibility equal, depth |d|/t <= 1e-4 (the
      trace rule), normals within 1e-5 * (1 + |ref|), and albedo within
      2.7e-3 (one ulp of t at 60 km moves the colormap's height by ~0.015 m;
      the CPU shows 2.67e-3);
    - the shadow decisions: from the same origins (the port's shadow-ray
      origins), JAX's standalone trace and the port's K5 plain version
      agree on every ray;
    - rgba: within one u8 step on >= 96% of pixels (the CPU shows 96.39%).
      The rest is JAX's own compilation: its R1 program is one jitted graph
      in which XLA fuses the hit position's multiply-add in some consumers
      and not in others (fusing it everywhere in the port moves this case to
      97.7% but breaks the byte-equality of the 2 m case in
      test_torch_mapscene.py), and its inlined shadow trace then decides
      differently from its standalone trace, which the port matches."""
    from forge3d_tpu import mapscene as jms
    from forge3d_tpu.ops import traversal as jtv
    from forge3d_tpu.ops.pyramid import build_pyramid as jbuild

    import jax.numpy as jnp

    from forge3d_tpu_torch.ops.traversal import normal_at, trace_plain

    y, x = np.mgrid[0:65, 0:65].astype(np.float32)
    dem = (6.0 * np.sin(x * 0.15) * np.cos(y * 0.12) + 3.0 + 0.05 * x).astype(np.float32)
    rec = jms.SceneRecipe(terrain=jms.TerrainSource(dem=dem, spacing=(1000.0, 0.0)),
                          output=jms.OutputSpec(size_px=(W, H)))
    plan = jms.MapScene(rec).compile_plan()
    p = plan["params"]
    assert p.shadows.enabled and p.shadows.bias == pytest.approx(0.001) and p.terrain_span == 64000
    fa, aa = JRenderer().render_with_aov(params=p, heightmap=plan["dem"])
    tr = rr.TerrainRenderer(device="cpu")
    pp = terrain_params_from_dict(p.to_dict())
    fb, ab = tr.render_with_aov(params=pp, heightmap=plan["dem"])
    ref, got = ({k: np.asarray(a[k]) for k in ("depth", "normal", "visibility", "albedo")}
                for a in (aa, ab))
    hit = np.isfinite(ref["depth"])
    np.testing.assert_array_equal(np.isfinite(got["depth"]), hit)
    np.testing.assert_array_equal(got["visibility"], ref["visibility"])
    assert 0.1 < hit.mean() < 0.9
    assert np.all(np.abs(got["depth"][hit] - ref["depth"][hit]) / ref["depth"][hit] <= 1e-4)
    assert np.all(np.abs(got["normal"] - ref["normal"]) <= 1e-5 * (1 + np.abs(ref["normal"])))
    assert np.abs(got["albedo"] - ref["albedo"]).max() <= 2.7e-3

    # the shadow rays from the port's origins, traced by both packages
    _, scene, a, _ = tr.render_inputs(params=pp, heightmap=plan["dem"])
    zero = torch.zeros(H, W)
    d = rr.camera_rays_r1(a, zero, zero)
    o = tuple(torch.full((H, W), c) for c in a.cam_o)
    h = trace_plain(scene, o, d)
    pos = [o[k] + h.t * d[k] for k in range(3)]
    n = normal_at(scene, pos, h.cell_x, h.cell_z)
    sro = [pos[k] + n[k] * 1e-3 + float(np.float32(a.sun[k]) * np.float32(a.shadow_bias))
           for k in range(3)]
    sdir = [torch.full((H, W), s) for s in a.sun]
    occ_t = trace_plain(scene, sro, sdir).hit.numpy()
    js, jst = jtv.scene_from_pyramid(jbuild(plan["dem"]), spacing_xz=scene.spacing_xz,
                                     exaggeration=scene.exaggeration)
    occ_j = np.asarray(jtv.trace(js, jst, tuple(jnp.asarray(c.numpy()) for c in sro),
                                 tuple(jnp.asarray(c.numpy()) for c in sdir)).hit)
    lit = h.hit.numpy()
    np.testing.assert_array_equal(occ_t[lit], occ_j[lit])
    assert occ_t[lit].any()

    du = np.abs(fa.rgba.astype(np.int32) - fb.rgba.astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= 0.96
