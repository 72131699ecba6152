# The port's screen-mode kernels S1-S7 (forge3d_tpu_torch/terrain/screen.py,
# their plain versions on the CPU) against the JAX package's functions in
# forge3d_tpu/terrain/screen.py, on the same inputs made with numpy from a
# seed, and render_screen_scene's options that TerrainRenderer does not
# reach (the filterable height sampler, the sRGB encode, the "consistent"
# and "recipe" golden generations, POM and the aerial sky with them), with
# the refusals of both packages.
#
# Gates: S1-S3 f16 cubes bit-equal on >= 99.9% of texels and within one f16
# step elsewhere; S4's light matrix, texel size, triangles, orientation vote
# and box bounds equal, depth equal on >= 99.9% of texels; S5's visibility
# within 1e-5 * (1 + |ref|) on >= 99.5% of receivers; S7's uv and layer
# within 1e-5 * (1 + |ref|) on every lane and its crossed flags equal; S6's
# cooked uniforms bit-equal, its u8 sky steps equal on every pixel (the CPU
# showed them all equal; the gate the port set is >= 99.5%, never more than
# one step apart); whole renders rgba
# within one u8 step on >= 99.5% of pixels and the AOVs within
# 1e-5 * (1 + |ref|) on >= 99.5% of elements. Both sides round every
# float32 operation once in the same order; they differ where XLA's
# atan2/acos/sin/exp/pow differ from PyTorch's by an ulp, and where a
# threshold test (a PCSS tap against a depth) lands on the other side.
#
# Every render of this file uses one DEM, sun, span (1.0, so that both
# golden generations raster the same shadow map), z scale, domain and
# environment, so each package builds its IBL pyramid and shadow map once.
import numpy as np
import pytest
import torch

from forge3d_tpu.terrain import screen as J

from forge3d_tpu_torch import colormaps
from forge3d_tpu_torch.terrain import screen as T

torch.set_num_threads(1)

FRAC = 0.999
REND_FRAC = 0.995


def dem_n(n):
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    return (4.0 * np.sin(x * 0.21) * np.cos(y * 0.17)).astype(np.float32)


def within(ref, got, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(got - ref) <= tol * (1.0 + np.abs(ref))


def f16_agree(ref, got):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert ref.shape == got.shape
    step = np.maximum(np.abs(ref), 2.0 ** -14) * 2.0 ** -10
    return (ref == got).mean(), bool((np.abs(got - ref) <= step * 1.0001).all())


EQ = np.random.default_rng(21).uniform(0.0, 3.0, (16, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def cube32():
    return np.array(J._ibl_env_cube(EQ, env_size=32))


def test_env_cube_s1(cube32):
    got = T.env_cube(torch.as_tensor(EQ), 32).numpy()
    frac, one_step = f16_agree(cube32, got)
    assert frac >= FRAC and one_step
    gradient = J.decode_test_hdr()
    frac, one_step = f16_agree(np.asarray(J._ibl_env_cube(gradient, env_size=32)),
                               T.env_cube(torch.as_tensor(gradient), 32).numpy())
    assert frac >= FRAC and one_step


def test_irradiance_s2(cube32):
    ref = np.asarray(J._ibl_irradiance(cube32))
    got = T.cube_convolve(torch.as_tensor(cube32), 0).numpy()
    frac, one_step = f16_agree(ref, got)
    assert got.shape == (6, 128, 128, 3) and frac >= FRAC and one_step


@pytest.mark.parametrize("mip", [1, 2, 3, 4, 5])
def test_prefilter_s3(cube32, mip):
    ref = np.asarray(J._ibl_prefilter_mip(cube32, mip))
    got = T.cube_convolve(torch.as_tensor(cube32), mip).numpy()
    frac, one_step = f16_agree(ref, got)
    assert frac >= FRAC and one_step


def test_cube_pyramid_s2_s3(cube32):
    """build_ibl's entry for S2 and S3 (one launch on the card): on the CPU
    the six plain convolutions, each JAX's within the gates, and each the
    per-mip call's bit for bit."""
    env = torch.as_tensor(cube32)
    got = T.cube_pyramid(env)
    assert len(got) == T.N_MIPS
    refs = [J._ibl_irradiance(cube32)] + [J._ibl_prefilter_mip(cube32, m)
                                          for m in range(1, T.N_MIPS)]
    for mip, (ref, g) in enumerate(zip(refs, got)):
        frac, one_step = f16_agree(np.asarray(ref), g.numpy())
        assert frac >= FRAC and one_step, mip
        assert torch.equal(g, T.cube_convolve(env, mip)), mip


def test_lobe_samples_and_face_dirs():
    np.testing.assert_array_equal(T._face_dirs(8), J._face_dirs(8))
    np.testing.assert_array_equal(T._hammersley(64), J._hammersley(64))
    assert T.lobe_samples(0).shape == (128, 3) and T.lobe_samples(5).shape == (64, 3)


SUN = -J.light_direction(135.0, 24.0)


@pytest.fixture(scope="module")
def shadow512(tmp_path_factory):
    """JAX's build_shadow_map at 512^2 over a 128^2 grid, computed afresh in
    a scratch cache with its raster's inputs recorded."""
    dem = dem_n(65)
    dom = (float(dem.min()), float(dem.max()))
    seen = {}
    raster = J._raster_depth

    def spy(tris, keep, resolution, wbb, hbb):
        seen.update(tris=np.asarray(tris), keep=np.asarray(keep), wbb=wbb, hbb=hbb)
        return raster(tris, keep, resolution, wbb, hbb)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "CACHE_DIR", tmp_path_factory.mktemp("jax_screen_cache"))
        mp.setattr(J, "_raster_depth", spy)
        depth, lvp, texel = J.build_shadow_map(dem, terrain_span=2.8, z_scale=1.45,
                                               sun_dir=SUN, resolution=512, grid_res=128,
                                               domain=dom)
    return dem, dom, np.asarray(depth), lvp, texel, seen


def test_shadow_geometry_and_raster_s4(shadow512):
    dem, dom, depth, lvp, texel, seen = shadow512
    lvp_t, texel_t, tris, keep, wbb, hbb = T.shadow_geometry(
        dem, terrain_span=2.8, z_scale=1.45, sun_dir=SUN, resolution=512, grid_res=128,
        domain=dom)
    np.testing.assert_array_equal(lvp_t, lvp)
    assert texel_t == texel
    np.testing.assert_array_equal(tris, seen["tris"])
    np.testing.assert_array_equal(keep, seen["keep"])
    assert (wbb, hbb) == (seen["wbb"], seen["hbb"])
    got, lvp_b, texel_b = T.build_shadow_map(dem, terrain_span=2.8, z_scale=1.45, sun_dir=SUN,
                                             resolution=512, grid_res=128, domain=dom,
                                             device="cpu")
    np.testing.assert_array_equal(lvp_b, lvp)
    assert (got.numpy() == depth).mean() >= FRAC
    assert 0.05 < (depth < 1.0).mean() < 1.0     # the terrain covers part of the map


def test_pcss_s5(shadow512):
    _, _, depth, lvp, _, _ = shadow512
    rng = np.random.default_rng(22)
    n = 2048
    pos = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                    rng.uniform(0.0, 1.45, n)], -1).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm[:, 1] = np.abs(nrm[:, 1]) + 0.5
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    ref = np.asarray(J.pcss_visibility(depth, lvp, None, pos, nrm, -SUN))
    got = T.pcss_visibility(torch.as_tensor(depth), lvp, None, torch.as_tensor(pos),
                            torch.as_tensor(nrm), -SUN).numpy()
    assert within(ref, got).mean() >= REND_FRAC
    assert 0.05 < (ref < 1.0).mean() < 0.95      # receivers both lit and shadowed


# ---------------------------------------------------------------------------
# render_screen_scene: the options TerrainRenderer does not set
# ---------------------------------------------------------------------------

DEM = dem_n(65)
DOM = (float(DEM.min()), float(DEM.max()))
LUT = np.asarray(colormaps.get_lut("viridis"), np.float32)[:, :3]
BASE = dict(terrain_span=1.0, z_scale=1.45, domain=DOM, hdr_rgb=J.decode_test_hdr())


def test_render_screen_scene_matches_jax():
    """The filterable height sampler, the sRGB encode and the "consistent"
    generation's shadow span and IBL fill, in one render."""
    kw = dict(BASE, size_px=(96, 64), height_filterable=True, encode="srgb",
              generation="consistent", hue_variation_strength=0.15, ibl_intensity=1.0)
    a, aa = J.render_screen_scene(DEM, LUT, return_aov=True, **kw)
    b, ab = T.render_screen_scene(DEM, LUT, return_aov=True, device="cpu", **kw)
    assert b.shape == a.shape and b.dtype == np.uint8
    du = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= REND_FRAC
    for k in ("albedo", "normal", "depth"):
        assert ab[k].shape == aa[k].shape and ab[k].dtype == np.float32, k
        assert within(aa[k], ab[k]).mean() >= REND_FRAC, k
    assert a[..., :3].std() > 5.0


def test_odd_sizes_refused_by_both():
    kw = dict(BASE, size_px=(65, 48))
    with pytest.raises(TypeError):      # JAX fails tracing the quad derivatives
        J.render_screen_scene(DEM, LUT, **kw)
    with pytest.raises(ValueError, match="even"):
        T.render_screen_scene(DEM, LUT, device="cpu", **kw)
    with pytest.raises(ValueError, match="even"):
        T.render_screen_scene(DEM, LUT, device="cpu", **dict(BASE, size_px=(64, 47)))


def test_unported_branches_refused():
    """Both packages refuse a sky that lacks its settings, with the same
    KeyError from _cook_sky_uniforms (the port no longer refuses the aerial
    sky or POM: see test_pom_and_sky_render_matches_jax)."""
    bare = dict(enabled=True, aerial_perspective=True)
    with pytest.raises(KeyError) as ref:
        J._cook_sky_uniforms(bare, J.light_direction(135.0, 24.0))
    with pytest.raises(KeyError) as got:
        T.render_screen_scene(DEM, LUT, size_px=(64, 48), device="cpu", sky=bare)
    assert got.value.args == ref.value.args == ("turbidity",)


def test_prepasses_default_to_cuda():
    """build_ibl and build_shadow_map called as the JAX package's are run on
    the card: without CUDA they raise DeviceError."""
    from forge3d_tpu_torch.errors import DeviceError

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        T.build_ibl(J.decode_test_hdr())
    with pytest.raises(DeviceError, match="CUDA is not available"):
        T.build_shadow_map(DEM, terrain_span=2.8, z_scale=1.45, sun_dir=SUN, domain=DOM)


# ---------------------------------------------------------------------------
# S7 and S6 alone
# ---------------------------------------------------------------------------

def _pom_field(n=2048, seed=23):
    """Normals (a fifth of them straight up) and view directions, grazing
    and near-normal, with uv across the map."""
    rng = np.random.default_rng(seed)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm[:, 1] = np.abs(nrm[:, 1]) + 0.05
    nrm[: n // 5] = (0.0, 1.0, 0.0)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    vd = rng.standard_normal((n, 3)).astype(np.float32)
    vd[: n // 4, 2] = 20.0          # near-normal to the TBN's z
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    return nrm, vd, rng.uniform(0, 1, n).astype(np.float32), rng.uniform(0, 1, n).astype(np.float32)


@pytest.mark.parametrize("filterable", [False, True], ids=["nearest", "bilinear"])
@pytest.mark.parametrize("metres", [False, True], ids=["unit", "metres"])
@pytest.mark.parametrize("refine", [0, 4])
def test_pom_uv_s7(filterable, metres, refine):
    import jax.numpy as jnp

    hm = (0.5 + 0.4 * np.sin(np.mgrid[0:33, 0:33][1] * 0.3)
          * np.cos(np.mgrid[0:33, 0:33][0] * 0.25)).astype(np.float32)
    if metres:
        hm = (hm * 800.0 + 1200.0).astype(np.float32)
    nrm, vd, u, v = _pom_field()
    kw = dict(scale=0.04, min_steps=12, max_steps=40, refine_steps=refine)
    ref = J._pom_uv(jnp.asarray(hm), jnp.asarray(u), jnp.asarray(v), jnp.asarray(nrm),
                    jnp.asarray(vd), samp=J._bilinear if filterable else J._nearest, **kw)
    got = T._pom_uv(torch.as_tensor(hm), torch.as_tensor(u), torch.as_tensor(v),
                    [torch.as_tensor(nrm[:, c]) for c in range(3)],
                    [torch.as_tensor(vd[:, c]) for c in range(3)],
                    samp=T._bilinear if filterable else T._nearest, **kw)
    for r, g in zip(ref[:3], got[:3]):
        assert within(np.asarray(r), g.numpy()).all()
    crossed = np.asarray(ref[3])
    np.testing.assert_array_equal(crossed, got[3].numpy())
    # a unit DEM stops lanes at different steps; over metres every lane marches to the end
    assert (crossed.mean() > 0.5) if not metres else not crossed.any()


SKY = dict(enabled=True, turbidity=3.0, ground_albedo=0.3, sun_intensity=1.0, sun_size=1.0,
           sky_exposure=1.0, aerial_density=1.0, aerial_perspective=True)


@pytest.mark.parametrize("model", ["hosek-wilkie", "preetham"])
def test_render_sky_s6(model):
    import jax.numpy as jnp

    eye = J.orbit_eye(5.0, 138.0, 18.0)     # a low camera: the sky fills the frame's top
    view = J.look_at_rh(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    proj = J.perspective_proj(54.0, 64 / 48, 0.1, 6000.0)
    for turb, el in ((3.0, 24.0), (8.0, 4.0)):
        ldir = J.light_direction(135.0, el)
        cfg = dict(SKY, model=model, turbidity=turb)
        ck, ck_t = J._cook_sky_uniforms(cfg, ldir), T._cook_sky_uniforms(cfg, ldir)
        assert set(ck) == set(ck_t)
        for k in ck:
            np.testing.assert_array_equal(np.asarray(ck[k]), np.asarray(ck_t[k]), err_msg=k)
        iv, ip = np.linalg.inv(view), np.linalg.inv(proj)
        ref = np.asarray(J._render_sky(64, 48, inv_view=jnp.asarray(iv), inv_proj=jnp.asarray(ip),
                                       u={k: jnp.asarray(x) for k, x in ck.items()}, model=model))
        got = T._render_sky(64, 48, inv_view=iv, inv_proj=ip, u=ck_t, model=model).numpy()
        # every u8 step equal: the CPU shows no pixel a step apart
        np.testing.assert_array_equal(np.rint(ref * 255.0), np.rint(got * 255.0))
        assert ref.std() > 0.01


@pytest.mark.parametrize("case", ["pom_preetham_filterable", "recipe_reflection_sky"])
def test_pom_and_sky_render_matches_jax(case):
    """POM (min/max steps, refinements) under the Preetham aerial sky with the
    filterable sampler; and the recipe generation (no layer->height switch)
    with water and a reflection, whose mirrored pass renders the Hosek sky."""
    pom = dict(enabled=True, height_scale=0.04, min_steps=12, max_steps=40, refine_steps=4)
    if case == "pom_preetham_filterable":
        kw = dict(height_filterable=True, pom=dict(pom, height_scale=0.05, max_steps=24),
                  sky=dict(SKY, model="preetham", turbidity=5.0))
    else:
        lo, hi = DOM
        kw = dict(generation="recipe", pom=pom, sky=dict(SKY, model="hosek-wilkie"),
                  water_mask=np.clip((lo + 0.3 * (hi - lo) - DEM) / (0.1 * (hi - lo)), 0, 1
                                     ).astype(np.float32),
                  reflection=dict(enabled=True, wave_strength=0.05, shore_atten_width=0.3))
    kw = dict(BASE, size_px=(64, 48), ibl_intensity=1.0, **kw)
    a, aa = J.render_screen_scene(DEM, LUT, return_aov=True, **kw)
    b, ab = T.render_screen_scene(DEM, LUT, return_aov=True, device="cpu", **kw)
    du = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= REND_FRAC
    for k in ("albedo", "normal", "depth"):
        assert within(aa[k], ab[k]).mean() >= REND_FRAC, k
    plain = J.render_screen_scene(DEM, LUT, **dict(kw, pom=None, sky=None))
    assert (np.abs(plain.astype(np.int32) - a.astype(np.int32)).max(-1) > 2).mean() > 0.05


def test_caches_are_bounded_and_charged():
    from forge3d_tpu_torch.mem import global_tracker

    before = global_tracker().metrics()["tracked_bytes"]
    T.build_ibl(J.decode_test_hdr(), device="cpu")
    assert len(T._IBL_CACHE) <= T.CACHE_ENTRIES
    assert any(k[0] == T._hash(J.decode_test_hdr().astype(np.float32), "iblj-v1", "golden")
               for k in T._IBL_CACHE)
    assert global_tracker().metrics()["tracked_bytes"] >= before
