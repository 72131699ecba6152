# Whole screen-mode renders of the port (forge3d_tpu_torch: TerrainRenderer
# with camera_mode="screen" and render_screen_scene, the plain versions of
# S1-S8 on the CPU, POM and the aerial sky included) against the JAX
# package's, at 64x48 and 96x64.
#
# Gates (ROADMAP's rule): rgba within one u8 step on >= 99.5% of pixels; the
# albedo, normal and depth AOVs within 1e-5 * (1 + |ref|) on >= 99.5% of
# elements; metadata, timing keys and the consumed and ignored settings
# groups equal. Both sides round every float32 operation once in the same
# order; they differ where XLA's sin/exp/pow differ from PyTorch's by an
# ulp, and where a PCSS tap's depth test lands on the other side.
#
# Every case renders one DEM with one sun, span, z scale, domain and
# environment (the gradient env, bound also where the IBL is off), so each
# package builds its IBL pyramid and its shadow map once for the file.
import numpy as np
import pytest
import torch

from forge3d_tpu.terrain import screen as J
from forge3d_tpu.terrain.params import make_terrain_params
from forge3d_tpu.terrain.renderer import IBL as JIBL
from forge3d_tpu.terrain.renderer import TerrainRenderer as JRenderer

from forge3d_tpu_torch import colormaps
from forge3d_tpu_torch.convert import terrain_params_from_dict
from forge3d_tpu_torch.terrain import renderer as rr
from forge3d_tpu_torch.terrain import screen as T

torch.set_num_threads(1)

FRAC = 0.995


def dem65():
    y, x = np.mgrid[0:65, 0:65].astype(np.float32)
    return (4.0 * np.sin(x * 0.21) * np.cos(y * 0.17)).astype(np.float32)


DEM = dem65()
LO, HI = float(DEM.min()), float(DEM.max())
ENV = J.decode_test_hdr()
# the water mask: the DEM's lowest 20% of heights, with a shore band of
# fractional values over the next 10%
WATER = np.clip((LO + 0.3 * (HI - LO) - DEM) / (0.1 * (HI - LO)), 0.0, 1.0).astype(np.float32)
SCENE = dict(camera_mode="screen", terrain_span=2.8, z_scale=1.45, colormap="viridis",
             light=dict(azimuth_deg=135.0, elevation_deg=24.0, intensity=2.4))
CAM = dict(cam_radius=5.0, cam_phi_deg=138.0, cam_theta_deg=63.0, fov_y_deg=54.0,
           clip=(0.1, 6000.0))
LAYERS = dict(enabled=True, snow_enabled=True, snow_altitude_min=0.2, snow_altitude_blend=0.5,
              snow_subsurface_strength=0.6, snow_subsurface_tint=(0.9, 0.95, 1.0),
              rock_enabled=True, rock_slope_min=-30.0, rock_subsurface_strength=0.3,
              rock_subsurface_tint=(1.0, 0.8, 0.7), wetness_enabled=True,
              wetness_subsurface_strength=0.2)

CASES = {
    "A_defaults": dict(size_px=(64, 48)),
    "ibl_hue": dict(size_px=(64, 48), ibl=dict(enabled=True, intensity=1.0),
                    hue_variation_strength=0.08, **CAM),
    "water_reflection": dict(size_px=(64, 48), ibl=dict(enabled=True, intensity=1.0),
                             water=True, reflection=dict(enabled=True, intensity=0.8,
                                                         wave_strength=0.05,
                                                         shore_atten_width=0.3), **CAM),
    "layers_sss_mix": dict(size_px=(96, 64), material_layers=LAYERS, albedo_mode="mix",
                           colormap_strength=0.5, hue_variation_strength=0.08, **CAM),
    "constant_nonunit_domain": dict(size_px=(64, 48), albedo_mode="constant",
                                    constant_albedo=(0.5, 0.4, 0.3), **CAM),
    "render_scale_blit": dict(size_px=(64, 48), render_scale=1.25, **CAM),
    # S7 with the family generation's layer->height switch, and S6's Hosek
    # sky with the aerial perspective
    "pom_family_hosek_sky": dict(size_px=(64, 48), ibl=dict(enabled=True, intensity=1.0),
                                 pom=dict(enabled=True, scale=0.04, min_steps=12, max_steps=40,
                                          refine_steps=4),
                                 sky=dict(enabled=True, model="hosek-wilkie", turbidity=3.0,
                                          aerial_perspective=True, aerial_density=2.0),
                                 hue_variation_strength=0.08, **CAM),
}


def params(case):
    kw = dict(CASES[case])
    water = kw.pop("water", False)
    p = make_terrain_params(**SCENE, **kw)
    return p, (WATER if water else None)


def within(ref, got, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(got - ref) <= tol * (1.0 + np.abs(ref))


@pytest.fixture(scope="module")
def renderers():
    return JRenderer(), rr.TerrainRenderer(device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_screen_render_with_aov_matches_jax(renderers, case):
    jr, tr = renderers
    p, wm = params(case)
    fj, aj = jr.render_with_aov(env_maps=JIBL(ENV), params=p, heightmap=DEM, water_mask=wm)
    ft, at = tr.render_with_aov(env_maps=rr.IBL(ENV), params=terrain_params_from_dict(p.to_dict()),
                                heightmap=DEM, water_mask=wm)
    assert ft.rgba.shape == fj.rgba.shape == (p.size_px[1], p.size_px[0], 4)
    du = np.abs(fj.rgba.astype(np.int32) - ft.rgba.astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= FRAC, case
    assert set(at.aovs) == set(aj.aovs) == {"albedo", "normal", "depth"}
    for k in ("albedo", "normal", "depth"):
        ref = np.broadcast_to(aj[k], at[k].shape)   # JAX keeps a constant albedo (1, 1, 3)
        assert at[k].dtype == np.float32, k
        assert within(ref, at[k]).mean() >= FRAC, (case, k)
    assert tr.last_consumed_settings == jr.last_consumed_settings
    assert tr.last_ignored_settings == jr.last_ignored_settings
    assert set(tr.last_gpu_timings) == set(jr.last_gpu_timings)
    assert {k: v for k, v in ft.metadata.items() if not k.endswith(("_ms", "timings"))} == \
        {k: v for k, v in fj.metadata.items() if not k.endswith(("_ms", "timings"))}
    assert fj.rgba[..., :3].std() > 5.0
    if wm is not None:   # the water and its shore band are in frame
        assert 0.02 < (np.abs(aj["normal"][..., 1] - at["normal"][..., 1]) < 1.0).mean()


def test_material_maps_through_render_screen_scene():
    rng = np.random.default_rng(31)
    maps = {"normal": rng.uniform(0.2, 1.0, (16, 16, 3)).astype(np.float32),
            "roughness": rng.uniform(0.0, 1.0, (16, 16)).astype(np.float32),
            "mask": rng.uniform(0.0, 1.0, (16, 16)).astype(np.float32)}
    lut = np.asarray(colormaps.get_lut("viridis"), np.float32)[:, :3]
    kw = dict(size_px=(64, 48), terrain_span=2.8, z_scale=1.45, domain=(LO, HI), hdr_rgb=ENV,
              ibl_intensity=1.0, material_maps=maps, albedo_mode="material")
    a, aa = J.render_screen_scene(DEM, lut, return_aov=True, **kw)
    b, ab = T.render_screen_scene(DEM, lut, return_aov=True, device="cpu", **kw)
    du = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= FRAC
    for k in ("albedo", "normal", "depth"):
        assert within(aa[k], ab[k]).mean() >= FRAC, k
    plain = T.render_screen_scene(DEM, lut, device="cpu", **dict(kw, material_maps=None))
    assert not np.array_equal(plain, b)   # the maps changed the image


def test_beauty_render_equals_the_aov_render(renderers):
    _, tr = renderers
    p, _ = params("ibl_hue")
    pt = terrain_params_from_dict(p.to_dict())
    f = tr.render_terrain_pbr_pom(env_maps=rr.IBL(ENV), params=pt, heightmap=DEM, certificate={})
    fa, _ = tr.render_with_aov(env_maps=rr.IBL(ENV), params=pt, heightmap=DEM)
    np.testing.assert_array_equal(f.rgba, fa.rgba)


def test_screen_refusals(renderers):
    """Odd sizes are refused by both (POM and the aerial sky no longer are:
    see the case pom_family_hosek_sky)."""
    jr, tr = renderers
    p = make_terrain_params(**dict(SCENE, size_px=(63, 48)))
    with pytest.raises(TypeError):     # JAX fails tracing the quad derivatives
        jr.render_with_aov(env_maps=JIBL(ENV), params=p, heightmap=DEM)
    with pytest.raises(ValueError, match="even"):
        tr.render_with_aov(env_maps=rr.IBL(ENV), params=terrain_params_from_dict(p.to_dict()),
                           heightmap=DEM)
