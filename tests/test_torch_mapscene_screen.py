# The port's copy of MapScene's recipe screen base (forge3d_tpu_torch/
# mapscene_screen.py) against forge3d_tpu/mapscene_screen.py: the value pins
# of tests/test_mapscene_screen_derivation.py run against the copy, the
# derived engine arguments equal, the post passes byte-equal, and
# render_screen_base (the port's screen engine, plain versions on the CPU)
# against JAX's at 96x64 with the rainier preset, POM at the recipe
# settings and an auto water mask.
#
# Gates: derived values equal; post passes byte-equal; the render's rgba
# within one u8 step on >= 99.5% of pixels (the CPU showed it byte-equal).
import numpy as np
import pytest
import torch

from forge3d_tpu import mapscene_screen as jms

from forge3d_tpu_torch import mapscene_screen as tms
from forge3d_tpu_torch.errors import DeviceError

torch.set_num_threads(1)

REF_META = {"source_id": "recipe-dem", "width": 8, "height": 8, "asset_status": "fixture",
            "bounds": (-122.5, 46.6, -121.9, 47.0)}


class _Cam:
    radius = 800.0
    phi_deg = 35.0
    theta_deg = 45.0
    fov_y_deg = 45.0


def _ramp(size=8):
    x = np.linspace(0.0, 1.0, size, dtype=np.float32)
    xx, yy = np.meshgrid(x, x)
    return (0.25 * xx + 0.75 * yy).astype(np.float32)


def metre_dem(n=33):
    """Terrain in metres with a flat lake floor at 1000 m in one corner."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = 1400.0 + 350.0 * np.sin(x * 0.23) * np.cos(y * 0.19) + 6.0 * x
    dem[: n // 3, : n // 3] = 1000.0
    return dem.astype(np.float32)


def recipe(mod, *, water=None, clouds=None, screen_space=None, size=(96, 64), samples=1):
    meta = dict(REF_META)
    if water is not None:
        meta["water"] = water

    class Rec:
        water_mask = None
        water_level = None
        camera = _Cam()
        lighting = mod.LightingPreset("rainier_showcase", intensity=1.15)

        class terrain:
            spacing = (1.0, 1.0)
            metadata = meta

        class output:
            size_px = size

    Rec.output.samples = samples
    Rec.clouds = clouds
    Rec.screen_space = screen_space
    return Rec


# -- the value pins of test_mapscene_screen_derivation.py, on the copy ------

def test_metadata_resolution_and_diagonal():
    rx, ry = tms.metadata_resolution(REF_META)
    assert rx == pytest.approx(0.6 / 8) and ry == pytest.approx(0.4 / 8)
    assert tms.terrain_scene_diagonal(_ramp(), (1.0, 1.0), REF_META) == pytest.approx(0.6)
    assert tms.terrain_scene_diagonal(_ramp(), (1.0, 1.0), None) == 8.0


def test_rainier_preset_resolution_values():
    lit = tms.resolve_recipe_lighting(tms.LightingPreset("rainier_showcase", intensity=1.15),
                                      _ramp(), (1.0, 1.0), REF_META, _Cam())
    assert lit["preset"] == "rainier_showcase"
    assert lit["sun_azimuth_deg"] == pytest.approx(135.0)
    assert lit["sun_elevation_deg"] == pytest.approx(24.8934, abs=1e-3)
    assert (lit["sun_intensity"], lit["ibl_intensity"], lit["exaggeration"]) == (1.15, 0.3, 1.35)
    assert (lit["albedo_mode"], lit["colormap_strength"]) == ("mix", 0.5)
    assert lit["cam"]["radius"] == pytest.approx(1.44)
    assert (lit["cam"]["phi_deg"], lit["cam"]["theta_deg"], lit["cam"]["fov_y_deg"]) == \
        (135.0, 45.0, 55.0)


def test_falsy_settings_and_fallback_preset():
    lit = tms.resolve_recipe_lighting(
        tms.LightingPreset("rainier_showcase", intensity=1.15,
                           settings={"albedo_mode": "material", "colormap_strength": 0.0,
                                     "exaggeration": 1.35}),
        _ramp(), (1.0, 1.0), REF_META, _Cam())
    assert (lit["albedo_mode"], lit["colormap_strength"], lit["exaggeration"]) == \
        ("material", 0.5, 1.35)
    lit = tms.resolve_recipe_lighting(tms.LightingPreset("outdoor_sun", intensity=1.1),
                                      _ramp(), (1.0, 1.0), REF_META, _Cam())
    assert lit["preset"] is None
    assert (lit["sun_azimuth_deg"], lit["sun_elevation_deg"], lit["sun_intensity"]) == \
        (135.0, 35.0, 1.1)
    assert lit["cam"]["radius"] == pytest.approx(1.44)


def test_water_mask_derivation_matches_reference_auto_mask():
    dem = np.ones((8, 8), np.float32)
    dem[2:6, 2:6] = 0.0

    class Rec:
        water_mask = None
        water_level = None
        lighting = "default"

        class terrain:
            metadata = {"water": {"enabled": True, "auto_mask": True, "level": 0.1,
                                  "slope_threshold": 1.0}}
    wm = tms.derive_water_mask_for_recipe(Rec, dem)
    assert wm is not None and wm[3, 3] == 1.0 and wm[0, 0] == 0.0
    np.testing.assert_array_equal(wm, jms.derive_water_mask_for_recipe(Rec, dem))


# -- the copy against the original --------------------------------------------

def test_derive_screen_params_equal():
    dem = metre_dem()
    ref = jms.derive_screen_params(recipe(jms), dem)
    got = tms.derive_screen_params(recipe(tms), dem)
    assert got["kw"].keys() == ref["kw"].keys()
    for k, v in ref["kw"].items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got["kw"][k], v, err_msg=k)
        else:
            assert got["kw"][k] == v, k
    np.testing.assert_array_equal(got["lut"], ref["lut"])
    np.testing.assert_array_equal(got["dem"], ref["dem"])
    assert got["lit"] == ref["lit"]
    assert got["kw"]["pom"] == dict(enabled=True, height_scale=0.04, min_steps=12,
                                    max_steps=40, refine_steps=4, occlusion=True)


def test_post_passes_byte_equal():
    dem = metre_dem()
    rgba = np.random.default_rng(51).integers(0, 256, (64, 96, 4), dtype=np.uint8)
    clouds = {"enabled": True, "shadows_enabled": True, "coverage": 0.72, "density": 0.48,
              "shadow_strength": 0.38, "quality": "high"}
    ssfx = {"ssao": {"enabled": True, "radius": 2.0}, "ssgi": {"enabled": True},
            "ssr": {"enabled": True, "intensity": 0.8}, "taa": {"enabled": True}}
    water = {"enabled": True, "auto_mask": True, "level": 1001.0, "slope_threshold": 50.0}
    jr, tr = (recipe(m, water=water, clouds=clouds, screen_space=ssfx) for m in (jms, tms))
    np.testing.assert_array_equal(tms.apply_cloud_shadow(rgba, tr), jms.apply_cloud_shadow(rgba, jr))
    got = tms.apply_screen_space_postfx(rgba, tr, dem)
    np.testing.assert_array_equal(got, jms.apply_screen_space_postfx(rgba, jr, dem))
    assert not np.array_equal(got, rgba)
    for shape in ((64, 96), (50, 70), (128, 40)):
        np.testing.assert_array_equal(tms.resize_nearest_rgba(rgba, shape),
                                      jms.resize_nearest_rgba(rgba, shape))


def test_render_screen_base_matches_jax():
    dem = metre_dem()
    water = {"enabled": True, "auto_mask": True, "level": 1001.0, "slope_threshold": 50.0}
    jr, tr = recipe(jms, water=water), recipe(tms, water=water)
    wm = tms.derive_water_mask_for_recipe(tr, dem)
    assert 0.05 < wm.mean() < 0.5
    a = jms.render_screen_base(jr, dem)
    b = tms.render_screen_base(tr, dem, device="cpu")
    assert b.shape == a.shape == (64, 96, 4) and b.dtype == np.uint8
    du = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= 0.995
    assert a[..., :3].std() > 5.0


def test_render_screen_base_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        tms.render_screen_base(recipe(tms), metre_dem())
