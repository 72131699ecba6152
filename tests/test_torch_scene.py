# The port's Scene (forge3d_tpu_torch/scene.py, the plain versions on the
# CPU: K5 trace, normal_at and E2) against the JAX package's
# forge3d_tpu/scene.py at 96x64 with grid=33 over a seeded 49^2 DEM
# (resampled by Scene itself): every effect off, then each on alone, then
# all on together; the setters' errors raised by both; render_png's bytes
# and render_frame.
#
# Gate: the ROADMAP's whole-render rule, rgba within one u8 step on >= 99.5%
# of pixels. The CPU shows more: every render with one effect is
# bit-equal, and the render with every effect on is bit-equal on >= 99.9%
# of pixels and never more than one step off (the bloom's jnp.exp taps
# and the rect light's power differ from PyTorch's by an ulp), so the test
# holds those.
import numpy as np
import pytest
import torch

from forge3d_tpu.errors import UploadError as JUploadError
from forge3d_tpu.scene import Scene as JScene

from forge3d_tpu_torch.errors import DeviceError, UploadError
from forge3d_tpu_torch.scene import Scene as TScene

torch.set_num_threads(1)

W, H, GRID = 96, 64, 33
_rng = np.random.default_rng(5)
_y, _x = np.mgrid[0:49, 0:49].astype(np.float32)
DEM = (40.0 * np.sin(_x * 0.2) * np.cos(_y * 0.17)
       + 2.0 * _rng.standard_normal((49, 49))).astype(np.float32)
EFFECTS = ("ssao", "rect_lights", "ground_plane", "water", "ssr", "bloom", "dof", "vignette")


def build(scene, effects):
    scene.set_height_from_r32f(DEM)
    scene.set_terrain_span(96.0, 1.0)
    scene.set_camera_look_at((0.0, 60.0, 110.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                             45.0, 0.1, 500.0)
    if "ssao" in effects:
        scene.set_ssao_enabled(True)
        scene.set_ssao_parameters(4.0, 1.0, 0.025)
    if "rect_lights" in effects:
        scene.add_rect_area_light((10.0, 50.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (8, 8),
                                  intensity=4.0)
        scene.add_rect_area_light((-20.0, 40.0, 20.0), (0.6, 0.0, 0.8), (0.0, 1.0, 0.0),
                                  (8.0, 8.0), color=(1.0, 0.8, 0.6), intensity=4.0)
    if "ground_plane" in effects:
        scene.set_ground_plane(True, float(DEM.min()))
    if "water" in effects:
        scene.set_water_surface(True, float(np.percentile(DEM, 20)), opacity=0.75)
    if "ssr" in effects:
        scene.set_ssr_enabled(True, 0.5)
    if "bloom" in effects:
        scene.set_bloom_enabled(True)
        scene.set_bloom_parameters(0.8, 0.5)
    if "dof" in effects:
        scene.set_dof_enabled(True)
        scene.set_dof_parameters(120.0, 40.0, 6.0)
    if "vignette" in effects:
        scene.set_vignette_enabled(True, 0.35)
    return scene


def renders(effects):
    ref = build(JScene(W, H, grid=GRID), effects).render_rgba()
    got = build(TScene(W, H, grid=GRID, device="cpu"), effects).render_rgba()
    assert got.dtype == np.uint8 and got.shape == ref.shape == (H, W, 4)
    return ref, got


def u8_stats(ref, got):
    d = np.abs(ref.astype(np.int16) - got.astype(np.int16)).max(-1)
    return float((d == 0).mean()), float((d <= 1).mean()), int(d.max())


@pytest.mark.parametrize("effects", [(), *((e,) for e in EFFECTS)],
                         ids=["off", *EFFECTS])
def test_scene_matches_jax(effects):
    ref, got = renders(effects)
    assert np.array_equal(ref, got), u8_stats(ref, got)


def test_scene_with_every_effect():
    ref, got = renders(EFFECTS)
    eq, step, worst = u8_stats(ref, got)
    assert eq >= 0.999 and step >= 0.995 and worst <= 1, (eq, step, worst)


def test_png_frame_and_default_heights(tmp_path):
    js, ts = JScene(W, H, grid=17), TScene(W, H, grid=17, device="cpu")
    js.render_png(tmp_path / "j.png")
    ts.render_png(tmp_path / "t.png")
    assert (tmp_path / "j.png").read_bytes() == (tmp_path / "t.png").read_bytes()
    fj, ft = js.render_frame(), ts.render_frame()
    assert np.array_equal(fj.rgba, ft.rgba) and fj.metadata == ft.metadata


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, str(e)
    return None


SETTER_ERRORS = [
    ("size", lambda S: S(0, 10, device="cpu") if S is TScene else S(0, 10)),
    ("grid", lambda S: S(8, 8, grid=1, device="cpu") if S is TScene else S(8, 8, grid=1)),
    ("colormap", lambda S: S(8, 8, colormap="no-such-map", device="cpu") if S is TScene
     else S(8, 8, colormap="no-such-map")),
    ("camera_finite", lambda s: s.set_camera_look_at((np.nan, 0, 0), (0, 0, 0), (0, 1, 0),
                                                     45, 0.1, 10)),
    ("camera_near_far", lambda s: s.set_camera_look_at((1, 1, 1), (0, 0, 0), (0, 1, 0),
                                                       45, 1.0, 0.5)),
    ("camera_eye_target", lambda s: s.set_camera_look_at((1, 1, 1), (1, 1, 1), (0, 1, 0),
                                                         45, 0.1, 10)),
    ("camera_fov", lambda s: s.set_camera_look_at((1, 1, 1), (0, 0, 0), (0, 1, 0),
                                                  180, 0.1, 10)),
    ("heights_shape", lambda s: s.set_height_from_r32f(np.zeros(5, np.float32))),
    ("heights_nan", lambda s: s.set_height_from_r32f(np.full((4, 4), np.nan, np.float32))),
    ("span", lambda s: s.set_terrain_span(0.0)),
    ("ssao_radius", lambda s: s.set_ssao_parameters(0.0, 1.0, 0.1)),
    ("bloom", lambda s: s.set_bloom_parameters(-1.0, 0.5)),
    ("dof", lambda s: s.set_dof_parameters(0.0, 1.0)),
    ("oit", lambda s: s.set_oit_enabled(True, "sorted")),
]


@pytest.mark.parametrize("case", [c[0] for c in SETTER_ERRORS])
def test_setter_errors_match_jax(case, monkeypatch):
    # the unknown-colormap message lists the registered maps: both sides see
    # the built-in maps alone, whatever another test in this process
    # registered with either package
    from forge3d_tpu import colormaps as jcm

    from forge3d_tpu_torch import colormaps as tcm

    for mod in (jcm, tcm):
        monkeypatch.setattr(mod, "_RUNTIME", {})
    fn = dict(SETTER_ERRORS)[case]
    if case in ("size", "grid", "colormap"):
        ref, got = _error(lambda: fn(JScene)), _error(lambda: fn(TScene))
    else:
        ref = _error(lambda: fn(JScene(8, 8)))
        got = _error(lambda: fn(TScene(8, 8, device="cpu")))
    assert ref is not None and got == ref


def test_upload_errors_are_the_ports_own():
    with pytest.raises(JUploadError):
        JScene(8, 8).set_height_from_r32f(np.zeros((1, 4), np.float32))
    with pytest.raises(UploadError):
        TScene(8, 8, device="cpu").set_height_from_r32f(np.zeros((1, 4), np.float32))


def test_setters_and_getters():
    s = TScene(8, 8, device="cpu")
    assert s.ssao_enabled() is False and s.set_ssao_enabled(1) is True
    s.set_ssao_parameters(2.0, 0.5, 0.01)
    assert s.get_ssao_parameters() == (2.0, 0.5, 0.01)
    assert s.add_rect_area_light((0, 1, 0), (1, 0, 0), (0, 0, 1), (1, 1)) == 0
    assert s.add_rect_area_light((0, 2, 0), (1, 0, 0), (0, 0, 1), (1, 1)) == 1
    s.clear_rect_area_lights()
    assert s.add_rect_area_light((0, 1, 0), (1, 0, 0), (0, 0, 1), (1, 1)) == 0


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        TScene(W, H)
