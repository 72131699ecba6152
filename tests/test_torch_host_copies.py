# The port's own copies of the JAX package's host modules
# (forge3d_tpu_torch.errors, .camera, .mem, .assurance, .terrain.params,
# .colormaps, .sky's assets, .io) against the originals in forge3d_tpu, on
# the CPU: the exception classes' names and chains of base names, the camera
# basis and orbit origin bit for bit, the memory ledger's budget refusals
# and records, a render certificate's canonical JSON, digest and Ed25519
# signature byte for byte, terrain parameter defaults and validation, the
# LUT and Hosek arrays, PNG bytes and PNG reads, the screen engine's host
# helpers (the clipmap mode's camera spelling, the sky's cooked uniforms),
# the wildfire path's named DEMs (datasets: heights and GeoTIFF bytes)
# and gis/osm (the Terrarium codec, the OSM parse, query and scene split),
# the daycycle path's astro.py (the Meeus ephemeris behind
# sky.sun_position_at) and shadows.py's CSM state, and the F3DZ codec's
# codec/f3dz.py (over native/f3dz.cpp) and codec/f3dz_pylane.py.
import inspect

import numpy as np
import pytest

from forge3d_tpu import _version as jver
from forge3d_tpu import camera as jcam
from forge3d_tpu import errors as jerr
from forge3d_tpu import mem as jmem
from forge3d_tpu.assurance import certificate as jcert

from forge3d_tpu_torch import _version as tver
from forge3d_tpu_torch import camera as tcam
from forge3d_tpu_torch import errors as terr
from forge3d_tpu_torch import mem as tmem
from forge3d_tpu_torch.assurance import certificate as tcert


def _classes(mod):
    return {n: c for n, c in vars(mod).items()
            if inspect.isclass(c) and issubclass(c, BaseException) and c.__module__ == mod.__name__}


def test_exception_hierarchy_names_and_bases():
    ref, got = _classes(jerr), _classes(terr)
    assert sorted(ref) == sorted(got) and len(ref) == 9
    for name, cls in ref.items():
        assert [c.__name__ for c in got[name].__mro__] == [c.__name__ for c in cls.__mro__], name
    e = terr.ConvergenceError("no", frames=7, variance=0.5)
    assert (e.frames, e.variance, str(e)) == (7, 0.5, "no")
    e = terr.MemoryBudgetExceeded("big", requested_bytes=10, budget_bytes=4)
    assert (e.requested_bytes, e.budget_bytes) == (10, 4)


CAMERAS = [((0, 1, 5), (0, 0, 0), (0, 1, 0)),
           ((512.0, 260.0, 1400.0), (512.0, 0.0, 512.0), (0, 1, 0)),
           ((1.2, 1.0, 2.2), (0, 0, 0), (0, 1, 0)),
           ((16.0, 40.0, 16.0), (16.0, 0.0, 16.001), (0, 1, 0)),
           ((-3.0, 2.0, -7.5), (4.0, -1.0, 2.0), (0.1, 1.0, -0.2))]


@pytest.mark.parametrize("cam", CAMERAS, ids=[f"cam{i}" for i in range(len(CAMERAS))])
def test_camera_basis_bit_equal(cam):
    ref = jcam.camera_basis(*cam)
    got = tcam.camera_basis(*cam)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_camera_basis_refuses_a_degenerate_view():
    for mod in (jcam, tcam):
        with pytest.raises(ValueError, match="zero vector"):
            mod.camera_basis((1, 2, 3), (1, 2, 3), (0, 1, 0))


def test_memory_tracker_budget_errors():
    assert tmem.MEMORY_BUDGET_CAP == jmem.MEMORY_BUDGET_CAP
    msgs = []
    for mod, err in ((jmem, jerr), (tmem, terr)):
        t = mod.MemoryTracker(budget_bytes=1000)
        a = t.track("a", 600)
        with pytest.raises(err.MemoryBudgetExceeded) as ei:
            t.track("b", 500)
        msgs.append((str(ei.value), ei.value.requested_bytes, ei.value.budget_bytes))
        t.free(a)
        t.track("b", 500)               # fits once "a" is freed
        t.set_policy("off")
        t.track("c", 10 ** 6)
        with pytest.raises(ValueError, match="policy must be one of"):
            t.set_policy("strict")
        with pytest.raises(ValueError, match=">= 0"):
            t.track("neg", -1)
        t.set_budget(10)
        assert (t.get_policy(), t.budget_bytes) == ("off", 10)
    assert msgs[0] == msgs[1]
    # warn records a degradation instead of raising
    t = tmem.MemoryTracker(budget_bytes=8)
    t.set_policy("warn")
    n = len(tmem._DEGRADATIONS)
    t.track("x", 16)
    assert len(tmem._DEGRADATIONS) == n + 1
    assert tmem._DEGRADATIONS[-1]["category"] == "memory_budget"
    m = t.metrics()
    assert (m["tracked_bytes"], m["peak_tracked_bytes"], m["within_budget"]) == (16, 16, False)
    assert isinstance(tmem.global_tracker(), tmem.MemoryTracker)


RENDER = {"frames": 12, "variance": 3.25e-4, "rgba": np.zeros((24, 32, 4), np.uint8)}


def test_certificate_bytes_equal():
    assert tver.__version__ == jver.__version__
    body = {"b": [1, 2.5, "x"], "a": {"z": None, "y": True}}
    assert tcert.canonical_json(body) == jcert.canonical_json(body)
    ref, got = {}, {}
    jcert.emit_certificate(ref, "terrain-pt", RENDER)
    tcert.emit_certificate(got, "terrain-pt", RENDER)
    assert jcert.canonical_json(ref) == tcert.canonical_json(got)
    assert tcert.certificate_public_key_hex() == jcert.certificate_public_key_hex()
    assert tcert.verify_render_certificate(got) and jcert.verify_render_certificate(got)
    forged = dict(got, label="other")
    assert not tcert.verify_render_certificate(forged)
    seed = bytes(range(32))
    assert (tcert.sign_render_certificate_digest(got["digest"], seed)
            == jcert.sign_render_certificate_digest(got["digest"], seed))


def test_certificate_capture_passes():
    reports = []
    for mod in (jcert, tcert):
        cap = mod.begin_render_capture("capture")
        assert mod.current_capture() is cap
        cap.record_pass("frame", 1.5, index=0)
        cap.meta["w"] = 32
        out = {}
        mod.emit_certificate(out, "ignored", RENDER)
        cap.finish()
        assert mod.current_capture() is None
        reports.append(out)
    assert reports[0]["passes"] == [{"name": "frame", "ms": 1.5, "index": 0}]
    assert jcert.canonical_json(reports[0]) == tcert.canonical_json(reports[1])


# The TerrainRenderer's host copies: params, the colormap and Hosek assets,
# the orbit camera, and the PNG writer.

def test_terrain_params_defaults_and_conversion_equal():
    from forge3d_tpu.terrain import params as jparams

    from forge3d_tpu_torch.convert import terrain_params_from_dict
    from forge3d_tpu_torch.terrain import params as tparams

    assert tparams.make_terrain_params().to_dict() == jparams.make_terrain_params().to_dict()
    kw = dict(size_px=(320, 200), fog=dict(enabled=True, density=0.1),
              shadows=dict(technique="pcss", softness=1.0, samples=4),
              material_layers=dict(enabled=True), tonemap=dict(mode="aces"),
              sky=dict(enabled=True, turbidity=4.0), domain=(0.0, 100.0))
    ref = jparams.make_terrain_params(**kw)
    assert tparams.make_terrain_params(**kw).to_dict() == ref.to_dict()
    lut = np.linspace(0, 1, 16, dtype=np.float32)
    env = np.ones((2, 4, 3), np.float32)
    got = terrain_params_from_dict(ref.to_dict(), env_map=env, height_curve_lut=lut)
    assert got.to_dict() == ref.to_dict() and got.height_curve_lut is not None
    np.testing.assert_array_equal(got.ibl.env_map, env)
    assert type(got.material_layers).__name__ == "MaterialLayerSettings"
    assert got.pom.to_screen_cfg() == ref.pom.to_screen_cfg()


BAD_PARAMS = [dict(size_px=(0, 10)), dict(render_scale=5.0), dict(msaa_samples=3),
              dict(z_scale=0.0), dict(cam_radius=-1.0), dict(fov_y_deg=180.0),
              dict(clip=(1.0, 0.5)), dict(albedo_mode="pbr"), dict(tonemap=dict(mode="hable")),
              dict(sampling=dict(aa_samples=300)), dict(shadows=dict(technique="ssao")),
              dict(shadows=dict(samples=0)), dict(pom=dict(scale=-1.0)),
              dict(sky=dict(turbidity=20.0)), dict(sky=dict(model="nishita"))]


@pytest.mark.parametrize("kw", BAD_PARAMS, ids=[str(i) for i in range(len(BAD_PARAMS))])
def test_terrain_params_validation_equal(kw):
    from forge3d_tpu.terrain import params as jparams

    from forge3d_tpu_torch.terrain import params as tparams

    errs = []
    for mod in (jparams, tparams):
        with pytest.raises(ValueError) as ei:
            mod.make_terrain_params(**kw)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


def test_colormap_and_hosek_assets_equal():
    from forge3d_tpu import colormaps as jcm
    from forge3d_tpu import sky as jsky

    from forge3d_tpu_torch import colormaps as tcm
    from forge3d_tpu_torch import sky as tsky

    assert tcm.available() == jcm.available()
    for name in jcm.available():
        np.testing.assert_array_equal(tcm.get_lut(name), jcm.get_lut(name))
    for a, b in zip(jsky._hosek_data(), tsky._hosek_data()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(KeyError, match="unknown colormap"):
        tcm.get_lut("no-such-map")
    with pytest.raises(ValueError, match="LUT must be"):
        tcm.register("bad", np.zeros((1, 3)))


@pytest.mark.parametrize("args", [((0.0, 0.0, 0.0), 120.0, 225.0, 35.0),
                                  ((512.0, 0.0, 512.0), 1300.0, 225.0, 35.0),
                                  ((3.5, -2.0, 7.25), 42.0, 17.0, -12.0)])
def test_orbit_camera_origin_bit_equal(args):
    ref = jcam.orbit_camera_origin(*args)
    got = tcam.orbit_camera_origin(*args)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_png_bytes_equal(tmp_path):
    from forge3d_tpu.io import image as jimage
    from forge3d_tpu.io import png as jpng

    from forge3d_tpu_torch.frame import Frame
    from forge3d_tpu_torch.io import image as timage
    from forge3d_tpu_torch.io import png as tpng

    rng = np.random.default_rng(12)
    for img in (rng.integers(0, 256, (9, 13, 4), dtype=np.uint8),
                rng.integers(0, 256, (7, 5, 3), dtype=np.uint8),
                rng.integers(0, 65536, (6, 4), dtype=np.uint16)):
        assert tpng.encode_png(img) == jpng.encode_png(img)
        np.testing.assert_array_equal(tpng.decode_png(tpng.encode_png(img)).squeeze(),
                                      img.squeeze())
    f = rng.uniform(-0.1, 1.1, (5, 6, 3)).astype(np.float32)
    jimage.numpy_to_png(tmp_path / "j.png", f)
    timage.numpy_to_png(tmp_path / "t.png", f)
    assert (tmp_path / "j.png").read_bytes() == (tmp_path / "t.png").read_bytes()
    rgba = rng.integers(0, 256, (9, 13, 4), dtype=np.uint8)
    Frame(rgba=rgba).save_png(tmp_path / "f.png")
    assert (tmp_path / "f.png").read_bytes() == jpng.encode_png(rgba)


# The screen engine's host copies (forge3d_tpu_torch/terrain/screen.py)
# against forge3d_tpu/terrain/screen.py and screen_golden._build_brdf_lut.

def test_screen_host_helpers_equal(tmp_path, monkeypatch):
    from forge3d_tpu.terrain import screen as js
    from forge3d_tpu.terrain import screen_golden as jg

    from forge3d_tpu_torch.terrain import screen as ts

    for name in ("SHADOW_MIN", "SHADOW_IBL_FACTOR", "AMBIENT_FLOOR", "WATER_DEPTH_ATTEN_DEEP",
                 "WATER_COMBINED_REFLECTION_SCALE", "WATER_SUN_SPECULAR_SCALE", "WATER_BASE_TINT",
                 "WATER_BASE_TINT_SCALE", "WATER_SCATTER_SCALE"):
        assert getattr(ts, name) == getattr(js, name), name
    for name in ("_POISSON_12", "_POISSON_16", "_MATERIAL_LINEAR"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    arrays = (np.arange(12, dtype=np.float32).reshape(3, 4), 2.8, (0.0, 1.0), "shadowj-v1")
    assert ts._hash(*arrays) == js._hash(*arrays)
    for args in [((1.2, 3.0, 4.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
                 ((-2.0, 0.5, 1.0), (0.3, -0.1, 0.2), (0.0, 0.0, 1.0))]:
        np.testing.assert_array_equal(ts.look_at_rh(*args), js.look_at_rh(*args))
        to = (args[0], np.subtract(args[1], args[0]), args[2])
        np.testing.assert_array_equal(ts.look_to_rh(*to), js.look_to_rh(*to))
    np.testing.assert_array_equal(ts.orthographic_rh(-1.5, 2.0, -0.7, 1.1, -3.0, 4.0),
                                  js.orthographic_rh(-1.5, 2.0, -0.7, 1.1, -3.0, 4.0))
    for a in [(5.0, 138.0, 63.0), (120.0, 225.0, 35.0)]:
        np.testing.assert_array_equal(ts.orbit_eye(*a), js.orbit_eye(*a))
    for a in [(135.0, 24.0), (10.0, 80.0), (300.0, 5.0)]:
        np.testing.assert_array_equal(ts.light_direction(*a), js.light_direction(*a))
    np.testing.assert_array_equal(ts.perspective_proj(54.0, 4 / 3, 0.1, 6000.0),
                                  js.perspective_proj(54.0, 4 / 3, 0.1, 6000.0))
    for n in (8, 32):
        np.testing.assert_array_equal(ts._face_dirs(n), js._face_dirs(n))
    for n in (64, 128, 1024):
        np.testing.assert_array_equal(ts._hammersley(n), js._hammersley(n))
    for kw in ({}, dict(width=16, height=8, blue=200)):
        np.testing.assert_array_equal(ts.decode_test_hdr(**kw), js.decode_test_hdr(**kw))
    stops = [(0.0, "#112233"), (0.35, "#80a040"), (0.7, "#f0e0c0"), (1.0, "#ffffff")]
    np.testing.assert_array_equal(ts.build_lut_from_stops(stops), js.build_lut_from_stops(stops))
    assert ts.default_material_layers() == js.default_material_layers()
    mats = dict(js.default_material_layers(), rock_color=[0.1, 0.2, 0.3])
    assert ts._freeze(mats) == js._freeze(mats) and ts._freeze(None) is None
    img = np.random.default_rng(41).integers(0, 256, (60, 80, 4), dtype=np.uint8)
    for size in ((64, 48), (100, 70)):
        np.testing.assert_array_equal(ts.blit_resolve(img, *size), js.blit_resolve(img, *size))
    # the BRDF LUT: zero by default, the analytic LUT under FORGE3D_IBL_BRDF=analytic
    np.testing.assert_array_equal(ts._build_brdf_lut(16, 64), jg._build_brdf_lut(16, 64))
    monkeypatch.setenv("FORGE3D_IBL_BRDF", "analytic")
    monkeypatch.setattr(jg, "CACHE_DIR", tmp_path)
    ref = jg._build_brdf_lut(16, 64)
    got = ts._build_brdf_lut(16, 64)
    assert ref.max() > 0.0
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["clipmap", "clipmap:4:32:32:10:0.3"])
def test_clipmap_config_from_camera_mode_equal(mode):
    from forge3d_tpu.terrain import clipmap_mesh as jcm

    from forge3d_tpu_torch.terrain import clipmap_mesh as tcm

    ref = jcm.ClipmapConfig.from_camera_mode(mode)
    got = tcm.ClipmapConfig.from_camera_mode(mode)
    assert vars(got) == vars(ref)
    assert got == tcm.ClipmapConfig(**vars(ref))


def test_png_to_numpy_reads_the_ports_png(tmp_path):
    from forge3d_tpu.io import image as jimg

    from forge3d_tpu_torch.io import image as timg
    from forge3d_tpu_torch.io import png as tpng

    rng = np.random.default_rng(44)
    for shape, dtype in (((9, 13, 4), np.uint8), ((7, 5, 3), np.uint8), ((6, 4), np.uint16)):
        a = rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype)
        tpng.write_png(tmp_path / "a.png", a)
        got = timg.png_to_numpy(tmp_path / "a.png")
        ref = jimg.png_to_numpy(tmp_path / "a.png")
        assert got.dtype == ref.dtype == dtype
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got.reshape(a.shape), a)


@pytest.mark.parametrize("turbidity", [1.0, 3.0, 10.0])
@pytest.mark.parametrize("elevation", [0.0, 24.0, 80.0])
def test_cook_sky_uniforms_bit_equal(turbidity, elevation):
    from forge3d_tpu.terrain import screen as js

    from forge3d_tpu_torch.terrain import screen as ts

    cfg = dict(turbidity=turbidity, ground_albedo=0.3, sun_intensity=1.2, sun_size=0.8,
               sky_exposure=1.1)
    ldir = js.light_direction(135.0, elevation)
    ref = js._cook_sky_uniforms(cfg, ldir)
    got = ts._cook_sky_uniforms(cfg, ldir)
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


# ---------------------------------------------------------------------------
# MapScene's host modules: diagnostics, style, screen_compose, gis/geotiff,
# io/mesh, geometry, buildings, furniture
# ---------------------------------------------------------------------------

def _report(mod):
    rep = mod.ValidationReport()
    rep.info("a.info", "fine")
    rep.warning("b.warn", "careful", "layers[0]")
    rep.error("c.err", "bad", "terrain")
    return rep


@pytest.mark.parametrize("policy", ["block_on_error", "block_on_warning", "never_block"])
def test_validation_report_equal(policy):
    from forge3d_tpu import diagnostics as jd

    from forge3d_tpu_torch import diagnostics as td

    ref, got = _report(jd), _report(td)
    assert ref.as_dict() == got.as_dict() and len(ref) == len(got) == 3
    assert [d.code for d in ref.blocking(policy)] == [d.code for d in got.blocking(policy)]
    assert [s.name for s in jd.Severity] == [s.name for s in td.Severity]
    if ref.blocking(policy):
        msgs = []
        for rep, err in ((ref, jerr), (got, terr)):
            with pytest.raises(err.RenderError) as ei:
                rep.raise_if_blocking(policy)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="unknown render policy"):
        got.blocking("sometimes")


STYLE_EXPRS = [
    (["get", "class"], {"class": 3}),
    (["match", ["get", "class"], 1, "#edf8fb", 2, "#b2e2e2", "#238b45"], {"class": 2}),
    (["interpolate", ["linear"], ["zoom"], 0, 1.0, 10, 5.0], {}),
    (["interpolate", ["exponential", 2.0], ["get", "v"], 0, "#000000", 10, "#ffffff"], {"v": 3}),
    (["step", ["get", "v"], "a", 10, "b", 20, "c"], {"v": 15}),
    (["case", [">", ["get", "v"], 5], "big", "small"], {"v": 7}),
    (["all", ["has", "v"], ["!=", ["get", "v"], 1]], {"v": 2}),
    (["+", 1, ["*", 2, ["get", "v"]], ["/", 6, 0]], {"v": 3}),
    (["concat", "a", ["to-string", ["get", "v"]]], {"v": 4}),
    ({"stops": [[0, 1.0], [10, 3.0]], "base": 1.5}, {}),
    (["coalesce", ["get", "missing"], ["literal", [6, 3]]], {}),
    ([6, 3], {}),
]


@pytest.mark.parametrize("i", range(len(STYLE_EXPRS)))
def test_style_evaluate_expression_equal(i):
    from forge3d_tpu import style as js

    from forge3d_tpu_torch import style as ts

    expr, props = STYLE_EXPRS[i]
    assert ts.evaluate_expression(expr, props, zoom=4.0) == \
        js.evaluate_expression(expr, props, zoom=4.0)
    for c in ("#2563eb", "rgba(10, 20, 30, 0.5)", "red", (0.1, 0.2, 0.3)):
        assert ts.parse_color(c) == js.parse_color(c)


def _screen_layers(mod):
    """Screen-space layers in both forms: GeoJSON features with a style, and
    the simplified kind + coordinates."""
    L = mod.VectorOverlayLayer
    feats = [{"id": "a", "geometry": {"type": "LineString",
                                      "coordinates": [(0.1, 0.2), (0.9, 0.75), (0.5, 0.9)]}},
             {"id": "p", "geometry": {"type": "Polygon", "coordinates": [
                 [(0.2, 0.2), (0.6, 0.25), (0.5, 0.7), (0.2, 0.2)]]},
              "properties": {"class": 2}},
             {"id": "m", "geometry": {"type": "MultiPoint",
                                      "coordinates": [(0.3, 0.3), (0.7, 0.6)]}}]
    return [
        L(layer_id="roads", features=feats, width_px=4, line_cap="square", line_join="miter",
          dash_array=[10, 5], style={"version": 8, "layers": [
              {"id": "r", "type": "line", "paint": {"line-color": "#f9fafb"}},
              {"id": "f", "type": "fill", "paint": {
                  "fill-color": ["match", ["get", "class"], 2, "#66c2a4", "#000000"],
                  "fill-opacity": 0.7}}]}),
        L(layer_id="bare", features=feats),
        L(kind="lines", coordinates=[(5, 5), (60, 40), (90, 10)], width=3.0, dash_array=[6, 3],
          line_cap="butt", line_join="miter", color=(0.9, 0.2, 0.1)),
        L(kind="polygons", coordinates=[[(0.1, 0.1), (0.5, 0.1), (0.3, 0.6)]], opacity=0.5),
        L(kind="points", coordinates=[(20, 20), (0.5, 0.5)], width=2.0),
    ]


@pytest.mark.parametrize("opaque", [False, True], ids=["alpha", "opaque"])
@pytest.mark.parametrize("k", range(5))
def test_screen_compose_vector_layer_bytes_equal(k, opaque):
    """Byte-equal on a base with random alpha and on an opaque one (where
    the port's copy blends only each stroke's window)."""
    from forge3d_tpu import mapscene as jms
    from forge3d_tpu import screen_compose as jsc

    from forge3d_tpu_torch import mapscene as tms
    from forge3d_tpu_torch import screen_compose as tsc

    img = np.random.default_rng(k).integers(0, 256, (64, 96, 4), dtype=np.uint8)
    if opaque:
        img[..., 3] = 255
    a, b = img.copy(), img.copy()
    jsc.composite_vector_layer(a, _screen_layers(jms)[k], 96, 64)
    tsc.composite_vector_layer(b, _screen_layers(tms)[k], 96, 64)
    np.testing.assert_array_equal(a, b)
    assert (a != img).any()
    a, b = img.copy(), img.copy()
    jsc.draw_disc(a, 30.3, 20.7, (200, 10, 10, 255), 4.5)
    tsc.draw_disc(b, 30.3, 20.7, (200, 10, 10, 255), 4.5)
    np.testing.assert_array_equal(a, b)
    assert jsc.dash_segments([(0, 0), (40, 30)], [6, 3]) == \
        tsc.dash_segments([(0, 0), (40, 30)], [6, 3])


def test_geotiff_bytes_and_reads_equal(tmp_path):
    from forge3d_tpu import gis as jg

    from forge3d_tpu_torch import gis as tg

    dem = np.random.default_rng(0).normal(500, 40, (33, 47)).astype(np.float32)
    kw = dict(transform=(2.0, 0.0, 1000.0, 0.0, -2.0, 5000.0), crs="EPSG:32610",
              nodata=-9999.0)
    for i, mod in enumerate((jg, tg)):
        mod.write_raster(str(tmp_path / f"d{i}.tif"), dem, **kw)
    assert (tmp_path / "d0.tif").read_bytes() == (tmp_path / "d1.tif").read_bytes()
    rgb = (np.random.default_rng(1).uniform(0, 255, (9, 11, 3))).astype(np.uint8)
    jg.write_raster(str(tmp_path / "rgb.tif"), rgb, compress="none")
    for name in ("d0.tif", "rgb.tif"):
        path = str(tmp_path / name)
        assert jg.read_raster_info(path) == tg.read_raster_info(path)
        np.testing.assert_array_equal(jg.read_raster(path), tg.read_raster(path))
        np.testing.assert_array_equal(jg.read_raster(path, band=0), tg.read_raster(path, band=0))


def _meshes(mod_geom):
    sq = np.array([[0, 0], [4, 0], [4, 3], [0, 3]], np.float64)
    hole = np.array([[1, 1], [1, 2], [2, 2], [2, 1]], np.float64)
    ell = np.stack([5 + 3 * np.cos(np.linspace(0, 6, 9)), 2 + np.sin(np.linspace(0, 6, 9))], 1)
    return [mod_geom.extrude_polygon(sq, 5.0, base=1.5),
            mod_geom.extrude_polygon(sq, 2.0, holes=[hole], cap_bottom=False),
            mod_geom.extrude_polygon(ell[::-1], 3.0)]


def _mesh_equal(a, b):
    for f in ("vertices", "indices", "normals", "uvs", "colors"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert a.name == b.name


def test_extrude_polygon_and_merge_meshes_equal():
    from forge3d_tpu import geometry as jgeo
    from forge3d_tpu.io import mesh as jmesh

    from forge3d_tpu_torch import geometry as tgeo
    from forge3d_tpu_torch.io import mesh as tmesh

    ref, got = _meshes(jgeo), _meshes(tgeo)
    for a, b in zip(ref, got):
        _mesh_equal(a, b)
    _mesh_equal(jmesh.merge_meshes(ref), tmesh.merge_meshes(got))
    a = jmesh.MeshData(ref[0].vertices, ref[0].indices)
    b = tmesh.MeshData(got[0].vertices, got[0].indices)
    np.testing.assert_array_equal(a.compute_normals(), b.compute_normals())


CITYJSON = {
    "type": "CityJSON", "version": "1.1",
    "transform": {"scale": [0.01, 0.01, 0.01], "translate": [100.0, 200.0, 0.0]},
    "vertices": [[0, 0, 0], [1000, 0, 0], [1000, 800, 0], [0, 800, 0],
                 [0, 0, 1200], [1000, 0, 1200], [1000, 800, 1200], [0, 800, 1200],
                 [200, 200, 1200], [400, 200, 1200], [400, 400, 1200], [200, 400, 1200]],
    "CityObjects": {
        "b1": {"type": "Building", "attributes": {"h": 12}, "geometry": [{
            "type": "Solid", "lod": "1", "boundaries": [[
                [[0, 3, 2, 1]], [[4, 5, 6, 7], [8, 11, 10, 9]], [[0, 1, 5, 4]], [[1, 2, 6, 5]],
                [[2, 3, 7, 6]], [[3, 0, 4, 7]]]]}]},
        "t1": {"type": "SolitaryVegetationObject", "geometry": []},
        "b2": {"type": "BuildingPart", "geometry": [{
            "type": "MultiSurface", "boundaries": [[[0, 1, 2]], [[0, 2, 3]]]}]},
    },
}


def test_buildings_equal():
    from forge3d_tpu import buildings as jb

    from forge3d_tpu_torch import buildings as tb

    fps = [np.array([[0, 0], [4, 0], [4, 3], [0, 3]], float) + [10 * i, 2 * i] for i in range(3)]
    _mesh_equal(jb.extrude_footprints(fps, [5, 8, 11], bases=[0.5, 1.0, 2.0]),
                tb.extrude_footprints(fps, [5, 8, 11], bases=[0.5, 1.0, 2.0]))
    ref, got = jb.load_cityjson(CITYJSON), tb.load_cityjson(CITYJSON)
    assert len(ref) == len(got) == 2
    for a, b in zip(ref, got):
        _mesh_equal(a, b)
        assert a.materials == b.materials
    for mod in (jb, tb):
        with pytest.raises(ValueError, match="no footprints"):
            mod.extrude_footprints([], [])


def test_furniture_equal():
    from forge3d_tpu import furniture as jf

    from forge3d_tpu_torch import furniture as tf

    img = np.random.default_rng(5).integers(0, 256, (120, 200, 4), dtype=np.uint8)
    out = []
    for mod in (jf, tf):
        a = img.copy()
        mod.draw_title_plate(a, "Title", "sub", scale=1)
        mod.draw_legend(a, mod.LegendSpec(colormap="terrain", vmin=-3.0, vmax=412.5,
                                          label="m", width=10, height=60), x=8, y=40)
        mod.draw_scale_bar(a, mod.ScaleBarSpec(meters_per_pixel=3.7, max_width_px=70),
                           x=60, y=100)
        mod.draw_north_arrow(a, x=160, y=60, size=20, rotation_deg=15.0)
        mod.draw_graticule(a, mod.GraticuleSpec(spacing=25.0), (0.0, 0.0, 130.0, 90.0))
        out.append(a)
    np.testing.assert_array_equal(*out)
    assert (out[0] != img).any()


# the host copies of the other path-tracing engines' slice: the golden-gate
# metrics, the EXR writer with its ZIP helpers, refit_bvh, build_tlas's
# float64 matrices and iter_tiles
@pytest.mark.parametrize("shape", [(24, 32, 3), (24, 32, 4), (24, 32)], ids=["rgb", "rgba", "gray"])
def test_image_metrics_equal(shape):
    from forge3d_tpu.utils import metrics as jm

    from forge3d_tpu_torch import metrics as tm

    rng = np.random.default_rng(len(shape) + shape[-1])
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-20, 20, shape), 0, 255).astype(np.uint8)
    assert tm.image_metrics(a, b) == jm.image_metrics(a, b)
    assert tm.mean_abs_error(a, b.astype(np.float32) / 255) == jm.mean_abs_error(
        a, b.astype(np.float32) / 255)
    if len(shape) == 3:
        np.testing.assert_array_equal(tm.delta_e2000(a, b), jm.delta_e2000(a, b))


@pytest.mark.parametrize("kw", [dict(), dict(half=True), dict(compression="zips"),
                                dict(channel_names=("Z", "A", "N")),
                                dict(half=True, compression="zips")],
                         ids=["float", "half", "zips", "names", "half_zips"])
def test_numpy_to_exr_byte_equal(tmp_path, kw):
    from forge3d_tpu.io import formats as jf

    from forge3d_tpu_torch.io import formats as tf

    img = np.random.default_rng(7).random((20, 28, 3)).astype(np.float32)
    img[:8] = 0.25                      # runs that ZIP shrinks
    jf.numpy_to_exr(tmp_path / "j.exr", img, **kw)
    tf.numpy_to_exr(tmp_path / "t.exr", img, **kw)
    assert (tmp_path / "t.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    raw = img.tobytes()
    z = tf._exr_zip_compress(raw)
    assert z == jf._exr_zip_compress(raw) and jf._exr_zip_decompress(z, len(raw)) == raw
    for bad in (dict(compression="piz"), dict(channel_names=("R",))):
        with pytest.raises(tf.FormatError):
            tf.numpy_to_exr(tmp_path / "x.exr", img, **bad)
    with pytest.raises(tf.FormatError, match="expected"):
        tf.numpy_to_exr(tmp_path / "x.exr", np.zeros((2, 2, 5), np.float32))


def test_refit_bvh_and_tlas_matrices_equal():
    from forge3d_tpu.ops import bvh as jbvh
    from forge3d_tpu.ops import tlas as jt

    from forge3d_tpu_torch.ops import bvh as tbvh
    from forge3d_tpu_torch.ops import tlas as tt

    rng = np.random.default_rng(11)
    v = rng.uniform(-2, 2, (150, 3)).astype(np.float32)
    f = np.arange(150, dtype=np.uint32).reshape(50, 3)
    moved = v * np.float32(1.1) + np.float32(0.3)
    rj = jbvh.refit_bvh(jbvh.build_sah_bvh(v, f), moved, f)
    rt = tbvh.refit_bvh(tbvh.build_sah_bvh(v, f), moved, f)
    for name in ("bounds_min", "bounds_max", "tri_v0", "tri_e1", "tri_e2"):
        assert getattr(rt, name).tobytes() == getattr(rj, name).tobytes(), name
    m = rng.normal(0, 1, (4, 4))
    m[3] = (0, 0, 0, 1)
    j = jt.build_tlas([(v, f)], [jt.Instance(0, m), jt.Instance(0, np.eye(4) * 2.0)])
    t = tt.build_tlas([(v, f)], [tt.Instance(0, m), tt.Instance(0, np.eye(4) * 2.0)],
                      device="cpu")
    for a, b in zip(j.inv_mats + j.nrm_mats, t.inv_mats + t.nrm_mats):
        assert a.dtype == b.dtype == np.float64 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("size", [(130, 70, 64), (64, 64, 64), (5, 3, 2), (1, 1, 8)])
def test_iter_tiles_equal(size):
    from forge3d_tpu.pt import path_tracer as jpt

    from forge3d_tpu_torch.pt import path_tracer as tpt

    assert list(tpt.iter_tiles(*size)) == list(jpt.iter_tiles(*size))


@pytest.mark.parametrize("name,size", [("mini", None), ("rainier", 129)])
def test_fetch_dem_equal(tmp_path, monkeypatch, name, size):
    """The named DEM registry: the same heights and GeoTIFF bytes, each side
    writing its own cache under FORGE3D_DATA_DIR, then the cached read."""
    from forge3d_tpu import datasets as jd

    from forge3d_tpu_torch import datasets as td

    out = {}
    for tag, mod in (("jax", jd), ("port", td)):
        monkeypatch.setenv("FORGE3D_DATA_DIR", str(tmp_path / tag))
        dem, info = mod.fetch_dem(name, size=size)
        again, info2 = mod.fetch_dem(name, size=size)
        assert not info["cached"] and info2["cached"]
        np.testing.assert_array_equal(dem, again)
        out[tag] = (dem, info, (tmp_path / tag / f"{name}_{info['size']}.tif").read_bytes(),
                    mod.dem_spacing(info))
    (a, ia, fa, sa), (b, ib, fb, sb) = out["jax"], out["port"]
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert fa == fb and sa == sb
    assert {k: v for k, v in ia.items() if k != "path"} == {
        k: v for k, v in ib.items() if k != "path"}
    assert jd.dataset_names() == td.dataset_names()
    assert jd.dataset_info(name) == td.dataset_info(name)
    if name == "mini":
        np.testing.assert_array_equal(jd.mini_dem(), td.mini_dem())
    for mod in (jd, td):
        with pytest.raises(KeyError, match="unknown dataset"):
            mod.dataset_info("atlantis")


OVERPASS = {"elements": [
    {"type": "node", "id": 1, "lon": -122.40, "lat": 37.79},
    {"type": "node", "id": 2, "lon": -122.399, "lat": 37.79},
    {"type": "node", "id": 3, "lon": -122.399, "lat": 37.791},
    {"type": "node", "id": 4, "lon": -122.40, "lat": 37.791},
    {"type": "node", "id": 5, "lon": -122.398, "lat": 37.792, "tags": {"amenity": "cafe"}},
    {"type": "way", "id": 10, "nodes": [1, 2, 3, 4, 1], "tags": {"building": "yes",
                                                                  "building:levels": "4"}},
    {"type": "way", "id": 11, "nodes": [1, 3, 5], "tags": {"highway": "residential"}},
    {"type": "way", "id": 12, "nodes": [2, 3, 4, 2], "tags": {"natural": "water"}},
]}


def test_osm_and_terrarium_equal():
    from forge3d_tpu.gis import osm as jo

    from forge3d_tpu_torch.gis import osm as to

    dem = np.random.default_rng(2).normal(800.0, 300.0, (37, 29)).astype(np.float32)
    dem[0, :3] = (-40000.0, 40000.0, 0.0)   # both clip ends of the code
    rgb = jo.build_terrarium_dem(dem)
    assert rgb.dtype == np.uint8 and np.array_equal(rgb, to.build_terrarium_dem(dem))
    np.testing.assert_array_equal(jo.decode_terrarium_dem(rgb), to.decode_terrarium_dem(rgb))
    coll = jo.parse_osm_features(OVERPASS)
    assert coll == to.parse_osm_features(OVERPASS)
    q = dict(tags={"highway": None}, geometry_type="LineString", bbox=(-123, 37, -122, 38))
    assert jo.query_osm_features(coll, **q) == to.query_osm_features(coll, **q)
    a, b = jo.prepare_osm_scene(coll), to.prepare_osm_scene(coll)
    ma, mb = a.pop("buildings_mesh"), b.pop("buildings_mesh")
    assert a == b and a["building_count"] == 1
    _mesh_equal(ma, mb)
    for mod in (jo, to):
        with pytest.raises(mod.OsmError, match="non-finite"):
            mod.build_terrarium_dem(np.array([[np.nan]]))
        with pytest.raises(mod.OsmError, match="terrarium RGB"):
            mod.decode_terrarium_dem(np.zeros((4, 4)))
        with pytest.raises(mod.OsmError, match="not an Overpass"):
            mod.parse_osm_features({"foo": 1})


def test_astro_sun_ephemeris_equal():
    """julian_date, the sun's position, the alt/az conversion and
    sun_position_at over a day of hours, value for value"""
    from forge3d_tpu import astro as ja
    from forge3d_tpu import sky as js

    from forge3d_tpu_torch import astro as ta
    from forge3d_tpu_torch import sky as ts

    for args in ((2026, 6, 21, 20.0), (2000, 1, 1, 12.0), (2049, 12, 31, 23.5), (2025, 2, 28)):
        assert ta.julian_date(*args) == ja.julian_date(*args)
    for lat, lon in ((46.85, -121.76), (-33.9, 151.2), (64.1, -21.9)):
        for h in range(24):
            jd = 2460855.5 + h / 24.0
            sun = ja.astro_body_position("sun", jd)
            assert ta.astro_body_position("sun", jd) == sun
            for refract in (True, False):
                assert ta.equatorial_to_altaz(sun["ra_deg"], sun["dec_deg"], jd, lat, lon,
                                              refract=refract) == ja.equatorial_to_altaz(
                    sun["ra_deg"], sun["dec_deg"], jd, lat, lon, refract=refract)
            assert ts.sun_position_at(jd, lat, lon) == js.sun_position_at(jd, lat, lon)
    for mod in (ja, ta):
        with pytest.raises(ValueError):
            mod.astro_body_position("sun", mod.julian_date(2100, 1, 1))


def test_csm_state_functions_equal():
    from forge3d_tpu import shadows as jsh

    from forge3d_tpu_torch import shadows as tsh

    saved = (jsh.csm_state(), tsh.csm_state())
    try:
        for mod in (jsh, tsh):
            mod.configure_csm(cascade_count=3, near=1.0, far=800.0, lam=0.5, pcf_kernel=7)
            mod.set_csm_light_direction(0.3, -1.0, 0.2)
            mod.set_csm_bias_params(2e-3, 4e-3)
        assert tsh.csm_state() == jsh.csm_state()
        assert tsh.get_csm_cascade_info() == jsh.get_csm_cascade_info()
        assert tsh.cascade_splits(0.2, 300.0, 5, 0.9) == jsh.cascade_splits(0.2, 300.0, 5, 0.9)
    finally:
        for mod, st in zip((jsh, tsh), saved):
            mod._STATE.clear()
            mod._STATE.update(st)


# the F3DZ codec's host copies: codec/f3dz.py (over its copy of
# native/f3dz.cpp) and codec/f3dz_pylane.py, on pages that exercise the
# partial edge tiles, escapes (a 9,278 m step) and a flat page
def _f3dz_pages():
    rng = np.random.default_rng(5)
    y, x = np.mgrid[0:300, 0:270].astype(np.float32)
    return {"sloped_noise": (200 + 0.5 * x + 3 * rng.standard_normal((300, 270))),
            "step": np.where(x > 100, 8848.0, -430.5) + 0.01 * y,
            "flat": np.full((70, 33), 12.5)}


@pytest.mark.parametrize("name", sorted(_f3dz_pages()))
@pytest.mark.parametrize("eps", [0.01, 0.25])
def test_f3dz_host_codec_and_python_lane_equal(name, eps):
    from forge3d_tpu.codec import f3dz as jf
    from forge3d_tpu.codec import f3dz_pylane as jpy
    from forge3d_tpu_torch.codec import f3dz as tf
    from forge3d_tpu_torch.codec import f3dz_pylane as tpy

    h = np.asarray(_f3dz_pages()[name], np.float32)
    blob = tf.compress_dem(h, eps)
    assert blob == jf.compress_dem(h, eps)
    assert tf.f3dz_info(blob) == jf.f3dz_info(blob)
    a, b = tf.decompress_dem(blob), jf.decompress_dem(blob)
    assert a.view(np.uint32).tolist() == b.view(np.uint32).tolist()
    assert tf.verify_dem(blob, h) == jf.verify_dem(blob, h)
    py = tpy.decompress_dem_pylane(blob)
    assert py.view(np.uint32).tolist() == jpy.decompress_dem_pylane(blob).view(np.uint32).tolist()
    assert py.view(np.uint32).tolist() == a.view(np.uint32).tolist()
    bad = bytearray(blob)
    bad[-1] ^= 0x5A     # inside the last tile's record
    for mod, err in ((tf, tf.F3dzError), (jf, jf.F3dzError)):
        with pytest.raises(err, match="F3DZ decode failed"):
            mod.decompress_dem(bytes(bad))
    for mod, err in ((tpy, tf.F3dzError), (jpy, jf.F3dzError)):
        with pytest.raises(err, match="tile CRC mismatch"):
            mod.decompress_dem_pylane(bytes(bad))
    assert tf.F3dzError.__mro__[1].__name__ == jf.F3dzError.__mro__[1].__name__ == "RenderError"
