# The port's MapScene (forge3d_tpu_torch/mapscene.py) against the JAX
# package's (forge3d_tpu/mapscene.py) on the CPU: each recipe is declared
# once with the JAX dataclasses, carried across with
# convert.scene_recipe, and rendered by both, at 96x64 over a 65^2 DEM
# (the port's plain versions: R1, E4, K9, the screen engine).
#
# Recipes: perspective with world lines (one dashed), polygons with a hole,
# points, a raster overlay and the plain furniture; perspective with a
# BuildingLayer and a point cloud (depth through render_with_aov, K9's plain
# version); the hash-stripe placeholder and the screen_rect landmark; screen
# with layer_space="screen" (the stroke-quality and choropleth features of
# tests/test_reference_golden_parity.py); clipmap; mesh; and
# TerrainSource(path=...) over a GeoTIFF written with the JAX package's
# write_raster. Also: validate().as_dict() equal on good and bad recipes,
# last_render_metadata's keys equal, stable_layer_hash equal, the refusals
# of what is not ported (each naming its ROADMAP item), and the CUDA
# default of MapScene and the vector entry points.
#
# Gate: rgba within one u8 step on >= 99.5% of pixels (the CPU shows every
# recipe here byte-equal).
import numpy as np
import pytest
import torch

from forge3d_tpu import mapscene as jm
from forge3d_tpu import thematic

from forge3d_tpu_torch import mapscene as tm
from forge3d_tpu_torch import vector as tv
from forge3d_tpu_torch.convert import scene_recipe
from forge3d_tpu_torch.errors import DeviceError, RenderError

torch.set_num_threads(1)

W, H = 96, 64
REF_META = {"source_id": "recipe-dem", "width": 65, "height": 65, "asset_status": "fixture",
            "bounds": (-122.5, 46.6, -121.9, 47.0)}


def dem65():
    y, x = np.mgrid[0:65, 0:65].astype(np.float32)
    return (6.0 * np.sin(x * 0.15) * np.cos(y * 0.12) + 3.0 + 0.05 * x).astype(np.float32)


def rings():
    t = np.linspace(0.0, 2.0 * np.pi, 13)[:-1]
    outer = np.stack([32 + 12 * np.cos(t), 32 + 10 * np.sin(t)], 1)
    hole = np.stack([32 + 4 * np.cos(-t), 32 + 3 * np.sin(-t)], 1)
    return outer, hole


def world_layers():
    rng = np.random.default_rng(1)
    line = np.stack([np.linspace(5, 60, 20), 20 + 8 * np.sin(np.linspace(0, 5, 20))], 1)
    outer, hole = rings()
    return [
        jm.VectorOverlayLayer(kind="lines", coordinates=line, width=2.0, color=(0.9, 0.1, 0.1)),
        jm.VectorOverlayLayer(kind="lines", coordinates=line + [0.0, 10.0], width=3.0,
                              dash_array=[6, 3]),
        jm.VectorOverlayLayer(kind="polygons", coordinates=[outer, hole], opacity=0.6,
                              color=(0.1, 0.4, 0.9)),
        jm.VectorOverlayLayer(kind="points", coordinates=rng.uniform(5, 60, (20, 2)), width=4.0),
        jm.RasterOverlayLayer(image=rng.uniform(0, 1, (40, 50, 3)).astype(np.float32),
                              opacity=0.35),
    ]


def town():
    fps = [np.array([[10, 10], [18, 10], [18, 16], [10, 16]], float) + [i * 12, (i % 2) * 20]
           for i in range(4)]
    return jm.BuildingLayer(footprints=fps, heights=[8.0, 12.0, 16.0, 20.0])


def screen_recipe(layers, **kw):
    """tests/test_reference_golden_parity.py:_base_recipe over the 65^2 DEM."""
    return jm.SceneRecipe(
        terrain=jm.TerrainSource(dem=dem65(), spacing=(1.0, 1.0), z_scale=1.0,
                                 metadata=dict(REF_META)),
        camera=jm.OrbitCamera(radius=800.0, phi_deg=35.0, theta_deg=45.0, fov_y_deg=45.0),
        lighting=jm.LightingPreset(name="rainier_showcase", intensity=1.15),
        output=jm.OutputSpec(size_px=(W, H)), layers=list(layers), camera_mode="screen",
        **kw)


def stroke_quality_layer():
    return jm.VectorOverlayLayer(
        layer_id="cartography", crs="EPSG:32610",
        features=[
            {"id": "hairpin", "geometry": {
                "type": "LineString",
                "coordinates": [(0.06, 0.74), (0.30, 0.18), (0.52, 0.74), (0.74, 0.22),
                                (0.94, 0.74)]}},
            {"id": "dashed-boundary", "geometry": {
                "type": "LineString", "coordinates": [(0.08, 0.10), (0.92, 0.10)]}},
            {"id": "park-with-hole", "geometry": {
                "type": "Polygon",
                "coordinates": [
                    [(0.10, 0.32), (0.38, 0.32), (0.38, 0.62), (0.10, 0.62), (0.10, 0.32)],
                    [(0.19, 0.41), (0.30, 0.41), (0.30, 0.53), (0.19, 0.53), (0.19, 0.41)]]}},
        ],
        width_px=6, line_cap="round", line_join="round", dash_array=[12, 7],
        style={"version": 8, "layers": [
            {"id": "cartography", "type": "line",
             "paint": {"line-color": "#f8fafc", "line-width": 6, "fill-color": "#2563eb"}}]})


def choropleth_layer():
    values = np.asarray([12.0, 28.0, 57.0, 83.0], np.float32)
    classes = thematic.classify(values, scheme="quantile", k=4)["classes"]
    palette = {1: "#edf8fb", 2: "#b2e2e2", 3: "#66c2a4", 4: "#238b45"}
    feats = []
    for idx, cls in enumerate(np.asarray(classes).tolist()):
        x0 = 0.10 + (idx % 2) * 0.42
        y0 = 0.14 + (idx // 2) * 0.38
        x1, y1 = x0 + 0.32, y0 + 0.28
        feats.append({"id": f"zone-{idx}", "geometry": {"type": "Polygon", "coordinates": [
            [(x0, y0), (x1, y0), (x1, y1), (x0, y1), (x0, y0)]]},
            "properties": {"class": int(cls), "value": float(values[idx])}})
    return jm.VectorOverlayLayer(
        layer_id="classified-zones", crs="EPSG:32610", features=feats, width_px=2,
        style={"version": 8, "layers": [
            {"id": "zones-fill", "type": "fill",
             "paint": {"fill-color": ["match", ["get", "class"], 1, palette[1], 2, palette[2],
                                      3, palette[3], palette[4]],
                       "fill-opacity": 0.84}},
            {"id": "zones-outline", "type": "line",
             "paint": {"line-color": "#0f172a", "line-width": 2}}]})


def render_both(rec, **kw):
    ref = jm.MapScene(rec)
    got = tm.MapScene(scene_recipe(rec), device="cpu")
    return ref, ref.render(**kw), got, got.render(**kw)


def assert_close(a, b):
    assert a.rgba.shape == b.rgba.shape == (H, W, 4)
    du = np.abs(a.rgba.astype(np.int32) - b.rgba.astype(np.int32)).max(-1)
    assert float((du <= 1).mean()) >= 0.995, du.max()
    assert float(a.rgba[..., :3].std()) > 5.0


def perspective(layers, **kw):
    kw.setdefault("output", jm.OutputSpec(size_px=(W, H)))
    return jm.SceneRecipe(terrain=jm.TerrainSource(dem=dem65()), layers=layers, **kw)


def test_perspective_world_layers_and_furniture():
    rec = perspective(world_layers(), furniture=jm.MapFurniture(
        legend=True, scale_bar=True, north_arrow=True, title="Ridge", subtitle="test",
        graticule_spacing=16.0))
    ref, a, got, b = render_both(rec)
    assert_close(a, b)
    assert sorted(ref.last_render_metadata) == sorted(got.last_render_metadata)
    assert a.metadata["recipe"] == b.metadata["recipe"] == "map"


def test_perspective_buildings_and_points():
    rng = np.random.default_rng(4)
    pts = np.c_[rng.uniform(5, 60, 50), rng.uniform(5, 15, 50), rng.uniform(5, 60, 50)]
    rec = perspective([town(), jm.PointCloudLayer(positions=pts, point_size=3),
                       jm.VectorOverlayLayer(kind="lines", coordinates=rings()[0], width=2.0)])
    _, a, _, b = render_both(rec)
    assert_close(a, b)
    # the town is in the frame: the buildings change the terrain render
    _, c, _, d = render_both(perspective([]))
    assert float((a.rgba != c.rgba).any(-1).mean()) > 0.02
    assert np.array_equal(c.rgba, d.rgba)


def test_raster_placeholder_and_screen_rect():
    rng = np.random.default_rng(2)
    rec = perspective([
        jm.RasterOverlayLayer(layer_id="ortho", path="fixtures/missing.tif", opacity=0.72),
        jm.RasterOverlayLayer(image=(rng.uniform(0, 1, (12, 20, 4)) * 255).astype(np.uint8),
                              screen_rect=(0.1, 0.2, 0.6, 0.7), opacity=0.8)])
    _, a, _, b = render_both(rec)
    assert_close(a, b)


def test_screen_layer_space():
    rec = screen_recipe([stroke_quality_layer(), choropleth_layer()], layer_space="screen",
                        screen_space={"ssao": {"enabled": True, "intensity": 1.0},
                                      "ssgi": {"enabled": True, "intensity": 1.0}})
    ref, a, got, b = render_both(rec)
    assert_close(a, b)
    assert ref.last_render_metadata["camera_mode"] == got.last_render_metadata["camera_mode"] \
        == "screen"


def test_clipmap_mode():
    meta = dict(REF_META, clipmap={"ring_count": 2, "ring_resolution": 8,
                                   "center_resolution": 8})
    rec = screen_recipe([])
    rec.terrain.metadata = meta
    ref, a, got, b = render_both(rec)
    assert_close(a, b)
    assert got.last_render_metadata["camera_mode"].startswith("clipmap:2:8:8")


def test_mesh_mode():
    rec = perspective([jm.VectorOverlayLayer(kind="points", coordinates=[[20.0, 20.0]],
                                             width=5.0)], camera_mode="mesh")
    _, a, _, b = render_both(rec)
    assert_close(a, b)


def test_geotiff_terrain_source_and_raster_path(tmp_path):
    from forge3d_tpu.gis import write_raster

    dem = dem65() * 10.0 + 500.0
    dem[0, :4] = -9999.0
    tif = tmp_path / "dem.tif"
    write_raster(str(tif), dem, transform=(2.0, 0.0, 1000.0, 0.0, -2.0, 5000.0),
                 crs="EPSG:32610", nodata=-9999.0)
    rec = jm.SceneRecipe(terrain=jm.TerrainSource(path=str(tif)),
                         output=jm.OutputSpec(size_px=(W, H)),
                         layers=[jm.RasterOverlayLayer(path=str(tif), opacity=0.5)])
    ref, a, got, b = render_both(rec)
    assert_close(a, b)
    ra, rb = rec.terrain.resolve(), scene_recipe(rec).terrain.resolve()
    np.testing.assert_array_equal(ra[0], rb[0])
    assert ra[1:] == rb[1:] == ((2.0, 2.0), "EPSG:32610")
    assert float(ra[0].min()) > 0.0        # the nodata cells were filled


def test_png_path_and_certificate(tmp_path):
    from forge3d_tpu_torch.io.image import png_to_numpy

    rec = perspective(world_layers()[:2])
    cert_a, cert_b = {}, {}
    a = jm.MapScene(rec).render(path=str(tmp_path / "a.png"), certificate=cert_a)
    b = tm.MapScene(scene_recipe(rec), device="cpu").render(path=str(tmp_path / "b.png"),
                                                           certificate=cert_b)
    assert_close(a, b)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    np.testing.assert_array_equal(png_to_numpy(str(tmp_path / "b.png")), b.rgba)
    assert sorted(cert_a) == sorted(cert_b) and cert_b["signature"]


BAD_RECIPES = {
    "good": lambda: perspective(world_layers() + [town()]),
    "no_terrain": lambda: jm.SceneRecipe(),
    "two_sources": lambda: jm.SceneRecipe(terrain=jm.TerrainSource(dem=dem65(), path="x.tif")),
    "nonfinite": lambda: jm.SceneRecipe(
        terrain=jm.TerrainSource(dem=np.full((8, 8), np.nan, np.float32))),
    "size_and_samples": lambda: perspective([], output=jm.OutputSpec(size_px=(0, 4), samples=0)),
    "preset": lambda: perspective([], lighting="dusk"),
    "layers": lambda: perspective([
        jm.VectorOverlayLayer(kind="blobs", coordinates=[[0, 0]], opacity=2.0),
        jm.VectorOverlayLayer(features=[{"geometry": {}}]),
        jm.RasterOverlayLayer(image=np.zeros((4, 4))),
        jm.BuildingLayer(footprints=[np.zeros((4, 2))]),
        jm.PointCloudLayer(),
        jm.Tiles3DLayer(),
        jm.LabelLayer(labels=[{"text": "a"}], occlusion="sky"),
        object()]),
}


@pytest.mark.parametrize("case", list(BAD_RECIPES))
def test_validate_report_equal(case):
    rec = BAD_RECIPES[case]()
    ref = jm.MapScene(rec).validate().as_dict()
    got = tm.MapScene(scene_recipe(rec), device="cpu").validate().as_dict()
    assert ref == got
    assert (ref["max_severity"] == "info") == (case == "good")
    if case != "good":
        with pytest.raises(RenderError, match="render blocked by diagnostics"):
            tm.MapScene(scene_recipe(rec), device="cpu").render()


HASHED = {
    "vector": lambda: stroke_quality_layer(),
    "choropleth": lambda: choropleth_layer(),
    "simple": lambda: jm.VectorOverlayLayer(kind="lines", coordinates=[[0, 0], [1, 1]],
                                            dash_array=[4, 2], line_cap="Round"),
    "raster": lambda: jm.RasterOverlayLayer(layer_id="ortho", path="a.tif", opacity=0.72,
                                            metadata={"w": 8}),
}


@pytest.mark.parametrize("case", list(HASHED))
@pytest.mark.parametrize("salt", ["", "vector", "raster-mask"])
def test_stable_layer_hash_equal(case, salt):
    layer = HASHED[case]()
    port = scene_recipe(jm.SceneRecipe(layers=[layer])).layers[0]
    assert type(port).__module__ == "forge3d_tpu_torch.mapscene"
    assert tm.stable_layer_hash(port, salt) == jm.stable_layer_hash(layer, salt)
    assert tm.layer_hash_rgb(port.to_dict(), salt) == jm.layer_hash_rgb(layer.to_dict(), salt)
    assert tm.layer_hash_int(port.to_dict(), salt) == jm.layer_hash_int(layer.to_dict(), salt)


REFUSED = {
    "labels": (lambda: perspective([jm.LabelLayer(labels=[{"text": "a", "position": (1, 2)}])]),
               {}, "LabelLayer.*item 14"),
    "reference_furniture": (lambda: perspective([], furniture=jm.MapFurniture(
        legend_cfg={"items": []})), {}, "reference layout.*item 14"),
    "tiles3d": (lambda: perspective([jm.Tiles3DLayer(tileset_path="t.json")]), {},
                "Tiles3DLayer.*item 15"),
    "pointcloud_path": (lambda: perspective([jm.PointCloudLayer(path="p.laz")]), {},
                        r"PointCloudLayer\(path=...\).*item 15"),
    "cache": (lambda: perspective([]), {"cache": object()}, r"cache=.*item 13"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_unported_parts_refused(case):
    make, kw, msg = REFUSED[case]
    with pytest.raises(NotImplementedError, match=msg):
        tm.MapScene(scene_recipe(make()), device="cpu").render(**kw)


def test_validation_comes_before_the_refusal():
    rec = perspective([jm.LabelLayer(labels=[{"text": "no position"}])])
    with pytest.raises(RenderError, match="layer.labels"):
        tm.MapScene(scene_recipe(rec), device="cpu").render()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    rec = scene_recipe(perspective(world_layers()))
    with pytest.raises(DeviceError, match="CUDA is not available"):
        tm.MapScene(rec)
    vs = tv.VectorScene()
    vs.add_points([[4.0, 4.0]])
    with pytest.raises(DeviceError):
        vs.render(16, 8)
    payload = dict(points_xy=[[4.0, 4.0]], polylines=[[[0, 0], [9, 5]]])
    for fn in (tv.vector_render_oit, tv.vector_render_oit_edl, tv.vector_render_pick_map,
               tv.vector_render_oit_and_pick):
        with pytest.raises(DeviceError):
            fn(16, 8, **payload)
    with pytest.raises(DeviceError):
        tv.stroke_coverage(16, 8, [[0, 0, 9, 5]], 2.0)
