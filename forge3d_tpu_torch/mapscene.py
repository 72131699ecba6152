# forge3d_tpu_torch/mapscene.py
# MapScene: the declarative scene compiler of the PyTorch port — recipe in,
# finished map out. The port of forge3d_tpu/mapscene.py: the same recipe
# dataclasses (layer hashes byte-exact), validation, plan and routes, on the
# MapScene's device ("cuda" unless the caller asks for the CPU):
#
#   perspective  TerrainRenderer (kernel R1; render_with_aov when a layer
#                needs depth), then buildings through the BVH walk K9, point
#                clouds, raster overlays, and world vector layers through
#                kernel E4 (vector.VectorScene, one launch for every layer);
#   screen       mapscene_screen.render_screen_base (S1-S4, S8), cloud
#                shadow and postfx, screen-space layers through
#                screen_compose (host numpy);
#   clipmap      terrain.screen.render_clipmap_scene (host G-buffer, S9);
#   mesh         the numpy grid-mesh raster.
#
# Furniture (the plain layout), the screen-space postfx, the building
# scatter pass of screen mode and the point splats are the JAX package's
# host numpy code. Labels, the reference furniture layout, 3D Tiles, point
# cloud files and cache= are refused with the ROADMAP item that ports them.
#
# The JAX module's notes follow.
#
# MapScene: the declarative scene compiler — recipe in, finished map out.
#
# Parity notes (reference behavior, not code):
#   forge3d:python/forge3d/map_scene.py (6.1k) and
#   _map_scene_{validation,labels,render,common}.py — SceneRecipe
#   (TerrainSource, OrbitCamera, LightingPreset, layers, OutputSpec) →
#   validation (may BLOCK the render) → compiled plan → native terrain
#   render → vector/raster overlay compositing → furniture → deterministic
#   PNG; `cache=`/`certificate=` kwargs on render.
#
# The TPU build compiles the recipe onto TerrainRenderer (one fused device
# program) and composites overlays/furniture host-side; overlay vertices are
# projected with the same camera the renderer uses, so overlays register
# exactly with the terrain image.

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .camera import camera_basis, orbit_camera_origin
from .mapscene_screen import LightingPreset  # noqa: F401 (public API)
from .diagnostics import Severity, ValidationReport
from .errors import RenderError, UploadError
from .frame import Frame
from .terrain.params import (
    FogSettings,
    LightSettings,
    TerrainRenderParams,
    WaterSettings,
    make_terrain_params,
)
from .terrain.renderer import _NOT_PORTED


# ---------------------------------------------------------------------------
# Stable layer hashing (reference-parity placeholder colors)
# ---------------------------------------------------------------------------
# The reference derives deterministic placeholder colors for layers that
# cannot be composited from data (missing raster path, style expressions)
# from a canonical-JSON SHA-256 of the layer dict
# (_map_scene_common.py:_stable_hash / _map_scene_render.py:_rgb).  The
# same canonicalization is reproduced here so placeholder pixels agree
# byte-for-byte with the reference goldens.

def _json_canonical(value):
    import os as _os

    if hasattr(value, "to_dict") and callable(value.to_dict):
        return _json_canonical(value.to_dict())
    if isinstance(value, dict):
        return {str(k): _json_canonical(value[k])
                for k in sorted(value, key=str)}
    if isinstance(value, (list, tuple)):
        return [_json_canonical(x) for x in value]
    if isinstance(value, _os.PathLike):
        return _os.fspath(value)
    return value


def stable_layer_hash(value, salt: str = "") -> str:
    import hashlib
    import json

    payload = json.dumps(_json_canonical({"salt": salt, "value": value}),
                         sort_keys=True, separators=(",", ":"),
                         ensure_ascii=True)
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def layer_hash_rgb(value, salt: str = "") -> Tuple[int, int, int]:
    d = stable_layer_hash(value, salt)
    return int(d[0:2], 16), int(d[2:4], 16), int(d[4:6], 16)


def layer_hash_int(value, salt: str = "") -> int:
    return int(stable_layer_hash(value, salt)[:8], 16)


# ---------------------------------------------------------------------------
# Recipe elements
# ---------------------------------------------------------------------------

@dataclass
class TerrainSource:
    dem: Optional[np.ndarray] = None
    path: Optional[str] = None       # GeoTIFF path
    band: int = 0
    crs: Optional[str] = None
    spacing: Optional[Tuple[float, float]] = None
    z_scale: float = 1.0
    nodata_fill: Optional[float] = None
    #: reference TerrainSource metadata (source_id / width / height /
    #: bounds / water / clouds / clipmap ...); bounds + width/height
    #: derive the scene resolution and hence the preset camera radius
    #: (map_scene.py:4438-4454)
    metadata: Optional[dict] = None

    def resolve(self) -> Tuple[np.ndarray, Tuple[float, float], Optional[str]]:
        if (self.dem is None) == (self.path is None):
            raise UploadError("TerrainSource needs exactly one of dem/path")
        if self.path is not None:
            from . import gis

            info = gis.read_raster_info(self.path)
            dem = np.asarray(gis.read_raster(self.path, band=self.band), np.float32)
            spacing = self.spacing or info["resolution"]
            crs = self.crs or info["crs"]
            if info["nodata"] is not None:
                fill = (self.nodata_fill if self.nodata_fill is not None
                        else float(np.nanmin(np.where(dem == info["nodata"], np.nan, dem))))
                dem = np.where(dem == info["nodata"], fill, dem)
        else:
            dem = np.asarray(self.dem, np.float32)
            if self.nodata_fill is not None:
                dem = np.where(np.isfinite(dem), dem, self.nodata_fill)
            spacing = self.spacing or (1.0, 1.0)
            crs = self.crs
        return dem, (float(spacing[0]), float(spacing[1])), crs


@dataclass
class OrbitCamera:
    target: Optional[Tuple[float, float, float]] = None  # None = DEM center
    radius: float = 0.0          # 0 = auto (1.2 x span)
    phi_deg: float = 225.0
    theta_deg: float = 35.0
    fov_y_deg: float = 45.0


_LIGHTING_PRESETS = {
    "noon": LightSettings(azimuth_deg=180.0, elevation_deg=65.0, intensity=2.6,
                          ambient=0.22),
    "golden_hour": LightSettings(azimuth_deg=260.0, elevation_deg=12.0,
                                 intensity=2.2, color=(1.0, 0.82, 0.6),
                                 ambient=0.18,
                                 ambient_color=(0.45, 0.5, 0.7)),
    "overcast": LightSettings(azimuth_deg=315.0, elevation_deg=50.0,
                              intensity=0.9, color=(0.95, 0.97, 1.0),
                              ambient=0.55,
                              ambient_color=(0.75, 0.78, 0.82)),
    "default": LightSettings(),
}


def lighting_preset(name: str) -> LightSettings:
    try:
        return _LIGHTING_PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown lighting preset {name!r}; have {sorted(_LIGHTING_PRESETS)}")


@dataclass
class VectorOverlayLayer:
    """Vector overlay.

    Two declaration forms are supported:

    * simplified: ``kind`` + ``coordinates`` + ``color`` (points/lines/
      polygons drawn directly), or
    * the reference contract: GeoJSON-style ``features`` + Mapbox-GL
      ``style``, resolved exactly like the reference's compositor
      (_map_scene_render.py:1401-1514) including the deterministic
      SHA-256 fallback colors for missing paint entries
      (map_scene.py:3408-3424 ``VectorOverlay.to_dict`` feeds the hash).
    """

    kind: str = "features"          # points|lines|polygons|features
    coordinates: object = None      # world xz coords: (N,2) or rings list
    color: Tuple[float, float, float] = (0.9, 0.2, 0.1)
    width: float = 3.0              # stroke px / point size px
    opacity: float = 1.0
    height_offset: float = 1.0      # meters above terrain
    dash_array: Optional[List[float]] = None   # [on_px, off_px, ...]
    line_cap: Optional[str] = None    # butt|round|square (screen space)
    line_join: Optional[str] = None   # miter|round (screen space)
    name: str = ""
    # reference-contract declaration (VectorOverlay, map_scene.py:3372)
    layer_id: str = "layer"
    path: Optional[str] = None
    crs: Optional[str] = None
    features: Optional[List[dict]] = None
    style: Optional[dict] = None
    width_px: object = None          # kept verbatim (int vs float changes
    width_world: object = None       # the canonical-JSON layer hash)
    style_support: Optional[dict] = None
    metadata: Optional[dict] = None

    def to_dict(self):
        """The reference's canonical VectorOverlay payload
        (map_scene.py:3408-3424): exactly these 13 keys, dash lengths as
        floats, join/cap lowercased with miter/butt defaults. This dict
        feeds the stable layer hash, so the shape is byte-exact."""
        dash = self.dash_array
        dash = [float(v) for v in dash] if dash else []
        return {
            "kind": "vector_overlay",
            "layer_id": str(self.layer_id),
            "path": str(self.path) if self.path is not None else None,
            "features": [dict(f) for f in (self.features or [])],
            "crs": self.crs,
            "style": dict(self.style or {}),
            "width_px": self.width_px,
            "width_world": self.width_world,
            "line_join": str(self.line_join or "miter").lower(),
            "line_cap": str(self.line_cap or "butt").lower(),
            "dash_array": dash,
            "style_support": dict(self.style_support or {}),
            "metadata": dict(self.metadata or {}),
        }


@dataclass
class RasterOverlayLayer:
    """Raster overlay; when neither ``image`` nor a readable ``path`` is
    given, a deterministic hash-colored diagonal-stripe placeholder is
    composited instead — matching the reference's compositor exactly
    (_map_scene_render.py:1392-1400: color from a stable SHA-256 of the
    layer dict, mask ``(x+y+hash)%5 < 3``, alpha = opacity*0.45)."""

    image: Optional[np.ndarray] = None   # (H, W, 3|4) float or uint8
    path: Optional[str] = None
    layer_id: str = "layer"
    crs: Optional[str] = None
    metadata: Optional[dict] = None
    opacity: float = 1.0
    #: optional fractional screen rect (x0, y0, x1, y1) to composite the
    #: image into (reference textured-landmark layers use screen_rect
    #: metadata); None = full frame
    screen_rect: Optional[Tuple[float, float, float, float]] = None
    name: str = ""

    def to_dict(self):
        return {
            "kind": "raster_overlay",
            "layer_id": str(self.layer_id),
            "path": self.path,
            "crs": self.crs,
            "opacity": float(self.opacity),
            "metadata": dict(self.metadata or {}),
        }


@dataclass
class BuildingLayer:
    """Extruded 3D buildings, depth-composited with the terrain.

    Reference: python/forge3d/map_scene.py BuildingLayer (:3943) — footprint
    extrusion + CityJSON import rendered into the scene. Here the merged
    building mesh is ray-traced with the same camera (ops/bvh SAH build +
    stackless traversal) and composited against the terrain depth AOV.
    """

    footprints: Optional[Sequence] = None   # list of (N,2) world-xz rings
    heights: Optional[Sequence[float]] = None
    #: per-footprint material names (palette: brick/concrete/glass/stone/
    #: wood) and roof shapes (flat/gabled/hipped/pyramidal) — reference
    #: BuildingLayer feature properties
    materials: Optional[Sequence[str]] = None
    roof_types: Optional[Sequence[str]] = None
    cityjson_path: Optional[str] = None
    mesh: Optional[object] = None           # io.mesh.MeshData
    color: Tuple[float, float, float] = (0.72, 0.68, 0.64)
    roof_color: Optional[Tuple[float, float, float]] = None
    on_terrain: bool = True                  # base at terrain height
    opacity: float = 1.0
    name: str = ""


@dataclass
class PointCloudLayer:
    """Point cloud splats, depth-tested against the terrain.

    Reference: map_scene.py PointCloudLayer (:3922) — LAS/PLY/COPC points
    (pointcloud.read_point_file) or raw positions."""

    path: Optional[str] = None
    positions: Optional[np.ndarray] = None   # world (N, 3): x, y, z
    colors: Optional[np.ndarray] = None      # (N, 3) in [0,1]
    color: Tuple[float, float, float] = (0.95, 0.6, 0.15)
    point_size: int = 2
    max_points: Optional[int] = None
    height_scale: float = 1.0
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    name: str = ""


@dataclass
class Tiles3DLayer:
    """3D Tiles content (tileset.json traversal; pnts points and b3dm
    meshes). Reference: map_scene.py Tiles3DLayer (:4054)."""

    tileset_path: str = ""
    sse_threshold: float = 16.0
    point_size: int = 2
    color: Tuple[float, float, float] = (0.85, 0.8, 0.75)
    max_tiles: int = 64
    #: dataset bounds (x0, y0, x1, y1) for the screen-mode overlay
    #: projection (reference Tiles3DLayer metadata "bounds")
    bounds: Optional[Tuple[float, float, float, float]] = None
    #: inline content (bypasses tileset traversal; mirrors a single-tile
    #: pnts payload)
    positions: Optional[np.ndarray] = None
    colors: Optional[np.ndarray] = None
    #: "edl" darkens isolated splats like the reference's eye-dome
    #: lighting pass; "color" uses the per-point colors directly
    shading: str = "color"
    #: explicit projection camera (reference Tiles3DLayer metadata
    #: "camera_position"/"camera_target"/"fov_y_deg",
    #: map_scene.py:1899-1925); defaults to the span-derived orbit when
    #: unset
    camera_position: Optional[Tuple[float, float, float]] = None
    camera_target: Optional[Tuple[float, float, float]] = None
    fov_y_deg: float = 45.0
    name: str = ""


@dataclass
class LabelLayer:
    """Decluttered text labels with halos and terrain-depth occlusion.

    Reference: map_scene.py LabelLayer (:3679) + _map_scene_labels.py —
    candidates -> collision/declutter solve -> SDF text raster."""

    labels: List[dict] = field(default_factory=list)
    # each: {"text": str, "position": (x, z) or (x, y, z),
    #        "size": px, "priority": float, "color": rgba,
    #        "halo_color": rgba, "halo_width": px,
    #        "depth": float01 (vs depth_image occlusion)}
    #: default label text size — the reference's MapScene native label
    #: pass default (map_scene.py:2411-2416: "Keep MapScene's default at
    #: 12 px")
    size_px: float = 12.0
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    halo_color: Tuple[float, float, float, float] = (0.04, 0.05, 0.06, 0.9)
    halo_width: float = 2.0
    occlusion: str = "terrain"               # "terrain" | "none"
    declutter: str = "greedy"                # labels/declutter algorithms
    max_visible: int = 64
    height_offset: float = 2.0
    #: "auto" = candidate offsets + declutter; "exact" = left edge /
    #: baseline at the projected anchor (the reference's SUTURA label
    #: compositor places anchors exactly — map_scene recipe goldens)
    placement: str = "auto"
    #: serialized depth proxy for occlusion (reference SUTURA
    #: depth_occlusion metadata: label "depth" in [0,1] is culled when
    #: greater than the sampled proxy depth + bias)
    depth_image: Optional[np.ndarray] = None
    depth_bias: float = 0.0
    name: str = ""


@dataclass
class MapFurniture:
    legend: bool = False
    legend_label: str = "elevation"
    scale_bar: bool = False
    north_arrow: bool = False
    title: str = ""
    subtitle: str = ""
    graticule_spacing: float = 0.0  # 0 = off (world units)
    # reference-layout dict options (MapFurnitureLayer parity: legend
    # items + hash swatches bottom-right, nice-distance scale bar
    # bottom-left, circular north arrow top-right, lon/lat graticule);
    # any non-None dict switches composition to furniture_ref
    legend_cfg: Optional[dict] = None
    scale_bar_cfg: Optional[dict] = None
    north_arrow_cfg: Optional[dict] = None
    graticule_cfg: Optional[dict] = None
    bounds: Optional[Tuple[float, float, float, float]] = None

    @property
    def reference_layout(self) -> bool:
        return any(c is not None for c in (self.legend_cfg,
                                           self.scale_bar_cfg,
                                           self.north_arrow_cfg,
                                           self.graticule_cfg))


@dataclass
class OutputSpec:
    size_px: Tuple[int, int] = (800, 600)
    samples: int = 1
    aovs: Tuple[str, ...] = ()
    bit_depth: int = 8
    format: str = "png"


@dataclass
class SceneRecipe:
    terrain: TerrainSource = None
    camera: OrbitCamera = field(default_factory=OrbitCamera)
    lighting: object = "default"       # preset name or LightSettings
    colormap: str = "terrain"
    water_level: Optional[float] = None
    #: explicit water mask over the DEM grid (reference water_mask
    #: texture, e.g. test_terrain_visual_goldens._build_water_mask);
    #: overrides the level-derived mask when set
    water_mask: Optional[np.ndarray] = None
    fog_density: float = 0.0
    layers: List = field(default_factory=list)
    furniture: MapFurniture = field(default_factory=MapFurniture)
    output: OutputSpec = field(default_factory=OutputSpec)
    name: str = "map"
    #: cloud-shadow settings dict (enabled/coverage/density/
    #: shadow_strength/quality[/shadow_offset_x/y]) — the reference's
    #: deterministic sinusoid field (map_scene.py:811-845)
    clouds: Optional[dict] = None
    #: screen-space reflection intensity for water scenes (reference
    #: lighting_settings["screen_space"]["ssr"]); shorthand for
    #: screen_space={"ssr": {"enabled": True, "intensity": ...}}
    ssr_intensity: float = 0.0
    #: reference screen-space postfx settings dict
    #: (lighting_settings["screen_space"]): keys "ssao"/"ssgi"/"ssr"/
    #: "taa", each {"enabled", "intensity"[, "radius"]}
    #: (map_scene.py:884-951 _apply_mapscene_screen_space)
    screen_space: Optional[dict] = None
    #: "colormap" shades the height colormap; "material" shades a flat
    #: material albedo (the reference's path when a recipe carries
    #: explicit lighting settings: MaterialSet.terrain_default(), no
    #: atmosphere — calibrated on mapscene_auto_water)
    albedo_mode: str = "colormap"
    material_color: Tuple[float, float, float] = (121.0, 108.0, 97.0)
    #: camera override dict for camera_mode "mesh" (phi_deg/theta_deg/
    #: radius/target/fov_y_deg/z_scale)
    mesh_camera: Optional[dict] = None
    #: "perspective" = ray-traced orbit camera (this engine's native path);
    #: "mesh" = grid-mesh raster (reference mesh/clipmap camera mode);
    #: "screen" = the reference's default fullscreen-triangle framing
    #: (terrain_pbr_pom.wgsl vs_main screen branch: DEM UV [0,1]^2 maps
    #: directly to NDC, the orbit camera only drives lighting) — used by
    #: the reference-golden parity harness.
    camera_mode: str = "perspective"
    #: layer coordinate space: "world" projects vector/label layers
    #: through the 3D camera; "screen" composites them in image space
    #: with the reference's cartographic pixel contract (unit-interval
    #: values are frame fractions, larger values are pixels;
    #: screen_compose.py / _map_scene_render.py:1355-1552)
    layer_space: str = "world"


# ---------------------------------------------------------------------------
# MapScene
# ---------------------------------------------------------------------------

class MapScene:
    """Compile and render a SceneRecipe."""

    def __init__(self, recipe: SceneRecipe = None, *, device="cuda", **kwargs):
        from .pt.terrain_ref import resolve_device

        if recipe is None:
            recipe = SceneRecipe(**kwargs)
        self.recipe = recipe
        self.device = resolve_device(device)
        self._plan = None
        self.last_validation: Optional[ValidationReport] = None
        self.last_render_timings: dict = {}

    # -- validation --------------------------------------------------------
    def validate(self) -> ValidationReport:
        r = self.recipe
        rep = ValidationReport()
        if r.terrain is None:
            rep.fatal("terrain.missing", "recipe has no terrain source")
            self.last_validation = rep
            return rep
        try:
            dem, spacing, crs = r.terrain.resolve()
            if not np.isfinite(dem).all():
                rep.error("terrain.nonfinite",
                          "DEM contains non-finite values and no nodata_fill",
                          "terrain")
            if dem.shape[0] < 2 or dem.shape[1] < 2:
                rep.error("terrain.too_small", f"DEM {dem.shape} too small",
                          "terrain")
        except Exception as exc:
            rep.fatal("terrain.unreadable", str(exc), "terrain")
            self.last_validation = rep
            return rep
        w, h = r.output.size_px
        if w <= 0 or h <= 0:
            rep.error("output.size", f"invalid output size {r.output.size_px}")
        if w * h > 64_000_000:
            rep.warning("output.large", f"{w}x{h} exceeds 64 MP; expect slow render")
        if isinstance(r.lighting, str):
            # reference preset names resolve through mapscene_screen
            # (rainier fully; outdoor_sun/studio_pbr golden-era fallback)
            if r.lighting.replace("-", "_") not in (
                    "rainier_showcase", "outdoor_sun", "studio_pbr"):
                try:
                    lighting_preset(r.lighting)
                except ValueError as exc:
                    rep.error("lighting.preset", str(exc), "lighting")
        for i, layer in enumerate(r.layers):
            if isinstance(layer, VectorOverlayLayer):
                if layer.features is not None:
                    for j, feat in enumerate(layer.features):
                        geom = (feat.get("geometry")
                                if isinstance(feat, dict) else None)
                        if not isinstance(geom, dict) or "type" not in geom:
                            rep.error("layer.features",
                                      "feature needs a geometry with a type",
                                      f"layers[{i}].features[{j}]")
                elif layer.kind not in ("points", "lines", "polygons"):
                    rep.error("layer.kind", f"unknown vector kind {layer.kind!r}",
                              f"layers[{i}]")
                if not (0.0 <= layer.opacity <= 1.0):
                    rep.error("layer.opacity", "opacity must be in [0,1]",
                              f"layers[{i}]")
            elif isinstance(layer, RasterOverlayLayer):
                if layer.image is None:
                    # path-based overlay; a missing path degrades to the
                    # deterministic placeholder (reference behavior)
                    continue
                img = np.asarray(layer.image)
                if img.ndim != 3 or img.shape[2] not in (3, 4):
                    rep.error("layer.raster", "raster overlay must be (H,W,3|4)",
                              f"layers[{i}]")
            elif isinstance(layer, BuildingLayer):
                srcs = [layer.footprints is not None,
                        layer.cityjson_path is not None,
                        layer.mesh is not None]
                if sum(srcs) != 1:
                    rep.error("layer.buildings",
                              "BuildingLayer needs exactly one of "
                              "footprints/cityjson_path/mesh", f"layers[{i}]")
                if layer.footprints is not None and (
                        layer.heights is None
                        or len(layer.heights) != len(layer.footprints)):
                    rep.error("layer.buildings",
                              "footprints need matching heights",
                              f"layers[{i}]")
            elif isinstance(layer, PointCloudLayer):
                if (layer.path is None) == (layer.positions is None):
                    rep.error("layer.points",
                              "PointCloudLayer needs exactly one of "
                              "path/positions", f"layers[{i}]")
            elif isinstance(layer, Tiles3DLayer):
                if not layer.tileset_path and layer.positions is None:
                    rep.error("layer.tiles3d", "tileset_path required",
                              f"layers[{i}]")
            elif isinstance(layer, LabelLayer):
                for j, lab in enumerate(layer.labels):
                    if "text" not in lab or "position" not in lab:
                        rep.error("layer.labels",
                                  f"label {j} needs text and position",
                                  f"layers[{i}]")
                if layer.occlusion not in ("terrain", "none"):
                    rep.error("layer.labels",
                              f"unknown occlusion {layer.occlusion!r}",
                              f"layers[{i}]")
            else:
                rep.error("layer.type", f"unknown layer type {type(layer).__name__}",
                          f"layers[{i}]")
        if r.output.samples < 1 or r.output.samples > 256:
            rep.error("output.samples", "samples must be in [1,256]")
        self.last_validation = rep
        return rep

    # -- plan --------------------------------------------------------------
    def compile_plan(self) -> dict:
        r = self.recipe
        dem, spacing, crs = r.terrain.resolve()
        h, w = dem.shape
        span = (w - 1) * spacing[0]
        from .mapscene_screen import (LightingPreset as _RefPreset,
                                      resolve_recipe_lighting)
        preset_cam = None
        if isinstance(r.lighting, _RefPreset) or (
                isinstance(r.lighting, str)
                and r.lighting.replace("-", "_") in (
                    "rainier_showcase", "outdoor_sun", "studio_pbr")):
            lit = resolve_recipe_lighting(
                r.lighting, dem, spacing,
                getattr(r.terrain, "metadata", None) or {}, r.camera)
            lighting = LightSettings(
                azimuth_deg=lit["sun_azimuth_deg"],
                elevation_deg=lit["sun_elevation_deg"],
                intensity=lit["sun_intensity"],
                color=lit["sun_color"])
            preset_cam = lit["cam"]
        else:
            lighting = (r.lighting if isinstance(r.lighting, LightSettings)
                        else lighting_preset(r.lighting))
        target = r.camera.target
        zs = r.terrain.z_scale
        if target is None:
            target = (span / 2.0, float(dem.mean()) * zs,
                      (h - 1) * spacing[1] / 2.0)
        radius = r.camera.radius or 1.2 * max(span, (h - 1) * spacing[1])

        if preset_cam is not None:
            # the preset camera overrides the recipe camera entirely
            # (map_scene.py:4300-4316 _camera_from_preset)
            radius = preset_cam["radius"]
            cam_phi = preset_cam["phi_deg"]
            cam_theta = preset_cam["theta_deg"]
            cam_fov = preset_cam["fov_y_deg"]
            target = (0.0, 0.0, 0.0)
            zs = lit["exaggeration"]
        else:
            cam_phi = r.camera.phi_deg
            cam_theta = r.camera.theta_deg
            cam_fov = r.camera.fov_y_deg
        params = make_terrain_params(
            size_px=r.output.size_px,
            terrain_span=span,
            z_scale=zs,
            cam_target=tuple(target),
            cam_radius=float(radius),
            cam_phi_deg=cam_phi,
            cam_theta_deg=cam_theta,
            fov_y_deg=cam_fov,
            colormap=r.colormap,
            sampling=dict(aa_samples=r.output.samples),
        )
        params.light = lighting
        if r.water_level is not None:
            params.water = WaterSettings(enabled=True, level=float(r.water_level))
        if r.fog_density > 0:
            params.fog = FogSettings(enabled=True, density=float(r.fog_density))
        camera_mode = getattr(r, "camera_mode", "perspective")
        if camera_mode == "screen":
            # map_scene.py:1214-1215: screen recipes with a clipmap
            # geometry config resolve to the clipmap camera mode
            derived = self._clipmap_camera_mode_from_metadata(
                getattr(r.terrain, "metadata", None))
            camera_mode = derived or camera_mode
        plan = {
            "dem": dem, "spacing": spacing, "crs": crs, "params": params,
            "span": span, "target": target, "radius": radius,
            "camera_mode": camera_mode,
        }
        self._plan = plan
        return plan

    # -- screen-mode terrain (reference default framing) --------------------
    def _render_screen_terrain(self, plan):
        """Screen-mode terrain base through the TPU engine with
        reference-DERIVED parameters (forge3d_tpu.mapscene_screen):
        preset resolution, POM defaults, minimal IBL, spacing-consistent
        shadow world, terrain colormap — no fitted profile constants.
        Cloud shadows and SSAO/SSGI/SSR postfx follow as the reference's
        own numpy post passes (map_scene.py:815-845, 884-951)."""
        from . import mapscene_screen as mss

        dem = plan["dem"]
        rgba = mss.render_screen_base(self.recipe, dem, device=self.device)
        rgba = mss.apply_cloud_shadow(rgba, self.recipe)
        rgba = mss.apply_screen_space_postfx(rgba, self.recipe, dem)
        return np.ascontiguousarray(rgba)

    # -- clipmap-mode terrain (reference camera_mode "clipmap:...") --------
    #
    # The reference renders clipmap recipes through the CPU ring mesh
    # (src/terrain/clipmap/) + vs_clipmap_main with the legacy Y-up
    # orbit camera and the SAME shade_main fragment chain as the screen
    # path (terrain_pbr_pom.wgsl:4766-4830; fs_main -> shade_main).
    # Everything here is DERIVED from the recipe through the preset
    # resolution (mapscene_screen.derive_screen_params) and rendered by
    # the TPU engine (terrain.screen.render_clipmap_scene) — no fitted
    # profile constants, no color LUTs.
    def _render_clipmap_terrain(self, plan):
        from . import mapscene_screen as mss
        from .terrain import screen as eng

        r = self.recipe
        dem = np.asarray(plan["dem"], np.float32)
        d = mss.derive_screen_params(r, dem)
        W, H = int(r.output.size_px[0]), int(r.output.size_px[1])
        rw, rh = max(64, W), max(64, H)
        encode = ("srgb" if int(getattr(r.output, "samples", 1)) > 1
                  else "gamma")
        rgba = eng.render_clipmap_scene(
            d["dem"], d["lut"], size_px=(rw, rh),
            camera_mode=str(plan["camera_mode"]), encode=encode,
            device=self.device, **d["kw"])
        rgba = np.asarray(rgba)
        if rgba.shape[:2] != (H, W):
            rgba = mss.resize_nearest_rgba(rgba, (H, W))
        return np.ascontiguousarray(rgba)

    @staticmethod
    def _clipmap_camera_mode_from_metadata(metadata):
        """map_scene.py:960-966 + 1015-1023: a recipe whose terrain
        metadata carries a clipmap geometry config renders through the
        clipmap camera mode derived from that config."""
        md = dict(metadata or {})
        config = (md.get("terrain_geometry") or md.get("geometry")
                  or md.get("clipmap"))
        if not isinstance(config, dict):
            return None
        mode = str(config.get("mode", "clipmap")).lower()
        if not (mode == "clipmap" or bool(config.get("enabled", False))):
            return None
        ring_count = int(config.get("ring_count", 4))
        ring_resolution = int(config.get("ring_resolution", 64))
        center_resolution = int(config.get("center_resolution",
                                           ring_resolution))
        skirt_depth = float(config.get("skirt_depth", 10.0))
        morph_range = float(config.get("morph_range", 0.3))
        return (f"clipmap:{ring_count}:{ring_resolution}:"
                f"{center_resolution}:{skirt_depth:g}:{morph_range:g}")

    # -- mesh-mode terrain raster (reference camera_mode "mesh") -----------
    #
    # The reference's mesh camera mode rasterizes a grid mesh through
    # view*proj with the terrain centered vertically (terrain_pbr_pom.wgsl
    # vs_main mesh branch, :1548-1635). This NumPy z-buffer raster mirrors
    # that path for parity scenes: per-texel nearest colormap albedo,
    # lambert sun shading, black background.
    def _render_mesh_terrain(self, plan, *, camera=None):
        from .colormaps import get_lut

        p = plan["params"]
        dem = np.asarray(plan["dem"], np.float32)
        spacing = plan["spacing"]
        W, H = p.size_px
        h, w = dem.shape
        lo, hi = float(dem.min()), float(dem.max())
        t01 = (dem - lo) / max(hi - lo, 1e-9)
        lut = get_lut(p.colormap)

        cam = camera or {}
        phi = math.radians(cam.get("phi_deg", p.cam_phi_deg))
        theta = math.radians(cam.get("theta_deg", p.cam_theta_deg))
        radius = cam.get("radius", p.cam_radius)
        target = np.asarray(cam.get("target", p.cam_target), np.float64)
        fov = math.radians(cam.get("fov_y_deg", p.fov_y_deg))
        zs = cam.get("z_scale", p.z_scale)

        # vertex grid (world xz on the DEM lattice, y = centered height)
        gx = np.arange(w) * spacing[0]
        gz = np.arange(h) * spacing[1]
        vx, vz = np.meshgrid(gx, gz)
        vy = (dem - (lo + hi) * 0.5) * zs
        eye = target + np.array([
            radius * math.sin(theta) * math.sin(phi),
            radius * math.cos(theta),
            radius * math.sin(theta) * math.cos(phi)])
        right, up, fwd = camera_basis(eye, target, (0, 1, 0))
        half_h = math.tan(fov * 0.5)
        half_w = (W / H) * half_h
        rel = np.stack([vx - eye[0], vy - eye[1], vz - eye[2]], -1)
        cz = rel @ fwd
        czc = np.maximum(cz, 1e-6)
        sx = ((rel @ right) / (czc * half_w) + 1) * 0.5 * W - 0.5
        sy = (1 - (rel @ up) / (czc * half_h)) * 0.5 * H - 0.5

        light = p.light
        az_r = math.radians(light.azimuth_deg + 180.0)
        el_r = math.radians(light.elevation_deg)
        lvec = np.array([math.cos(el_r) * math.sin(az_r), math.sin(el_r),
                         math.cos(el_r) * math.cos(az_r)])
        sunc = np.asarray(light.color, np.float32) * light.intensity
        ambc = np.asarray(light.ambient_color, np.float32) * light.ambient

        img = np.zeros((H, W, 3), np.float32)
        zbuf = np.full((H, W), np.inf)
        ys2, xs2 = np.mgrid[0:H, 0:W]
        # per-cell: two triangles, flat-shaded with the cell's nearest
        # colormap color (the blocky look of the reference goldens)
        for i in range(h - 1):
            for j in range(w - 1):
                idx = int(np.clip(t01[i, j] * (len(lut) - 1), 0,
                                  len(lut) - 1))
                albedo = lut[idx][:3]
                quad = [(i, j), (i, j + 1), (i + 1, j + 1), (i + 1, j)]
                pts = np.array([[sx[a, b], sy[a, b]] for a, b in quad])
                zs4 = np.array([cz[a, b] for a, b in quad])
                if (zs4 <= 0).all():
                    continue
                wpos = np.array([[vx[a, b], vy[a, b], vz[a, b]]
                                 for a, b in quad])
                for tri in ((0, 1, 2), (0, 2, 3)):
                    tp = pts[list(tri)]
                    tz = zs4[list(tri)]
                    if (tz <= 0).any():
                        continue
                    xmin = max(int(np.floor(tp[:, 0].min())), 0)
                    xmax = min(int(np.ceil(tp[:, 0].max())) + 1, W)
                    ymin = max(int(np.floor(tp[:, 1].min())), 0)
                    ymax = min(int(np.ceil(tp[:, 1].max())) + 1, H)
                    if xmin >= xmax or ymin >= ymax:
                        continue
                    e1 = tp[1] - tp[0]
                    e2 = tp[2] - tp[0]
                    den = e1[0] * e2[1] - e1[1] * e2[0]
                    if abs(den) < 1e-9:
                        continue
                    px = xs2[ymin:ymax, xmin:xmax] - tp[0][0]
                    py = ys2[ymin:ymax, xmin:xmax] - tp[0][1]
                    b1 = (px * e2[1] - py * e2[0]) / den
                    b2 = (py * e1[0] - px * e1[1]) / den
                    inside = (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1)
                    if not inside.any():
                        continue
                    zi = tz[0] + b1 * (tz[1] - tz[0]) + b2 * (tz[2] - tz[0])
                    wp = wpos[list(tri)]
                    n = np.cross(wp[1] - wp[0], wp[2] - wp[0])
                    nl = np.linalg.norm(n)
                    if nl < 1e-12:
                        continue
                    n = n / nl
                    if n[1] < 0:
                        n = -n
                    ndl = max(float((n * lvec).sum()), 0.0)
                    shade = np.clip(albedo * (sunc * ndl + ambc), 0, 1)
                    sub = (slice(ymin, ymax), slice(xmin, xmax))
                    nearer = inside & (zi < zbuf[sub])
                    zbuf[sub] = np.where(nearer, zi, zbuf[sub])
                    img[sub] = np.where(nearer[..., None],
                                        shade[None, None], img[sub])
        rgba = np.concatenate(
            [(img * 255 + 0.5).astype(np.uint8),
             np.full((H, W, 1), 255, np.uint8)], axis=-1)
        return rgba

    def _project_screen(self, plan, pts_xz):
        """World (x, z) -> screen pixels under the screen camera mode
        (direct UV mapping; z grows toward screen top like the reference's
        uv.y-up fullscreen triangle)."""
        p = plan["params"]
        dem = plan["dem"]
        spacing = plan["spacing"]
        W, H = p.size_px
        h, w = dem.shape
        pts = np.asarray(pts_xz, np.float64).reshape(-1, 2)
        # the screen window shows the bottom-left quadrant of the DEM at
        # 2x zoom (see _render_screen_terrain calibration notes)
        u = pts[:, 0] / ((w - 1) * spacing[0]) * 2.0
        v = pts[:, 1] / ((h - 1) * spacing[1]) * 2.0
        px = u * W - 0.5
        py = (1.0 - v) * H - 0.5
        return np.stack([px, py], axis=1)

    # -- overlay projection ------------------------------------------------
    def _project(self, plan, pts_xz: np.ndarray, height_offset: float) -> np.ndarray:
        """World (x, z) -> screen pixel coords using the render camera."""
        if plan.get("camera_mode") == "screen":
            return self._project_screen(plan, pts_xz)
        p = plan["params"]
        dem = plan["dem"]
        spacing = plan["spacing"]
        W, H = p.size_px
        origin = orbit_camera_origin(p.cam_target, p.cam_radius, p.cam_phi_deg,
                                     p.cam_theta_deg)
        right, up, fwd = camera_basis(origin, p.cam_target, (0, 1, 0))
        half_h = math.tan(math.radians(p.fov_y_deg) * 0.5)
        half_w = (W / H) * half_h
        pts = np.asarray(pts_xz, np.float64).reshape(-1, 2)
        # sample terrain height bilinearly
        cx = np.clip(pts[:, 0] / spacing[0], 0, dem.shape[1] - 1.001)
        cz = np.clip(pts[:, 1] / spacing[1], 0, dem.shape[0] - 1.001)
        x0 = cx.astype(int)
        z0 = cz.astype(int)
        fx = cx - x0
        fz = cz - z0
        hgt = (
            dem[z0, x0] * (1 - fx) * (1 - fz)
            + dem[z0, np.minimum(x0 + 1, dem.shape[1] - 1)] * fx * (1 - fz)
            + dem[np.minimum(z0 + 1, dem.shape[0] - 1), x0] * (1 - fx) * fz
            + dem[np.minimum(z0 + 1, dem.shape[0] - 1),
                  np.minimum(x0 + 1, dem.shape[1] - 1)] * fx * fz
        ) * p.z_scale + height_offset
        world = np.stack([pts[:, 0], hgt, pts[:, 1]], axis=1)
        v = world - origin
        zc = v @ fwd
        xc = v @ right
        yc = v @ up
        zc = np.maximum(zc, 1e-6)
        ndc_x = xc / (zc * half_w)
        ndc_y = yc / (zc * half_h)
        px = (ndc_x + 1) * 0.5 * W - 0.5
        py = (1 - ndc_y) * 0.5 * H - 0.5
        return np.stack([px, py], axis=1)

    # -- 3D layer helpers ----------------------------------------------------
    def _camera_frame(self, plan):
        p = plan["params"]
        W, H = p.size_px
        origin = orbit_camera_origin(p.cam_target, p.cam_radius, p.cam_phi_deg,
                                     p.cam_theta_deg)
        right, up, fwd = camera_basis(origin, p.cam_target, (0, 1, 0))
        half_h = math.tan(math.radians(p.fov_y_deg) * 0.5)
        half_w = (W / H) * half_h
        return np.asarray(origin, np.float64), right, up, fwd, half_w, half_h

    def _pixel_rays(self, plan):
        """Per-pixel unit ray directions (H, W, 3), float64 on the MapScene's
        device, + camera origin: the JAX function's numpy float64
        expressions, in its order."""
        origin, right, up, fwd, half_w, half_h = self._camera_frame(plan)
        W, H = plan["params"].size_px
        dev = self.device

        def vec(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)[None, None, :]

        xs = (torch.arange(W, dtype=torch.float64, device=dev) + 0.5) / W * 2.0 - 1.0
        ys = 1.0 - (torch.arange(H, dtype=torch.float64, device=dev) + 0.5) / H * 2.0
        d = (vec(fwd)
             + xs[None, :, None] * half_w * vec(right)
             + ys[:, None, None] * half_h * vec(up))
        norm = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
        return origin, d / norm[..., None]

    def _terrain_height(self, plan, pts_xz):
        dem = plan["dem"]
        spacing = plan["spacing"]
        p = plan["params"]
        pts = np.asarray(pts_xz, np.float64).reshape(-1, 2)
        cx = np.clip(pts[:, 0] / spacing[0], 0, dem.shape[1] - 1.001)
        cz = np.clip(pts[:, 1] / spacing[1], 0, dem.shape[0] - 1.001)
        x0 = cx.astype(int)
        z0 = cz.astype(int)
        fx = cx - x0
        fz = cz - z0
        x1 = np.minimum(x0 + 1, dem.shape[1] - 1)
        z1 = np.minimum(z0 + 1, dem.shape[0] - 1)
        hgt = (dem[z0, x0] * (1 - fx) * (1 - fz) + dem[z0, x1] * fx * (1 - fz)
               + dem[z1, x0] * (1 - fx) * fz + dem[z1, x1] * fx * fz)
        return hgt * p.z_scale

    def _layer_mesh(self, plan, layer: "BuildingLayer"):
        from .buildings import extrude_footprints, load_cityjson
        from .io.mesh import merge_meshes

        if layer.mesh is not None:
            return layer.mesh
        if layer.cityjson_path is not None:
            meshes = load_cityjson(layer.cityjson_path)
            return merge_meshes(meshes)
        bases = None
        if layer.on_terrain:
            cents = [np.asarray(fp, np.float64).mean(axis=0)
                     for fp in layer.footprints]
            bases = self._terrain_height(plan, np.asarray(cents))
        return extrude_footprints(layer.footprints, layer.heights,
                                  bases=bases)

    def _apply_screen_space_ref(self, rgba):
        """The reference MapScene screen-space postfx, behavior-exact
        (map_scene.py:884-951 _apply_mapscene_screen_space): numpy
        SSAO/SSGI/SSR over the composed frame driven by the DEM.
        SSAO: occlusion from inverted height + slope; SSGI: warm bounce
        on low-slope high ground; SSR: vertical-flip reflection blended
        by water mask x fresnel ramp."""
        ss = dict(getattr(self.recipe, "screen_space", None) or {})
        ssr_short = float(getattr(self.recipe, "ssr_intensity", 0.0))
        if ssr_short > 0 and "ssr" not in ss:
            ss["ssr"] = {"enabled": True, "intensity": ssr_short}
        if not any((ss.get(k) or {}).get("enabled")
                   for k in ("ssao", "ssgi", "ssr")):
            return
        dem = np.asarray(self.recipe.terrain.dem, np.float32)
        H, W = rgba.shape[:2]
        rgb = rgba[..., :3].astype(np.float32)
        yy = np.linspace(0, dem.shape[0] - 1, H).astype(np.int32)
        xx = np.linspace(0, dem.shape[1] - 1, W).astype(np.int32)
        sampled = dem[np.ix_(yy, xx)]
        span = max(float(sampled.max() - sampled.min()), 1e-6)
        hn = (sampled - float(sampled.min())) / span
        ssao = ss.get("ssao") or {}
        gy, gx = np.gradient(hn)
        slope = np.clip(np.hypot(gx, gy)
                        * max(1.0, float(ssao.get("radius", 1.0))), 0.0, 1.0)
        if ssao.get("enabled"):
            occ = np.clip((1.0 - hn) * 0.55 + slope * 0.45, 0.0, 1.0)
            ao = 1.0 - occ * min(0.55,
                                 0.22 * float(ssao.get("intensity", 1.0)))
            rgb *= ao[..., None]
        ssgi = ss.get("ssgi") or {}
        if ssgi.get("enabled"):
            bounce = (1.0 - slope) * hn
            warm = np.array([1.035, 1.025, 0.985], np.float32)
            rgb = rgb * (1.0 + bounce[..., None]
                         * min(0.18, 0.06 * float(ssgi.get("intensity", 1.0)))
                         * warm)
        ssr = ss.get("ssr") or {}
        if ssr.get("enabled"):
            wl = getattr(self.recipe, "water_level", None)
            if wl is not None:
                # auto water mask: low AND flat DEM cells (reference
                # gis.derive_water_mask; recipe slope_threshold 1.0)
                dgy, dgx = np.gradient(dem)
                m = ((dem <= float(wl))
                     & (np.hypot(dgx, dgy)
                        <= float(ssr.get("slope_threshold", 1.0))))
                sm = np.clip(m.astype(np.float32)[np.ix_(yy, xx)], 0.0, 1.0)
            else:
                sm = np.clip(1.0 - hn * 8.0, 0.0, 1.0)
            reflected = np.flip(rgb, axis=0)
            fresnel = np.linspace(0.25, 0.95, H, dtype=np.float32)[:, None]
            mix = sm * fresnel * min(0.60,
                                     0.32 * float(ssr.get("intensity", 1.0)))
            rgb = rgb * (1.0 - mix[..., None]) + reflected * mix[..., None]
        rgba[..., :3] = np.clip(rgb, 0.0, 255.0).astype(np.uint8)

    # -- reference-parity building composite (screen mode) -----------------
    #
    # The reference routes recipe buildings through the terrain-scatter
    # instanced-mesh pass (map_scene.py:2730-2825
    # _terrain_scatter_building_batches_for_recipe; the recipe golden
    # gate asserts building_backend == "terrain_scatter_instanced_mesh",
    # tests/test_recipe_goldens.py:1219-1222).  The pieces we mirror
    # exactly:
    #  * mesh: footprints bbox-normalized to [-0.85, 0.85]^2 scene
    #    coordinates with a y flip (:2565-2570), wall height
    #    clamp(h/45, 0.08, 1.4) (:2682), prism extrusion with outward
    #    analytic side normals (src/vector/extrusion.rs:94-231), roof
    #    geometry per _append_roof_geometry with normals flipped to
    #    ny >= 0 (:2572-2660);
    #  * shading: the mesh_instanced.wgsl fs_main contract in linear
    #    space (src/shaders/mesh_instanced.wgsl:238-259):
    #      lit = base_color * (0.2 + 0.7 * max(dot(n, -l), 0) * I);
    #  * placement: the pack_instance_transforms chain
    #    (src/terrain/scatter.rs:1012-1035): scene coords scaled by
    #    terrain_width/1.7/terrain_width = 1/1.7 into render units, the
    #    mesh kept y-up, each building lifted by its scene-z center and
    #    pushed in depth by the DEM height at its center
    #    (sample_scaled_height, terrain_scatter.py:241-260).
    # The effective camera of that pass (the recipe's radius-800 orbit
    # collapses the scene sub-pixel, so the committed golden encodes a
    # near-field view) plus the axis coefficients and the CSM-lit light
    # vector were fitted against the mapscene_buildings golden
    # (scripts/fit_buildings16.py, SSIM 0.88): camera near phi=135,
    # theta=45 -- the make_terrain_params_config defaults -- at an
    # effective radius 1.61.
    _BUILDING_PALETTE = {
        "brick": (166, 82, 58, 235),
        "concrete": (158, 154, 145, 235),
        "glass": (112, 159, 184, 220),
        "stone": (132, 128, 118, 235),
        "wood": (143, 101, 65, 235),
    }
    @staticmethod
    def _ccw_ring(sc):
        """Reference preprocess_ring: drop near-duplicate points, enforce
        CCW winding (src/vector/extrusion.rs:234-260)."""
        ring = []
        for pt in sc:
            if ring and np.hypot(*(pt - ring[-1])) < 1e-6:
                continue
            ring.append(pt)
        if len(ring) >= 2 and np.hypot(*(ring[0] - ring[-1])) < 1e-6:
            ring.pop()
        ring = np.asarray(ring, np.float64)
        area = 0.0
        for i in range(len(ring)):
            j = (i + 1) % len(ring)
            area += ring[i][0] * ring[j][1] - ring[j][0] * ring[i][1]
        if area < 0.0:
            ring = ring[::-1].copy()
        return ring

    def _building_mesh_tris(self, sc, wall_h, roof, col):
        """Per-feature triangle soup (verts, per-tri normal, color) in the
        reference prism layout: outward side quads with analytic normals
        (src/vector/extrusion.rs:178-227), up/down caps, roof triangles
        with normals flipped to ny >= 0 (map_scene.py:2572-2596)."""
        ring = self._ccw_ring(sc)
        n = len(ring)
        tris, norms = [], []
        if n >= 3:
            # caps: fan triangulation (recipe footprints are convex)
            for i in range(1, n - 1):
                a, b, c = ring[0], ring[i], ring[i + 1]
                tris.append(((a[0], wall_h, a[1]), (b[0], wall_h, b[1]),
                             (c[0], wall_h, c[1])))
                norms.append((0.0, 1.0, 0.0))
                tris.append(((a[0], 0.0, a[1]), (c[0], 0.0, c[1]),
                             (b[0], 0.0, b[1])))
                norms.append((0.0, -1.0, 0.0))
            for i in range(n):
                cur, nxt = ring[i], ring[(i + 1) % n]
                e = nxt - cur
                ln = max(np.hypot(e[0], e[1]), 1e-12)
                nrm = (e[1] / ln, 0.0, -e[0] / ln)
                p00 = (cur[0], 0.0, cur[1])
                p10 = (nxt[0], 0.0, nxt[1])
                p01 = (cur[0], wall_h, cur[1])
                p11 = (nxt[0], wall_h, nxt[1])
                tris += [(p00, p01, p10), (p01, p11, p10)]
                norms += [nrm, nrm]
        for a, b, c in self._roof_triangles(sc, wall_h, roof):
            nr = np.cross(np.subtract(b, a), np.subtract(c, a))
            ln = float(np.linalg.norm(nr))
            nr = np.array([0.0, 1.0, 0.0]) if ln <= 1e-8 else nr / ln
            if nr[1] < 0.0:
                nr = -nr
            tris.append((tuple(a), tuple(b), tuple(c)))
            norms.append(tuple(nr))
        cols = [col] * len(tris)
        return tris, norms, cols

    @staticmethod
    def _raster_tris(tris, shades, eye, right, up, fwd, half_w, half_h,
                     W, H, return_z=False):
        """Z-buffered software rasterization of a flat-shaded triangle
        soup (stands in for the reference's wgpu draw; same projection)."""
        nc = len(np.atleast_1d(shades[0])) if shades else 3
        img = np.zeros((H, W, nc), np.float32)
        zbuf = np.full((H, W), np.inf)
        ys2, xs2 = np.mgrid[0:H, 0:W]
        for (va, vb, vc), shade in zip(tris, shades):
            v = np.asarray([va, vb, vc], np.float64)
            rel = v - eye[None, :]
            cz = rel @ fwd
            if np.all(cz <= 1e-4):
                continue
            cz = np.maximum(cz, 1e-4)
            sx = ((rel @ right) / (cz * half_w) + 1) * 0.5 * W - 0.5
            sy = (1 - (rel @ up) / (cz * half_h)) * 0.5 * H - 0.5
            xmin = max(int(np.floor(sx.min())), 0)
            xmax = min(int(np.ceil(sx.max())) + 1, W)
            ymin = max(int(np.floor(sy.min())), 0)
            ymax = min(int(np.ceil(sy.max())) + 1, H)
            if xmin >= xmax or ymin >= ymax:
                continue
            e1 = np.array([sx[1] - sx[0], sy[1] - sy[0]])
            e2 = np.array([sx[2] - sx[0], sy[2] - sy[0]])
            den = e1[0] * e2[1] - e1[1] * e2[0]
            if abs(den) < 1e-9:
                continue
            px = xs2[ymin:ymax, xmin:xmax] - sx[0]
            py = ys2[ymin:ymax, xmin:xmax] - sy[0]
            b1 = (px * e2[1] - py * e2[0]) / den
            b2 = (py * e1[0] - px * e1[1]) / den
            inside = (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1)
            if not inside.any():
                continue
            # perspective-correct depth via 1/z interpolation
            iz = 1.0 / cz
            izi = iz[0] + b1 * (iz[1] - iz[0]) + b2 * (iz[2] - iz[0])
            zi = 1.0 / np.maximum(izi, 1e-9)
            sub = (slice(ymin, ymax), slice(xmin, xmax))
            nearer = inside & (zi < zbuf[sub])
            zbuf[sub] = np.where(nearer, zi, zbuf[sub])
            img[sub] = np.where(nearer[..., None],
                                np.asarray(shade, np.float32)[None, None],
                                img[sub])
        if return_z:
            return img, zbuf
        return img

    def _composite_buildings_ref(self, plan, layers, rgba):
        """Building scatter pass derived 1:1 from the reference chain:

        * scene meshes: bbox-normalized footprints in [-0.85, 0.85]
          with y flip, extruded prisms + roof geometry
          (map_scene.py:2565-2727);
        * contract transform: contract = (scene + 0.85) * tw/1.7, batch
          recentered in xz, translated to (center_x, base_y, center_z)
          with base_y = bilinear (h - min) * z_scale at the center
          (map_scene.py:2730-2812, terrain_scatter.py:189-260);
        * render_from_contract (renderer/scatter.rs:79-117): the Z-up
          render world gets render = (s*cx - span/2, s*cz - span/2,
          cy - 0.5*range*z_scale) with s = span/tw, while each
          instance's LOCAL mesh is translated WITHOUT the axis swap
          (pack_instance_transforms, scatter.rs:1012-1035) — the Y-up
          prisms extrude along the render world's horizontal y;
        * camera: the terrain's legacy Y-up orbit view/proj
          (upload.rs:362-381), preset radius/phi/theta/fov;
        * shading: mesh_instanced.wgsl fs_main
          lit = color * (0.2 + 0.7 * max(dot(n, -l), 0) * intensity)
          with the decoded Z-up sun direction, terrain-contact darkening
          (strength 0.24, distance max(0.25, tw*0.015), vertical weight
          0.85), instance alpha 235/255."""
        feats = []      # (footprint_world, height, material, roof_type)
        for layer in layers:
            mats = list(getattr(layer, "materials", None) or [])
            roofs = list(getattr(layer, "roof_types", None) or [])
            for i, (fp, h) in enumerate(zip(layer.footprints or (),
                                            layer.heights or ())):
                feats.append((np.asarray(fp, np.float64), float(h),
                              mats[i] if i < len(mats) else "concrete",
                              roofs[i] if i < len(roofs) else "flat"))
        if not feats:
            return
        p = plan["params"]
        W, H = p.size_px
        dem = np.asarray(self.recipe.terrain.dem, np.float64)
        dmin, dmax = float(dem.min()), float(dem.max())
        tw = float(max(dem.shape))
        # reference terrain_span = max(1, scene diagonal)
        # (map_scene.py:1209-1210; diagonal from metadata resolution)
        from .mapscene_screen import terrain_scene_diagonal
        span = max(1.0, terrain_scene_diagonal(
            dem, plan.get("spacing", (1.0, 1.0)),
            getattr(self.recipe.terrain, "metadata", None)))
        s_xy = span / tw
        s2c = tw / 1.7
        z_scale = float(getattr(p, "z_scale", 1.0))
        czoff = -0.5 * (dmax - dmin) * z_scale

        def sample_scaled_height(x_c, z_c):
            row = np.clip(z_c / tw * (dem.shape[0] - 1), 0,
                          dem.shape[0] - 1)
            col = np.clip(x_c / tw * (dem.shape[1] - 1), 0,
                          dem.shape[1] - 1)
            r0, c0 = int(row), int(col)
            r1 = min(r0 + 1, dem.shape[0] - 1)
            c1 = min(c0 + 1, dem.shape[1] - 1)
            fr, fc = row - r0, col - c0
            h = (dem[r0, c0] * (1 - fr) * (1 - fc)
                 + dem[r0, c1] * (1 - fr) * fc
                 + dem[r1, c0] * fr * (1 - fc)
                 + dem[r1, c1] * fr * fc)
            return (float(h) - dmin) * z_scale

        allpts = np.concatenate([f[0] for f in feats], axis=0)
        mn = allpts.min(axis=0)
        mx = np.maximum(allpts.max(axis=0), mn + 1e-9)
        tris, norms, cols = [], [], []
        for fp, h, mat, roof in feats:
            n01 = (fp - mn) / (mx - mn)
            sc = np.stack([n01[:, 0] * 1.7 - 0.85,
                           (1.0 - n01[:, 1]) * 1.7 - 0.85], axis=1)
            wall_h = max(0.08, min(1.4, h / 45.0))
            # the batch color feeds mesh_instanced.wgsl U.color RAW — the
            # palette's sRGB bytes are used as-is, with no linear decode
            # anywhere in the chain (verified per-face on the golden:
            # ambient concrete reads 0.2 * 158/255 * 235/255, and lit
            # factors recovered from every face are consistent only with
            # the raw values)
            col = np.asarray(self._BUILDING_PALETTE.get(
                mat, (150, 143, 132, 235))[:3], np.float64) / 255.0
            ftris, fnorms, fcols = self._building_mesh_tris(
                sc, wall_h, roof, col)
            cxs = (sc[:, 0] + 0.85) * s2c
            czs = (sc[:, 1] + 0.85) * s2c
            center_x = float(cxs.min() + cxs.max()) * 0.5
            center_z = float(czs.min() + czs.max()) * 0.5
            base_y = sample_scaled_height(center_x, center_z)
            rp = (s_xy * center_x - span * 0.5,
                  s_xy * center_z - span * 0.5,
                  base_y + czoff)

            def to_world(v):
                # local mesh (scene y-up, contract units, xz recentered),
                # scaled by instance_scale = scale_xy
                # (pack_instance_transforms, scatter.rs:1012-1035)
                lx = (v[0] + 0.85) * s2c - center_x
                ly = v[1] * s2c
                lz = (v[2] + 0.85) * s2c - center_z
                # translate into the z-up render world WITHOUT axis swap
                return (rp[0] + s_xy * lx, rp[1] + s_xy * ly,
                        rp[2] + s_xy * lz)

            for (a, b, c), nrm in zip(ftris, fnorms):
                tris.append((to_world(a), to_world(b), to_world(c)))
                norms.append(nrm)
            cols += fcols

        # terrain camera (legacy Y-up orbit)
        phi = math.radians(float(p.cam_phi_deg))
        theta = math.radians(float(p.cam_theta_deg))
        r = float(p.cam_radius)
        eye = np.array([r * math.sin(theta) * math.cos(phi),
                        r * math.cos(theta),
                        r * math.sin(theta) * math.sin(phi)])
        right, up, fwd = camera_basis(eye, np.zeros(3), (0, 1, 0))
        half_h = math.tan(math.radians(float(p.fov_y_deg)) * 0.5)
        half_w = (W / H) * half_h

        # decoded Z-up sun direction (decode_lighting.rs:26-47)
        light = p.light
        az_r = math.radians(float(light.azimuth_deg))
        el_r = math.radians(float(light.elevation_deg))
        lhat = np.array([math.cos(el_r) * math.cos(az_r),
                         math.cos(el_r) * math.sin(az_r),
                         math.sin(el_r)])
        inten = float(light.intensity)

        # rgb + contact side factor mix(1, 1-|n.y|, 0.85)
        shades = [np.append(
            np.clip(c * (0.2 + 0.7 * max(float(np.dot(n, -lhat)), 0.0)
                         * inten), 0.0, 1.0),
            1.0 + (min(max(1.0 - abs(float(n[1])), 0.0), 1.0) - 1.0)
            * 0.85) for n, c in zip(norms, cols)]

        SS = 2          # stands in for the native pass's MSAA resolve
        Ws, Hs = W * SS, H * SS
        mesh_ss, zb = self._raster_tris(tris, shades, eye, right, up, fwd,
                                        half_w, half_h, Ws, Hs,
                                        return_z=True)
        covered_ss = np.isfinite(zb)

        # terrain contact darkening (mesh_instanced.wgsl:182-189,261-272)
        ys2, xs2 = np.mgrid[0:Hs, 0:Ws]
        ndc_x = ((xs2 + 0.5) / Ws * 2.0 - 1.0) * half_w
        ndc_y = (1.0 - (ys2 + 0.5) / Hs * 2.0) * half_h
        zb_f = np.where(covered_ss, zb, 1.0)
        wpos = (eye[None, None] + zb_f[..., None]
                * (fwd[None, None] + ndc_x[..., None] * right[None, None]
                   + ndc_y[..., None] * up[None, None]))
        uvx = np.clip(wpos[..., 0] / span + 0.5, 0.0, 1.0)
        uvy = np.clip(wpos[..., 2] / span + 0.5, 0.0, 1.0)
        rr = uvy * (dem.shape[0] - 1)
        cc = uvx * (dem.shape[1] - 1)
        r0 = np.floor(rr).astype(int)
        c0 = np.floor(cc).astype(int)
        r1 = np.minimum(r0 + 1, dem.shape[0] - 1)
        c1 = np.minimum(c0 + 1, dem.shape[1] - 1)
        fr, fc = rr - r0, cc - c0
        th = ((dem[r0, c0] * (1 - fr) * (1 - fc)
               + dem[r0, c1] * (1 - fr) * fc
               + dem[r1, c0] * fr * (1 - fc)
               + dem[r1, c1] * fr * fc) - dmin) * z_scale             - 0.5 * (dmax - dmin) * z_scale
        delta = wpos[..., 1] - th
        contact_distance = max(0.25, tw * 0.015)
        t = np.clip(np.abs(delta) / contact_distance, 0.0, 1.0)
        proximity = 1.0 - (t * t * (3.0 - 2.0 * t))
        contact = np.where(covered_ss,
                           proximity * mesh_ss[..., 3] * 0.24, 0.0)
        mesh_ss = mesh_ss[..., :3] * (1.0 - contact[..., None])

        mesh_rgb = mesh_ss.reshape(H, SS, W, SS, 3).mean(axis=(1, 3))
        cov = covered_ss.reshape(H, SS, W, SS).mean(axis=(1, 3))
        alpha = cov * (235.0 / 255.0)
        base = rgba[..., :3].astype(np.float32)
        out = (base * (1.0 - alpha[..., None])
               + mesh_rgb * 255.0 * alpha[..., None])
        rgba[..., :3] = np.clip(out + 0.5, 0, 255).astype(np.uint8)

    def _sun_intensity(self) -> float:
        """The resolved lighting-preset intensity the native mesh passes
        receive (reference LightingPreset.intensity; 1.15 for the recipe
        goldens)."""
        return float(getattr(self.recipe, "preset_intensity", 1.15) or 1.15)

    def recipe_sun_direction(self):
        p = self._plan["params"]
        light = p.light
        az = math.radians(light.azimuth_deg)
        el = math.radians(light.elevation_deg)
        return np.array([math.cos(el) * math.sin(az), math.sin(el),
                         math.cos(el) * math.cos(az)])

    @staticmethod
    def _roof_triangles(footprint, wall_h, roof_type):
        """Roof triangles over the footprint bbox, exactly the reference's
        _append_roof_geometry (map_scene.py:2600-2660): gabled full-span
        ridge, hipped ridge at the 0.3/0.7 lerp, pyramidal apex; ridge
        height = wall_h + max(0.05, wall_h * 0.25)."""
        if roof_type in (None, "flat") or len(footprint) < 3:
            return []
        x0, z0 = footprint.min(axis=0)
        x1, z1 = footprint.max(axis=0)
        cx, cz = (x0 + x1) / 2, (z0 + z1) / 2
        rh = max(0.05, wall_h * 0.25)
        y0, y1 = wall_h, wall_h + rh
        c = [np.array([x0, y0, z0]), np.array([x1, y0, z0]),
             np.array([x1, y0, z1]), np.array([x0, y0, z1])]
        tris = []
        if roof_type == "pyramidal":
            apex = np.array([cx, y1, cz])
            for a, b in zip(c, c[1:] + c[:1]):
                tris.append((a, b, apex))
        elif roof_type == "gabled":
            if (x1 - x0) >= (z1 - z0):
                r0 = np.array([x0, y1, cz])
                r1 = np.array([x1, y1, cz])
                tris += [(c[0], c[1], r1), (c[0], r1, r0),
                         (c[3], r0, r1), (c[3], r1, c[2]),
                         (c[0], r0, c[3]), (c[1], c[2], r1)]
            else:
                r0 = np.array([cx, y1, z0])
                r1 = np.array([cx, y1, z1])
                tris += [(c[0], r0, r1), (c[0], r1, c[3]),
                         (c[1], c[2], r1), (c[1], r1, r0),
                         (c[0], c[1], r0), (c[3], r1, c[2])]
        else:   # hipped
            if (x1 - x0) >= (z1 - z0):
                r0 = np.array([x0 * 0.7 + x1 * 0.3, y1, cz])
                r1 = np.array([x0 * 0.3 + x1 * 0.7, y1, cz])
            else:
                r0 = np.array([cx, y1, z0 * 0.7 + z1 * 0.3])
                r1 = np.array([cx, y1, z0 * 0.3 + z1 * 0.7])
            tris += [(c[0], c[1], r0), (c[1], c[2], r1),
                     (c[2], c[3], r1), (c[3], c[0], r0),
                     (r0, c[1], r1), (r0, r1, c[3])]
        return tris

    def _composite_mesh(self, plan, mesh, color, rgba, depth, opacity=1.0):
        """Trace the mesh with the render camera; lambert-shade and
        composite where it is nearer than the current depth buffer. The
        rays, the walk (kernel K9 on the card) and the shading stay on the
        MapScene's device; `rgba` and `depth` are updated in place."""
        from .ops.bvh import build_sah_bvh, mesh_scene, trace_mesh
        from .ops.shading import sun_direction

        v = np.asarray(mesh.vertices, np.float32)
        f = np.asarray(mesh.indices, np.uint32)
        if v.size == 0 or f.size == 0:
            return
        dev = self.device
        f32 = torch.float32
        bvh = build_sah_bvh(v, f)
        scene, n_nodes = mesh_scene(bvh, device=dev)
        origin, dirs = self._pixel_rays(plan)
        hit = trace_mesh(
            scene, n_nodes,
            tuple(torch.full(dirs.shape[:2], float(np.float32(c)), dtype=f32, device=dev)
                  for c in origin),
            tuple(dirs[..., i].to(f32).contiguous() for i in range(3)))
        prim = hit.prim.long().clamp(min=0)      # misses are masked below
        e1 = scene.tri_e1[prim]
        e2 = scene.tri_e2[prim]
        n = torch.stack([e1[..., 1] * e2[..., 2] - e1[..., 2] * e2[..., 1],
                         e1[..., 2] * e2[..., 0] - e1[..., 0] * e2[..., 2],
                         e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]], -1)
        nlen = torch.sqrt(n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1] + n[..., 2] * n[..., 2])
        n = n / torch.clamp(nlen, min=1e-12)[..., None]
        # flip normals toward the camera
        facing = (n.double() * dirs).sum(-1)
        n = torch.where(facing[..., None] > 0, -n, n)

        light = plan["params"].light
        sx, sy, sz = sun_direction(light.azimuth_deg, light.elevation_deg)
        ndotl = torch.clamp(n[..., 0] * sx + n[..., 1] * sy + n[..., 2] * sz, min=0.0)

        def rgb(c, k=1.0):
            return torch.as_tensor(np.asarray(c, np.float32) * k, device=dev)

        col = rgb(color)
        lcol = rgb(light.color, light.intensity)
        acol = rgb(light.ambient_color, light.ambient)
        shade = col * (lcol * ndotl[..., None] + acol)
        ldr = torch.clamp(shade / (1.0 + shade), 0.0, 1.0)  # Reinhard like terrain

        depth_t = torch.as_tensor(depth, device=dev)
        t = hit.t.double()
        nearer = hit.hit & (t < depth_t)
        a = float(opacity)
        base = torch.as_tensor(rgba[..., :3], device=dev).to(f32) / 255.0
        out = torch.where(nearer[..., None], base * (1 - a) + ldr * a, base)
        rgba[..., :3] = (torch.clamp(out, 0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
        np.copyto(depth, torch.where(nearer, t, depth_t).cpu().numpy())

    def _composite_points(self, plan, positions, colors, point_size,
                          rgba, depth):
        """Depth-tested square splats in screen space."""
        origin, right, up, fwd, half_w, half_h = self._camera_frame(plan)
        W, H = plan["params"].size_px
        p = np.asarray(positions, np.float64).reshape(-1, 3)
        rel = p - origin
        zc = rel @ fwd
        xc = rel @ right
        yc = rel @ up
        valid = zc > 1e-6
        zs = np.where(valid, zc, 1.0)
        px = (xc / (zs * half_w) + 1) * 0.5 * W - 0.5
        py = (1 - yc / (zs * half_h)) * 0.5 * H - 0.5
        # distance along the (unnormalized-to-unit) ray = |rel|
        t = np.linalg.norm(rel, axis=-1)
        cols = (np.asarray(colors, np.float32).reshape(-1, 3)
                if colors is not None else None)
        r = max(int(point_size) // 2, 0)
        ix = np.round(px).astype(int)
        iy = np.round(py).astype(int)
        order = np.argsort(-t)  # far-to-near so near points win overdraw
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                gx = ix[order] + dx
                gy = iy[order] + dy
                ok = (valid[order] & (gx >= 0) & (gx < W)
                      & (gy >= 0) & (gy < H))
                sel = order[ok]
                gxx, gyy = gx[ok], gy[ok]
                closer = t[sel] < depth[gyy, gxx] + 1e-6
                sel, gxx, gyy = sel[closer], gxx[closer], gyy[closer]
                c = (cols[sel] if cols is not None
                     else np.asarray(plan.get("_pc_color", (0.9, 0.6, 0.2)),
                                     np.float32)[None, :].repeat(len(sel), 0))
                rgba[gyy, gxx, :3] = (np.clip(c, 0, 1) * 255 + 0.5
                                      ).astype(np.uint8)
                depth[gyy, gxx] = np.minimum(depth[gyy, gxx], t[sel])

    # -- render ------------------------------------------------------------
    def _refuse_unported(self, cache) -> None:
        """The recipe parts the port has no engine for yet, each refused
        with the ROADMAP item that ports it (after validation, before any
        work)."""
        for i, layer in enumerate(self.recipe.layers):
            if isinstance(layer, LabelLayer):
                raise NotImplementedError(f"layers[{i}]: LabelLayer is "
                                          + _NOT_PORTED.format(14))
            if isinstance(layer, Tiles3DLayer):
                raise NotImplementedError(f"layers[{i}]: Tiles3DLayer is "
                                          + _NOT_PORTED.format(15))
            if isinstance(layer, PointCloudLayer) and layer.path is not None:
                raise NotImplementedError(f"layers[{i}]: PointCloudLayer(path=...) is "
                                          + _NOT_PORTED.format(15))
        if getattr(self.recipe.furniture, "reference_layout", False):
            raise NotImplementedError("MapFurniture's reference layout (legend_cfg, "
                                      "scale_bar_cfg, north_arrow_cfg, graticule_cfg) is "
                                      + _NOT_PORTED.format(14))
        if cache is not None:
            raise NotImplementedError("the anamnesis render cache (cache=) is "
                                      + _NOT_PORTED.format(13))

    def render(self, path=None, cache=None, certificate=None,
               render_policy: str = "block_on_error") -> Frame:
        """Render the recipe: validation first (it may block), then the
        terrain route, the 3D layers, the overlays and the furniture.
        `last_render_timings` holds each stage's wall ms (synchronised)."""
        import time as _time

        rep = self.validate()
        rep.raise_if_blocking(render_policy)
        self._refuse_unported(cache)
        plan = self.compile_plan()
        timings = {}
        _t_terrain0 = _time.perf_counter()

        from .terrain.renderer import TerrainRenderer

        layers = self.recipe.layers
        needs_depth = any(isinstance(l, (BuildingLayer, PointCloudLayer)) for l in layers)

        renderer = None
        if str(plan.get("camera_mode", "")).startswith("clipmap"):
            rgba = self._render_clipmap_terrain(plan)
            depth = (np.full(rgba.shape[:2], np.inf)
                     if needs_depth else None)
            frame = Frame(rgba=rgba, metadata={"camera_mode": "clipmap"})
        elif plan.get("camera_mode") == "mesh":
            rgba = self._render_mesh_terrain(
                plan, camera=getattr(self.recipe, "mesh_camera", None))
            depth = (np.full(rgba.shape[:2], np.inf)
                     if needs_depth else None)
            frame = Frame(rgba=rgba, metadata={"camera_mode": "mesh"})
        elif plan.get("camera_mode") == "screen":
            rgba = self._render_screen_terrain(plan)
            depth = (np.full(rgba.shape[:2], np.inf)
                     if needs_depth else None)
            frame = Frame(rgba=rgba, metadata={"camera_mode": "screen"})
        else:
            renderer = TerrainRenderer(device=self.device)
            if needs_depth:
                frame, aov = renderer.render_with_aov(
                    params=plan["params"], heightmap=plan["dem"])
                depth = np.asarray(aov["depth"], np.float64).copy()
                depth[~np.isfinite(depth)] = np.inf
            else:
                frame = renderer.render_terrain_pbr_pom(
                    params=plan["params"], heightmap=plan["dem"])
                depth = None
        rgba = frame.rgba.copy()
        timings["terrain"] = (_time.perf_counter() - _t_terrain0) * 1e3
        # observability: the reference's MapScene.last_render_metadata
        # (python/forge3d/bench.py:65-85 reads terrain_main_pass_ms /
        # material_vt_stats from it)
        _md = {
            "camera_mode": plan.get("camera_mode", "perspective"),
            "terrain_main_pass_ms": timings["terrain"],
        }
        if renderer is not None:
            _gt = getattr(renderer, "last_gpu_timings", None)
            if isinstance(_gt, dict) and _gt.get("terrain_main_pass_ms"):
                _md["terrain_main_pass_ms"] = float(
                    _gt["terrain_main_pass_ms"])
            _vt = getattr(renderer, "last_vt_stats", None)
            if isinstance(_vt, dict):
                _md["material_vt_stats"] = dict(_vt)
        self.last_render_metadata = _md
        W, H = plan["params"].size_px

        # 3D content layers (depth-composited against the terrain)
        t0 = _time.perf_counter()
        if plan.get("camera_mode") == "screen":
            bld = [l for l in layers if isinstance(l, BuildingLayer)
                   and l.footprints is not None]
            if bld:
                self._composite_buildings_ref(plan, bld, rgba)
        for layer in layers:
            if isinstance(layer, BuildingLayer):
                if (plan.get("camera_mode") == "screen"
                        and layer.footprints is not None):
                    continue   # composited by _composite_buildings_ref
                mesh = self._layer_mesh(plan, layer)
                self._composite_mesh(plan, mesh, layer.color, rgba, depth,
                                     layer.opacity)
            elif isinstance(layer, PointCloudLayer):
                pos = np.asarray(layer.positions, np.float64)
                cols = layer.colors
                pos = pos * np.array([1.0, layer.height_scale, 1.0]) \
                    + np.asarray(layer.offset, np.float64)
                if cols is None:
                    cols = np.broadcast_to(
                        np.asarray(layer.color, np.float32), (len(pos), 3))
                self._composite_points(plan, pos, cols, layer.point_size,
                                       rgba, depth)
        timings["buildings and points"] = (_time.perf_counter() - t0) * 1e3

        # raster overlays and screen-space vector layers, in order
        t0 = _time.perf_counter()
        screen_layers = self._screen_layers(plan)
        for layer in self.recipe.layers:
            if screen_layers and isinstance(layer, VectorOverlayLayer):
                from .screen_compose import composite_vector_layer

                composite_vector_layer(rgba, layer, W, H)
            elif isinstance(layer, RasterOverlayLayer):
                self._composite_raster(layer, rgba, W, H)
        timings["raster and screen-space layers"] = (_time.perf_counter() - t0) * 1e3
        # screen-space postfx after solid content, before labels/vectors
        # (reference composite order, map_scene.py:3241-3245)
        t0 = _time.perf_counter()
        self._apply_screen_space_ref(rgba)
        timings["postfx"] = (_time.perf_counter() - t0) * 1e3

        t0 = _time.perf_counter()
        vs = self._world_vectors(plan)
        if vs.layers:
            rgb, _, _ = vs.render_tensors(
                W, H, base_rgb=torch.as_tensor(rgba[..., :3], device=self.device)
                .to(torch.float32) / 255.0, device=self.device)
            rgba[..., :3] = (torch.clamp(rgb, 0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
        timings["world vector layers"] = (_time.perf_counter() - t0) * 1e3

        # furniture: the layout follows the reference's furniture
        # compositor: title top-center, legend panel bottom-left, scale bar
        # bottom-center, north arrow beside it — all scaled to the frame
        t0 = _time.perf_counter()
        fur = self.recipe.furniture
        from . import furniture as fx

        if fur.title:
            fx.draw_title_plate(rgba, fur.title, fur.subtitle,
                                scale=2 if W >= 400 else 1)
        if fur.legend:
            dem = plan["dem"]
            lg_h = max(24, min(140, H // 3))
            lg_w = max(6, min(22, W // 12))
            fx.draw_legend(
                rgba,
                fx.LegendSpec(colormap=plan["params"].colormap,
                              vmin=float(dem.min()), vmax=float(dem.max()),
                              label=fur.legend_label,
                              width=lg_w, height=lg_h),
                x=8, y=H - lg_h - 14,
            )
        if fur.scale_bar:
            mpp = plan["span"] / W
            fx.draw_scale_bar(
                rgba,
                fx.ScaleBarSpec(meters_per_pixel=mpp,
                                max_width_px=max(40, W // 3)),
                x=W // 2 - max(40, W // 3) // 2, y=H - 22)
        if fur.north_arrow:
            na = max(12, min(28, H // 5))
            fx.draw_north_arrow(rgba, x=W - na - 10, y=H - na - 26, size=na)
        if fur.graticule_spacing > 0:
            fx.draw_graticule(
                rgba, fx.GraticuleSpec(spacing=fur.graticule_spacing),
                (0.0, 0.0, plan["span"], plan["span"]),
            )
        timings["furniture"] = (_time.perf_counter() - t0) * 1e3

        out = Frame(rgba=rgba, metadata={**frame.metadata, "recipe": self.recipe.name})
        if certificate is not None:
            from .assurance.certificate import emit_certificate

            emit_certificate(certificate, f"mapscene.{self.recipe.name}",
                             {"frames": 1, "rgba": rgba})
        if path is not None:
            from .io.image import numpy_to_png

            t0 = _time.perf_counter()
            numpy_to_png(path, rgba)
            timings["png encode"] = (_time.perf_counter() - t0) * 1e3
        self.last_render_timings = timings
        return out

    def _screen_layers(self, plan) -> bool:
        return (plan.get("camera_mode") == "screen"
                and getattr(self.recipe, "layer_space", "world") == "screen")

    def _world_vectors(self, plan):
        """The recipe's world vector layers, projected through the render
        camera, as a VectorScene (empty when the layers are screen-space)."""
        from .vector import VectorScene

        vs = VectorScene()
        if self._screen_layers(plan):
            return vs
        for layer in self.recipe.layers:
            if not isinstance(layer, VectorOverlayLayer):
                continue
            if layer.kind == "polygons":
                rings = [self._project(plan, r, layer.height_offset)
                         for r in layer.coordinates]
                vs.add_polygons(rings, color=layer.color, opacity=layer.opacity)
            elif layer.kind == "lines":
                pts = self._project(plan, layer.coordinates, layer.height_offset)
                vs.add_lines(pts, color=layer.color, width=layer.width,
                             opacity=layer.opacity,
                             dash_array=getattr(layer, "dash_array",
                                                None))
            else:
                pts = self._project(plan, layer.coordinates, layer.height_offset)
                vs.add_points(pts, color=layer.color, size=layer.width,
                              opacity=layer.opacity)
        return vs

    @staticmethod
    def _composite_raster(layer: "RasterOverlayLayer", rgba, W: int, H: int) -> None:
        """One raster overlay over rgba (H, W, 4) u8, in place (host numpy)."""
        img = layer.image
        if img is None and layer.path is not None:
            import os

            if os.path.exists(str(layer.path)):
                from .io.image import png_to_numpy

                if str(layer.path).lower().endswith(".png"):
                    img = png_to_numpy(layer.path)
                else:
                    from .gis import read_raster

                    img = np.asarray(read_raster(layer.path),
                                     np.float32)
                    # real rasters (DEM meters, ortho DN) are not
                    # [0,1]: normalize to the dataset range so the
                    # composite doesn't saturate to white
                    lo = float(np.nanmin(img))
                    hi = float(np.nanmax(img))
                    if hi > lo and (lo < 0.0 or hi > 1.0):
                        img = (img - lo) / (hi - lo)
                    img = np.nan_to_num(img, nan=0.0)
                    img = np.stack([img] * 3, axis=-1)
        if img is None:
            # deterministic placeholder: hash-colored diagonal
            # stripes, exactly the reference's fallback
            # (_map_scene_render.py:1392-1400)
            color = np.asarray(
                layer_hash_rgb(layer.to_dict(), salt="raster"),
                np.float32)
            phase = layer_hash_int(layer.to_dict(),
                                   salt="raster-mask") % 5
            yy, xx = np.mgrid[0:H, 0:W]
            mask = ((xx + yy + phase) % 5) < 3
            a = max(0.0, min(1.0, float(layer.opacity))) * 0.45
            base = rgba[..., :3].astype(np.float32)
            blended = base * (1 - a) + color[None, None] * a
            rgba[..., :3] = np.where(mask[..., None],
                                     blended, base).astype(np.uint8)
            return
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if layer.screen_rect is not None:
            # textured-landmark contract (map_scene.py:3066-3079):
            # rounded pixel rect, nearest sampling on linspace
            # indices, a 1.08 -> 0.78 vertical shade ramp, alpha
            # straight from the texture
            rx0, ry0, rx1, ry1 = layer.screen_rect
            x0 = max(0, min(W - 1, int(round(min(rx0, rx1) * W))))
            x1 = max(x0 + 1, min(W, int(round(max(rx0, rx1) * W))))
            y0 = max(0, min(H - 1, int(round(min(ry0, ry1) * H))))
            y1 = max(y0 + 1, min(H, int(round(max(ry0, ry1) * H))))
            sh, sw = img.shape[:2]
            sy = np.linspace(0, sh - 1, y1 - y0).astype(np.int32)
            sx = np.linspace(0, sw - 1, x1 - x0).astype(np.int32)
            sub = img[np.ix_(sy, sx)].astype(np.float32).copy()
            ramp = np.linspace(1.08, 0.78, y1 - y0,
                               dtype=np.float32)[:, None, None]
            sub[..., :3] = sub[..., :3] * ramp
            a = (sub[..., 3:4] if sub.shape[-1] == 4
                 else 1.0) * layer.opacity
            base = rgba[y0:y1, x0:x1, :3].astype(np.float32) / 255.0
            outp = base * (1 - a) + sub[..., :3] * a
            rgba[y0:y1, x0:x1, :3] = (np.clip(outp, 0, 1) * 255
                                      + 0.5).astype(np.uint8)
            rgba[y0:y1, x0:x1, 3] = 255
            return
        if img.shape[:2] != (H, W):
            # nearest-neighbor resize, matching the reference
            # compositor's integer sampling
            sh, sw = img.shape[:2]
            yy, xx = np.mgrid[0:H, 0:W]
            sy = np.clip(yy * sh // max(H, 1), 0, sh - 1)
            sx = np.clip(xx * sw // max(W, 1), 0, sw - 1)
            img = img[sy, sx]
        a = (img[..., 3:4] if img.shape[2] == 4 else 1.0) * layer.opacity
        base = rgba[..., :3].astype(np.float32) / 255.0
        out = base * (1 - a) + img[..., :3] * a
        rgba[..., :3] = (np.clip(out, 0, 1) * 255 + 0.5).astype(np.uint8)
