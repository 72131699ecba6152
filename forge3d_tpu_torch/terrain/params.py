# forge3d_tpu_torch/terrain/params.py
# TerrainRenderParams: the nested settings tree of the terrain renderer, a
# copy of forge3d_tpu/terrain/params.py (pure Python), so that the port
# validates, defaults and round-trips parameters exactly as the JAX package
# does. Settings groups that the perspective path does not read are
# accepted, validated and carried; the renderer reports which groups it
# consumed via TerrainRenderer.last_consumed_settings.

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class LightSettings:
    azimuth_deg: float = 315.0
    elevation_deg: float = 45.0
    intensity: float = 2.5
    color: Tuple[float, float, float] = (1.0, 0.97, 0.92)
    ambient: float = 0.15
    ambient_color: Tuple[float, float, float] = (0.55, 0.65, 0.8)


@dataclass
class IblSettings:
    enabled: bool = False
    intensity: float = 0.35
    rotation_deg: float = 0.0
    env_map: Optional[np.ndarray] = None  # (H, W, 3) f32 equirect
    #: analytic sky used when no env_map is supplied: "hosek" bakes the
    #: Hosek-Wilkie RGB model (the reference's sky, src/terrain/
    #: hosek_sky.rs) aligned to the sun; "gradient" keeps the simple
    #: two-tone fallback
    sky_model: str = "hosek"
    turbidity: float = 3.0
    ground_albedo: float = 0.3


@dataclass
class ShadowSettings:
    enabled: bool = True
    technique: str = "raytrace"  # TPU path ray-marches the heightfield;
    # accepts reference names (hard/pcf/pcss/vsm/evsm/msm/csm) and maps
    # them onto ray-traced sun visibility with matching softness.
    softness: float = 0.0        # angular radius (deg) for soft shadows
    samples: int = 1
    intensity: float = 1.0
    bias: float = 1e-3

    _TECHNIQUES = ("raytrace", "hard", "pcf", "pcss", "vsm", "evsm",
                   "msm", "csm")

    def __post_init__(self):
        # reference ShadowSettings.validate_for_terrain semantics
        # (terrain_params.py technique whitelist + positive controls)
        if str(self.technique).lower() not in self._TECHNIQUES:
            raise ValueError(
                f"unknown shadow technique {self.technique!r}; "
                f"expected one of {self._TECHNIQUES}")
        if self.softness < 0.0:
            raise ValueError("shadow softness must be >= 0")
        if int(self.samples) < 1:
            raise ValueError("shadow samples must be >= 1")
        if self.bias <= 0.0:
            raise ValueError("shadow bias must be > 0")


@dataclass
class FogSettings:
    enabled: bool = False
    density: float = 0.01
    color: Tuple[float, float, float] = (0.7, 0.78, 0.88)
    height_falloff: float = 0.0
    start_distance: float = 0.0


@dataclass
class WaterSettings:
    enabled: bool = False
    level: float = 0.0
    color: Tuple[float, float, float] = (0.08, 0.22, 0.35)
    roughness: float = 0.08
    reflectivity: float = 0.6


@dataclass
class ReflectionSettings:
    enabled: bool = False
    intensity: float = 0.5
    # planar water reflection controls (reference water_reflection/
    # uniforms.rs; consumed by the screen-mode pass)
    fresnel_power: float = 5.0
    wave_strength: float = 0.0
    shore_atten_width: float = 0.0
    water_plane_height: float = 0.0


@dataclass
class SkySettings:
    """Analytic sky + aerial perspective (sky.wgsl, renderer/atmosphere.rs).

    Consumed by the screen-mode pass; the perspective ray path keeps its
    own Hosek environment binding (IblSettings.sky_model)."""

    enabled: bool = False
    model: str = "hosek-wilkie"  # hosek-wilkie | preetham
    turbidity: float = 2.0
    ground_albedo: float = 0.3
    sun_intensity: float = 1.0
    sun_size: float = 1.0
    aerial_density: float = 1.0
    sky_exposure: float = 1.0
    aerial_perspective: bool = True

    def __post_init__(self):
        # reference SkySettings ranges (terrain_params.py:1296-1312)
        if str(self.model) not in ("hosek-wilkie", "preetham",
                                   "approximate"):
            raise ValueError(f"unknown sky model {self.model!r}")
        if not (1.0 <= float(self.turbidity) <= 10.0):
            raise ValueError("sky turbidity must be in [1, 10]")
        if not (0.0 <= float(self.ground_albedo) <= 1.0):
            raise ValueError("sky ground_albedo must be in [0, 1]")

    def to_dict_cfg(self) -> dict:
        return dict(enabled=self.enabled, model=self.model,
                    turbidity=self.turbidity,
                    ground_albedo=self.ground_albedo,
                    sun_intensity=self.sun_intensity,
                    sun_size=self.sun_size,
                    aerial_density=self.aerial_density,
                    sky_exposure=self.sky_exposure,
                    aerial_perspective=self.aerial_perspective)


@dataclass
class CloudSettings:
    enabled: bool = False
    coverage: float = 0.4
    density: float = 0.5
    shadow_strength: float = 0.4
    scale: float = 0.002
    seed: int = 7


@dataclass
class HeightAoSettings:
    enabled: bool = False
    radius: float = 8.0
    samples: int = 8
    strength: float = 1.0


@dataclass
class SunVisibilitySettings:
    enabled: bool = False
    samples: int = 4
    softness_deg: float = 0.5


@dataclass
class TriplanarSettings:
    enabled: bool = False
    scale: float = 1.0
    blend_sharpness: float = 4.0


@dataclass
class PomSettings:
    enabled: bool = False
    scale: float = 0.0
    steps: int = 16
    # reference POM march controls (terrain_pbr_pom.wgsl:2660-2719);
    # when min/max are left at 0 the legacy `steps` drives both
    min_steps: int = 0
    max_steps: int = 0
    refine_steps: int = 0
    occlusion: bool = True
    shadow: bool = False

    def __post_init__(self):
        # reference PomSettings.__post_init__
        # (terrain_params.py:1760-1773)
        if self.scale < 0.0:
            raise ValueError("pom scale must be >= 0")
        if int(self.steps) < 1:
            raise ValueError("pom steps must be >= 1")
        if self.min_steps and int(self.min_steps) < 1:
            raise ValueError("pom min_steps must be >= 1")
        if self.min_steps and self.max_steps \
                and int(self.max_steps) < int(self.min_steps):
            raise ValueError("pom max_steps must be >= min_steps")
        if int(self.refine_steps) < 0:
            raise ValueError("pom refine_steps must be >= 0")

    def to_screen_cfg(self) -> dict:
        mx = self.max_steps if self.max_steps > 0 else self.steps
        mn = self.min_steps if self.min_steps > 0 else max(mx // 4, 1)
        return dict(enabled=self.enabled, height_scale=float(self.scale),
                    min_steps=int(mn), max_steps=int(mx),
                    refine_steps=int(self.refine_steps),
                    occlusion=bool(self.occlusion))


@dataclass
class LodSettings:
    mode: str = "full"
    screen_space_error: float = 1.5


@dataclass
class SamplingSettings:
    aa_samples: int = 1
    aa_seed: int = 7
    max_bounces: int = 0


@dataclass
class ClampSettings:
    luminance_clamp: Optional[float] = None
    value_clamp: Optional[float] = None


@dataclass
class TonemapSettings:
    mode: str = "reinhard"  # reinhard|reinhard_extended|filmic|aces|off
    exposure: float = 1.0
    white_point: float = 4.0


@dataclass
class DetailSettings:
    enabled: bool = False
    strength: float = 0.5
    scale: float = 8.0


@dataclass
class MaterialLayerSettings:
    """Height/slope material layers (snow/rock/wetness).

    Carries both the TPU perspective-path knobs (snow_height/snow_blend/
    rock_slope_deg) and the full reference M4 schema (forge3d's
    terrain_params.py:546-600) consumed by the screen-mode pass, including
    TV10 subsurface scattering."""

    enabled: bool = False
    snow_height: float = 0.75     # normalized height above which snow blends
    snow_blend: float = 0.1
    snow_color: Tuple[float, float, float] = (0.95, 0.95, 0.97)
    rock_slope_deg: float = 50.0  # slope beyond which rock replaces albedo
    rock_blend_deg: float 	= 10.0
    rock_color: Tuple[float, float, float] = (0.45, 0.4, 0.38)
    # reference M4 schema (screen-mode pass)
    snow_enabled: bool = False
    snow_altitude_min: float = 2000.0
    snow_altitude_blend: float = 500.0
    snow_slope_max: float = 45.0
    snow_slope_blend: float = 15.0
    snow_aspect_influence: float = 0.3
    snow_subsurface_strength: float = 0.0
    snow_subsurface_tint: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    rock_enabled: bool = False
    rock_slope_min: float = 45.0
    rock_slope_blend: float = 10.0
    rock_subsurface_strength: float = 0.0
    rock_subsurface_tint: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    wetness_enabled: bool = False
    wetness_strength: float = 0.3
    wetness_slope_influence: float = 0.5
    wetness_subsurface_strength: float = 0.0
    wetness_subsurface_tint: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    def to_layer_dict(self) -> dict:
        """The reference layer dict consumed by the screen-mode pass."""
        return dict(
            snow_enabled=self.snow_enabled,
            snow_altitude_min=self.snow_altitude_min,
            snow_altitude_blend=self.snow_altitude_blend,
            snow_slope_max=self.snow_slope_max,
            snow_slope_blend=self.snow_slope_blend,
            snow_aspect_influence=self.snow_aspect_influence,
            snow_color=tuple(self.snow_color),
            snow_subsurface_strength=self.snow_subsurface_strength,
            snow_subsurface_tint=tuple(self.snow_subsurface_tint),
            rock_enabled=self.rock_enabled,
            rock_slope_min=self.rock_slope_min,
            rock_slope_blend=self.rock_slope_blend,
            rock_color=tuple(self.rock_color),
            rock_subsurface_strength=self.rock_subsurface_strength,
            rock_subsurface_tint=tuple(self.rock_subsurface_tint),
            wetness_enabled=self.wetness_enabled,
            wetness_strength=self.wetness_strength,
            wetness_slope_influence=self.wetness_slope_influence,
            wetness_subsurface_strength=self.wetness_subsurface_strength,
            wetness_subsurface_tint=tuple(self.wetness_subsurface_tint),
        )


@dataclass
class TerrainRenderParams:
    """Master terrain rendering parameter container (reference parity:
    terrain_params.py:1853)."""

    size_px: Tuple[int, int] = (512, 512)
    render_scale: float = 1.0
    terrain_span: float = 0.0       # 0 => derived from DEM dims * spacing
    msaa_samples: int = 1
    z_scale: float = 1.0
    cam_target: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    cam_radius: float = 120.0
    cam_phi_deg: float = 225.0
    cam_theta_deg: float = 35.0
    cam_gamma_deg: float = 0.0
    fov_y_deg: float = 45.0
    clip: Tuple[float, float] = (0.1, 10_000.0)
    light: LightSettings = field(default_factory=LightSettings)
    ibl: IblSettings = field(default_factory=IblSettings)
    shadows: ShadowSettings = field(default_factory=ShadowSettings)
    triplanar: TriplanarSettings = field(default_factory=TriplanarSettings)
    pom: PomSettings = field(default_factory=PomSettings)
    lod: LodSettings = field(default_factory=LodSettings)
    sampling: SamplingSettings = field(default_factory=SamplingSettings)
    clamp: ClampSettings = field(default_factory=ClampSettings)
    overlays: List = field(default_factory=list)
    exposure: float = 1.0
    gamma: float = 2.2
    albedo_mode: str = "colormap"   # colormap|constant
    colormap: str = "terrain"
    constant_albedo: Tuple[float, float, float] = (0.6, 0.6, 0.6)
    colormap_strength: float = 1.0
    height_curve_mode: str = "linear"
    height_curve_strength: float = 0.0
    height_curve_power: float = 1.0
    height_curve_lut: Optional[np.ndarray] = None
    lambert_contrast: float = 0.0
    fog: Optional[FogSettings] = None
    reflection: Optional[ReflectionSettings] = None
    water: Optional[WaterSettings] = None
    clouds: Optional[CloudSettings] = None
    ao_weight: float = 0.0
    detail: Optional[DetailSettings] = None
    height_ao: Optional[HeightAoSettings] = None
    sun_visibility: Optional[SunVisibilitySettings] = None
    material_layers: Optional[MaterialLayerSettings] = None
    tonemap: TonemapSettings = field(default_factory=TonemapSettings)
    colormap_srgb: bool = False
    output_srgb_eotf: bool = False
    #: additional screen-mode inputs: sky/atmosphere config, explicit
    #: height domain (reference: decode domain, core.rs:38-97), and hue
    #: variation strength (core.rs hue_variation_strength)
    sky: Optional[SkySettings] = None
    domain: Optional[Tuple[float, float]] = None
    hue_variation_strength: float = 0.0
    #: "screen" = the reference's default fullscreen-triangle forward
    #: pass (terrain_pbr_pom.wgsl shade_main), evaluated by the jitted
    #: screen pipeline (terrain/screen.py); "perspective" = the
    #: TPU-native orbit ray render (the default here: it is this
    #: engine's production path and what every perf harness drives)
    camera_mode: str = "perspective"
    culling: str = "frustum"
    shading: str = "forward"
    debug_mode: str = "off"

    def validate(self) -> None:
        w, h = self.size_px
        if w <= 0 or h <= 0:
            raise ValueError("size_px must be positive")
        if not (0.1 <= self.render_scale <= 4.0):
            raise ValueError("render_scale must be in [0.1, 4]")
        if self.msaa_samples not in (1, 2, 4, 8, 16):
            raise ValueError("msaa_samples must be one of 1/2/4/8/16")
        if self.z_scale <= 0:
            raise ValueError("z_scale must be > 0")
        if self.cam_radius <= 0:
            raise ValueError("cam_radius must be > 0")
        if not (0.0 < self.fov_y_deg < 180.0):
            raise ValueError("fov_y_deg must be in (0, 180)")
        if self.clip[0] <= 0 or self.clip[1] <= self.clip[0]:
            raise ValueError("clip must satisfy 0 < znear < zfar")
        if self.albedo_mode not in ("colormap", "constant", "material",
                                    "mix"):
            raise ValueError(
                "albedo_mode must be one of colormap/constant/material/mix")
        if self.tonemap.mode not in (
            "reinhard", "reinhard_extended", "filmic", "aces", "off"
        ):
            raise ValueError(f"unknown tonemap mode {self.tonemap.mode!r}")
        if self.sampling.aa_samples < 1 or self.sampling.aa_samples > 256:
            raise ValueError("sampling.aa_samples must be in [1, 256]")

    def to_dict(self) -> dict:
        d = asdict(self)
        d.pop("height_curve_lut", None)
        ibl = d.get("ibl")
        if ibl is not None:
            ibl.pop("env_map", None)
        return d


def make_terrain_params(**overrides) -> TerrainRenderParams:
    """Convenience constructor with keyword overrides for nested groups:
    make_terrain_params(size_px=(800, 600), light=dict(azimuth_deg=90))."""
    groups = {
        "light": LightSettings, "ibl": IblSettings, "shadows": ShadowSettings,
        "triplanar": TriplanarSettings, "pom": PomSettings, "lod": LodSettings,
        "sampling": SamplingSettings, "clamp": ClampSettings,
        "fog": FogSettings, "water": WaterSettings, "clouds": CloudSettings,
        "reflection": ReflectionSettings, "height_ao": HeightAoSettings,
        "sun_visibility": SunVisibilitySettings, "detail": DetailSettings,
        "material_layers": MaterialLayerSettings, "tonemap": TonemapSettings,
        "sky": SkySettings,
    }
    kw = {}
    for k, v in overrides.items():
        if k in groups and isinstance(v, dict):
            kw[k] = groups[k](**v)
        else:
            kw[k] = v
    p = TerrainRenderParams(**kw)
    p.validate()
    return p
