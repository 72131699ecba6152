# forge3d_tpu_torch/terrain/renderer.py
# The perspective TerrainRenderer of forge3d_tpu/terrain/renderer.py on
# PyTorch: one-shot renders (render_terrain_pbr_pom, render_with_aov) and
# the offline progressive accumulation session (begin / accumulate_batch /
# read_accumulation_metrics / resolve / tonemap / end) that
# terrain/offline.py:render_offline drives.
#
# The JAX package compiles one XLA program per configuration from the
# shading closure `_make_shade`; here that program is kernel R1
# (csrc/terrain_shade.cuh, launched by csrc/renderer.cu): `render_program`
# launches the one-shot render (a thread a pixel in 16x16 tiles, or at aa 4
# a lane per AA sample, four lanes a pixel),
# `offline_step` one accumulation sample and the 32x32 tile means. Beside
# each is its plain PyTorch version (`render_plain`, `step_plain`, over
# `shade_plain`), which the wrappers run for CPU tensors; CUDA tensors
# launch the kernels, and nothing falls back from one to the other. The
# IBL's Hosek sky is baked by kernel E5 (sky.py).
#
# A MaterialSet with a virtual-texture store (terrain/vt.py) resolves the
# albedo per pixel inside R1 as the JAX package's does (renderer.py:833-871):
# the host residency pass `_vt_residency` decodes the pages whose mip level
# matches their footprint from this camera into an atlas under the byte
# budget and builds the page table; R1 then reads the level from each hit's
# footprint, the page table and the atlas texel, and counts the terrain
# pixels of sample 0 whose page is not resident (the fallback texels). Only
# the atlas slots that were filled go to the card.
#
# camera_mode="screen" renders go to the screen engine (terrain/screen.py,
# kernels S1-S4 and S8, with POM and the aerial sky inside S8) through
# `_render_screen`, as the JAX package's do.
#
# Not ported yet, and refused by the one-shot renders with
# NotImplementedError: the anamnesis render cache (`cache=`, ROADMAP item
# 13). The offline session ignores camera_mode and the VT store, as the JAX
# package's does, and renders the perspective shade; so does screen mode
# ignore the store.

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import _kernels, colormaps
from ..camera import camera_basis, orbit_camera_origin
from ..errors import RenderError, UploadError
from ..frame import AovFrame, Frame, HdrFrame, ldr_to_rgba
from ..mem import global_tracker
from ..ops import tonemap as tm
from ..ops.pyramid import build_pyramid
from ..ops.rng import MASK32, seed_state, xorshift32
from ..ops.shading import EnvMap, cosine_dir, env_radiance, fdiv, luminance, rsqrt
from ..ops.traversal import TerrainScene, f32, normal_at, scene_from_pyramid, trace_plain
from .params import TerrainRenderParams, make_terrain_params

_F32 = torch.float32

TONEMAPS = ("off", "reinhard", "reinhard_extended", "filmic", "aces")  # csrc enum order
CURVES = {"pow": 1, "smoothstep": 2}   # any other mode is linear
SEED_RENDER = 0x9E3779B9
SEED_STEP = 0x85EBCA6B
TILE = 32   # metric tile size in pixels

_NOT_PORTED = "not ported to forge3d_tpu_torch yet (ROADMAP queue 1 item {})"


class MaterialSet:
    """Material description for the terrain surface. It can bind a packed
    VT store (terrain/vt.py; a path opens a VTStore under the budget): per
    render, the residency pass decodes the needed albedo pages into an atlas
    and R1 samples it, falling back to the colormap or constant albedo
    where a page is not resident (the fallback texels are counted per
    render). The offline session and screen mode ignore the store."""

    def __init__(self, name: str = "default", vt_store=None,
                 vt_budget_bytes: int = 64 * 1024 * 1024):
        self.name = name
        self.vt_budget_bytes = int(vt_budget_bytes)
        if vt_store is not None and not hasattr(vt_store, "request"):
            from .vt import VTStore

            vt_store = VTStore(vt_store, budget_bytes=self.vt_budget_bytes)
        self.vt_store = vt_store

    @staticmethod
    def default() -> "MaterialSet":
        return MaterialSet()


class IBL:
    """Environment lighting wrapper: an optional (H, W, 3) equirect map."""

    def __init__(self, env_map: Optional[np.ndarray] = None, intensity: float = 0.35):
        if env_map is not None:
            env_map = np.asarray(env_map, np.float32)
            if env_map.ndim != 3 or env_map.shape[2] != 3:
                raise UploadError("IBL env_map must be (H, W, 3)")
        self.env_map = env_map
        self.intensity = float(intensity)

    @staticmethod
    def default() -> "IBL":
        return IBL()


# ---------------------------------------------------------------------------
# Per-render constants: the flags of _make_shade and the float32 uniforms of
# _uniforms, shared by the kernels and the plain versions
# ---------------------------------------------------------------------------


def _v3(v) -> Tuple[float, float, float]:
    return tuple(f32(c) for c in np.asarray(v, np.float64).reshape(3))


@dataclass(frozen=True)
class ShadeArgs:
    """R1's inputs besides the scene: the colormap LUT and the IBL map as
    tensors on the scene's device, flags, and float32 values (Python floats
    holding float32 numbers). Field names are csrc/terrain_shade.cuh's."""

    lut: torch.Tensor                 # (N, 3)
    env_rgb: Optional[torch.Tensor]   # (eh, ew, 3) or None: the sky gradient
    width: int
    height: int
    aa: int
    use_colormap: bool
    tonemap: int
    srgb_out: bool
    debug_normals: bool
    curve_mode: int
    shadow_samples: int               # 0: off
    ao_samples: int                   # 0: off
    fog_on: bool
    water_on: bool
    wrefl_on: bool
    clouds_on: bool
    layers_on: bool
    tri_on: bool
    det_on: bool
    pom_on: bool
    aa_seed: int
    cam_o: Tuple[float, float, float]
    right: Tuple[float, float, float]
    up: Tuple[float, float, float]
    fwd: Tuple[float, float, float]
    half_h: float
    aspect: float
    sun: Tuple[float, float, float]
    sun_rgb: Tuple[float, float, float]
    ambient_rgb: Tuple[float, float, float]
    zenith: Tuple[float, float, float]
    ibl_intensity: float
    hmin: float
    hmax: float
    exposure: float
    inv_gamma: float
    white_point: float
    colormap_strength: float
    constant_albedo: Tuple[float, float, float]
    lambert_contrast: float
    shadow_softness: float
    shadow_intensity: float
    shadow_bias: float
    curve_power: float
    curve_strength: float
    ao_mix_weight: float
    time: float
    fog_density: float = 0.0
    fog_rgb: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    fog_falloff: float = 0.0
    fog_start: float = 0.0
    water_level: float = 0.0
    water_rgb: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    water_reflectivity: float = 0.0
    refl_intensity: float = 0.0
    cloud_coverage: float = 0.0
    cloud_strength: float = 0.0
    cloud_scale: float = 0.0
    ao_radius: float = 0.0
    ao_strength: float = 0.0
    tri_scale: float = 0.0
    tri_sharp: float = 0.0
    det_strength: float = 0.0
    det_scale: float = 8.0            # the detail frequency POM reads with detail off
    det_fade: float = f32(1e9)
    pom_scale: float = 0.0
    snow_h: float = 0.0
    snow_blend: float = 0.0
    snow_rgb: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rock_cos: float = 0.0
    rock_blend: float = 0.0
    rock_rgb: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # the virtual-texture albedo (renderer.py:_vt_residency); vt_atlas None: off
    vt_atlas: Optional[torch.Tensor] = None   # (slots * page * page, 3) f32
    vt_table: Optional[torch.Tensor] = None   # slot per (level, tile), i32; -1 not resident
    vt_levels: Tuple[int, ...] = ()           # the store's albedo levels, ascending
    vt_tiles: Tuple[int, ...] = ()            # pages per side, per level
    vt_offs: Tuple[int, ...] = ()             # each level's first table entry
    vt_page: int = 0
    vt_pix_angle: float = 0.0
    vt_tpw0: float = 0.0
    vt_inv_span: float = 0.0

    @property
    def env(self) -> Optional[EnvMap]:
        return None if self.env_rgb is None else EnvMap(self.env_rgb, self.ibl_intensity)

    def kernel_args(self) -> _kernels.TerrainArgs:
        _kernels.require_cuda("terrain", self.lut,
                              *(() if self.env_rgb is None else (self.env_rgb,)))
        args = _kernels.TerrainArgs()
        args.lut = self.lut.data_ptr()
        args.lut_n = int(self.lut.shape[0])
        if self.env_rgb is not None:
            args.env_rgb = self.env_rgb.data_ptr()
            args.env_h, args.env_w = int(self.env_rgb.shape[0]), int(self.env_rgb.shape[1])
        for f in dataclasses.fields(self):
            if f.name in ("lut", "env_rgb") or f.name.startswith("vt_"):
                continue
            v = getattr(self, f.name)
            setattr(args, f.name, _kernels._F3(*v) if isinstance(v, tuple) else v)
        if self.vt_atlas is not None:
            _kernels.require_cuda("terrain VT", self.vt_atlas, self.vt_table)
            args.vt_atlas = self.vt_atlas.data_ptr()
            args.vt_table = self.vt_table.data_ptr()
            args.vt_levels = len(self.vt_levels)
            args.vt_level0, args.vt_level_last = self.vt_levels[0], self.vt_levels[-1]
            args.vt_page = self.vt_page
            for i, (n, off) in enumerate(zip(self.vt_tiles, self.vt_offs)):
                args.vt_tiles[i], args.vt_offs[i] = n, off
            args.vt_pix_angle = self.vt_pix_angle
            args.vt_tpw0 = self.vt_tpw0
            args.vt_inv_span = self.vt_inv_span
        return args


def make_shade_args(p: TerrainRenderParams, dem_shape, span: float, hmin: float, hmax: float,
                    W: int, H: int, time_seconds: float, lut: torch.Tensor,
                    env_rgb: Optional[torch.Tensor]) -> ShadeArgs:
    """renderer.py:_uniforms and _make_shade's flags: the camera, sun and
    colours in float64 on the host, each rounded once to float32."""
    target = np.asarray(p.cam_target, np.float64)
    if not np.any(target):  # default: centre of the terrain footprint
        target = np.array([span * 0.5, 0.0,
                           span * 0.5 * (dem_shape[0] - 1) / (dem_shape[1] - 1)])
    origin = orbit_camera_origin(target, p.cam_radius, p.cam_phi_deg, p.cam_theta_deg)
    right, up, fwd = camera_basis(origin, target, (0.0, 1.0, 0.0))
    if abs(p.cam_gamma_deg) > 1e-6:
        g = math.radians(p.cam_gamma_deg)
        c, s = np.float32(math.cos(g)), np.float32(math.sin(g))
        right, up = (c * right + s * up), (-s * right + c * up)
    az = math.radians(p.light.azimuth_deg)
    el = math.radians(p.light.elevation_deg)
    sun = (math.cos(az) * math.cos(el), math.sin(el), math.sin(az) * math.cos(el))
    amb = np.asarray(_v3(np.asarray(p.light.ambient_color) * p.light.ambient), np.float32)
    lum = np.float32(0.2126) * amb[0] + np.float32(0.7152) * amb[1] + np.float32(0.0722) * amb[2]
    zenith = amb / np.maximum(lum, np.float32(1e-4)) * np.float32(0.9)
    shadows_on = bool(p.shadows.enabled)
    ao_on = p.height_ao is not None and p.height_ao.enabled
    water_on = p.water is not None and p.water.enabled
    kw = dict(
        lut=lut, env_rgb=env_rgb, width=W, height=H, aa=int(p.sampling.aa_samples),
        use_colormap=p.albedo_mode == "colormap", tonemap=TONEMAPS.index(p.tonemap.mode),
        srgb_out=bool(p.output_srgb_eotf), debug_normals=p.debug_mode == "normals",
        curve_mode=CURVES.get(p.height_curve_mode, 0),
        shadow_samples=max(1, int(p.shadows.samples)) if shadows_on else 0,
        ao_samples=int(p.height_ao.samples) if ao_on else 0,
        fog_on=p.fog is not None and p.fog.enabled, water_on=water_on,
        wrefl_on=water_on and p.reflection is not None and p.reflection.enabled,
        clouds_on=p.clouds is not None and p.clouds.enabled,
        layers_on=p.material_layers is not None and p.material_layers.enabled,
        tri_on=p.triplanar is not None and p.triplanar.enabled,
        det_on=p.detail is not None and p.detail.enabled,
        pom_on=p.pom is not None and p.pom.enabled and float(p.pom.scale) > 0.0,
        aa_seed=int(p.sampling.aa_seed) & MASK32,
        cam_o=_v3(origin), right=_v3(right), up=_v3(up), fwd=_v3(fwd),
        half_h=f32(math.tan(math.radians(p.fov_y_deg) * 0.5)), aspect=f32(W / H),
        sun=_v3(sun), sun_rgb=_v3(np.asarray(p.light.color) * p.light.intensity),
        ambient_rgb=_v3(amb), zenith=_v3(zenith), ibl_intensity=f32(p.ibl.intensity),
        hmin=f32(hmin * p.z_scale), hmax=f32(hmax * p.z_scale),
        exposure=f32(p.tonemap.exposure * p.exposure), inv_gamma=f32(1.0 / p.gamma),
        white_point=f32(p.tonemap.white_point), colormap_strength=f32(p.colormap_strength),
        constant_albedo=_v3(p.constant_albedo), lambert_contrast=f32(p.lambert_contrast),
        shadow_softness=f32(math.radians(p.shadows.softness)),
        shadow_intensity=f32(p.shadows.intensity), shadow_bias=f32(p.shadows.bias),
        curve_power=f32(p.height_curve_power), curve_strength=f32(p.height_curve_strength),
        ao_mix_weight=float(np.maximum(np.float32(p.ao_weight), np.float32(ao_on))),
        time=f32(time_seconds),
    )
    if p.fog and p.fog.enabled:
        kw.update(fog_density=f32(p.fog.density), fog_rgb=_v3(p.fog.color),
                  fog_falloff=f32(p.fog.height_falloff), fog_start=f32(p.fog.start_distance))
    if water_on:
        kw.update(water_level=f32(p.water.level * p.z_scale), water_rgb=_v3(p.water.color),
                  water_reflectivity=f32(p.water.reflectivity))
    if p.clouds and p.clouds.enabled:
        kw.update(cloud_coverage=f32(p.clouds.coverage),
                  cloud_strength=f32(p.clouds.shadow_strength), cloud_scale=f32(p.clouds.scale))
    if ao_on:
        kw.update(ao_radius=f32(p.height_ao.radius), ao_strength=f32(p.height_ao.strength))
    if p.triplanar and p.triplanar.enabled:
        kw.update(tri_scale=f32(p.triplanar.scale), tri_sharp=f32(p.triplanar.blend_sharpness))
    if p.detail and p.detail.enabled:
        kw.update(det_strength=f32(p.detail.strength), det_scale=f32(p.detail.scale),
                  det_fade=f32(max(span * 3.0, 1.0)))
    if p.pom and p.pom.enabled:
        kw.update(pom_scale=f32(p.pom.scale))
    if p.reflection and p.reflection.enabled:
        kw.update(refl_intensity=f32(p.reflection.intensity))
    layers = p.material_layers
    if layers and layers.enabled:
        kw.update(snow_h=f32(layers.snow_height), snow_blend=f32(max(layers.snow_blend, 1e-4)),
                  snow_rgb=_v3(layers.snow_color),
                  rock_cos=f32(math.cos(math.radians(layers.rock_slope_deg))),
                  rock_blend=f32(max(math.radians(layers.rock_blend_deg), 1e-4)),
                  rock_rgb=_v3(layers.rock_color))
    return ShadeArgs(**kw)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (renderer.py:_make_shade and _build_program)
# ---------------------------------------------------------------------------


def _f2i(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 value (held in int64), saturating as the kernel's
    conversion does; only values the sky replaces are ever out of range."""
    return torch.clamp(x, -2147483648.0, 2147483520.0).to(torch.int64)


def _lattice(ix: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    """vnoise2's hash: int32 products that wrap and an arithmetic shift,
    carried in int64 with explicit 32-bit wrapping."""
    n = ((ix * 374761393 + iz * 668265263) & MASK32) ^ 1274126177
    s = n - ((n >> 31) << 32)              # the int32 value of the word
    n = ((n ^ ((s >> 13) & MASK32)) * 1103515245) & MASK32
    s = n - ((n >> 31) << 32)
    return fdiv(((s >> 8) & 0xFFFF).to(_F32), 65535.0)


def vnoise2(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Deterministic 2-D value noise (hash lattice + smoothstep)."""
    xi = torch.floor(x)
    zi = torch.floor(z)
    xf = x - xi
    zf = z - zi
    ix0, ix1, iz0, iz1 = _f2i(xi), _f2i(xi + 1.0), _f2i(zi), _f2i(zi + 1.0)
    sx = xf * xf * (3 - 2 * xf)
    sz = zf * zf * (3 - 2 * zf)
    a = _lattice(ix0, iz0) * (1 - sx) + _lattice(ix1, iz0) * sx
    b = _lattice(ix0, iz1) * (1 - sx) + _lattice(ix1, iz1) * sx
    return a * (1 - sz) + b * sz


def _sky_rgb(a: ShadeArgs, dy):
    t = torch.clamp(0.5 * (dy + 1.0), 0.0, 1.0)
    return [h * (1 - t) + z * t for h, z in zip((0.95, 0.97, 1.0), a.zenith)]


def _env_sample(a: ShadeArgs, dx, dy, dz):
    if a.env_rgb is not None:
        return env_radiance(a.env, dx, dy, dz)
    return [c * a.ibl_intensity for c in _sky_rgb(a, dy)]


def _cloud_shadow(a: ShadeArgs, px, pz):
    sc = a.cloud_scale
    tshift = f32(np.float32(a.time) * np.float32(0.02))
    n = 0.65 * vnoise2(px * sc + tshift, pz * sc) + 0.35 * vnoise2(
        px * sc * 2.7 + 13.7 + f32(np.float32(tshift) * np.float32(1.7)), pz * sc * 2.7)
    cov = torch.clamp(fdiv(n - f32(np.float32(1.0) - np.float32(a.cloud_coverage)),
                           max(a.cloud_coverage, f32(1e-4))), 0.0, 1.0)
    return 1.0 - a.cloud_strength * cov


def camera_rays_r1(a: ShadeArgs, jx, jy):
    """renderer.py:726-736: cx * right + cy * up + fwd, normalised once."""
    W, H = a.width, a.height
    dev = jx.device
    xs = torch.arange(W, dtype=_F32, device=dev).expand(H, W)
    ys = torch.arange(H, dtype=_F32, device=dev)[:, None].expand(H, W)
    ndc_x = fdiv(xs + 0.5 + jx, float(W)) * 2.0 - 1.0
    ndc_y = (1.0 - fdiv(ys + 0.5 + jy, float(H))) * 2.0 - 1.0
    cx = ndc_x * a.aspect * a.half_h
    cy = ndc_y * a.half_h
    d = [cx * a.right[k] + cy * a.up[k] + a.fwd[k] for k in range(3)]
    inv = rsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return d[0] * inv, d[1] * inv, d[2] * inv


def _trace_where(scene: TerrainScene, mask, o, d, tmax=1e30):
    """Hit mask of the rays traced where `mask` holds (False elsewhere):
    the other rays' results are never read."""
    sel = torch.nonzero(mask.reshape(-1)).squeeze(1)
    hit = torch.zeros(mask.numel(), dtype=torch.bool, device=mask.device)
    if sel.numel():
        h = trace_plain(scene, [c.reshape(-1)[sel] for c in o],
                        [c.reshape(-1)[sel] for c in d], tmax=tmax)
        hit[sel] = h.hit
    return hit.reshape(mask.shape)


def _surface_albedo(a: ShadeArgs, hn):
    if a.use_colormap:
        rgb = colormaps.sample_lut(a.lut, hn)
        cs = a.colormap_strength
        one_minus = np.float32(1.0) - np.float32(cs)
        return [c * cs + f32(np.float32(k) * one_minus) for c, k in zip(rgb, a.constant_albedo)]
    return [torch.full_like(hn, k) for k in a.constant_albedo]


def _vt_resolve(a: ShadeArgs, hit, t, px, pz, alb):
    """renderer.py:833-871: the albedo from the VT atlas where the hit's
    page is resident. Returns (albedo, fallback mask: terrain hits whose
    page is not resident). A missed ray's indices are never used."""
    dev = t.device
    levels = a.vt_levels
    page = a.vt_page
    foot = t * a.vt_pix_angle
    des = torch.log2(torch.clamp(foot * a.vt_tpw0, min=1e-9))
    lvl = torch.clamp(torch.round(des), levels[0], levels[-1])
    li = (lvl - levels[0]).to(torch.int64)
    listed = li < len(levels)   # past the list jnp.take fills INT_MIN: no page
    li = torch.clamp(li, max=len(levels) - 1)
    ntl = torch.as_tensor(a.vt_tiles, dtype=torch.int64, device=dev)[li]
    offs = torch.as_tensor(a.vt_offs, dtype=torch.int64, device=dev)[li]
    ntl_f = ntl.to(_F32)
    uu = torch.clamp(px * a.vt_inv_span, 0.0, 0.999999)
    vv = torch.clamp(pz * a.vt_inv_span, 0.0, 0.999999)
    gx = uu * ntl_f * page
    gz = vv * ntl_f * page
    tx = torch.floor(uu * ntl_f).to(torch.int64)
    tz = torch.floor(vv * ntl_f).to(torch.int64)
    tix = torch.clamp(gx - tx.to(_F32) * page, 0, page - 1).to(torch.int64)
    tiz = torch.clamp(gz - tz.to(_F32) * page, 0, page - 1).to(torch.int64)
    ok = hit & listed
    slot = a.vt_table.to(torch.int64)[torch.where(ok, offs + tz * ntl + tx, 0)]
    resident = ok & (slot >= 0)
    addr = torch.where(resident, slot * (page * page) + tiz * page + tix, 0)
    texel = a.vt_atlas[addr]
    alb = [torch.where(resident, texel[..., k], c) for k, c in enumerate(alb)]
    return alb, hit & ~resident


def shade_plain(scene: TerrainScene, a: ShadeArgs, jx, jy, st):
    """Plain PyTorch version of one sample of R1 for every pixel
    (renderer.py:_make_shade.shade). st: int64-held u32 random state per
    pixel. Returns ((r, g, b), st, aux) with aux the sample's record: hit,
    t (water's where water is in front), normal and albedo."""
    dx, dy, dz = camera_rays_r1(a, jx, jy)
    shape = dx.shape
    o = tuple(torch.full(shape, c, dtype=_F32, device=dx.device) for c in a.cam_o)
    ox, oy, oz = o
    hit = trace_plain(scene, o, (dx, dy, dz))
    t = hit.t
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    nx, ny, nz = normal_at(scene, (px, py, pz), hit.cell_x, hit.cell_z)
    hrange = max(f32(np.float32(a.hmax) - np.float32(a.hmin)), f32(1e-6))

    if a.pom_on or a.det_on or a.tri_on:
        dfreq = f32(np.float32(a.det_scale) / np.float32(hrange))
    pxs, pzs = px, pz
    if a.pom_on:
        hdet = (vnoise2(px * dfreq, pz * dfreq) - 0.5) * a.pom_scale
        pxs, pzs = px - dx * hdet, pz - dz * hdet
    if a.det_on or a.tri_on:
        d_top = vnoise2(pxs * dfreq, pzs * dfreq)
        if a.tri_on:
            wx, wy, wz = (torch.pow(c.abs(), a.tri_sharp) for c in (nx, ny, nz))
            wsum = torch.clamp(wx + wy + wz, min=1e-6)
            d_x = vnoise2(py * dfreq * a.tri_scale, pzs * dfreq * a.tri_scale)
            d_z = vnoise2(pxs * dfreq * a.tri_scale, py * dfreq * a.tri_scale)
            detail = (wx * d_x + wy * d_top + wz * d_z) / wsum
        else:
            detail = d_top
        dist_fade = torch.clamp(1.0 - fdiv(t, a.det_fade), 0.0, 1.0)
    if a.det_on:  # detail normals, reoriented onto the geometric normal
        eps_d = f32(np.float32(0.5) / np.float32(dfreq))
        two_eps = f32(np.float32(2.0) * np.float32(eps_d))
        gdx = fdiv(vnoise2((pxs + eps_d) * dfreq, pzs * dfreq)
                   - vnoise2((pxs - eps_d) * dfreq, pzs * dfreq), two_eps)
        gdz = fdiv(vnoise2(pxs * dfreq, (pzs + eps_d) * dfreq)
                   - vnoise2(pxs * dfreq, (pzs - eps_d) * dfreq), two_eps)
        s_d = a.det_strength * dist_fade
        gx, gz = gdx * s_d, gdz * s_d
        tinv = rsqrt(1.0 + gx * gx + gz * gz)
        tnx, tny, tnz = -gdx * s_d * tinv, tinv, -gdz * s_d * tinv
        qx, qy, qz = nx, ny + 1.0, nz
        qdot = qx * tnx + qy * tny + qz * tnz
        qy_safe = torch.clamp(qy, min=1e-4)
        bn = [q * qdot / qy_safe - tn for q, tn in ((qx, tnx), (qy, tny), (qz, tnz))]
        binv = rsqrt(bn[0] * bn[0] + bn[1] * bn[1] + bn[2] * bn[2])
        nx, ny, nz = bn[0] * binv, bn[1] * binv, bn[2] * binv

    # albedo
    hn = torch.clamp(fdiv(py - a.hmin, hrange), 0.0, 1.0)
    if a.curve_mode == CURVES["pow"]:
        hn = torch.pow(hn, a.curve_power)
    elif a.curve_mode == CURVES["smoothstep"]:
        sm = hn * hn * (3.0 - 2.0 * hn)
        hn = hn + (sm - hn) * a.curve_strength
    alb = _surface_albedo(a, hn)
    vt_miss = None
    if a.vt_atlas is not None:
        alb, vt_miss = _vt_resolve(a, hit.hit, t, px, pz, alb)
    if a.layers_on:
        snow = torch.clamp(fdiv(hn - a.snow_h, a.snow_blend), 0.0, 1.0) \
            * torch.clamp(fdiv(ny - 0.6, 0.4), 0.0, 1.0)
        rock = torch.clamp(fdiv(a.rock_cos - ny, a.rock_blend) + 1.0, 0.0, 1.0) \
            * (ny < a.rock_cos).to(_F32)
        alb = [c * (1 - rock) + k * rock for c, k in zip(alb, a.rock_rgb)]
        alb = [c * (1 - snow) + k * snow for c, k in zip(alb, a.snow_rgb)]
    if a.det_on:
        mod = 1.0 + a.det_strength * (detail - 0.5) * dist_fade
        alb = [c * mod for c in alb]

    # sun term and visibility
    sd = a.sun
    ndl = torch.clamp(nx * sd[0] + ny * sd[1] + nz * sd[2], min=0.0)
    ndl = ndl + (ndl * ndl * (3.0 - 2.0 * ndl) - ndl) * a.lambert_contrast
    vis = torch.ones_like(ndl)
    if a.shadow_samples:
        acc = torch.zeros_like(ndl)
        sro = [p + n * 1e-3 + f32(np.float32(s) * np.float32(a.shadow_bias))
               for p, n, s in zip((px, py, pz), (nx, ny, nz), sd)]
        for _ in range(a.shadow_samples):
            if a.shadow_samples > 1:  # a direction jittered in the sun's cone
                st, u1 = xorshift32(st)
                st, u2 = xorshift32(st)
                full = [torch.full_like(ndl, c) for c in sd]
                cdir = cosine_dir(*full, u1, u2)
                jd = [s + (c - s) * a.shadow_softness for s, c in zip(sd, cdir)]
                jinv = rsqrt(jd[0] * jd[0] + jd[1] * jd[1] + jd[2] * jd[2])
                sdir = [c * jinv for c in jd]
            else:
                sdir = [torch.full_like(ndl, c) for c in sd]
            occ = _trace_where(scene, hit.hit, sro, sdir)
            acc = acc + torch.where(occ, 0.0, 1.0)
        vis = fdiv(acc, float(a.shadow_samples))
        vis = 1.0 - a.shadow_intensity * (1.0 - vis)
    if a.clouds_on:
        vis = vis * _cloud_shadow(a, px, pz)

    # ambient, height AO, IBL
    ao = torch.ones_like(ndl)
    if a.ao_samples:
        occf = torch.zeros_like(ndl)
        aro = (px + nx * 1e-3, py + ny * 1e-3, pz + nz * 1e-3)
        for _ in range(a.ao_samples):
            st, u1 = xorshift32(st)
            st, u2 = xorshift32(st)
            adir = cosine_dir(nx, ny, nz, u1, u2)
            occ = _trace_where(scene, hit.hit, aro, adir, tmax=a.ao_radius)
            occf = occf + torch.where(occ, 1.0, 0.0)
        ao = 1.0 - fdiv(a.ao_strength * occf, float(a.ao_samples))
    ao_mix = 1.0 + (ao - 1.0) * a.ao_mix_weight
    env = _env_sample(a, nx, ny, nz)
    lit = ndl * vis
    r, g, b = (c * (s * lit + (am + e) * ao_mix)
               for c, s, am, e in zip(alb, a.sun_rgb, a.ambient_rgb, env))

    # water plane
    hit_any = hit.hit
    if a.water_on:
        twp = fdiv(a.water_level - oy, torch.where(dy.abs() > 1e-7, dy, 1e-7))
        water_first = (twp > 0) & (twp < t)
        wx, wz = ox + twp * dx, oz + twp * dz
        cosv = torch.clamp(-dy, 0.0, 1.0)
        fres = 0.02 + 0.98 * torch.pow(1.0 - cosv, 5.0)
        sky = list(_env_sample(a, dx, dy.abs(), dz))
        refl = a.water_reflectivity
        if a.wrefl_on:  # planar reflection, traced where water is in front
            sel = torch.nonzero(water_first.reshape(-1)).squeeze(1)
            if sel.numel():
                pick = lambda c: c.reshape(-1)[sel]  # noqa: E731
                rdx, rdy, rdz = pick(dx), pick(dy).abs(), pick(dz)
                rwx, rwz = pick(wx), pick(wz)
                ry0 = torch.full_like(rwx, f32(np.float32(a.water_level) + np.float32(1e-3)))
                rh = trace_plain(scene, (rwx, ry0, rwz), (rdx, rdy, rdz))
                rp = (rwx + rh.t * rdx, a.water_level + rh.t * rdy, rwz + rh.t * rdz)
                rn = normal_at(scene, rp, rh.cell_x, rh.cell_z)
                rhn = torch.clamp(fdiv(rp[1] - a.hmin, hrange), 0.0, 1.0)
                if a.use_colormap:
                    ralb = colormaps.sample_lut(a.lut, rhn)
                else:
                    ralb = [torch.full_like(rhn, k) for k in a.constant_albedo]
                rndl = torch.clamp(rn[0] * sd[0] + rn[1] * sd[1] + rn[2] * sd[2], min=0.0)
                for k in range(3):
                    tr = ralb[k] * (a.sun_rgb[k] * rndl + a.ambient_rgb[k]) * a.refl_intensity
                    flat = sky[k].reshape(-1).clone()
                    flat[sel] = torch.where(rh.hit, tr, flat[sel])
                    sky[k] = flat.reshape(shape)
        glint = torch.pow(torch.clamp(dx * sd[0] + dy.abs() * sd[1] + dz * sd[2], min=0.0), 64.0)
        water = [w * (1 - fres) + s * fres * refl * 4.0 + glint * sr * refl
                 for w, s, sr in zip(a.water_rgb, sky, a.sun_rgb)]
        r, g, b = (torch.where(water_first, w, c) for w, c in zip(water, (r, g, b)))
        t = torch.where(water_first, twp, t)
        hit_any = hit_any | water_first

    if a.fog_on:
        dist = torch.clamp(t - a.fog_start, min=0.0)
        dens = a.fog_density * torch.exp(-a.fog_falloff * torch.clamp(py, min=0.0))
        fogf = 1.0 - torch.exp(-dens * dist)
        r, g, b = (c + (f - c) * fogf for c, f in zip((r, g, b), a.fog_rgb))
    sky_c = _sky_rgb(a, dy)
    r, g, b = (torch.where(hit_any, c, s) for c, s in zip((r, g, b), sky_c))
    return (r, g, b), st, {"hit": hit.hit, "t": t, "n": (nx, ny, nz), "albedo": tuple(alb),
                           "vt_miss": vt_miss}


def _pixel_grid(a: ShadeArgs, dev):
    xs = torch.arange(a.width, device=dev).expand(a.height, a.width)
    ys = torch.arange(a.height, device=dev)[:, None].expand(a.height, a.width)
    return xs, ys


def _aovs(aux) -> Dict[str, torch.Tensor]:
    """renderer.py:1096-1099: albedo and normal times the hit mask, depth
    NaN off the terrain, visibility the mask."""
    m = aux["hit"].to(_F32)
    return {
        "albedo": torch.stack(aux["albedo"], -1) * m[..., None],
        "normal": torch.stack(aux["n"], -1) * m[..., None],
        "depth": torch.where(aux["hit"], aux["t"], float("nan")),
        "visibility": m,
    }


def _encode(a: ShadeArgs, hdr, n):
    """The tonemap and the sRGB or gamma encode (renderer.py:1073-1086)."""
    if a.debug_normals:
        return torch.stack(n, -1) * 0.5 + 0.5
    mode = TONEMAPS[a.tonemap]
    if mode == "off":
        ldr = torch.clamp(hdr * a.exposure, 0.0, 1.0)
    elif mode == "reinhard_extended":
        ldr = tm.reinhard_extended(hdr, a.exposure, a.white_point)
    else:
        ldr = tm.apply(mode, hdr, exposure=a.exposure)
    if a.srgb_out:
        return tm.srgb_eotf_inv(ldr)
    return torch.pow(torch.clamp(ldr, 0.0, 1.0), a.inv_gamma)


def render_plain(scene: TerrainScene, a: ShadeArgs) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of R1 render: `aa` samples per pixel, their
    mean, the tonemap, the u8 rgba and sample 0's AOVs."""
    dev = scene.device
    xs, ys = _pixel_grid(a, dev)
    st = seed_state(a.aa_seed, SEED_RENDER, xs, ys, 0)
    zero = torch.zeros((a.height, a.width), dtype=_F32, device=dev)
    acc = [zero, zero, zero]
    aux0 = None
    for k in range(a.aa):
        if a.aa > 1:
            st, u1 = xorshift32(st)
            st, u2 = xorshift32(st)
            jx, jy = u1 - 0.5, u2 - 0.5
        else:
            jx = jy = zero
        rgb, st, aux = shade_plain(scene, a, jx, jy, st)
        if k == 0:
            aux0 = aux
        acc = [s + c for s, c in zip(acc, rgb)]
    hdr = torch.stack([fdiv(c, float(a.aa)) for c in acc], -1)
    ldr = _encode(a, hdr, aux0["n"])
    rgba = torch.full((a.height, a.width, 4), 255, dtype=torch.uint8, device=dev)
    rgba[..., :3] = tm.to_u8(ldr).to(torch.uint8)
    out = {"rgba": rgba, "hdr": hdr, **_aovs(aux0)}
    if aux0["vt_miss"] is not None:
        out["vt_fallback"] = aux0["vt_miss"].sum()
    return out


def _render_kernel(scene: TerrainScene, a: ShadeArgs, want_aov: bool):
    dev = scene.device
    H, W = a.height, a.width
    empty = lambda *s: torch.empty((H, W, *s), dtype=_F32, device=dev)  # noqa: E731
    out = {"rgba": torch.empty((H, W, 4), dtype=torch.uint8, device=dev)}
    if want_aov:
        out.update(hdr=empty(3), albedo=empty(3), normal=empty(3), depth=empty(),
                   visibility=empty())
    if a.vt_atlas is not None:
        out["vt_fallback"] = torch.zeros((), dtype=torch.int32, device=dev)
    ptr = lambda k: out[k].data_ptr() if k in out else None  # noqa: E731
    planes = _kernels.TerrainOut(ptr("rgba"), ptr("hdr"), ptr("albedo"), ptr("normal"),
                                 ptr("depth"), ptr("visibility"), ptr("vt_fallback"))
    err = _kernels.lib().f3d_terrain_render(scene.kernel_args(), a.kernel_args(), planes,
                                            _kernels.stream_ptr(dev))
    _kernels.check(err, "R1 render")
    render_program.launches += 1
    return out


def render_program(scene: TerrainScene, a: ShadeArgs, want_aov: bool = True):
    """One render of R1: {"rgba": (H, W, 4) u8, and with want_aov "hdr",
    "albedo", "normal", "depth", "visibility"; with a VT atlas the fallback
    count "vt_fallback"} as tensors on the scene's device. CPU scenes run
    `render_plain`; CUDA scenes launch the kernel."""
    if scene.device.type == "cpu":
        return render_plain(scene, a)
    return _render_kernel(scene, a, want_aov)


render_program.launches = 0


def tile_means_plain(lum: torch.Tensor) -> torch.Tensor:
    """Mean luminance per 32x32 tile, the image padded by replicating its
    last row and column (renderer.py:1144-1148)."""
    H, W = lum.shape
    th, tw = -(-H // TILE), -(-W // TILE)
    rows = torch.clamp(torch.arange(th * TILE, device=lum.device), max=H - 1)
    cols = torch.clamp(torch.arange(tw * TILE, device=lum.device), max=W - 1)
    return lum[rows][:, cols].reshape(th, TILE, tw, TILE).mean(dim=(1, 3))


def tile_means_ordered(lum: torch.Tensor) -> torch.Tensor:
    """The tile means in R1 step's summation order (csrc/terrain_shade.cuh:
    tile_partial, tile_mean_serial): per tile, partial sums j = 0..255 over
    the elements j, j + 256, j + 512, j + 768 (row-major in the tile), then
    a halving tree, then / 1024; float32 throughout."""
    H, W = lum.shape
    th, tw = -(-H // TILE), -(-W // TILE)
    rows = torch.clamp(torch.arange(th * TILE, device=lum.device), max=H - 1)
    cols = torch.clamp(torch.arange(tw * TILE, device=lum.device), max=W - 1)
    e = lum[rows][:, cols].reshape(th, TILE, tw, TILE).permute(0, 2, 1, 3).reshape(th, tw, -1)
    part = torch.zeros((th, tw, 256), dtype=_F32, device=lum.device)
    for q in range(TILE * TILE // 256):
        part = part + e[..., 256 * q:256 * (q + 1)]
    w = 128
    while w:
        part = torch.cat([part[..., :w] + part[..., w:2 * w], part[..., 2 * w:]], -1)
        w //= 2
    return part[..., 0] / float(TILE * TILE)


def step_plain(scene: TerrainScene, a: ShadeArgs, accum: torch.Tensor, sample_idx: int):
    """Plain PyTorch version of R1 step: one jittered sample added to the
    (H, W, 4) accumulator. Returns (accum, tile means, the sample's AOVs);
    the input accumulator is not modified."""
    xs, ys = _pixel_grid(a, accum.device)
    st = seed_state(a.aa_seed, SEED_STEP, xs, ys, 0) ^ ((int(sample_idx) * 92837111) & MASK32)
    st, u1 = xorshift32(st)
    st, u2 = xorshift32(st)
    (r, g, b), st, aux = shade_plain(scene, a, u1 - 0.5, u2 - 0.5, st)
    accum = accum + torch.stack([r, g, b, torch.ones_like(r)], dim=-1)
    mean = accum[..., :3] / accum[..., 3:4]
    lum = luminance(mean[..., 0], mean[..., 1], mean[..., 2])
    return accum, tile_means_plain(lum), _aovs(aux)


def _step_kernel(scene: TerrainScene, a: ShadeArgs, accum: torch.Tensor, sample_idx: int):
    H, W = a.height, a.width
    if tuple(accum.shape) != (H, W, 4) or accum.dtype != _F32:
        raise ValueError(f"offline_step: accum must be float32 ({H}, {W}, 4)")
    _kernels.require_cuda("offline_step", accum)
    dev = accum.device
    lum = torch.empty((H, W), dtype=_F32, device=dev)
    tiles = torch.empty((-(-H // TILE), -(-W // TILE)), dtype=_F32, device=dev)
    aov = {k: torch.empty((H, W, *s), dtype=_F32, device=dev)
           for k, s in (("albedo", (3,)), ("normal", (3,)), ("depth", ()), ("visibility", ()))}
    planes = _kernels.TerrainOut(None, None, *(aov[k].data_ptr() for k in aov))
    err = _kernels.lib().f3d_terrain_step(
        scene.kernel_args(), a.kernel_args(), _kernels.ptr(accum), int(sample_idx) & MASK32,
        _kernels.ptr(lum), planes, _kernels.ptr(tiles), _kernels.stream_ptr(dev))
    _kernels.check(err, "R1 step")
    offline_step.launches += 1
    return accum, tiles, aov


def offline_step(scene: TerrainScene, a: ShadeArgs, accum: torch.Tensor, sample_idx: int):
    """One offline accumulation sample (kernel R1 step, with its tile-mean
    reduction). Returns (accum, (ceil(H/32), ceil(W/32)) tile means, the
    sample's AOVs). On CUDA the kernel adds into `accum` in place and
    returns it; on the CPU the plain version returns a new tensor."""
    if accum.device.type == "cpu":
        return step_plain(scene, a, accum, sample_idx)
    return _step_kernel(scene, a, accum, sample_idx)


offline_step.launches = 0


# ---------------------------------------------------------------------------
# The renderer
# ---------------------------------------------------------------------------


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class TerrainRenderer:
    """Offscreen PBR terrain renderer (kernel R1). `device="cuda"` (the
    default) renders on the card and raises DeviceError without CUDA;
    "cpu" runs the plain PyTorch versions. `session` is accepted for the
    JAX package's signature and not used."""

    def __init__(self, session=None, *, device="cuda"):
        from ..pt.terrain_ref import resolve_device

        self.device = resolve_device(device)
        self._session = session
        self._scene_cache: Dict[tuple, tuple] = {}
        self._offline = None
        self.last_consumed_settings: tuple = ()
        self.last_ignored_settings: tuple = ()
        self.last_gpu_timings: Dict[str, float] = {}

    @staticmethod
    def _settings_report(p, has_env: bool, has_water_mask: bool, has_vt: bool):
        """(consumed, ignored) settings-group names for this render:
        `consumed` mirrors the shading's gating conditions, `ignored` lists
        groups the caller enabled that this path does not read."""
        consumed = ["light", "sampling", "tonemap", "camera", "colormap"]
        ignored = []
        if p.ibl.enabled:
            consumed.append("ibl")
        if p.shadows.enabled:
            consumed.append("shadows")
        if p.triplanar is not None and p.triplanar.enabled:
            consumed.append("triplanar")
        if p.pom is not None and p.pom.enabled and float(p.pom.scale) > 0:
            consumed.append("pom")
        if p.fog is not None and p.fog.enabled:
            consumed.append("fog")
        water_on = p.water is not None and p.water.enabled
        if water_on:
            consumed.append("water")
        if water_on and p.reflection is not None and p.reflection.enabled:
            consumed.append("reflection")
        elif p.reflection is not None and p.reflection.enabled:
            ignored.append("reflection")   # needs water enabled
        if p.clouds is not None and p.clouds.enabled:
            consumed.append("clouds")
        if p.detail is not None and p.detail.enabled:
            consumed.append("detail")
        if p.height_ao is not None and p.height_ao.enabled:
            consumed.append("height_ao")
        if p.material_layers is not None and p.material_layers.enabled:
            consumed.append("material_layers")
        if has_vt:
            consumed.append("vt")
        if p.height_curve_mode != "linear":
            consumed.append("height_curve")
        if p.sun_visibility is not None and getattr(p.sun_visibility, "enabled", False):
            ignored.append("sun_visibility")
        if getattr(p.lod, "enabled", False):
            ignored.append("lod")
        return tuple(sorted(consumed)), tuple(sorted(ignored))

    # -- scene prep --------------------------------------------------------
    def _scene_for(self, heightmap: np.ndarray, span: float, z_scale: float):
        hm = np.ascontiguousarray(np.asarray(heightmap, np.float32))
        key = (hm.shape, float(span), float(z_scale), hash(hm.tobytes()))
        if key in self._scene_cache:
            return self._scene_cache[key]
        h, w = hm.shape
        spacing = (span / (w - 1), span / (h - 1)) if span > 0 else (1.0, 1.0)
        pyr = build_pyramid(hm)
        scene = scene_from_pyramid(pyr, origin_xz=(0.0, 0.0), spacing_xz=spacing,
                                   exaggeration=z_scale, device=self.device)
        tracker = global_tracker()
        rid = tracker.track(f"terrain.pyramid{hm.shape}", pyr.nbytes, "pyramid")
        entry = (scene, spacing, float(hm.min()), float(hm.max()), rid)
        if len(self._scene_cache) > 4:  # keep the ledger bounded
            old = self._scene_cache.pop(next(iter(self._scene_cache)))
            tracker.free(old[-1])
        self._scene_cache[key] = entry
        return entry

    @staticmethod
    def _vt_residency(vt, p: TerrainRenderParams, span, W, H, *, budget: int) -> dict:
        """renderer.py:_vt_residency on the host: pick the albedo pages whose
        mip level matches their footprint from this camera, decode them under
        the budget into atlas slots and build the page table. Returns the
        filled slots (n, page, page, 3) float32, the table and the level
        geometry."""
        from .vt import PAGE_SIZE

        levels = sorted({k[1] for k in vt.index if k[0] == "albedo"})
        if not levels:
            raise UploadError("VT store has no albedo pages")
        if len(levels) > _kernels.VT_MAX_LEVELS:
            raise NotImplementedError(f"a VT store of {len(levels)} albedo levels: R1 takes at "
                                      f"most {_kernels.VT_MAX_LEVELS}")
        tiles = []
        for lv in levels:
            n = max(k[2] for k in vt.index if k[0] == "albedo" and k[1] == lv) + 1
            tiles.append(int(n))
        level_offs = []
        acc = 0
        for n in tiles:
            level_offs.append(acc)
            acc += n * n
        capacity = max(int(budget) // (PAGE_SIZE * PAGE_SIZE * 3 * 4), 1)

        origin = orbit_camera_origin(p.cam_target, p.cam_radius, p.cam_phi_deg, p.cam_theta_deg)
        pix_angle = 2.0 * math.tan(math.radians(p.fov_y_deg) * 0.5) / H
        tpw0 = tiles[0] * PAGE_SIZE / max(span, 1e-6)

        # desired level per candidate page from its centre's distance
        cands = []
        for li, lv in enumerate(levels):
            n = tiles[li]
            for (kind, lvv, x, y) in vt.index:
                if kind != "albedo" or lvv != lv:
                    continue
                cx = (x + 0.5) / n * span
                cz = (y + 0.5) / n * span
                d = math.dist((cx, 0.0, cz), (origin[0], origin[1], origin[2]))
                desired = math.log2(max(d * pix_angle * tpw0, 1e-9))
                # the shader clamps per-pixel levels into the pyramid range
                desired = min(max(desired, levels[0]), levels[-1])
                cands.append((abs(desired - lv), d, li, x, y))
        cands.sort()
        table = np.full(acc, -1, np.int32)
        pages = []
        for prio, d, li, x, y in cands:
            if len(pages) >= capacity or prio > 1.0:
                break
            rgb = np.asarray(vt.request("albedo", levels[li], x, y), np.float32)
            if rgb.max() > 1.5:
                rgb = rgb / 255.0
            table[level_offs[li] + y * tiles[li] + x] = len(pages)
            pages.append(rgb[..., :3])
        if not pages:   # no page resident: the atlas is never read
            pages.append(np.zeros((PAGE_SIZE, PAGE_SIZE, 3), np.float32))
        return dict(atlas=np.stack(pages), table=table, levels=tuple(levels), tiles=tuple(tiles),
                    offs=tuple(level_offs), page=PAGE_SIZE, pix_angle=pix_angle, tpw0=tpw0,
                    inv_span=1.0 / max(span, 1e-6))

    def _with_vt(self, p: TerrainRenderParams, args: ShadeArgs, material_set, span: float):
        """`args` with the VT atlas and page table of `material_set`'s store
        on the device, or `args` itself without a store."""
        vt = getattr(material_set, "vt_store", None) if material_set is not None else None
        if vt is None:
            return args
        r = self._vt_residency(vt, p, span, args.width, args.height,
                               budget=getattr(material_set, "vt_budget_bytes", 64 * 1024 * 1024))
        atlas = np.ascontiguousarray(r["atlas"].reshape(-1, 3))
        return dataclasses.replace(
            args, vt_atlas=torch.as_tensor(atlas, device=self.device),
            vt_table=torch.as_tensor(r["table"], device=self.device), vt_levels=r["levels"],
            vt_tiles=r["tiles"], vt_offs=r["offs"], vt_page=r["page"],
            vt_pix_angle=f32(r["pix_angle"]), vt_tpw0=f32(r["tpw0"]),
            vt_inv_span=f32(r["inv_span"]))

    def _lut(self, p: TerrainRenderParams) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(colormaps.get_lut(p.colormap), np.float32),
                               device=self.device)

    def _env_tensor(self, env_map) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(np.asarray(env_map, np.float32)),
                               device=self.device)

    # -- public API --------------------------------------------------------
    def render_terrain_pbr_pom(
        self, material_set=None, env_maps=None, params=None, heightmap=None,
        target=None, water_mask=None, time_seconds=0.0, certificate=None,
        cache=None,
    ) -> Frame:
        if target is not None:
            raise RenderError(
                "Custom render targets not supported; use target=None for "
                "offscreen rendering."
            )
        if self.offline_session_active():
            raise RenderError(
                "An offline accumulation session is active; call "
                "end_offline_accumulation() before one-shot rendering."
            )
        if cache is not None and certificate is None:
            raise NotImplementedError("the anamnesis render cache (cache=) is "
                                      + _NOT_PORTED.format(13))
        frame, _ = self._render(material_set, env_maps, params, heightmap,
                                water_mask, time_seconds, want_aov=False)
        self.last_anamnesis_report = {}
        if certificate is not None:
            from ..assurance.certificate import emit_certificate

            emit_certificate(certificate, "render_terrain_pbr_pom",
                             {"frames": 1, "rgba": frame.rgba})
        return frame

    def render_with_aov(
        self, material_set=None, env_maps=None, params=None, heightmap=None,
        water_mask=None, time_seconds=0.0, certificate=None, cache=None,
    ) -> Tuple[Frame, AovFrame]:
        frame, aov = self._render(material_set, env_maps, params, heightmap,
                                  water_mask, time_seconds, want_aov=True)
        if certificate is not None:
            from ..assurance.certificate import emit_certificate

            emit_certificate(certificate, "render_with_aov",
                             {"frames": 1, "rgba": frame.rgba})
        return frame, aov

    # -- core --------------------------------------------------------------
    def render_inputs(self, params=None, heightmap=None, env_maps=None, water_mask=None,
                      time_seconds=0.0, material_set=None, *, offline=False):
        """Validate a render's inputs and prepare what kernel R1 takes:
        (params, scene, ShadeArgs, has_env). The scene (pyramid on the
        device) is cached per heightmap; a one-shot render's IBL without a
        map bakes the Hosek sky through kernel E5. `offline=True` prepares
        the offline session as the JAX package's does: it checks the
        heightmap and the water mask no further, bakes no sky, and renders
        the perspective shade whatever camera_mode or material_set ask. A
        one-shot render's material_set with a VT store adds its atlas and page
        table (the residency pass) to the ShadeArgs."""
        p, scene, args, has_env, span = self._inputs(params, heightmap, env_maps, water_mask,
                                                     time_seconds, offline)
        if not offline:
            args = self._with_vt(p, args, material_set, span)
        return p, scene, args, has_env

    def _inputs(self, params, heightmap, env_maps, water_mask, time_seconds, offline):
        """render_inputs without the VT store: (params, scene, ShadeArgs,
        has_env, span)."""
        if offline:
            if heightmap is None:
                raise UploadError("heightmap is required")
            p = params if params is not None else make_terrain_params()
            p.validate()
            hm = np.asarray(heightmap, np.float32)
        else:
            p, hm = self._checked(params, heightmap)
        env: IBL = env_maps if env_maps is not None else IBL.default()

        W = max(1, int(round(p.size_px[0] * p.render_scale)))
        H = max(1, int(round(p.size_px[1] * p.render_scale)))
        span = p.terrain_span if p.terrain_span > 0 else float(hm.shape[1] - 1)
        scene, _, hmin, hmax, _ = self._scene_for(hm, span, p.z_scale)

        has_env = p.ibl.enabled and (p.ibl.env_map is not None or env.env_map is not None)
        env_rgb = None
        if has_env:
            env_rgb = self._env_tensor(p.ibl.env_map if p.ibl.env_map is not None
                                       else env.env_map)
        elif not offline and p.ibl.enabled and getattr(p.ibl, "sky_model", "hosek") == "hosek":
            # the analytic Hosek-Wilkie sky (kernel E5) as the environment
            from ..sky import hosek_environment_tensor

            env_rgb = hosek_environment_tensor(
                p.light.azimuth_deg, p.light.elevation_deg, turbidity=p.ibl.turbidity,
                ground_albedo=p.ibl.ground_albedo, width=128, height=64, device=self.device)
            has_env = True
        if water_mask is not None and not offline:
            wm = np.asarray(water_mask, np.float32)
            if wm.shape != hm.shape:
                raise UploadError("water_mask must match heightmap shape")
        args = make_shade_args(p, hm.shape, span, hmin, hmax, W, H, time_seconds,
                               self._lut(p), env_rgb)
        return p, scene, args, has_env, span

    @staticmethod
    def _checked(params, heightmap):
        """(params, float32 heightmap) of a one-shot render, validated."""
        if heightmap is None:
            raise UploadError("heightmap is required")
        p = params if params is not None else make_terrain_params()
        p.validate()
        hm = np.asarray(heightmap, np.float32)
        if hm.ndim != 2 or hm.shape[0] < 2 or hm.shape[1] < 2:
            raise UploadError("heightmap must be 2D, at least 2x2")
        if not np.isfinite(hm).all():
            raise UploadError("heightmap contains non-finite values")
        return p, hm

    def _render(self, material_set, env_maps, params, heightmap, water_mask,
                time_seconds, want_aov: bool):
        p, hm = self._checked(params, heightmap)
        if p.camera_mode == "screen":
            return self._render_screen(p, hm, env_maps, water_mask, want_aov)
        t0 = time.perf_counter()
        p, scene, args, has_env, span = self._inputs(params, heightmap, env_maps, water_mask,
                                                     time_seconds, False)
        W, H = args.width, args.height
        _sync(self.device)
        t_scene = time.perf_counter()
        args = self._with_vt(p, args, material_set, span)
        vt = args.vt_atlas is not None
        self.last_consumed_settings, self.last_ignored_settings = \
            self._settings_report(p, has_env, water_mask is not None, vt)
        _sync(self.device)
        t_prep = time.perf_counter()
        out = render_program(scene, args, want_aov)
        vt_fallback = float(out["vt_fallback"]) if vt else 0.0   # synchronises
        _sync(self.device)
        t_exec = time.perf_counter()
        if vt:
            self.last_vt_stats = {**material_set.vt_store.stats(),
                                  "fallback_texels_frame": vt_fallback}
        rgba = out["rgba"].cpu().numpy()
        aovs = None
        if want_aov:
            aovs = {k: out[k].cpu().numpy() for k in ("albedo", "normal", "depth", "visibility",
                                                      "hdr")}
        t_read = time.perf_counter()
        ms = (t_read - t0) * 1000.0
        self.last_gpu_timings = {
            "terrain_main_pass_ms": (t_exec - t_prep) * 1000.0,
            "prepare_ms": (t_scene - t0) * 1000.0,
            "vt_residency_ms": (t_prep - t_scene) * 1000.0,
            "readback_ms": (t_read - t_exec) * 1000.0,
            "total_ms": ms,
        }
        from ..assurance.certificate import current_capture

        cap = current_capture()
        if cap is not None:
            for name, v in self.last_gpu_timings.items():
                if name != "total_ms":
                    cap.record_pass(name, v)
        meta = {
            "width": W, "height": H, "aa_samples": p.sampling.aa_samples,
            "albedo_mode": p.albedo_mode, "tonemap": p.tonemap.mode,
            "render_ms": ms, "gpu_timings": dict(self.last_gpu_timings),
        }
        frame = Frame(rgba=rgba, metadata=meta)
        aov_frame = AovFrame(aovs=aovs, metadata=meta) if want_aov else None
        return frame, aov_frame

    @staticmethod
    def screen_inputs(p: TerrainRenderParams, hm, env_maps=None, water_mask=None):
        """The screen engine's arguments for params `p` and heightmap `hm`,
        mapped as the JAX package's renderer.py:_render_screen (395) maps
        them: (lut, keyword arguments of screen.render_screen_tensors, output
        size)."""
        env: IBL = env_maps if env_maps is not None else IBL.default()
        env_rgb = p.ibl.env_map if p.ibl.env_map is not None else env.env_map
        if env_rgb is None:
            # product default: the reference MapScene's minimal clear-sky
            # Radiance env (2x2 constant (180, 190, 205) @ e=128 -> byte/256)
            env_rgb = np.full((2, 2, 3), 0.0, np.float32)
            env_rgb[:] = np.array([180.0, 190.0, 205.0], np.float32) / 256.0
        dom = p.domain
        if dom is None:
            dom = (float(hm.min()), float(hm.max()))
            if dom[0] == dom[1]:
                dom = (dom[0], dom[0] + 1.0)
        albedo_mode = p.albedo_mode
        material_albedo = None
        if albedo_mode == "constant":
            albedo_mode = "material"
            material_albedo = np.broadcast_to(np.asarray(p.constant_albedo, np.float32),
                                              (1, 1, 3))
        lut = np.asarray(colormaps.get_lut(p.colormap), np.float32)[:, :3]
        mats = None
        if p.material_layers is not None and p.material_layers.enabled:
            mats = p.material_layers.to_layer_dict()
        pom = None
        if p.pom is not None and p.pom.enabled and float(p.pom.scale) > 0.0:
            pom = p.pom.to_screen_cfg()
        refl = None
        if p.reflection is not None and p.reflection.enabled:
            refl = dict(enabled=True, intensity=float(p.reflection.intensity),
                        fresnel_power=float(p.reflection.fresnel_power),
                        wave_strength=float(p.reflection.wave_strength),
                        shore_atten_width=float(p.reflection.shore_atten_width),
                        water_plane_height=float(p.reflection.water_plane_height))
        sky = p.sky.to_dict_cfg() if p.sky is not None else None
        W_out, H_out = int(p.size_px[0]), int(p.size_px[1])
        W = max(1, int(round(W_out * p.render_scale)))
        H = max(1, int(round(H_out * p.render_scale)))
        span = p.terrain_span if p.terrain_span > 0 else float(hm.shape[1] - 1)
        kw = dict(
            size_px=(W, H), terrain_span=span, z_scale=p.z_scale, exposure=p.exposure,
            light_azimuth_deg=p.light.azimuth_deg, light_elevation_deg=p.light.elevation_deg,
            sun_intensity=p.light.intensity, sun_color=tuple(p.light.color),
            ibl_intensity=p.ibl.intensity if p.ibl.enabled else 0.0,
            cam_radius=p.cam_radius, cam_phi_deg=p.cam_phi_deg,
            cam_theta_deg=p.cam_theta_deg, fov_y_deg=p.fov_y_deg, clip=tuple(p.clip),
            albedo_mode=albedo_mode, colormap_strength=p.colormap_strength,
            hue_variation_strength=p.hue_variation_strength, water_mask=water_mask, sky=sky,
            hdr_rgb=env_rgb, material_albedo_rgb=material_albedo, materials=mats, pom=pom,
            reflection=refl, domain=dom)
        return lut, kw, (W_out, H_out)

    def _render_screen(self, p: TerrainRenderParams, hm, env_maps, water_mask,
                       want_aov: bool):
        """camera_mode="screen": the screen engine (terrain/screen.py: S1-S4
        from their caches or built, then S8)."""
        from . import screen as scr

        t0 = time.perf_counter()
        lut, kw, (W_out, H_out) = self.screen_inputs(p, hm, env_maps, water_mask)
        W, H = kw["size_px"]
        out = scr.render_screen_tensors(hm, lut, device=self.device, **kw)
        rgba = out["rgba"].cpu().numpy()
        aovs = None
        if want_aov:
            aovs = {"albedo": out["albedo"].cpu().numpy(), "normal": out["normal"].cpu().numpy(),
                    "depth": out["height"].cpu().numpy()}
        if (W, H) != (W_out, H_out):
            rgba = scr.blit_resolve(rgba, W_out, H_out)
        ms = (time.perf_counter() - t0) * 1000.0
        self.last_gpu_timings = {
            "terrain_main_pass_ms": ms, "prepare_ms": 0.0,
            "vt_residency_ms": 0.0, "readback_ms": 0.0, "total_ms": ms,
        }
        self.last_consumed_settings, self.last_ignored_settings = \
            self._settings_report(p, True, water_mask is not None, False)
        meta = {
            "width": W_out, "height": H_out, "camera_mode": "screen",
            "albedo_mode": p.albedo_mode, "render_ms": ms,
            "gpu_timings": dict(self.last_gpu_timings),
        }
        frame = Frame(rgba=rgba, metadata=meta)
        aov_frame = AovFrame(aovs=aovs, metadata=meta) if want_aov else None
        return frame, aov_frame

    # ------------------------------------------------------------------
    # Offline progressive accumulation: per-sample projection jitter into an
    # RGBA32F buffer on the device, tile-luminance metrics for convergence.
    # ------------------------------------------------------------------

    def offline_session_active(self) -> bool:
        return self._offline is not None

    def begin_offline_accumulation(self, material_set=None, env_maps=None,
                                   params=None, heightmap=None,
                                   water_mask=None) -> None:
        if self.offline_session_active():
            raise RenderError("an offline accumulation session is already active")
        p, scene, args, _ = self.render_inputs(params, heightmap, env_maps, water_mask, 0.0,
                                               material_set, offline=True)
        W, H = args.width, args.height
        self._offline = {
            "params": p, "scene": scene, "args": args, "W": W, "H": H,
            "accum": torch.zeros((H, W, 4), dtype=_F32, device=self.device),
            "tiles": np.zeros((-(-H // TILE), -(-W // TILE)), np.float32),
            "samples": 0,
            "last_metrics": None,
            "aov": None,
            "threshold": 1e-3,
        }
        global_tracker().track("offline.accum", H * W * 16, "buffer")

    def _active_session(self):
        sess = self._offline
        if sess is None:
            raise RenderError("no offline accumulation session is active")
        return sess

    def accumulate_batch(self, n_samples: int):
        sess = self._active_session()
        if n_samples <= 0:
            raise ValueError("n_samples must be >= 1")
        accum = sess["accum"]
        for _ in range(int(n_samples)):
            accum, new_tiles, aov = offline_step(sess["scene"], sess["args"], accum,
                                                 sess["samples"])
            sess["samples"] += 1
        new_tiles = new_tiles.cpu().numpy()
        delta = np.abs(new_tiles - sess["tiles"])
        sess["accum"] = accum
        sess["tiles"] = new_tiles
        sess["aov"] = aov
        thr = sess["threshold"]
        sess["last_metrics"] = {
            "total_samples": sess["samples"],
            "mean_delta": float(delta.mean()),
            "p95_delta": float(np.percentile(delta, 95)),
            "max_tile_delta": float(delta.max()),
            "converged_tile_ratio": float((delta < thr).mean()),
        }
        return dict(sess["last_metrics"])

    def read_accumulation_metrics(self, convergence_threshold: float = 1e-3):
        sess = self._active_session()
        sess["threshold"] = float(convergence_threshold)
        if sess["last_metrics"] is None:
            return {
                "total_samples": 0, "mean_delta": float("inf"),
                "p95_delta": float("inf"), "max_tile_delta": float("inf"),
                "converged_tile_ratio": 0.0,
            }
        return dict(sess["last_metrics"])

    def resolve_offline_hdr(self):
        sess = self._active_session()
        if sess["samples"] == 0:
            raise RenderError("no samples accumulated")
        accum = sess["accum"].cpu().numpy()
        hdr = accum[..., :3] / accum[..., 3:4]
        aov = AovFrame(aovs={k: v.cpu().numpy() for k, v in sess["aov"].items()},
                       metadata={"samples": sess["samples"]})
        return HdrFrame(rgb=hdr.astype(np.float32),
                        metadata={"samples": sess["samples"]}), aov

    def tonemap_offline_hdr(self, hdr_frame: HdrFrame) -> Frame:
        sess = self._offline
        p = sess["params"] if sess else make_terrain_params()
        rgb = torch.as_tensor(np.asarray(hdr_frame.rgb, np.float32), device=self.device)
        ldr = tm.apply(p.tonemap.mode if p.tonemap.mode != "off" else "reinhard", rgb,
                       exposure=f32(p.tonemap.exposure * p.exposure))
        if p.output_srgb_eotf:
            ldr = tm.srgb_eotf_inv(ldr)
        else:
            ldr = torch.pow(torch.clamp(ldr, 0.0, 1.0), f32(1.0 / p.gamma))
        return Frame(rgba=ldr_to_rgba(ldr.cpu().numpy()), metadata=dict(hdr_frame.metadata))

    def end_offline_accumulation(self) -> None:
        self._offline = None
