# forge3d_tpu_torch/_kernels.py
# Build and load the port's hand-written CUDA kernels (csrc/).
#
# Each csrc/*.cu is compiled by its own nvcc process, all started together,
# and the objects are linked into one shared library with a plain C
# interface, loaded with ctypes: no PyTorch headers, so a build takes
# seconds. The library is built at first use, keyed by a hash of the sources
# and flags, into build/forge3d_tpu_torch/ beside the package (listed in
# .gitignore). Importing this module needs neither nvcc nor a GPU.
#
# Flags: sm_90a (Hopper); -fmad=false because nvcc otherwise contracts
# a*b+c into FMA, which moves the leaf solve and the shading sums away from
# the plain PyTorch versions and flips silhouette hits; no --use_fast_math,
# so sqrtf, division and the transcendental functions stay IEEE/libdevice
# accurate.

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "forge3d_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Shared-memory bytes per CTA above which K2 and K3 keep their rows in
# device memory instead (the same code, through another pointer).
SMEM_LIMIT = 160 * 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_F3 = ctypes.c_float * 3
_LL = ctypes.c_longlong


class SceneArgs(ctypes.Structure):
    """Mirror of `SceneArgs` in csrc/common.cuh."""

    _fields_ = [
        ("h_pair", _P), ("mm_pack", _P), ("level_offset", _P), ("level_w", _P),
        ("dem_w", _I), ("cell_w", _I), ("cell_h", _I), ("mip_count", _I),
        ("max_iters", _I),
        ("ox", _F), ("oz", _F), ("sx", _F), ("sz", _F), ("ex", _F),
    ]


class ResArgs(ctypes.Structure):
    """Mirror of `ResArgs`: the ten SoA reservoir arrays, in field order."""

    _fields_ = [(name, _P) for name in (
        "dir_x", "dir_y", "dir_z", "intensity", "light_type", "light_index",
        "w_sum", "m", "weight", "target_pdf")]


class FrameArgs(ctypes.Structure):
    """Mirror of `FrameArgs`: per-render constants of the frame kernel, and
    the band of rows row0 .. row0 + rows - 1 it runs on."""

    _fields_ = [
        ("env_rgb", _P),
        ("width", _I), ("height", _I), ("spp", _I), ("env_w", _I),
        ("env_h", _I), ("shadows", _I), ("restir", _I),
        ("frame_index", _U), ("seed_hi", _U), ("seed_lo", _U),
        ("cam_o", _F3), ("right", _F3), ("up", _F3), ("fwd", _F3),
        ("half_w", _F), ("half_h", _F),
        ("sun", _F3), ("alb", _F3), ("alc", _F3),
        ("lum_lc", _F), ("env_intensity", _F), ("inv_spp", _F), ("lc", _F3),
        ("row0", _I), ("rows", _I),
    ]


class MeshArgs(ctypes.Structure):
    """Mirror of `MeshArgs` in csrc/mesh.cuh; all zero = no mesh."""

    _fields_ = [(n, _P) for n in ("bmin", "bmax", "first", "count", "miss", "v0", "e1",
                                  "e2", "fnorm")] + [
        ("n_nodes", _I), ("n_prims", _I), ("max_iters", _I)]


class LightArgs(ctypes.Structure):
    """Mirror of `LightArgs` in csrc/lights.cuh; all zero = no typed lights."""

    _fields_ = [(n, _P) for n in ("type_id", "color", "direction", "position", "radius",
                                  "extent", "cones", "prob", "alias", "pdf")] + [
        ("count", _I), ("u_hi", _F)]


class CamArgs(ctypes.Structure):
    """Mirror of `CamArgs` in csrc/pbr.cuh (P1, P2)."""

    _fields_ = [("width", _I), ("height", _I)] + [
        (n, _F3) for n in ("origin", "right", "up", "fwd")] + [
        (n, _F) for n in ("aspect", "tan_half", "exposure")] + [
        ("sun_l", _F3), ("sun_li", _F3)]


class SphereArgs(ctypes.Structure):
    """Mirror of `SphereArgs` in csrc/pbr.cuh (P1)."""

    _fields_ = [(n, _P) for n in ("center", "radius", "albedo", "metallic", "emissive",
                                  "roughness", "ax", "ay")] + [("n", _I)]


class MaterialArgs(ctypes.Structure):
    """Mirror of `MaterialArgs` in csrc/pbr.cuh (P2)."""

    _fields_ = [("albedo", _F3), ("metallic", _F), ("roughness", _F), ("emissive", _F3),
                ("sun_dir", _F3), ("sun_intensity", _F)]


class AovArgs(ctypes.Structure):
    """Mirror of `AovArgs` in csrc/pbr.cuh: the output planes of P1, P2."""

    _fields_ = [(n, _P) for n in ("ldr", "albedo", "normal", "depth", "direct", "indirect",
                                  "vis")]


class RotArgs(ctypes.Structure):
    """Mirror of `RotArgs` in csrc/sweep.cuh (K1)."""

    _fields_ = [("heights", _P), ("dem_w", _I), ("dem_h", _I), ("n_v", _I), ("n_u", _I)] + [
        (n, _F) for n in ("u0", "v0", "spacing", "cam_x", "cam_z", "eu0", "eu2", "ev0", "ev2",
                          "ox", "oz", "sx", "sz", "ex", "ex_sx", "ex_sz")]


class PolarArgs(ctypes.Structure):
    """Mirror of `PolarArgs` in csrc/sweep.cuh (K3): the polar plan, the
    rotated grid, the scene's shading constants and the frame's jitter."""

    _fields_ = [("env_rgb", _P), ("env_w", _I), ("env_h", _I), ("env_intensity", _F)] + [
        (n, _I) for n in ("n_v", "n_u", "K", "A", "E", "r1", "r2", "dem_w", "dem_h",
                          "shadows")] + [
        (n, _F) for n in ("t_lo", "t_step", "y_step", "fv", "uvhh", "fy", "uyhh", "cam_y",
                          "cam_iu", "cam_iv", "spacing", "base", "row0", "u0", "v0",
                          "cam_x", "cam_z", "eu0", "eu2", "ev0", "ev2", "v0ev0", "v0ev2",
                          "sx", "sz", "ex", "ex_sx", "ex_sz", "xmax", "zmax")] + [
        ("sun", _F3), ("lc", _F3), ("alb", _F3), ("eps", _F),
        ("xi", _F), ("ja", _F), ("je", _F)]


class ResolveArgs(ctypes.Structure):
    """Mirror of `ResolveArgs` in csrc/sweep.cuh (K4)."""

    _fields_ = [(n, _I) for n in ("A", "E", "row_ss", "width", "height")] + [
        (n, _F) for n in ("hw", "t_lo", "t_step", "n_frames")] + [
        (n, ctypes.c_double) for n in ("fv", "uvhh", "y_step")]


#: levels a VT store may have (F3D_VT_MAX_LEVELS in csrc/terrain_shade.cuh)
VT_MAX_LEVELS = 16


class TerrainArgs(ctypes.Structure):
    """Mirror of `TerrainArgs` in csrc/terrain_shade.cuh (R1)."""

    _fields_ = [("lut", _P), ("env_rgb", _P)] + [
        (n, _I) for n in ("lut_n", "env_w", "env_h", "width", "height", "aa", "use_colormap",
                          "tonemap", "srgb_out", "debug_normals", "curve_mode",
                          "shadow_samples", "ao_samples", "fog_on", "water_on", "wrefl_on",
                          "clouds_on", "layers_on", "tri_on", "det_on", "pom_on")] + [
        ("aa_seed", _U)] + [(n, _F3) for n in ("cam_o", "right", "up", "fwd")] + [
        ("half_h", _F), ("aspect", _F)] + [
        (n, _F3) for n in ("sun", "sun_rgb", "ambient_rgb", "zenith")] + [
        (n, _F) for n in ("ibl_intensity", "hmin", "hmax", "exposure", "inv_gamma",
                          "white_point", "colormap_strength")] + [
        ("constant_albedo", _F3)] + [
        (n, _F) for n in ("lambert_contrast", "shadow_softness", "shadow_intensity",
                          "shadow_bias", "curve_power", "curve_strength", "ao_mix_weight",
                          "time", "fog_density")] + [
        ("fog_rgb", _F3), ("fog_falloff", _F), ("fog_start", _F), ("water_level", _F),
        ("water_rgb", _F3)] + [
        (n, _F) for n in ("water_reflectivity", "refl_intensity", "cloud_coverage",
                          "cloud_strength", "cloud_scale", "ao_radius", "ao_strength",
                          "tri_scale", "tri_sharp", "det_strength", "det_scale", "det_fade",
                          "pom_scale", "snow_h", "snow_blend")] + [
        ("snow_rgb", _F3), ("rock_cos", _F), ("rock_blend", _F), ("rock_rgb", _F3)] + [
        ("vt_atlas", _P), ("vt_table", _P)] + [
        (n, _I) for n in ("vt_levels", "vt_level0", "vt_level_last", "vt_page")] + [
        ("vt_tiles", _I * VT_MAX_LEVELS), ("vt_offs", _I * VT_MAX_LEVELS)] + [
        (n, _F) for n in ("vt_pix_angle", "vt_tpw0", "vt_inv_span")]


class TerrainOut(ctypes.Structure):
    """Mirror of `TerrainOut`: R1's output planes and its VT fallback
    count; a null one is not written."""

    _fields_ = [(n, _P) for n in ("rgba", "hdr", "albedo", "normal", "depth", "vis",
                                  "vt_fallback")]


class AtrousArgs(ctypes.Structure):
    """Mirror of `AtrousArgs` in csrc/post.cuh (E3)."""

    _fields_ = [(n, _P) for n in ("albedo", "normal", "depth")] + [
        ("width", _I), ("height", _I)] + [
        (n, _F) for n in ("k_color", "k_albedo", "k_normal", "k_depth")]


class HosekArgs(ctypes.Structure):
    """Mirror of `HosekArgs` in csrc/post.cuh (E5)."""

    _fields_ = [("sun", _F3), ("cfg", _F * 27), ("rad", _F3), ("exposure", _F)]


class SkyArgs(ctypes.Structure):
    """Mirror of `SkyArgs` in csrc/screen.cuh (S6)."""

    _fields_ = [("model", _I), ("sun", _F3), ("inv_view", _F * 16), ("inv_proj", _F * 16),
                ("cfg", _F * 27), ("rad", _F3), ("mie_k1", _F3), ("mie_k2", _F3)] + [
        (n, _F) for n in ("pA", "pB", "pC", "pD", "pE", "p_den")] + [
        ("p_col", _F3), ("p_haze", _F), ("p_mix", _F), ("p_alb", _F), ("daylight", _F),
        ("night0", _F3), ("night_d", _F3), ("disc_cos", _F), ("limb_den", _F), ("disc_c", _F3),
        ("glow_cos", _F), ("glow_den", _F), ("ring_c", _F3)] + [
        (n, _F) for n in ("low_sun", "e_fwd", "e_broad", "inten", "k_broad", "hglow_k",
                          "amb")] + [
        ("scat_c", _F3), ("exposure", _F)] + [
        (n, _F) for n in ("density_neg", "k_fac", "k_amt", "k_desat", "k_target")] + [
        ("tint", _F3), ("add", _F3), ("k_blend", _F)]


class ScreenArgs(ctypes.Structure):
    """Mirror of `ScreenArgs` in csrc/screen.cuh (S8, S9)."""

    _fields_ = [(n, _P) for n in ("hm", "lut", "wm", "mat_albedo", "mmn", "mmr", "mmk", "shadow",
                                  "irr")] + [("spec", _P * 6), ("brdf", _P), ("refl", _P)] + [
        (n, _I) for n in ("hm_h", "hm_w", "lut_n", "wm_h", "wm_w", "mat_albedo_stride", "mmn_h",
                          "mmn_w", "mmr_h", "mmr_w", "mmk_h", "mmk_w", "shadow_res",
                          "irr_size")] + [("spec_size", _I * 6)] + [
        (n, _I) for n in ("brdf_h", "brdf_w", "refl_h", "refl_w", "width", "height", "has_wm",
                          "has_mat_albedo", "has_refl", "albedo_mode", "hue_on", "filterable",
                          "srgb", "mm_normal", "mm_rough", "mm_mask", "mats_on", "snow_on",
                          "sss_on")] + [
        (n, _F) for n in ("dom_lo", "dom_hi", "dom_rng", "z_scale", "exposure", "ibl_intensity",
                          "colormap_strength", "hue_strength", "ibl_fill", "shadow_rspan",
                          "vert", "sun_int", "f0_water")] + [
        ("texel", _F * 2), ("z_corners", _F3), ("wave_cs", _F * 2)] + [
        (n, _F3) for n in ("ldir", "lcol", "camera_pos", "pcss_ld")] + [
        ("lvp", _F * 12), ("rvp", _F * 16)] + [
        (n, _F) for n in ("refl_wave", "refl_intensity", "refl_shore_w", "refl_fresnel",
                          "snow_alt_min", "snow_alt_div", "snow_slope_f", "wet_scale",
                          "rock_mix")] + [
        ("rock_c", _F3), ("snow_c", _F3), ("layer_w", _F * 2), ("sss_strength", _F3),
        ("sss_tint", _F * 9), ("ml", _F * 12), ("filmic", _F * 7)] + [
        (n, _I) for n in ("pom_on", "pom_min", "pom_max", "pom_refine", "pom_occl",
                          "pom_layer")] + [
        ("pom_scale", _F), ("sky", SkyArgs)]


class ScreenOut(ctypes.Structure):
    """Mirror of `ScreenOut`: S8's output planes."""

    _fields_ = [(n, _P) for n in ("rgba", "albedo", "normal", "height")]


class ClipArgs(ctypes.Structure):
    """Mirror of `ClipArgs` in csrc/screen.cuh: S9's G-buffer."""

    _fields_ = [("uv", _P), ("world", _P), ("valid", _P), ("spacing", _F), ("wtex", _F * 2)]


class SdfArgs(ctypes.Structure):
    """Mirror of `SdfArgs` in csrc/sdf.cuh (P6): the tape."""

    _fields_ = [(n, _P) for n in ("is_op", "kind", "params", "smoothing", "material")] + [
        ("tape_len", _I), ("stack_depth", _I)]


class TlasArgs(ctypes.Structure):
    """Mirror of `TlasArgs` in csrc/pt.cuh (P5)."""

    _fields_ = [("blas", _P), ("xform", _P), ("inst_blas", _P), ("n_inst", _I)]


class HybridArgs(ctypes.Structure):
    """Mirror of `HybridArgs` in csrc/pt.cuh (P3)."""

    _fields_ = [(n, _I) for n in ("width", "height", "use_terrain", "use_mesh", "use_sdf")] + [
        ("cam_o", _F3), ("sun", _F3), ("sun_i", _F), ("env_intensity", _F), ("exposure", _F),
        ("albedo", _F * 9)]


class HybridOut(ctypes.Structure):
    """Mirror of `HybridOut`: P3's output planes; a null one is not written."""

    _fields_ = [(n, _P) for n in ("rgba", "depth", "normal", "vis", "kind", "albedo")]


class AdjArgs(ctypes.Structure):
    """Mirror of `AdjArgs` in csrc/adjudication.cuh (P4)."""

    _fields_ = [(n, _I) for n in ("width", "height", "spp", "n_quad")] + [
        ("sph", _F * 12), ("r2", _F3), ("alb", _F * 12), ("rough", _F * 4)] + [
        (n, _F3) for n in ("sun_wi", "li", "amb", "sky", "pe_sun", "pe_amb", "pe_sky")] + [
        ("pe_s", _F * 9)] + [(n, _F3) for n in ("cam_o", "right", "up", "fwd")] + [
        (n, _F) for n in ("half_w", "half_h", "quad_w")]


class SmokeMarchArgs(ctypes.Structure):
    """Mirror of `SmokeMarchArgs` in csrc/smoke.cuh (E8 march)."""

    _fields_ = [(n, _I) for n in ("nx", "ny", "nz", "width", "height", "steps", "sun_steps")] + [
        (n, _F) for n in ("half_w", "half_h", "steps_f")] + [
        (n, _F3) for n in ("right", "up", "fwd", "cam_o", "lo", "hi", "org", "rcp")] + [
        (n, _F) for n in ("sigma_t", "sun_k", "scat_k")] + [
        (n, _F3) for n in ("alb", "sun_c", "emis_c", "bg")]


class PreethamArgs(ctypes.Structure):
    """Mirror of `PreethamArgs` in csrc/leaf.cuh (E5 Preetham)."""

    _fields_ = [("sun", _F3), ("perez", _F * 15), ("zenith", _F3), ("den", _F3),
                ("exposure", _F)]


class GuideArgs(ctypes.Structure):
    """Mirror of `GuideArgs` in csrc/leaf.cuh (E7)."""

    _fields_ = [(n, _F) for n in ("ox", "oz", "ex", "ez", "cells_f", "ang_k")] + [
        ("cells", _I), ("res", _I)]


#: the structs whose sizes csrc/layout.cu:f3d_struct_sizes reports, in its order
STRUCTS = (ScreenArgs, ScreenOut, ClipArgs, SkyArgs, SdfArgs, MeshArgs, TlasArgs, HybridArgs,
           HybridOut, AdjArgs, TerrainArgs, TerrainOut, SmokeMarchArgs, PreethamArgs, GuideArgs)


_SIGNATURES = {
    # (rot, h_rot, du, dv, stream)
    "f3d_rotate_heights": [ctypes.POINTER(RotArgs), _P, _P, _P, _P],
    # (h, du, dv, V, U, tasks, n_tasks, ctas, n_ctas, cluster, threads, table, nb_max, zs,
    #  band, groups, invn, zglob, partial, z_orient, plane_q, n_planes, sun_q, e_sky, z_sun,
    #  stream)
    "f3d_sweep_lighting": [_P, _P, _P, _I, _I, _P, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P,
                           _P, _P, _P, _P, _I, _I, _P, _P, _P],
    # (cluster, threads, nb_max, zs, band, global, n out)
    "f3d_sweep_clusters": [_I, _I, _I, _I, _I, _I, _P],
    # (polar, h_rot, e_sky, z_sun, corners, acc, scratch, stream)
    "f3d_polar_frame": [ctypes.POINTER(PolarArgs)] + [_P] * 7,
    # (resolve, acc, out, stream)
    "f3d_resolve": [ctypes.POINTER(ResolveArgs), _P, _P, _P],
    # (scene, rox, roy, roz, rdx, rdy, rdz, n, tmin, tmax,
    #  hit, t, cell_x, cell_z, stream)
    "f3d_trace": [ctypes.POINTER(SceneArgs)] + [_P] * 6 + [_I, _F, _F] + [_P] * 5,
    # (scene, frame, mesh, lights, accum_in, welford_in, res_in, accum_out,
    #  welford_out, res_out, stream)
    "f3d_frame_step": [ctypes.POINTER(SceneArgs), ctypes.POINTER(FrameArgs),
                       ctypes.POINTER(MeshArgs), ctypes.POINTER(LightArgs),
                       _P, _P, ctypes.POINTER(ResArgs), _P, _P,
                       ctypes.POINTER(ResArgs), _P],
    # (res_in, res_out, gb_nx, gb_ny, gb_nz, width, height, frame_index,
    #  seed_hi, k_neighbors, radius, row0, rows, stream)
    "f3d_spatial_reuse": [ctypes.POINTER(ResArgs), ctypes.POINTER(ResArgs),
                          _P, _P, _P, _I, _I, _U, _U, _I, _I, _I, _I, _P],
    # (scene, mesh, n, cam_o, albedo, dx, dy, dz, hit, t, cell_x, cell_z,
    #  albedo_out, normal_out, depth_out, vis_out, gb_nx, gb_ny, gb_nz, stream)
    "f3d_center_gbuffer": [ctypes.POINTER(SceneArgs), ctypes.POINTER(MeshArgs), _I, _F3,
                           _F3] + [_P] * 7 + [_P] * 7 + [_P],
    # (mesh, rox, roy, roz, rdx, rdy, rdz, n, tmin, tmax, hit, t, prim, u, v,
    #  stream)
    "f3d_trace_mesh": [ctypes.POINTER(MeshArgs)] + [_P] * 6 + [_I, _F, _F] + [_P] * 6,
    # (lights, n, px, py, pz, nx, ny, nz, u_pick, u1, u2, dx, dy, dz, dist,
    #  wr, wg, wb, stream)
    "f3d_sample_light_nee": [ctypes.POINTER(LightArgs), _I] + [_P] * 9 + [_P] * 7 + [_P],
    # (cam, spheres, aovs, stream)
    "f3d_render_spheres": [ctypes.POINTER(CamArgs), ctypes.POINTER(SphereArgs),
                           ctypes.POINTER(AovArgs), _P],
    # (cam, mesh, material, aovs, stream)
    "f3d_render_mesh": [ctypes.POINTER(CamArgs), ctypes.POINTER(MeshArgs),
                        ctypes.POINTER(MaterialArgs), ctypes.POINTER(AovArgs), _P],
    # (scene, terrain, out, stream)
    "f3d_terrain_render": [ctypes.POINTER(SceneArgs), ctypes.POINTER(TerrainArgs),
                           ctypes.POINTER(TerrainOut), _P],
    # (scene, terrain, accum, sample_idx, lum, out, tiles, stream)
    "f3d_terrain_step": [ctypes.POINTER(SceneArgs), ctypes.POINTER(TerrainArgs), _P, _U, _P,
                         ctypes.POINTER(TerrainOut), _P, _P],
    # (args, in, out, step, stream)
    "f3d_atrous_pass": [ctypes.POINTER(AtrousArgs), _P, _P, _I, _P],
    # (sky, dx, dy, dz, n, rgb, stream)
    "f3d_hosek_radiance": [ctypes.POINTER(HosekArgs), _P, _P, _P, _I, _P, _P],
    # (eq, eq_h, eq_w, dirs, size, out, stream)
    "f3d_ibl_env_cube": [_P, _I, _I, _P, _I, _P, _P],
    # (env, env_size, dirs, size, samples, count, mode, out, stream)
    "f3d_ibl_convolve": [_P, _I, _P, _I, _P, _I, _I, _P, _P],
    # (tris, keep, n_tris, resolution, wbb, hbb, depth, stream)
    "f3d_raster_depth": [_P, _P, _I, _I, _I, _I, _P, _P],
    # (args, out, stream)
    "f3d_screen_shade": [ctypes.POINTER(ScreenArgs), ctypes.POINTER(ScreenOut), _P],
    # (args, gbuffer, rgba, stream)
    "f3d_clipmap_shade": [ctypes.POINTER(ScreenArgs), ctypes.POINTER(ClipArgs), _P, _P],
    # (sizes out, capacity) -> the number of structs
    "f3d_struct_sizes": [ctypes.POINTER(ctypes.c_longlong), _I],
    # (prims, n, kind, width, height, half, evenodd, color, opacity, pick_id,
    #  cov, rgb, alpha, pick, stream)
    "f3d_vector_layer": [_P, _I, _I, _I, _I, _F, _I, _F3, _F, _I, _P, _P, _P, _P, _P],
    # (sdf, px, py, pz, n, d, mat, stream)
    "f3d_sdf_eval": [ctypes.POINTER(SdfArgs), _P, _P, _P, _I, _P, _P, _P],
    # (sdf, px, py, pz, n, eps, out (3, n), stream)
    "f3d_sdf_normal": [ctypes.POINTER(SdfArgs), _P, _P, _P, _I, _F, _P, _P],
    # (sdf, rox, roy, roz, rdx, rdy, rdz, n, tmin, tmax, max_steps, hit_eps,
    #  hit, t, mat, stream)
    "f3d_sdf_march": [ctypes.POINTER(SdfArgs)] + [_P] * 6 + [_I, _F, _F, _I, _F] + [_P] * 4,
    # (tlas, rox, roy, roz, rdx, rdy, rdz, n, tmin, tmax, hit, t, inst, prim,
    #  u, v, stream)
    "f3d_trace_tlas": [ctypes.POINTER(TlasArgs)] + [_P] * 6 + [_I, _F, _F] + [_P] * 7,
    # (scene, mesh, sdf, args, rdx, rdy, rdz, out, stream)
    "f3d_hybrid_render": [ctypes.POINTER(SceneArgs), ctypes.POINTER(MeshArgs),
                          ctypes.POINTER(SdfArgs), ctypes.POINTER(HybridArgs), _P, _P, _P,
                          ctypes.POINTER(HybridOut), _P],
    # (args, quad, rgba, hdr, stream)
    "f3d_adj_raster": [ctypes.POINTER(AdjArgs), _P, _P, _P, _P],
    # (args, keys, rgba, hdr, stream)
    "f3d_adj_pt": [ctypes.POINTER(AdjArgs), _P, _P, _P, _P],
    # E2: (in, out, taps, radius, outer, n, inner, stream)
    "f3d_blur_axis": [_P, _P, _P, _I, _I, _I, _I, _P],
    # (mode, height, width, channels, a, b, c, d, out, p0..p5, stream)
    "f3d_post_point": [_I, _I, _I, _I] + [_P] * 5 + [_F] * 6 + [_P],
    # (color, depth, normal, nc, out, height, width, stride, max_steps,
    #  intensity, fade_den, stream)
    "f3d_ssr": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _F, _P],
    # (cur, hist, out, height, width, channels, blend, 1 - blend, clamp, stream)
    "f3d_taa": [_P, _P, _P, _I, _I, _I, _F, _F, _I, _P],
    # (depth, normal, nc, offsets, n_samples, out, height, width, bias, rden,
    #  intensity, stream)
    "f3d_ssao": [_P, _P, _I, _P, _I, _P, _I, _I, _F, _F, _F, _P],
    # (p, n, v, count, lights, n_lights, out, stream)
    "f3d_rect_lights": [_P, _P, _P, _I, _P, _I, _P, _P],
    # E1: (env, env_h, env_w, dirs, weights, samples, texels, mode, out, stream)
    "f3d_equirect_accum": [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P],
    # E8 step: (vel, temp, vf, n, dtb, amb, w0, w1, w2, kdamp, stream)
    "f3d_smoke_forces": [_P, _P, _P, ctypes.c_longlong] + [_F] * 6 + [_P],
    # (vf, va, nx, ny, nz, dt, forms, stream)
    "f3d_smoke_advect_velocity": [_P, _P, _I, _I, _I, _F, _I, _P],
    # (va, div, nx, ny, nz, stream)
    "f3d_smoke_divergence": [_P, _P, _I, _I, _I, _P],
    # (p or null, div, p_out, nx, ny, nz, sixth, stream)
    "f3d_smoke_jacobi": [_P, _P, _P, _I, _I, _I, _F, _P],
    # (va, p or null, div or null, dens, temp, soot, emis, vel_out, dens_out,
    #  temp_out, soot_out, emis_out, nx, ny, nz, dt, keep, keep2, sixth, stream)
    "f3d_smoke_project_advect": [_P] * 12 + [_I, _I, _I, _F, _F, _F, _F, _P],
    # E8 march: (args, dens, emis, soot, sun_off, rgba, stream)
    "f3d_smoke_march": [ctypes.POINTER(SmokeMarchArgs)] + [_P] * 6,
    # E9: (op, a_hi, a_lo, b_hi, b_lo, n, hi, lo, stream)
    "f3d_dd": [_I, _P, _P, _P, _P, _LL, _P, _P, _P],
    # E5 Preetham: (sky, dx, dy, dz, n, rgb (3, n), stream)
    "f3d_preetham": [ctypes.POINTER(PreethamArgs), _P, _P, _P, _LL, _P, _P],
    # E6: (lights (L, 16), L, p, n, u or null, count, out, stream)
    "f3d_eval_lights": [_P, _I, _P, _P, _P, _LL, _P, _P],
    # E7: (dx, dy, dz, n, res, bins, stream); (bins, n, res, dirs (3, n), stream)
    "f3d_octa_encode": [_P, _P, _P, _LL, _I, _P, _P],
    "f3d_octa_decode": [_P, _LL, _I, _P, _P],
    # (guide, px, pz, dx, dy, dz, n, keys, stream)
    "f3d_guide_keys": [ctypes.POINTER(GuideArgs)] + [_P] * 5 + [_LL, _P, _P],
    # (sorted keys, perm, luminance, n, seg_start, seg_end, lum_sorted, stream)
    "f3d_guide_bounds": [_P, _P, _P, _LL, _P, _P, _P, _P],
    # (seg_start, seg_end, lum_sorted, hist_in, bins, threshold, long_list, hist_out,
    #  stream)
    "f3d_guide_bins": [_P, _P, _P, _P, _LL, _I, _P, _P, _P],
    # (seg_start, seg_end, lum_sorted, hist_in, long_list, max_long, hist_out, stream)
    "f3d_guide_long": [_P, _P, _P, _P, _P, _I, _P, _P],
    # (guide, hist, px, pz, u1, u2, n, out (4, n), stream)
    "f3d_guide_sample": [ctypes.POINTER(GuideArgs)] + [_P] * 5 + [_LL, _P, _P],
    # C1 entropy: (stream, lens, cap, freq, extras, ecap, n_tiles, d, stream)
    "f3d_rans_decode": [_P, _P, _I, _P, _P, _I, _I, _P, _P],
    # C1 reconstruction: (d, n_tiles, ntx, width, step, out, stream)
    "f3d_med_reconstruct": [_P, _I, _I, _I, ctypes.c_double, _P, _P],
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libforge3d_tpu_torch_{_digest()}.so"


def build() -> Path:
    """Compile csrc/*.cu, one nvcc process per source, all at once, and link
    the objects into the shared library, unless a build of these exact
    sources exists. Writes nvcc's report (registers, spills) beside the
    library as build.log. Raises RuntimeError if nvcc fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{cu.stem}.o" for cu in cus]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(cu)]
            for cu, o in zip(cus, objs)]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    log = []
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        failed = []
        for c, p in zip(cmds, procs):
            so, se = p.communicate()
            log.append(" ".join(c) + "\n" + so + se)
            if p.returncode != 0:
                failed.append(f"nvcc failed ({p.returncode}) on {c[-1]}:\n{se[-4000:]}")
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        (BUILD_DIR / "build.log").write_text("".join(log))
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("\n".join(failed))
        os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return out


def bind(handle: ctypes.CDLL) -> ctypes.CDLL:
    """Set the launchers' signatures on a loaded library and check that the
    argument structs' mirrors have the sizes the library was compiled with
    (a field out of place shifts every uniform after it without a word)."""
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.f3d_error_string.argtypes = [ctypes.c_int]
    handle.f3d_error_string.restype = ctypes.c_char_p
    sizes = (ctypes.c_longlong * len(STRUCTS))()
    count = handle.f3d_struct_sizes(sizes, len(STRUCTS))
    mirrors = [ctypes.sizeof(s) for s in STRUCTS]
    if count != len(STRUCTS) or list(sizes) != mirrors:
        raise RuntimeError(f"the kernels' argument structs {[s.__name__ for s in STRUCTS]} are "
                           f"{list(sizes)[:count]} bytes, their ctypes mirrors {mirrors}")
    return handle


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return bind(ctypes.CDLL(str(build())))


def check(err: int, kernel: str) -> None:
    """Raise if a launcher reported a CUDA error (cudaGetLastError after the
    launch): a refused launch never runs and synchronize() would not say."""
    if err != 0:
        msg = lib().f3d_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err}: {msg}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(name: str, *tensors) -> None:
    """The kernels take contiguous CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: kernel inputs must be CUDA tensors on one "
                             f"device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")
