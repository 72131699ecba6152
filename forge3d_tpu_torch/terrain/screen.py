# forge3d_tpu_torch/terrain/screen.py
# The screen-mode terrain render of forge3d_tpu/terrain/screen.py
# (camera_mode="screen": the reference's fullscreen-triangle forward pass)
# and its clipmap camera mode on PyTorch, through five hand-written CUDA
# kernels (csrc/screen.cu over csrc/screen.cuh):
#
#   S1    env_cube        the equirect-to-cube resample (screen.py:355)
#   S2/S3 cube_convolve   the cosine irradiance (:363) and the GGX prefilter
#                         mips 1-5 (:388): one kernel, two lobes, a
#                         pyramid's six in one launch (cube_pyramid)
#   S4    raster_depth    the light-space depth raster (:464)
#   S8    shade           the per-pixel shade (:1098), with the PCSS
#                         visibility S5 (:656), parallax occlusion mapping
#                         S7 (:979) and the analytic sky with aerial
#                         perspective S6 (:748, :1508) inside
#   S9    clipmap_shade   the clipmap mode's shade over a host G-buffer
#                         (:1857), with S5 and S7 inside
#
# Beside each wrapper is its plain PyTorch version, which the wrapper runs
# for CPU tensors; CUDA tensors launch the kernel, and nothing falls back
# from one to the other. Each wrapper counts its launches in `.launches`.
#
# The host helpers of the JAX module (camera matrices, cube face
# directions, the Hammersley set, the shadow map's light matrices and
# triangles, test environments and LUTs, the blit) are copied here under
# their original names, as is screen_golden._build_brdf_lut. The IBL
# pyramid and the shadow map are cached in process by the JAX module's
# content-hash keys, as device tensors charged to the memory ledger; the
# port writes no file. S8 and S9 read the shadow map through a texture object
# over the cached map itself (ShadowTexture, no copy), made once with the
# map's cache entry (shadow_texture) and dropped with it. The clipmap mode's
# G-buffer is rasterized on the host by terrain/clipmap_mesh.py, a copy of
# the JAX package's.

from __future__ import annotations

import ctypes
import hashlib
import math
import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..mem import global_tracker
from ..ops.shading import fdiv, sqrt32
from ..ops.traversal import f32

_F32 = torch.float32

# Composition constants (screen.py:67-75).
SHADOW_MIN = 0.20
SHADOW_IBL_FACTOR = 0.20
AMBIENT_FLOOR = 0.18
WATER_DEPTH_ATTEN_DEEP = 0.30
WATER_COMBINED_REFLECTION_SCALE = 0.30
WATER_SUN_SPECULAR_SCALE = 0.50
WATER_BASE_TINT = (0.15, 0.45, 0.85)
WATER_BASE_TINT_SCALE = 0.80
WATER_SCATTER_SCALE = 2.0

# PCSS poisson disks (terrain_pbr_pom.wgsl:1057-1069, 1245-1262)
_POISSON_12 = np.array([
    (-0.94201624, -0.39906216), (0.94558609, -0.76890725),
    (-0.094184101, -0.92938870), (0.34495938, 0.29387760),
    (-0.91588581, 0.45771432), (-0.81544232, -0.87912464),
    (-0.38277543, 0.27676845), (0.97484398, 0.75648379),
    (0.44323325, -0.97511554), (0.53742981, -0.47373420),
    (-0.26496911, -0.41893023), (0.79197514, 0.19090188)], np.float32)
_POISSON_16 = np.concatenate([_POISSON_12, np.array([
    (-0.24188840, 0.99706507), (-0.81409955, 0.91437590),
    (0.19984126, 0.78641367), (0.14383161, -0.14100790)], np.float32)])

SHADOW_RES = 4096     # build_shadow_map's defaults
SHADOW_GRID = 1024
ENV_SIZE = 256        # build_ibl's cube sizes
IRR_SIZE = 128
N_MIPS = 6
CACHE_ENTRIES = 4     # per cache; the oldest entry is dropped past it


def _hash(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, np.ndarray):
            h.update(np.ascontiguousarray(a).tobytes())
        else:
            h.update(repr(a).encode())
    return h.hexdigest()[:24]


# ---------------------------------------------------------------------------
# glam camera matrices (host numpy, copied from screen.py:122-187)
# ---------------------------------------------------------------------------

def look_at_rh(eye, target, up):
    eye = np.asarray(eye, np.float32)
    f = np.asarray(target, np.float32) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float32))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def look_to_rh(eye, direction, up):
    eye = np.asarray(eye, np.float32)
    return look_at_rh(eye, eye + np.asarray(direction, np.float32), up)


def orthographic_rh(left, right, bottom, top, near, far):
    """glam orthographic_rh: z mapped to [0, 1] (WebGPU convention)."""
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -1.0 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -near / (far - near)
    m[3, 3] = 1.0
    return m


def orbit_eye(radius, phi_deg, theta_deg, target=(0.0, 0.0, 0.0)):
    """Y-up orbit eye (upload.rs:366-375, screen-mode branch)."""
    phi = np.deg2rad(phi_deg)
    theta = np.deg2rad(theta_deg)
    off = np.array([
        radius * np.sin(theta) * np.cos(phi),
        radius * np.cos(theta),
        radius * np.sin(theta) * np.sin(phi)], np.float32)
    return np.asarray(target, np.float32) + off


def light_direction(azimuth_deg, elevation_deg):
    """Z-up sun direction (decode_lighting.rs:26-41)."""
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    d = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], np.float32)
    return d / np.linalg.norm(d)


def perspective_proj(fov_y_deg, aspect, near, far):
    """glam perspective_rh (reversed-range [0,1] z, WebGPU)."""
    fov = np.deg2rad(fov_y_deg)
    f = 1.0 / np.tan(fov * 0.5)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = f / aspect
    proj[1, 1] = f
    proj[2, 2] = far / (near - far)
    proj[2, 3] = near * far / (near - far)
    proj[3, 2] = -1.0
    return proj


# ---------------------------------------------------------------------------
# Cube maps and the Hammersley set (host, copied from screen.py:239, 322)
# ---------------------------------------------------------------------------

def _face_dirs(size):
    """Direction of every texel of every face: (6, size, size, 3). Host."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size
    u, v = np.meshgrid(t, t)
    cu = u * 2.0 - 1.0
    cv = v * 2.0 - 1.0
    one = np.ones_like(cu)
    faces = np.stack([
        np.stack([one, -cv, -cu], -1),
        np.stack([-one, -cv, cu], -1),
        np.stack([cu, one, cv], -1),
        np.stack([cu, -one, -cv], -1),
        np.stack([cu, -cv, one], -1),
        np.stack([-cu, -cv, -one], -1)], 0)
    return faces / np.linalg.norm(faces, axis=-1, keepdims=True)


def _hammersley(n):
    """Host-side Hammersley sequence (static per build)."""
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = (bits << np.uint32(16)) | (bits >> np.uint32(16))
    bits = ((bits & np.uint32(0x55555555)) << np.uint32(1)) | \
           ((bits & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    bits = ((bits & np.uint32(0x33333333)) << np.uint32(2)) | \
           ((bits & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    bits = ((bits & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | \
           ((bits & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    bits = ((bits & np.uint32(0x00FF00FF)) << np.uint32(8)) | \
           ((bits & np.uint32(0xFF00FF00)) >> np.uint32(8))
    return np.stack([i.astype(np.float32) / n,
                     bits.astype(np.float64).astype(np.float32)
                     * np.float32(2.3283064365386963e-10)], -1)


# ---------------------------------------------------------------------------
# Test environments, LUTs, materials (host, copied from screen.py:909-976)
# ---------------------------------------------------------------------------

def _srgb_to_linear_np(c):
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92,
                    ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


#: MaterialSet.terrain_default() base colors (material_set/py_api.rs:29-51)
#: stored Rgba8UnormSrgb: sampling returns srgb_to_linear(u8 round).
_MATERIAL_BASE_SRGB = np.array([
    [0.28, 0.26, 0.24],   # rock,  roughness 0.50
    [0.18, 0.38, 0.10],   # grass, roughness 0.85
    [0.35, 0.25, 0.15],   # dirt,  roughness 0.50
    [0.95, 0.97, 1.00],   # snow,  roughness 0.25
], np.float32)
_MATERIAL_LINEAR = _srgb_to_linear_np(
    np.round(_MATERIAL_BASE_SRGB * 255.0) / 255.0)


def default_material_layers():
    """M4 material-layer defaults (terrain_params.py:546-600 reference)."""
    return dict(
        snow_enabled=False, snow_altitude_min=2000.0,
        snow_altitude_blend=500.0, snow_slope_max=45.0,
        snow_slope_blend=15.0, snow_aspect_influence=0.3,
        snow_color=(0.95, 0.95, 0.98), snow_subsurface_strength=0.0,
        snow_subsurface_tint=(1.0, 1.0, 1.0),
        rock_enabled=False, rock_slope_min=45.0, rock_slope_blend=10.0,
        rock_color=(0.35, 0.32, 0.28), rock_subsurface_strength=0.0,
        rock_subsurface_tint=(1.0, 1.0, 1.0),
        wetness_enabled=False, wetness_strength=0.3,
        wetness_slope_influence=0.5, wetness_subsurface_strength=0.0,
        wetness_subsurface_tint=(1.0, 1.0, 1.0),
    )


def decode_test_hdr(width=8, height=4, blue=128):
    """The reference golden suites' gradient RGBE env
    (test_terrain_visual_goldens.py:41-50)."""
    x = np.arange(width, dtype=np.float32)
    y = np.arange(height, dtype=np.float32)
    r = np.floor(x / max(width - 1, 1) * 255.0)
    g = np.floor(y / max(height - 1, 1) * 255.0)
    img = np.zeros((height, width, 3), np.float32)
    img[..., 0] = r[None, :] / 256.0
    img[..., 1] = g[:, None] / 256.0
    img[..., 2] = float(blue) / 256.0
    return img


def build_lut_from_stops(stops):
    """Colormap1D.from_stops: 256-wide u8 LUT (colormap1d.rs:131-175),
    returned as float [0,1] rgb. Host data prep."""
    pos = np.array([s[0] for s in stops], np.float32)
    cols = np.array([[int(s[1][i:i + 2], 16) for i in (1, 3, 5)]
                     for s in stops], np.float32)
    t = np.linspace(0.0, 1.0, 256, dtype=np.float32)
    out = np.zeros((256, 3), np.float32)
    for i, v in enumerate(t):
        if v <= pos[0]:
            out[i] = cols[0]
        elif v >= pos[-1]:
            out[i] = cols[-1]
        else:
            j = np.searchsorted(pos, v, side="right") - 1
            j = min(j, len(pos) - 2)
            f = (v - pos[j]) / max(pos[j + 1] - pos[j], 1e-20)
            out[i] = np.round(cols[j] + (cols[j + 1] - cols[j]) * f)
    return out / 255.0


def _build_brdf_lut(size=512, samples=1024):
    """screen_golden._build_brdf_lut: the ZERO LUT the terrain goldens
    bake, or under FORGE3D_IBL_BRDF=analytic the ibl_brdf.wgsl LUT (with
    its non-standard g_vis), f16-rounded. Not cached."""
    if os.environ.get("FORGE3D_IBL_BRDF", "golden") != "analytic":
        return np.zeros((size, size, 2), np.float32)
    uv = (np.arange(size, dtype=np.float32) + 0.5) / size
    out = np.zeros((size, size, 2), np.float32)
    xi = _hammersley(samples)
    for yi in range(size):
        rough = uv[yi]
        a = rough * rough
        phi = 2.0 * np.pi * xi[:, 0]
        ct = np.sqrt((1.0 - xi[:, 1]) / (1.0 + (a * a - 1.0) * xi[:, 1]))
        st = np.sqrt(1.0 - ct * ct)
        h = np.stack([np.cos(phi) * st, np.sin(phi) * st, ct], -1)  # (S,3)
        ndv = uv  # (X,)
        sin_v = np.sqrt(np.maximum(1.0 - ndv * ndv, 0.0))
        vdh = sin_v[:, None] * h[None, :, 0] + ndv[:, None] * h[None, :, 2]
        lz = 2.0 * vdh * h[None, :, 2] - ndv[:, None]
        ndl = np.maximum(lz, 0.0)
        ndh = np.maximum(h[None, :, 2], 0.0)
        vdh_c = np.maximum(vdh, 0.0)
        g = (2.0 * ndh * ndv[:, None]) / np.maximum(vdh_c, 1e-5)
        g_vis = g / np.maximum(ndl, 1e-5)
        fres = (1.0 - vdh_c) ** 5
        live = ndl > 0.0
        aa = np.where(live, (1.0 - fres) * g_vis, 0.0).sum(1) / samples
        bb = np.where(live, fres * g_vis, 0.0).sum(1) / samples
        out[yi, :, 0] = np.clip(aa, 0.0, 1.0)
        out[yi, :, 1] = np.clip(bb, 0.0, 1.0)
    return np.asarray(out, np.float16).astype(np.float32)


def _freeze(d):
    if d is None:
        return None
    out = []
    for k in sorted(d):
        v = d[k]
        if isinstance(v, (list, tuple)):
            v = tuple(float(x) for x in v)
        out.append((k, v))
    return tuple(out)


def blit_resolve(img, out_w, out_h):
    """terrain.blit_pass: bilinear fullscreen blit from the internal
    (render_scale-supersampled) Rgba8 target (draw/execute.rs:800-869)."""
    a = img[..., :3].astype(np.float32)
    h, w = a.shape[:2]
    ys = (np.arange(out_h, dtype=np.float32) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w, dtype=np.float32) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    top = a[y0][:, x0] * (1 - fx) + a[y0][:, x1] * fx
    bot = a[y1][:, x0] * (1 - fx) + a[y1][:, x1] * fx
    out = np.empty((out_h, out_w, 4), np.uint8)
    out[..., :3] = np.round(np.clip(top * (1 - fy) + bot * fy, 0, 255))
    out[..., 3] = 255
    return out


# ---------------------------------------------------------------------------
# Plain sampling functions (screen.py:194-348), on tensors. Vectors are
# lists of three (...) tensors, so that every sum runs left to right as in
# csrc/screen.cuh.
# ---------------------------------------------------------------------------

def _f16(x: torch.Tensor) -> torch.Tensor:
    """rgba16float storage round trip (round to nearest even)."""
    return x.to(torch.float16).to(_F32)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _norm(v):
    return sqrt32(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def _normalize(v, eps=1e-20):
    n = torch.clamp(_norm(v), min=eps)
    return [c / n for c in v]


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]


def _mod1(x):
    """jnp.mod(x, 1.0): fmod, moved into [0, 1)."""
    m = torch.fmod(x, 1.0)
    return torch.where(m < 0, m + 1.0, m)


def _clip01(x):
    return torch.clamp(x, 0.0, 1.0)


def _texel(tex, y, x):
    """tex[y, x] as a list of channels (one entry for a 2-D texture)."""
    v = tex[y, x]
    return [v] if tex.dim() == 2 else [v[..., c] for c in range(tex.shape[2])]


def _nearest(tex, u, v):
    """ClampToEdge nearest sample of a (H, W[, C]) texture at uv arrays."""
    h, w = tex.shape[:2]
    x = torch.clamp(torch.floor(u * w).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.floor(v * h).to(torch.int64), 0, h - 1)
    return _texel(tex, y, x)


def _bilinear(tex, u, v):
    """ClampToEdge bilinear sample of a (H, W[, C]) texture."""
    h, w = tex.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y0 = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    out = []
    for t00, t10, t01, t11 in zip(_texel(tex, y0, x0), _texel(tex, y0, x1),
                                  _texel(tex, y1, x0), _texel(tex, y1, x1)):
        top = t00 + (t10 - t00) * fx
        bot = t01 + (t11 - t01) * fx
        out.append(top + (bot - top) * fy)
    return out


def _lut_sample(lut_rgb, u):
    """256x1 Rgba8Unorm LUT, linear filter at (u, 0.5) (colormap_lut.rs)."""
    n = lut_rgb.shape[0]
    x = u * n - 0.5
    x0 = torch.floor(x)
    f = x - x0
    x0 = torch.clamp(x0.to(torch.int64), 0, n - 1)
    x1 = torch.clamp(x0 + 1, 0, n - 1)
    return [lut_rgb[x0, c] + (lut_rgb[x1, c] - lut_rgb[x0, c]) * f for c in range(3)]


def _gt(a, b):
    """(a > b) as a float 0/1 mask, in arithmetic: sign(a - b) is 1 exactly
    when a > b (no finite difference of a > b rounds to 0). PyTorch's
    where() and bool kernels run far slower than its float arithmetic on
    the CPU, and the cube samplers are the plain IBL bake's hot loop."""
    return torch.sign(a - b).clamp_(min=0.0)


def _dir_to_face_uv(d):
    """Inverse of uv_to_direction: face index (float) and face uv of
    directions, as screen.py:_dir_to_face_uv selects them. Each selection
    is a sum of masked terms: one term is the selected value and the others
    are +-0, so the sum is that value (up to the sign of a zero, which the
    `+ 1` after the division removes). In-place steps keep the bake's
    temporaries few; every step is one float32 operation as written."""
    x, y, z = d
    ax, ay, az = x.abs(), y.abs(), z.abs()
    gyx = _gt(ay, ax)
    ix = (1.0 - gyx).mul_(1.0 - _gt(az, ax))          # ax >= ay and ax >= az
    iy = gyx.mul_(1.0 - _gt(az, ay))                  # ay > ax and ay >= az
    iz = (1.0 - ix).sub_(iy)
    xp, yp, zp = _gt(x, 0.0), _gt(y, 0.0), _gt(z, 0.0)
    face = (1.0 - xp).mul_(ix).add_((3.0 - yp).mul_(iy)).add_((5.0 - zp).mul_(iz))
    uc = (2.0 * xp).sub_(1.0).mul_(-z).mul_(ix).add_(iy * x).add_(
        (2.0 * zp).sub_(1.0).mul_(x).mul_(iz))
    vc = (1.0 - iy).mul_(-y).add_((2.0 * yp).sub_(1.0).mul_(z).mul_(iy))
    ma = torch.maximum(torch.maximum(ax, ay), az).clamp_(min=1e-20)   # the chosen axis
    u = uc.div_(ma).add_(1.0).mul_(0.5)
    v = vc.div_(ma).add_(1.0).mul_(0.5)
    return face, u, v


def _planes(cube):
    """(3, 6 S S): a cube's channels as contiguous rows."""
    return cube.reshape(-1, 3).t().contiguous()


def _cube_sample(cube, dirs, planes=None):
    """Bilinear cube sample. cube: (6, S, S, 3); dirs: three tensors;
    `planes` the cube's _planes, where the caller keeps them. The texel
    indices are formed in float32, exact below 2**24."""
    face, u, v = _dir_to_face_uv(dirs)
    s = cube.shape[1]
    if planes is None:
        planes = _planes(cube)
    x = u.mul_(s).sub_(0.5)
    y = v.mul_(s).sub_(0.5)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x.sub_(x0).reshape(1, -1)
    fy = y.sub_(y0).reshape(1, -1)
    x0.clamp_(0.0, s - 1.0)
    y0.clamp_(0.0, s - 1.0)
    x1 = (x0 + 1.0).clamp_(max=s - 1.0)
    y1 = (y0 + 1.0).clamp_(max=s - 1.0)
    face.mul_(s)
    row0 = (face + y0).mul_(s)
    row1 = face.add_(y1).mul_(s)
    tap = lambda i: planes.index_select(1, i.reshape(-1).to(torch.int32))  # noqa: E731
    t00, t10, t01, t11 = tap(row0 + x0), tap(row0 + x1), tap(row1 + x0), tap(row1 + x1)
    top = t10.sub_(t00).mul_(fx).add_(t00)
    bot = t11.sub_(t01).mul_(fx).add_(t01)
    out = bot.sub_(top).mul_(fy).add_(top)
    return [out[c].reshape(x0.shape) for c in range(3)]


def _cube_sample_mips(mips, dirs, mip):
    """Trilinear between the two prefiltered mips that bracket `mip`,
    clamped to the chain (screen.py:304: it samples all six and selects
    two; the value is the same)."""
    max_mip = len(mips) - 1
    mip = torch.clamp(mip, 0.0, float(max_mip))
    lo = torch.floor(mip).to(torch.int64)
    f = mip - lo.to(_F32)
    hi = torch.clamp(lo + 1, max=max_mip)
    lo_s = [torch.zeros_like(mip) for _ in range(3)]
    hi_s = [torch.zeros_like(mip) for _ in range(3)]
    for m, cube in enumerate(mips):
        for sel, acc in ((lo == m, lo_s), (hi == m, hi_s)):
            if bool(sel.any()):
                got = _cube_sample(cube, [c[sel] for c in dirs])
                for c in range(3):
                    acc[c][sel] = got[c]
    return [a + (b - a) * f for a, b in zip(lo_s, hi_s)]


def _tangent_frame(n):
    """up = |n.z|<0.999 ? +Z : +X; t = norm(cross(up, n)); b = cross(n, t)."""
    zup = n[2].abs() < 0.999
    one, zero = torch.ones_like(n[0]), torch.zeros_like(n[0])
    up = [torch.where(zup, zero, one), zero, torch.where(zup, one, zero)]
    t = _normalize(_cross(up, n))
    return t, _cross(n, t)


# ---------------------------------------------------------------------------
# S1: the equirect-to-cube resample (screen.py:355-360)
# ---------------------------------------------------------------------------

_TABLES: Dict[tuple, torch.Tensor] = {}


def _table(kind: str, size: int, device) -> torch.Tensor:
    """The kernels' constant tables on `device`, made once: "dirs", the
    face directions _face_dirs(size) (6, size, size, 3); "lobe", the sample
    vectors of convolution `size` (lobe_samples)."""
    key = (kind, size, str(device))
    if key not in _TABLES:
        host = np.ascontiguousarray(_face_dirs(size), np.float32) if kind == "dirs" \
            else lobe_samples(size)
        _TABLES[key] = torch.as_tensor(host, device=device).contiguous()
    return _TABLES[key]


def _dirs_tensor(size, device):
    d = _table("dirs", size, device)
    return [d[..., c].contiguous() for c in range(3)]


def env_cube_plain(eq: torch.Tensor, size: int = ENV_SIZE) -> torch.Tensor:
    """Plain PyTorch version of S1: (6, size, size, 3) f16-rounded."""
    d = _dirs_tensor(size, eq.device)
    u = fdiv(torch.atan2(d[2], d[0]), f32(2.0 * math.pi)) + 0.5
    v = fdiv(torch.acos(torch.clamp(d[1], -1.0, 1.0)), f32(math.pi))
    out = _bilinear(_f16(eq), _mod1(u), _clip01(v))
    return _f16(torch.stack(out, -1))


def _env_cube_kernel(eq: torch.Tensor, size: int) -> torch.Tensor:
    if eq.dim() != 3 or eq.shape[2] != 3 or eq.dtype != _F32:
        raise ValueError("env_cube: eq must be float32 (H, W, 3)")
    dirs = _table("dirs", size, eq.device)
    _kernels.require_cuda("S1 env_cube", eq, dirs)
    out = torch.empty((6, size, size, 3), dtype=_F32, device=eq.device)
    err = _kernels.lib().f3d_ibl_env_cube(
        _kernels.ptr(eq), int(eq.shape[0]), int(eq.shape[1]), _kernels.ptr(dirs), int(size),
        _kernels.ptr(out), _kernels.stream_ptr(eq.device))
    _kernels.check(err, "S1 env_cube")
    env_cube.launches += 1
    return out


def env_cube(eq: torch.Tensor, size: int = ENV_SIZE) -> torch.Tensor:
    """S1: resample the equirect map `eq` (H, W, 3) to a (6, size, size, 3)
    cube, both sides f16-rounded. CPU tensors run the plain version."""
    eq = eq.contiguous()
    if eq.device.type == "cpu":
        return env_cube_plain(eq, size)
    return _env_cube_kernel(eq, size)


env_cube.launches = 0


# ---------------------------------------------------------------------------
# S2 and S3: the cube convolution (screen.py:363-422)
# ---------------------------------------------------------------------------

MODE_IRRADIANCE, MODE_PREFILTER = 0, 1


def lobe_samples(mip: int) -> torch.Tensor:
    """The (count, 3) sample vectors of one convolution, in JAX's order,
    computed in float32 on the host: mip 0 the 128 cosine samples of the
    irradiance, mips 1-5 the max(1024 >> mip, 64) GGX half vectors at
    roughness sqrt(mip / 5)."""
    if mip == 0:
        xi = torch.as_tensor(_hammersley(128))
        phi = f32(2.0 * math.pi) * xi[:, 0]
        ct = sqrt32(1.0 - xi[:, 1])
    else:
        rough = math.sqrt(mip / 5.0)
        a = rough * rough
        xi = torch.as_tensor(_hammersley(max(1024 >> mip, 64)))
        phi = f32(2.0 * math.pi) * xi[:, 0]
        ct = sqrt32((1.0 - xi[:, 1]) / (1.0 + f32(a * a - 1.0) * xi[:, 1]))
    st = sqrt32(1.0 - ct * ct)
    return torch.stack([torch.cos(phi) * st, torch.sin(phi) * st, ct], -1).contiguous()


def cube_convolve_plain(env: torch.Tensor, mip: int) -> torch.Tensor:
    """Plain PyTorch version of S2 (mip 0: the 128^2 irradiance) and S3
    (mips 1-5: the prefiltered (256 >> mip)^2 cube): a scan over the
    samples in order, the sum and the f16 rounding last."""
    size = IRR_SIZE if mip == 0 else env.shape[1] >> mip
    n = _dirs_tensor(size, env.device)
    t, b = _tangent_frame(n)
    smp = _table("lobe", mip, "cpu").tolist()
    planes = _planes(env)
    acc = [torch.zeros_like(n[0]) for _ in range(3)]
    wacc = torch.zeros_like(n[0])
    for s0, s1, s2 in smp:   # in place where it saves a temporary; the same operations
        d = [(t[c] * s0).add_(b[c] * s1).add_(n[c] * s2) for c in range(3)]
        nrm = _norm(d)
        d = [c.div_(nrm) for c in d]
        if mip == 0:
            col = _cube_sample(env, d, planes)
            for a_, c in zip(acc, col):
                a_.add_(c.mul_(s2))
            continue
        v2 = 2.0 * _dot(n, d)
        lv = [(hc * v2).sub_(nc) for hc, nc in zip(d, n)]
        ln = torch.clamp(_norm(lv), min=1e-20)
        lv = [c.div_(ln) for c in lv]
        ndl = torch.clamp(_dot(n, lv), min=0.0)
        col = _cube_sample(env, lv, planes)
        for a_, c in zip(acc, col):
            a_.add_(c.mul_(ndl))
        wacc.add_(ndl)
    if mip == 0:
        out = [_clip01(fdiv(f32(math.pi) * a, 128.0)) for a in acc]
    else:
        den = torch.clamp(wacc, min=1e-3)
        out = [_clip01(a / den) for a in acc]
    return _f16(torch.stack(out, -1))


#: the lanes that share a texel in each convolution (index: the mip, 0 the
#: irradiance), powers of two up to 32: the fastest of the sets timed on an
#: H100 in one launch (PERF.md §6)
CONV_GROUPS = (1, 2, 4, 8, 16, 32)


def conv_size(env_size: int, mip: int) -> int:
    """The texels a side of convolution `mip` of an env cube of env_size."""
    return IRR_SIZE if mip == 0 else env_size >> mip


def _rgbx(env: torch.Tensor) -> torch.Tensor:
    """The RGBx copy (6, S, S, 4), x = 0, of a (6, S, S, 3) cube."""
    return torch.cat([env, torch.zeros_like(env[..., :1])], -1).contiguous()


def _convolve_launch(env: torch.Tensor, mips, groups) -> list:
    """One launch of the convolutions `mips` of the cube, read from its RGBx
    copy, each texel on groups[mip] lanes, the largest first; their outputs
    in the order of `mips`."""
    if env.dim() != 4 or env.shape[0] != 6 or env.shape[3] != 3 or env.dtype != _F32:
        raise ValueError("cube_convolve: env must be a float32 (6, S, S, 3) cube")
    env4 = _rgbx(env)
    env_size = int(env.shape[1])
    outs, jobs = {}, []
    for mip in mips:
        size = conv_size(env_size, mip)
        dirs = _table("dirs", size, env.device)
        smp = _table("lobe", mip, env.device)
        out = torch.empty((6, size, size, 3), dtype=_F32, device=env.device)
        _kernels.require_cuda("S2/S3 cube_convolve", env4, dirs, smp, out)
        outs[mip] = out
        n, count = 6 * size * size, int(smp.shape[0])
        jobs.append((n * count, [dirs.data_ptr(), smp.data_ptr(), out.data_ptr(), n, count,
                                 MODE_IRRADIANCE if mip == 0 else MODE_PREFILTER,
                                 int(groups[mip])]))
    jobs.sort(key=lambda j: -j[0])     # the largest work first; sort is stable
    words = (ctypes.c_longlong * (7 * len(jobs)))(*(w for _, job in jobs for w in job))
    err = _kernels.lib().f3d_ibl_convolve(_kernels.ptr(env4), env_size, words, len(jobs),
                                          _kernels.stream_ptr(env.device))
    _kernels.check(err, "S2/S3 cube_convolve")
    cube_convolve.launches += 1
    return [outs[m] for m in mips]


def _cube_convolve_kernel(env: torch.Tensor, mip: int, groups=None) -> torch.Tensor:
    return _convolve_launch(env, [mip], groups or CONV_GROUPS)[0]


def cube_convolve(env: torch.Tensor, mip: int) -> torch.Tensor:
    """S2 (mip 0) or S3 (mips 1-5) of the env cube. CPU tensors run the
    plain version."""
    env = env.contiguous()
    if env.device.type == "cpu":
        return cube_convolve_plain(env, mip)
    return _cube_convolve_kernel(env, mip)


def _cube_pyramid_kernel(env: torch.Tensor, groups=None) -> list:
    return _convolve_launch(env, list(range(N_MIPS)), groups or CONV_GROUPS)


def cube_pyramid(env: torch.Tensor) -> list:
    """S2 and S3 of a pyramid, [irradiance, mip 1, ..., mip 5]: on the card
    one launch of all six, equal to six cube_convolve calls. CPU tensors run
    the plain versions."""
    env = env.contiguous()
    if env.device.type == "cpu":
        return [cube_convolve_plain(env, m) for m in range(N_MIPS)]
    return _cube_pyramid_kernel(env)


cube_convolve.launches = 0


# ---------------------------------------------------------------------------
# In-process caches of the IBL pyramid and the shadow map
# ---------------------------------------------------------------------------

_IBL_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_SHADOW_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()


def _cache_get(cache, key):
    if key in cache:
        cache.move_to_end(key)
        return cache[key][0]
    return None


def _cache_put(cache, key, value, nbytes: int, name: str):
    tracker = global_tracker()
    rid = tracker.track(name, nbytes, "screen")
    cache[key] = (value, rid)
    while len(cache) > CACHE_ENTRIES:
        old_key, (_, old) = cache.popitem(last=False)
        tracker.free(old)
        _SHADOW_TEX.pop(old_key, None)
    return value


def clear_caches() -> None:
    """Drop the cached IBL pyramids and shadow maps with their textures
    (and their ledger records)."""
    tracker = global_tracker()
    for cache in (_IBL_CACHE, _SHADOW_CACHE):
        for key, (_, rid) in list(cache.items()):
            tracker.free(rid)
            _SHADOW_TEX.pop(key, None)
        cache.clear()


class ShadowTexture:
    """S8's and S9's view of a shadow map: a texture object over the (R, R) float32
    map itself, a pitch-2D resource that takes no memory of its own
    (csrc/screen.cu:f3d_shadow_texture_create: point filtering, clamp
    addressing, unnormalised coordinates), through which its PCSS taps are
    fetched. It holds the map until it is closed or collected. Raises
    where the texture cannot be made (a map that is not contiguous, or
    whose start or row pitch the texture unit cannot address)."""

    def __init__(self, depth: torch.Tensor):
        self.res = int(depth.shape[0])
        if depth.dim() != 2 or depth.shape[1] != self.res or not depth.is_contiguous():
            raise ValueError(f"a shadow texture is made of a contiguous square map, got "
                             f"{tuple(depth.shape)}")
        self._lib = _kernels.lib()
        tex = ctypes.c_ulonglong(0)
        _kernels.check(self._lib.f3d_shadow_texture_create(_kernels.ptr(depth), self.res,
                                                           ctypes.byref(tex)),
                       "S5 shadow texture")
        self.handle, self._depth = int(tex.value), depth

    def close(self) -> None:
        if self._depth is not None:
            err = self._lib.f3d_shadow_texture_destroy(self.handle)
            self._depth = None
            _kernels.check(err, "S5 shadow texture")

    def __del__(self):
        try:
            self.close()
        except Exception:   # the CUDA context may be gone at interpreter exit
            pass


# the textures of the cached shadow maps, by the maps' cache keys
_SHADOW_TEX: Dict[tuple, ShadowTexture] = {}


def shadow_texture(depth: torch.Tensor) -> ShadowTexture:
    """The texture S8 and S9 read `depth` through: for a map of the shadow cache,
    the one made with its cache entry on first use and dropped with the
    entry; for any other map a new one that lives as long as its holder."""
    for key, (value, _) in _SHADOW_CACHE.items():
        if value[0] is depth:
            if key not in _SHADOW_TEX:
                _SHADOW_TEX[key] = ShadowTexture(depth)
            return _SHADOW_TEX[key]
    return ShadowTexture(depth)


def build_ibl(hdr_rgb, *, device="cuda") -> dict:
    """Split-sum IBL pyramid per the reference pipeline (IBLQuality::Medium)
    on `device`, the card unless device="cpu": S1 (the 256^2 env cube, which
    is also mip 0), S2 (the 128^2 irradiance) and S3 (mips 1-5) in one launch
    (cube_pyramid), and the BRDF LUT (zero unless
    FORGE3D_IBL_BRDF=analytic). Cached in process by screen.py's key."""
    from ..pt.terrain_ref import resolve_device

    device = resolve_device(device)
    hdr_rgb = np.asarray(hdr_rgb, np.float32)
    brdf_mode = os.environ.get("FORGE3D_IBL_BRDF", "golden")
    key = (_hash(hdr_rgb, "iblj-v1", brdf_mode), str(device))
    hit = _cache_get(_IBL_CACHE, key)
    if hit is not None:
        return hit
    eq = torch.as_tensor(np.ascontiguousarray(hdr_rgb), device=device)
    env = env_cube(eq, ENV_SIZE)
    irradiance, *mips = cube_pyramid(env)
    spec_mips = [env] + mips
    brdf = torch.as_tensor(_build_brdf_lut(), device=device)
    ibl = {"irradiance": irradiance, "spec_mips": spec_mips, "brdf": brdf}
    nbytes = sum(t.numel() * 4 for t in [irradiance, brdf, *spec_mips])
    return _cache_put(_IBL_CACHE, key, ibl, nbytes, f"screen.ibl[{key[0][:8]}]")


# ---------------------------------------------------------------------------
# S4: the shadow depth raster (screen.py:464-519) and build_shadow_map's
# host geometry (screen.py:522-621, copied)
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """float32 a * b + c rounded once (fmaf): the product is exact in
    float64, the sum is rounded to float64 and then to float32."""
    return (a.double() * b.double() + c.double()).to(_F32)


def _xy_minus_uv(x, y, u, v):
    """x * y - u * v as XLA contracts it on _raster_depth: fma(x, y, -(u v))."""
    return _fma(x, y, -(u * v))


def _triangle_setup(tris: torch.Tensor, keep: torch.Tensor):
    """Per-triangle constants of the raster: live mask, bias, pixel bounds
    and 1 / area (screen.py:472-496). The raster's products follow the
    fused multiply-adds that XLA forms in _raster_depth (its depth map
    matches them bit for bit on the CPU; see _xy_minus_uv)."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    area2 = _xy_minus_uv(b[:, 0] - a[:, 0], c[:, 1] - a[:, 1], b[:, 1] - a[:, 1],
                         c[:, 0] - a[:, 0])
    live = keep & (area2.abs() > 1e-12)
    safe = torch.where(live, area2, torch.ones_like(area2))
    dzdx = _xy_minus_uv(c[:, 2] - a[:, 2], b[:, 1] - a[:, 1], b[:, 2] - a[:, 2],
                        c[:, 1] - a[:, 1]) / safe
    dzdy = _xy_minus_uv(b[:, 2] - a[:, 2], c[:, 0] - a[:, 0], c[:, 2] - a[:, 2],
                        b[:, 0] - a[:, 0]) / safe
    m = torch.maximum(dzdx.abs(), dzdy.abs())
    zmax = torch.clamp(torch.maximum(torch.maximum(a[:, 2].abs(), b[:, 2].abs()), c[:, 2].abs()),
                       min=1e-20)
    e = (torch.floor(torch.log2(zmax)) - 23.0).to(torch.int32)
    r_unit = torch.ldexp(torch.ones_like(zmax), e)
    bias = 2.0 * m + 2.0 * r_unit
    xmin = torch.floor(torch.minimum(torch.minimum(a[:, 0], b[:, 0]), c[:, 0]) + 0.5)
    ymin = torch.floor(torch.minimum(torch.minimum(a[:, 1], b[:, 1]), c[:, 1]) + 0.5)
    xmax = torch.ceil(torch.maximum(torch.maximum(a[:, 0], b[:, 0]), c[:, 0]) - 0.5)
    ymax = torch.ceil(torch.maximum(torch.maximum(a[:, 1], b[:, 1]), c[:, 1]) - 0.5)
    return live, bias, xmin, ymin, xmax, ymax, fdiv(1.0, safe)


def raster_depth_plain(tris: torch.Tensor, keep: torch.Tensor, resolution: int, wbb: int,
                       hbb: int) -> torch.Tensor:
    """Plain PyTorch version of S4: JAX's loop over the wbb x hbb offsets
    of every triangle's box, each step a scatter-min of the covered
    pixels' depths; masked lanes write the clear value, which a min
    leaves unchanged. A triangle whose box a row offset leaves is dropped
    from the rows after it, since every larger offset leaves it too."""
    live, bias, xmin, ymin, xmax, ymax, inv = _triangle_setup(tris, keep)
    depth = torch.ones(resolution * resolution, dtype=_F32, device=tris.device)
    cols = [tris[:, i, j].contiguous() for i in range(3) for j in range(3)]
    rows = torch.nonzero(live).squeeze(1)
    for dy in range(hbb):
        rows = rows[ymin.index_select(0, rows) + float(dy) + 0.5
                    <= ymax.index_select(0, rows) + 0.5]
        if rows.numel() == 0:
            break
        ax, ay, az, bx, by, bz, cx, cy, cz = (c.index_select(0, rows) for c in cols)
        r_xmin, r_xmax, r_bias, r_inv = (t.index_select(0, rows) for t in (xmin, xmax, bias, inv))
        py = ymin.index_select(0, rows) + float(dy) + 0.5
        ys = torch.clamp(py.to(torch.int64), 0, resolution - 1) * resolution
        for dx in range(wbb):
            px = r_xmin + float(dx) + 0.5
            w0 = _xy_minus_uv(bx - px, cy - py, cx - px, by - py) * r_inv
            w1 = _xy_minus_uv(cx - px, ay - py, ax - px, cy - py) * r_inv
            w2 = 1.0 - w0 - w1
            inside = (px <= r_xmax + 0.5) & (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            z = torch.clamp(_fma(w2, cz, _fma(w0, az, w1 * bz)) + r_bias, 0.0, 1.0)
            # -0.0 -> +0.0, as the kernel stores it; masked lanes write the
            # clear value 1.0, which a min leaves unchanged
            z = torch.where(inside, z + 0.0, 1.0)
            xs = torch.clamp(px.to(torch.int64), 0, resolution - 1)
            depth.scatter_reduce_(0, ys + xs, z, reduce="amin")
    return depth.reshape(resolution, resolution)


def _raster_depth_kernel(tris: torch.Tensor, keep: torch.Tensor, resolution: int, wbb: int,
                         hbb: int) -> torch.Tensor:
    if tris.dim() != 3 or tuple(tris.shape[1:]) != (3, 3) or tris.dtype != _F32:
        raise ValueError("raster_depth: tris must be float32 (T, 3, 3)")
    keep8 = keep.to(torch.uint8).contiguous()
    _kernels.require_cuda("S4 raster_depth", tris, keep8)
    depth = torch.ones((resolution, resolution), dtype=_F32, device=tris.device)
    err = _kernels.lib().f3d_raster_depth(
        _kernels.ptr(tris), _kernels.ptr(keep8), int(tris.shape[0]), int(resolution), int(wbb),
        int(hbb), _kernels.ptr(depth), _kernels.stream_ptr(tris.device))
    _kernels.check(err, "S4 raster_depth")
    raster_depth.launches += 1
    return depth


def raster_depth(tris: torch.Tensor, keep: torch.Tensor, resolution: int, wbb: int,
                 hbb: int) -> torch.Tensor:
    """S4: depth-only raster of `tris` (T, 3, 3) in framebuffer coordinates
    (x, y, depth) where `keep` (T,) holds, into a (resolution,)^2 map
    cleared to 1.0 (wgpu cull Back, depth Less, bias constant 2 slope 2).
    CPU tensors run the plain version."""
    tris = tris.contiguous()
    if tris.device.type == "cpu":
        return raster_depth_plain(tris, keep, resolution, wbb, hbb)
    return _raster_depth_kernel(tris, keep, resolution, wbb, hbb)


raster_depth.launches = 0


def shadow_geometry(heightmap, *, terrain_span, z_scale, sun_dir, resolution=SHADOW_RES,
                    grid_res=SHADOW_GRID, domain=(0.0, 1.0)):
    """build_shadow_map's host part (screen.py:538-620): the light's ortho
    view-projection, the texel size, the grid's triangles in framebuffer
    coordinates, the whole-pass orientation vote and the raster's static
    box bounds. Returns (lvp, texel, tris (T, 3, 3), keep (T,), wbb, hbb)."""
    heightmap = np.asarray(heightmap, np.float32)
    light_dir = np.asarray(sun_dir, np.float32)
    light_dir = light_dir / np.linalg.norm(light_dir)
    light_up = np.array([0.0, 1.0, 0.0], np.float32) \
        if abs(light_dir[2]) > 0.99 else np.array([0.0, 0.0, 1.0],
                                                  np.float32)

    lo_d, hi_d = float(domain[0]), float(domain[1])
    rng_d = max(hi_d - lo_d, 1e-6)
    half = terrain_span * 0.5
    tmin = np.array([-half, -half, 0.0], np.float32)
    tmax = np.array([half, half, z_scale], np.float32)
    center = (tmin + tmax) * 0.5
    diag = np.linalg.norm(tmax - tmin)
    cam_pos = center - light_dir * (diag * 2.0)
    view = look_to_rh(cam_pos, light_dir, light_up)

    corners = np.array([[x, y, z] for z in (tmin[2], tmax[2])
                        for y in (tmin[1], tmax[1])
                        for x in (tmin[0], tmax[0])], np.float32)
    lc = (view[:3, :3] @ corners.T).T + view[:3, 3]
    lmin = lc.min(0) - terrain_span * 0.3
    lmax = lc.max(0) + terrain_span * 0.3
    zpad = terrain_span * 0.1
    proj = orthographic_rh(lmin[0], lmax[0], lmin[1], lmax[1],
                           -lmax[2] - zpad, -lmin[2] + zpad)
    lvp = proj @ view
    texel = (lmax[0] - lmin[0]) / resolution

    # grid vertices: uv i/(grid-1); height textureLoad at floor(uv*dims)
    g = np.arange(grid_res, dtype=np.float32) / (grid_res - 1)
    hdim = heightmap.shape
    tx = np.clip((g * hdim[1]).astype(np.int64), 0, hdim[1] - 1)
    ty = np.clip((g * hdim[0]).astype(np.int64), 0, hdim[0] - 1)
    hgrid = heightmap[np.ix_(ty, tx)]
    wx = (g - 0.5) * terrain_span
    wz = (np.clip(hgrid, lo_d, hi_d) - lo_d) / rng_d * z_scale

    X, Y = np.meshgrid(wx, wx)
    P = np.stack([X, Y, wz], -1).reshape(-1, 3)
    ndc = (lvp[:3, :3] @ P.T).T + lvp[:3, 3]
    fx = ((ndc[:, 0] * 0.5 + 0.5) * resolution).reshape(grid_res, grid_res)
    fy = ((0.5 - ndc[:, 1] * 0.5) * resolution).reshape(grid_res, grid_res)
    fz = ndc[:, 2].reshape(grid_res, grid_res)

    # quad triangles per terrain_shadow_depth.wgsl:
    # t0=(0,0)(1,0)(0,1), t1=(1,0)(1,1)(0,1)
    v00 = np.stack([fx[:-1, :-1], fy[:-1, :-1], fz[:-1, :-1]], -1)
    v10 = np.stack([fx[:-1, 1:], fy[:-1, 1:], fz[:-1, 1:]], -1)
    v01 = np.stack([fx[1:, :-1], fy[1:, :-1], fz[1:, :-1]], -1)
    v11 = np.stack([fx[1:, 1:], fy[1:, 1:], fz[1:, 1:]], -1)
    v00 = v00.reshape(-1, 3)
    v10 = v10.reshape(-1, 3)
    v01 = v01.reshape(-1, 3)
    v11 = v11.reshape(-1, 3)
    tris = np.concatenate([
        np.stack([v00, v10, v01], 1),
        np.stack([v10, v11, v01], 1)], 0)

    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    area2 = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
             - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
    # wgpu front_face=Ccw in NDC = CW in framebuffer = negative area; the
    # whole-pass orientation vote mirrors the oracle's Back-cull outcome.
    keep = area2 < 0.0
    if keep.sum() < (~keep).sum():
        keep = ~keep

    # static bbox bounds for the raster loop (per-scene; cached with it)
    live = keep & (np.abs(area2) > 1e-12)
    if live.any():
        la, lb, lc2 = a[live], b[live], c[live]
        xmin = np.floor(np.minimum(np.minimum(la[:, 0], lb[:, 0]),
                                   lc2[:, 0]) + 0.5)
        ymin = np.floor(np.minimum(np.minimum(la[:, 1], lb[:, 1]),
                                   lc2[:, 1]) + 0.5)
        xmax = np.ceil(np.maximum(np.maximum(la[:, 0], lb[:, 0]),
                                  lc2[:, 0]) - 0.5)
        ymax = np.ceil(np.maximum(np.maximum(la[:, 1], lb[:, 1]),
                                  lc2[:, 1]) - 0.5)
        wbb = int(np.clip((xmax - xmin).max() + 1, 1, 64))
        hbb = int(np.clip((ymax - ymin).max() + 1, 1, 64))
    else:
        wbb = hbb = 1
    return lvp, texel, np.ascontiguousarray(tris, np.float32), keep, wbb, hbb


def build_shadow_map(heightmap, *, terrain_span, z_scale, sun_dir, resolution=SHADOW_RES,
                     grid_res=SHADOW_GRID, domain=(0.0, 1.0), device="cuda"):
    """Rasterize the DEM grid into the light's ortho depth map on `device`,
    the card unless device="cpu" (S4), with the host-computed light
    matrices. Returns (depth (R, R) tensor, light_view_proj 4x4 numpy,
    texel_size). sun_dir is the NEGATED light direction
    (shadows/setup.rs:150-153). Cached in process by screen.py's key."""
    from ..pt.terrain_ref import resolve_device

    device = resolve_device(device)
    heightmap = np.asarray(heightmap, np.float32)
    key = (_hash(heightmap, terrain_span, z_scale, np.asarray(sun_dir), resolution, grid_res,
                 domain, "shadowj-v1"), str(device))
    hit = _cache_get(_SHADOW_CACHE, key)
    if hit is not None:
        return hit
    lvp, texel, tris, keep, wbb, hbb = shadow_geometry(
        heightmap, terrain_span=terrain_span, z_scale=z_scale, sun_dir=sun_dir,
        resolution=resolution, grid_res=grid_res, domain=domain)
    depth = raster_depth(torch.as_tensor(tris, device=device),
                         torch.as_tensor(keep, device=device), resolution, wbb, hbb)
    return _cache_put(_SHADOW_CACHE, key, (depth, lvp, texel), depth.numel() * 4,
                      f"screen.shadow[{key[0][:8]}]")


# ---------------------------------------------------------------------------
# S5: PCSS shadow visibility (screen.py:634-710); on the card it runs inside
# S8 (csrc/screen.cuh:pcss_visibility)
# ---------------------------------------------------------------------------

def _pcf2x2(depth_map, u, v, ref):
    """Hardware PCF: bilinear weight of per-texel (ref <= texel)."""
    r = depth_map.shape[0]
    x = u * r - 0.5
    y = v * r - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, r - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, r - 1)
    x1i = torch.clamp(x0i + 1, 0, r - 1)
    y1i = torch.clamp(y0i + 1, 0, r - 1)
    c00 = (ref <= depth_map[y0i, x0i]).to(_F32)
    c10 = (ref <= depth_map[y0i, x1i]).to(_F32)
    c01 = (ref <= depth_map[y1i, x0i]).to(_F32)
    c11 = (ref <= depth_map[y1i, x1i]).to(_F32)
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def light_dir_unit(light_dir_csm) -> Tuple[float, float, float]:
    """light_dir_csm / |light_dir_csm| in float32 (screen.py:669)."""
    d = np.asarray(light_dir_csm, np.float32)
    n = np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return tuple(float(c / n) for c in d)


def _pcss(depth_map, lvp, sp, nrm, ld):
    """PCSS visibility of receivers `sp` (three tensors) with normals `nrm`
    and the unit light direction `ld`, at pcss_visibility's defaults."""
    L = np.asarray(lvp, np.float32)
    ndc = [sp[0] * float(L[k, 0]) + sp[1] * float(L[k, 1]) + sp[2] * float(L[k, 2])
           + float(L[k, 3]) for k in range(3)]
    su = ndc[0] * 0.5 + 0.5
    sv = ndc[1] * -0.5 + 0.5
    depth01 = ndc[2]
    ndl = torch.clamp(_dot(nrm, ld), min=0.0)
    slope = _clip01(1.0 - ndl)
    cmp = depth01 - (f32(0.0005) + f32(0.001) * slope + f32(0.0002))
    inb = (su >= 0) & (su <= 1) & (sv >= 0) & (sv <= 1) & (depth01 >= 0) & (depth01 <= 1)

    r = depth_map.shape[0]
    sr = f32(min(6.0, 50.0) * (1.0 / 4096.0))
    bsum = torch.zeros_like(su)
    bcnt = torch.zeros_like(su)
    for pu, pv in _POISSON_12:
        bu = su + float(pu) * sr
        bv = sv + float(pv) * sr
        binb = (bu >= 0) & (bu <= 1) & (bv >= 0) & (bv <= 1)
        tx = torch.clamp(bu * r, 0.0, r - 1.0).to(torch.int64)
        ty = torch.clamp(bv * r, 0.0, r - 1.0).to(torch.int64)
        sdep = depth_map[ty, tx]
        is_blk = binb & (sdep < cmp)
        bsum = bsum + torch.where(is_blk, sdep, 0.0)
        bcnt = bcnt + is_blk.to(_F32)
    has_blk = bcnt > 0
    avg_blk = torch.where(has_blk, bsum / torch.clamp(bcnt, min=1.0), -1.0)
    pen = torch.clamp(cmp - avg_blk, min=0.0) * 1.0 / torch.clamp(avg_blk, min=0.001)
    pen = torch.clamp(pen, 0.0, 100.0)
    fr = torch.clamp(torch.clamp(pen, min=1.0), max=4.0)
    sfr = fdiv(fr, 4096.0)
    cref = _clip01(cmp)
    ssum = torch.zeros_like(su)
    for pu, pv in _POISSON_16:
        fu = su + float(pu) * sfr
        fv = sv + float(pv) * sfr
        finb = (fu >= 0) & (fu <= 1) & (fv >= 0) & (fv <= 1)
        ssum = ssum + torch.where(finb, _pcf2x2(depth_map, fu, fv, cref), 1.0)
    ssum = fdiv(ssum, 16.0)
    vin = torch.where(has_blk, ssum, 1.0)
    return torch.where(inb, vin, 1.0)


def pcss_visibility(depth_map, lvp, texel_size, shadow_pos, normal, light_dir_csm):
    """sample_shadow_pcf_terrain, technique PCSS, at its defaults (shadow
    map 4096, blocker radius 6, filter radius 4, light size 1, biases
    0.0005 / 0.001 / 0.0002): the plain version of S5. shadow_pos and
    normal are (..., 3) tensors; returns (...) visibility."""
    sp = [shadow_pos[..., c] for c in range(3)]
    nrm = [normal[..., c] for c in range(3)]
    return _pcss(depth_map, lvp, sp, nrm, light_dir_unit(light_dir_csm))


# ---------------------------------------------------------------------------
# S7: parallax occlusion mapping (screen.py:979-1035); on the card it runs
# inside S8 and S9 (csrc/screen.cuh:pom_uv)
# ---------------------------------------------------------------------------

def _pom_uv(hm, u, v, n, view_dir, *, scale, min_steps, max_steps, refine_steps,
            samp=_nearest):
    """parallax_occlusion_mapping as screen.py:_pom_uv computes it: the TBN of
    the blended normal `n`, a step count between min_steps and max_steps set
    by the view angle, the height march (a lane stops once its layer reaches
    the height, and never resumes, so the loop ends when every lane has
    stopped) and `refine_steps` halvings. `n` and `view_dir` are three
    tensors each; `samp` is the height sampler. Returns (u', v', layer,
    crossed). Adds the lanes' marched steps to `_pom_uv.marched`."""
    zero = torch.zeros_like(u)
    yup = n[1].abs() > 0.99
    up = [zero, torch.where(yup, 0.0, 1.0), torch.where(yup, 1.0, 0.0)]
    t = _normalize(_cross(up, n))
    b = _cross(n, t)
    vd = _normalize([t[c] * view_dir[0] + b[c] * view_dir[1] + n[c] * view_dir[2]
                     for c in range(3)])
    blend = _clip01(vd[2].abs())
    steps = torch.clamp(torch.round(blend * float(min_steps - max_steps) + float(max_steps)),
                        1.0, float(max_steps))
    L = sqrt32(vd[0] * vd[0] + vd[1] * vd[1])
    active = L >= 1e-5
    Lc = torch.clamp(L, min=1e-20)
    pdx = vd[0] / Lc * scale
    pdy = vd[1] / Lc * scale
    step = fdiv(1.0, steps)
    h = lambda a, c: samp(hm, _clip01(a), _clip01(c))[0]  # noqa: E731
    cu, cv, layer, ch = u, v, zero, h(u, v)
    for i in range(int(max_steps)):
        go = active & (steps > i) & (layer < ch)
        n_go = int(go.sum())
        if n_go == 0:
            break
        _pom_uv.marched += n_go
        cu = torch.where(go, cu - pdx * step, cu)
        cv = torch.where(go, cv - pdy * step, cv)
        layer = torch.where(go, layer + step, layer)
        ch = torch.where(go, h(cu, cv), ch)
    crossed = active & (layer >= ch)
    rss = step
    for _ in range(int(refine_steps)):
        du = pdx * rss * 0.5
        dv = pdy * rss * 0.5
        rss = rss * 0.5
        ge = layer >= h(cu, cv)
        cu = torch.where(active, torch.where(ge, cu - du, cu + du), cu)
        cv = torch.where(active, torch.where(ge, cv - dv, cv + dv), cv)
        layer = torch.where(active, torch.where(ge, layer - rss, layer + rss), layer)
    return (torch.where(active, _clip01(cu), u), torch.where(active, _clip01(cv), v),
            torch.where(active, layer, zero), crossed)


_pom_uv.marched = 0


def pom_config(pom, generation: str) -> Optional[dict]:
    """The POM settings a render runs (screen.py:1673-1686), or None."""
    if pom is None or not pom.get("enabled", False) or not pom.get("height_scale", 0.0) > 0.0:
        return None
    return dict(enabled=True, height_scale=float(pom["height_scale"]),
                min_steps=int(pom.get("min_steps", 1)), max_steps=int(pom.get("max_steps", 1)),
                refine_steps=int(pom.get("refine_steps", 0)),
                occlusion=bool(pom.get("occlusion", True)),
                # the family generation converts the layer to a height where the
                # march crossed; the recipe generation keeps the displaced sample
                layer_height=(generation == "family"))


def _pom_kw(pom: dict) -> dict:
    return dict(scale=pom["height_scale"], min_steps=pom["min_steps"],
                max_steps=pom["max_steps"], refine_steps=pom["refine_steps"])


# ---------------------------------------------------------------------------
# S6: the analytic sky (screen.py:748-877) and the aerial perspective that
# blends it into the shade (:1508-1541); on the card a branch of S8
# (csrc/screen.cuh:sky_pixel, aerial_blend). The per-channel Hosek configs
# are cooked on the host (:719-745); every other per-image value is a
# float32 scalar computed here once, in JAX's order, and read by both the
# kernel and the plain version.
# ---------------------------------------------------------------------------

HOSEK_NAMES = ("hosek-wilkie", "hosek_wilkie", "hosekwilkie")
SKY_HOSEK, SKY_PREETHAM = 1, 2


def _cook_sky_uniforms(sky_cfg, light_dir):
    from ..sky import _cook_channel, _hosek_data

    sun_dir = np.array([light_dir[0], light_dir[2], light_dir[1]],
                       np.float32)
    turbidity = float(np.clip(sky_cfg["turbidity"], 1.0, 10.0))
    albedo = float(np.clip(sky_cfg["ground_albedo"], 0.0, 1.0))
    sky_sun_y = float(np.clip(light_dir[2], 0.0, 1.0))
    solar_elev = float(np.clip(np.arcsin(sky_sun_y), 0.0, np.pi / 2))
    cfgs, rads = _hosek_data()
    configs = []
    radiances = []
    for ch in range(3):
        cc, rr = _cook_channel(cfgs[ch], rads[ch], turbidity, albedo,
                               solar_elev)
        configs.append(np.asarray(cc, np.float32))
        radiances.append(np.float32(rr))
    return {
        "sky_sun_dir": sun_dir,
        "sky_configs": np.stack(configs, 0),
        "sky_radiances": np.array(radiances, np.float32),
        "sky_turbidity": np.float32(turbidity),
        "sky_albedo": np.float32(albedo),
        "sky_sun_intensity": np.float32(max(sky_cfg["sun_intensity"], 0.0)),
        "sky_sun_size": np.float32(max(sky_cfg["sun_size"], 0.0)),
        "sky_exposure": np.float32(max(sky_cfg["sky_exposure"], 0.0)),
    }


def _smooth32(e0, e1, x):
    t = _clip01(fdiv(x - e0, e1 - e0))
    return t * t * (3.0 - 2.0 * t)


def _vec32(*v):
    return torch.tensor(v, dtype=_F32)


def sky_consts(u: dict, model: str, inv_view, inv_proj) -> dict:
    """The sky pass's per-image constants (screen.py:748-877) from the cooked
    uniforms `u`, as float32 scalars (Python floats) and lists of them."""
    T = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    sun, tb, alb = T(u["sky_sun_dir"]), T(u["sky_turbidity"]), T(u["sky_albedo"])
    inten, ssize = T(u["sky_sun_intensity"]), T(u["sky_sun_size"])
    cfg = T(u["sky_configs"])
    I = cfg[:, 8]   # noqa: E741
    k = {"model": SKY_HOSEK if model in HOSEK_NAMES else SKY_PREETHAM,
         "sun": sun.tolist(), "cfg": cfg.reshape(-1).tolist(),
         "rad": T(u["sky_radiances"]).tolist(), "mie_k1": (1.0 + I * I).tolist(),
         "mie_k2": (2.0 * I).tolist(),
         "inv_view": np.asarray(inv_view, np.float32).reshape(-1).tolist(),
         "inv_proj": np.asarray(inv_proj, np.float32).reshape(-1).tolist()}
    # Preetham (sky.wgsl eval_preetham), luminance only
    A = 0.1787 * tb - 1.4630
    B = -0.3554 * tb + 0.4275
    C = -0.0227 * tb + 5.3251
    D = 0.1206 * tb - 2.5771
    E = -0.0670 * tb + 0.3703
    cts = torch.clamp(sun[1], min=0.0)
    g1 = torch.acos(torch.clamp(cts, -1.0, 1.0))
    perez1 = (1.0 + A * torch.exp(fdiv(B, 1.0 + 0.01))) * (1.0 + C * torch.exp(D * g1)
                                                           + E * cts * cts)
    sunset = _clip01(fdiv(g1 - 1.4, 0.4))      # g1 is also the sun's angle
    sunset = sunset * sunset * (3.0 - 2.0 * sunset)
    zc = _vec32(0.4, 0.5, 0.8)
    dusk = zc + (_vec32(1.0, 0.6, 0.3) - zc) * sunset
    k.update(pA=A, pB=B, pC=C, pD=D, pE=E, p_den=torch.clamp(perez1, min=0.01),
             p_col=_vec32(0.3, 0.5, 1.0) if bool(cts > 0.1) else dusk,
             p_haze=fdiv(tb - 2.0, 8.0), p_mix=torch.clamp(fdiv(tb, 10.0), max=0.5),
             p_alb=1.0 + alb * 0.2)
    # night fade, sun disc and glow
    solar_alt = torch.asin(torch.clamp(sun[1], -1.0, 1.0)) * f32(180.0 / math.pi)
    daylight = _clip01(fdiv(solar_alt + 18.0, 14.0))
    n0 = _vec32(0.002, 0.003, 0.009)
    sun_radius = 0.0093 * torch.clamp(ssize, min=0.01)
    scr = torch.cos(sun_radius)
    gcos = torch.cos(torch.maximum(0.05 * torch.clamp(ssize, min=0.25), sun_radius * 2.0))
    k.update(daylight=daylight * daylight * (3.0 - 2.0 * daylight), night0=n0,
             night_d=_vec32(0.008, 0.012, 0.024) - n0, disc_cos=scr,
             limb_den=torch.clamp(1.0 - scr, min=1e-9),
             disc_c=_vec32(1.0, 0.95, 0.9) * (inten * 50.0), glow_cos=gcos,
             glow_den=torch.clamp(scr - gcos, min=1e-9),
             ring_c=_vec32(1.0, 0.8, 0.6) * (inten * 2.0))
    # solar scattering, exposure
    low_sun = 1.0 - _smooth32(0.18, 0.72, torch.clamp(sun[1], min=0.0))
    haze = _clip01(fdiv(tb - 1.0, 9.0))
    size_norm = _clip01(fdiv(ssize, 4.0))
    w0, d0 = _vec32(1.0, 0.95, 0.9), _vec32(1.0, 0.97, 0.92)
    sunset_c = w0 + (_vec32(1.0, 0.72, 0.42) - w0) * (low_sun * (0.75 + haze * 0.2))
    day_c = d0 + (_vec32(1.0, 0.9, 0.78) - d0) * (haze * 0.6)
    k.update(low_sun=low_sun, e_fwd=22.0 + (4.0 - 22.0) * size_norm,
             e_broad=10.0 + (2.5 - 10.0) * size_norm, inten=inten,
             k_broad=0.06 + size_norm * 0.08, hglow_k=0.35 + haze * 0.35 + size_norm * 0.2,
             amb=inten * (0.02 + haze * 0.03), scat_c=day_c + (sunset_c - day_c) * low_sun,
             exposure=T(u["sky_exposure"]))
    return {key: (val.tolist() if isinstance(val, torch.Tensor) else val)
            for key, val in k.items()}


def aerial_consts(u: dict, ldir) -> dict:
    """The aerial perspective's per-image constants (screen.py:1514-1540)."""
    T = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    sun_i, sun_sz = T(u["sky_sun_intensity_raw"]), T(u["sky_sun_size_raw"])
    low_sun = 1.0 - _smooth32(0.18, 0.72, torch.clamp(T(ldir)[2], min=0.0))
    haze = _clip01(fdiv(T(u["sky_turbidity"]) - 1.0, 9.0))
    sun_energy = torch.clamp(sun_i * (0.5 + sun_sz * 0.35), 0.0, 8.0)
    warm = 1.0 + (_vec32(1.16, 0.98, 0.82) - 1.0) * (low_sun * (0.55 + haze * 0.25))
    k = dict(density_neg=-T(u["sky_aerial_density"]), k_fac=0.08 + haze * 0.04,
             k_amt=0.8 + haze * 0.25 + sun_energy * 0.05, k_desat=0.4 + haze * 0.15,
             k_target=1.0 + sun_energy * 0.04, tint=1.0 + (warm - 1.0) * low_sun,
             add=_vec32(0.14, 0.07, 0.025) * (low_sun * sun_energy * 0.18
                                                * T(u["sky_exposure"])),
             k_blend=0.34 + low_sun * 0.18 + haze * 0.12)
    return {key: val.tolist() for key, val in k.items()}


def _pixel_grid(W, H, device):
    """((x + 0.5) / W, (y + 0.5) / H) of every pixel, (H, W) each."""
    px = fdiv(torch.arange(W, dtype=_F32, device=device) + 0.5, float(W)).expand(H, W)
    py = fdiv(torch.arange(H, dtype=_F32, device=device) + 0.5, float(H))[:, None].expand(H, W)
    return px, py


def sky_plain(k: dict, W: int, H: int, device) -> list:
    """Plain PyTorch version of S6's sky: three (H, W) channels in k/255
    steps (screen.py:_render_sky)."""
    px, py = _pixel_grid(W, H, device)
    ndc = [px * 2.0 - 1.0, 1.0 - py * 2.0]
    P, V = k["inv_proj"], k["inv_view"]
    vp = [ndc[0] * P[4 * r] + ndc[1] * P[4 * r + 1] + P[4 * r + 2] + P[4 * r + 3]
          for r in range(4)]
    vdir = [vp[c] / vp[3] for c in range(3)]
    nv = _norm(vdir)
    vdir = [c / nv for c in vdir]
    wdir = [vdir[0] * V[4 * r] + vdir[1] * V[4 * r + 1] + vdir[2] * V[4 * r + 2]
            for r in range(3)]
    nw = _norm(wdir)
    wdir = [c / nw for c in wdir]
    ct = torch.clamp(wdir[1], min=0.0)
    cg = _dot(wdir, k["sun"])
    gamma = torch.acos(torch.clamp(cg, -1.0, 1.0))
    ray_m = cg * cg
    if k["model"] == SKY_HOSEK:
        zenith = sqrt32(torch.clamp(ct, min=0.0))
        color = []
        for ch in range(3):
            A, B, C, D, E, F, G, Hc, _ = k["cfg"][9 * ch:9 * ch + 9]
            mie_den = torch.clamp(k["mie_k1"][ch] - k["mie_k2"][ch] * cg, min=1e-4)
            mie = (1.0 + ray_m) / torch.pow(mie_den, 1.5)
            color.append(k["rad"][ch] * (1.0 + A * torch.exp(fdiv(B, ct + 0.01)))
                         * (C + D * torch.exp(E * gamma) + F * ray_m + G * mie + Hc * zenith))
    else:
        Y = fdiv((1.0 + k["pA"] * torch.exp(fdiv(k["pB"], ct + 0.01)))
                 * (1.0 + k["pC"] * torch.exp(k["pD"] * gamma) + k["pE"] * cg * cg), k["p_den"])
        color = [c * Y for c in k["p_col"]]
        color = [(c + (k["p_haze"] - c) * k["p_mix"]) * k["p_alb"] for c in color]
    color = [torch.clamp(c, min=0.0) for c in color]
    horizon = 1.0 - _clip01(wdir[1])
    h2 = horizon * horizon
    night = [n0 + nd * h2 for n0, nd in zip(k["night0"], k["night_d"])]
    color = [n + (c - n) * k["daylight"] for n, c in zip(night, color)]
    inside = cg >= k["disc_cos"]
    limb = _clip01(fdiv(cg - k["disc_cos"], k["limb_den"]))
    limb = limb * limb * (3.0 - 2.0 * limb)
    ring = (cg >= k["glow_cos"]) & ~inside
    gf = _clip01(fdiv(cg - k["glow_cos"], k["glow_den"]))
    gf = gf * gf * (3.0 - 2.0 * gf)
    zero = torch.zeros_like(cg)
    color = [c + torch.where(ring, rc * gf, torch.where(inside, dc * limb, zero))
             for c, dc, rc in zip(color, k["disc_c"], k["ring_c"])]
    sun_align = torch.clamp(cg, min=0.0)
    fwd = torch.pow(sun_align, k["e_fwd"])
    broad = torch.pow(sun_align, k["e_broad"])
    hglow = h2 * k["low_sun"] * k["hglow_k"]
    inten = k["inten"]
    scat = fwd * inten * 0.35 + broad * inten * k["k_broad"] + hglow * inten * 0.22 + k["amb"]
    out = []
    for c, sc in zip(color, k["scat_c"]):
        c = (c + sc * scat) * k["exposure"]
        c = c / (c + 1.0)
        out.append(fdiv(torch.round(_clip01(c) * 255.0), 255.0))
    return out


def _render_sky(width, height, *, inv_view, inv_proj, u, model):
    """screen.py:_render_sky on the cooked uniforms `u`: (H, W, 3) on the CPU."""
    k = sky_consts(u, model, inv_view, inv_proj)
    return torch.stack(sky_plain(k, width, height, torch.device("cpu")), -1)


def _aerial_blend(k: dict, shaded, sky, world, cam):
    """screen.py:1514-1541: desaturate the exposed shade by the distance to
    the camera and blend it toward the sky."""
    vdist = _norm([c - w for c, w in zip(cam, world)])
    a_fac = 1.0 - torch.exp(k["density_neg"] * vdist * k["k_fac"])
    a_amt = _clip01(a_fac * k["k_amt"])
    luma = shaded[0] * 0.2126 + shaded[1] * 0.7152 + shaded[2] * 0.0722
    dk = a_amt * k["k_desat"]
    blend = a_amt * k["k_blend"]
    out = []
    for s, sk, tn, ad in zip(shaded, sky, k["tint"], k["add"]):
        desat = s + (luma - s) * dk
        out.append(desat + (sk * k["k_target"] * tn + ad - desat) * blend)
    return out


# ---------------------------------------------------------------------------
# S8: the shade (screen.py:1085-1600). ShadeCfg holds the static switches of
# JAX's `cfg` (:1704-1707); the uniforms dict `u` the tensors on the device
# and the float32 scalars (Python floats), host-derived ones included, so
# that the kernel and the plain version read the same numbers.
# ---------------------------------------------------------------------------

ALBEDO_MODES = ("colormap", "material", "mix")
LAYERS = (("wetness_subsurface_strength", "wetness_subsurface_tint"),
          ("rock_subsurface_strength", "rock_subsurface_tint"),
          ("snow_subsurface_strength", "snow_subsurface_tint"))


@dataclass(frozen=True)
class ShadeCfg:
    width: int
    height: int
    has_wm: bool
    albedo_mode: str
    hue_on: bool
    mats: Optional[tuple]        # _freeze(material layer dict) or None
    has_mat_albedo: bool
    has_refl: bool
    filterable: bool
    encode: str                  # "gamma" | "srgb"
    mm_flags: Tuple[bool, bool, bool]   # normal, roughness, mask maps
    pom: Optional[tuple] = None  # _freeze(pom_config(...)) or None
    sky: Optional[str] = None    # the sky model when the aerial perspective is on

    @property
    def mats_dict(self) -> Optional[dict]:
        return None if self.mats is None else dict(self.mats)

    @property
    def pom_dict(self) -> Optional[dict]:
        return None if self.pom is None else dict(self.pom)

    @property
    def sss_on(self) -> bool:
        m = self.mats_dict
        return m is not None and any(float(m[k]) > 0.0 for k, _ in LAYERS)


def _s32(a, b) -> float:
    """float32(a) - float32(b), rounded once, as JAX's constant arrays do."""
    return float(np.float32(a) - np.float32(b))


def _mul32(a, b) -> float:
    return float(np.float32(a) * np.float32(b))


def _filmic_consts():
    A, B, C, D, E, F, W = 0.22, 0.30, 0.10, 0.20, 0.01, 0.30, 11.2
    wc = ((W * (A * W + C * B) + D * E) / (W * (A * W + B) + D * F)) - E / F
    return f32(A), f32(B), f32(C * B), f32(D * E), f32(D * F), f32(E / F), f32(max(wc, 1e-6))


FILMIC = _filmic_consts()
F0_WATER = f32(((1.33 - 1.0) / (1.33 + 1.0)) ** 2)   # water's f0 at ior 1.33


def tonemap_filmic_terrain(c):
    A, B, CB, DE, DF, EF, WC = FILMIC
    x = torch.clamp(c, min=0.0)
    curve = ((x * (A * x + CB) + DE) / (x * (A * x + B) + DF)) - EF
    return _clip01(fdiv(curve, WC))


def gamma_correct(c, gamma=2.2):
    return torch.pow(_clip01(c), f32(1.0 / max(gamma, 0.1)))


def srgb_encode(c):
    csr = _clip01(c)
    return torch.where(csr <= 0.0031308, csr * 12.92,
                       f32(1.055) * torch.pow(torch.clamp(csr, min=1e-8), f32(1.0 / 2.4)) - 0.055)


def layer_consts(mats: dict) -> dict:
    """The material layers' host constants (screen.py:1277-1326): the snow
    slope factor, the rock and wetness weights, the layering factors, the
    f16 layer colours and the subsurface strengths and tints, as float32."""
    deg = math.pi / 180.0
    slope_f = 0.0
    if mats["snow_enabled"]:
        slope_max = mats["snow_slope_max"] * deg
        slope_blend = mats["snow_slope_blend"] * deg
        slope_f = 1.0 - float(np.clip((0.0 - slope_max + slope_blend)
                                      / max(slope_blend, 0.001), 0.0, 1.0))
    rock_w = 0.0
    if mats["rock_enabled"]:
        rock_w = float(np.clip((0.0 - mats["rock_slope_min"] * deg)
                               / max(mats["rock_slope_blend"] * deg, 0.001), 0.0, 1.0))
    wet_w = 1.0 * mats["wetness_slope_influence"] if mats["wetness_enabled"] else 0.0
    f16c = lambda c: tuple(float(x) for x in  # noqa: E731
                           np.asarray(np.asarray(c, np.float32), np.float16).astype(np.float32))
    return dict(
        snow_on=bool(mats["snow_enabled"]), snow_alt_min=f32(mats["snow_altitude_min"]),
        snow_alt_div=f32(max(mats["snow_altitude_blend"], 0.001)), snow_slope_f=f32(slope_f),
        wet_scale=f32(1.0 - np.clip(wet_w, 0.0, 1.0) * mats["wetness_strength"]),
        rock_c=f16c(mats["rock_color"]), rock_mix=f32(np.clip(rock_w, 0, 1)),
        snow_c=f16c(mats["snow_color"]),
        weights=(f32(wet_w), f32(rock_w)),
        strengths=tuple(f32(float(mats[k])) for k, _ in LAYERS),
        tints=tuple(tuple(f32(x) for x in mats[t]) for _, t in LAYERS),
    )


def _hue_variation(albedo, height_norm, strength):
    """_apply_slope_hue_variation at slope factor 1 (screen.py:1038)."""
    r, g, b = albedo
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    gray = delta < 0.001
    sd = torch.where(gray, 1.0, delta)
    hue = torch.where(maxc == r, fdiv((g - b) / sd, 6.0),
                      torch.where(maxc == g, fdiv(2.0 + (b - r) / sd, 6.0),
                                  fdiv(4.0 + (r - g) / sd, 6.0)))
    hue = torch.where(hue < 0.0, hue + 1.0, hue)
    sat = delta / torch.clamp(maxc, min=1e-20)
    val = maxc
    slope_shift = _mul32(0.5, strength)
    elev_shift = (height_norm - 0.5) * strength * 0.4
    noise_shift = (sat - 0.5) * strength * 0.5
    new_hue = _mod1(hue + slope_shift + elev_shift + noise_shift)
    c = sat * val
    h6 = new_hue * 6.0
    x = c * (1.0 - ((h6 - torch.floor(h6)) * 2.0 - 1.0).abs())
    m = val - c
    z = torch.zeros_like(c)
    w = torch.where
    out = []
    for k in range(3):
        seq = [(c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c), (c, z, x)]
        v = seq[5][k]
        for i in (4, 3, 2, 1, 0):
            v = w(h6 < float(i + 1), seq[i][k], v)
        out.append(w(gray, albedo[k], v + m))
    return out


def shade_plain(cfg: ShadeCfg, u: dict) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of S8 (screen.py:_build_shade_fn.shade), PCSS
    (S5) included. Returns {"rgba": (H, W, 4) u8, "albedo", "normal":
    (H, W, 3), "height": (H, W)}."""
    W, H = cfg.width, cfg.height
    hm = u["hm"]
    dev = hm.device
    lo, hi, rng = u["dom_lo"], u["dom_hi"], u["dom_rng"]
    zsc, ldir, cam = u["z_scale"], u["ldir"], u["camera_pos"]
    samp = _bilinear if cfg.filterable else _nearest
    where = torch.where

    px = torch.arange(W, dtype=_F32, device=dev).expand(H, W)
    py = torch.arange(H, dtype=_F32, device=dev)[:, None].expand(H, W)
    sx = fdiv(px + 0.5, float(W))
    sy = 1.0 - fdiv(py + 0.5, float(H))
    uu = sx * 0.5
    vv = sy * 0.5
    z0, z1, z2 = u["z_corners"]
    wp_z = z0 * (1.0 - sx * 0.5 - sy * 0.5) + z1 * (sx * 0.5) + z2 * (sy * 0.5)
    world = [sx - 0.5, sy - 0.5, wp_z]
    vd = _normalize([c - w_ for c, w_ in zip(cam, world)])
    ones = torch.ones_like(uu)
    zeros = torch.zeros_like(uu)

    # heights and the Sobel normal (Y-up)
    t0, t1 = u["texel"]

    def geom(a, b):
        return torch.clamp(samp(hm, _clip01(a), _clip01(b))[0], lo, hi)

    tl, tc, tr = geom(uu - t0, vv - t1), geom(uu, vv - t1), geom(uu + t0, vv - t1)
    lc, rc_ = geom(uu - t0, vv), geom(uu + t0, vv)
    bl, bc, br = geom(uu - t0, vv + t1), geom(uu, vv + t1), geom(uu + t0, vv + t1)
    dx = (tr + 2.0 * rc_ + br) - (tl + 2.0 * lc + bl)
    dy = (bl + 2.0 * bc + br) - (tl + 2.0 * tc + tr)
    blended = _normalize([fdiv(-dx, t0), torch.full_like(dx, u["vert"]), fdiv(-dy, t1)])

    # POM (S7): the parallax uv, and the occlusion from the displaced height
    pom = cfg.pom_dict
    pu, pv, occl = uu, vv, ones
    if pom is not None:
        pu, pv, layer, crossed = _pom_uv(hm, uu, vv, blended, vd, samp=samp, **_pom_kw(pom))
    wm = _nearest(u["water_mask"], _clip01(pu), _clip01(pv))[0] if cfg.has_wm else zeros
    is_water = wm > 0.001
    hs = samp(hm, _clip01(pu), _clip01(pv))[0]
    if pom is not None and pom["layer_height"]:
        hs = where(crossed, 1.0 - layer, hs)
    hs = torch.clamp(hs, lo, hi)
    if pom is not None and pom["occlusion"]:
        occl = torch.clamp(hs, 0.65, 1.0)
    height_norm = _clip01(fdiv(hs - lo, rng))

    # material layer weights (gaussian, sigma = blend_half * 1.5)
    centers = (0.0, f32(1.0 / 3.0), f32(2.0 / 3.0), 1.0)
    rough_tab = (0.50, 0.85, 0.50, 0.25)
    slope_mod = (1.5, 0.5, 1.0, 1.0)
    wgt = []
    for cn, sm in zip(centers, slope_mod):
        d = height_norm - cn
        wgt.append(torch.exp(fdiv(-(d * d), f32(2.0 * 0.1875 * 0.1875))) * sm)
    wsum = torch.clamp(wgt[0] + wgt[1] + wgt[2] + wgt[3], min=1e-5)
    wgt = [x / wsum for x in wgt]
    roughness = wgt[0] * rough_tab[0] + wgt[1] * rough_tab[1] + wgt[2] * rough_tab[2] \
        + wgt[3] * rough_tab[3]
    if cfg.has_mat_albedo:
        ma = u["material_albedo"]
        mat_alb = [ma[..., c].expand(H, W) if ma.dim() == 3 else ma.reshape(-1)[c].expand(H, W)
                   for c in range(3)]
    else:
        ML = _MATERIAL_LINEAR
        mat_alb = [wgt[0] * float(ML[0, c]) + wgt[1] * float(ML[1, c])
                   + wgt[2] * float(ML[2, c]) + wgt[3] * float(ML[3, c]) for c in range(3)]

    sn = blended
    wdv = zeros
    scatter = [zeros, zeros, zeros]
    if cfg.has_wm:
        enc = (wm > 0.01) & (wm < 0.99)
        shore = where(enc, wm, 1.0 - _clip01(fdiv(height_norm, 0.20)))
        wdv = where(is_water, shore, 0.0)
        deep, shallow = (0.05, 0.45, 0.95), (0.1, 0.5, 0.85)
        under = [s + _s32(d, s) * wdv for d, s in zip(deep, shallow)]
        scatter = [where(is_water, un * (1.0 - wdv * 0.3) * 1.2, 0.0) for un in under]
        wx, wy = world[0], world[1]
        wc, ws = u["wave_cs"]
        c1 = wx * wc + wy * ws
        cp = -wx * ws + wy * wc
        wscale = 0.3 + 0.7 * wdv
        w1 = torch.sin(c1 * 0.05) * 0.07 * wscale
        w2 = torch.sin(c1 * 0.15 + cp * 0.03) * 0.035 * wscale
        w3 = torch.sin(c1 * 0.4 + 1.7) * 0.018
        cw = torch.sin(cp * 0.12 + 0.5) * 0.02 * wscale
        s3 = w1 + w2 + w3
        wave_n = _normalize([s3 * wc + cw * (-ws), ones, s3 * ws + cw * wc])
        sn = [where(is_water, a, b) for a, b in zip(wave_n, sn)]
        roughness = where(is_water, 0.02, roughness)
        mat_alb = [where(is_water, a, b) for a, b in zip(under, mat_alb)]

    # colormap overlay, hue variation
    overlay = _lut_sample(u["lut"], height_norm)
    cms = u["colormap_strength"]
    if cfg.albedo_mode == "colormap":
        final = overlay
    elif cfg.albedo_mode == "material":
        final = mat_alb
    else:
        final = [m + (o - m) * cms for m, o in zip(mat_alb, overlay)]
    if cfg.has_wm:
        final = [where(is_water, m, f) for m, f in zip(mat_alb, final)]
    albedo = [_clip01(c) for c in final]
    if cfg.hue_on:
        shifted = _hue_variation(albedo, height_norm, u["hue_strength"])
        albedo = [where(is_water, a, s) for a, s in zip(albedo, shifted)] \
            if cfg.has_wm else shifted

    # M4 material layers and TV10 subsurface state
    sss_strength = zeros
    sss_tint = [ones, ones, ones]
    mats = cfg.mats_dict
    if mats is not None:
        k = layer_consts(mats)
        snow_w = zeros
        if k["snow_on"]:
            alt_f = _clip01(fdiv(world[2] - k["snow_alt_min"], k["snow_alt_div"]))
            snow_w = alt_f * k["snow_slope_f"]
        layered = [a * k["wet_scale"] for a in albedo]
        layered = [x + (c - x) * k["rock_mix"] for x, c in zip(layered, k["rock_c"])]
        sw = _clip01(snow_w)
        layered = [x + (c - x) * sw for x, c in zip(layered, k["snow_c"])]
        albedo = [where(is_water, a, x) for a, x in zip(albedo, layered)] \
            if cfg.has_wm else layered
        for w_, strength, tint in zip((*k["weights"], snow_w), k["strengths"], k["tints"]):
            if strength <= 0.0:
                continue
            warr = torch.full_like(uu, w_) if not isinstance(w_, torch.Tensor) else w_
            cov = where(warr > 0.0, _clip01(warr), 0.0)
            sss_strength = sss_strength + (strength - sss_strength) * cov
            sss_tint = [t + (c - t) * cov for t, c in zip(sss_tint, tint)]

    # M4 material maps
    mmf = cfg.mm_flags
    if any(mmf):
        mm_u, mm_v = _clip01(pu), _clip01(pv)
        map_mask = _bilinear(u["mm_mask"], mm_u, mm_v)[0] if mmf[2] else ones
        if mmf[0]:
            tn = _normalize([e * 2.0 - 1.0 for e in _bilinear(u["mm_normal"], mm_u, mm_v)])
            n_b = sn
            yup = n_b[1].abs() > 0.99
            up_t = [zeros, where(yup, 0.0, 1.0), where(yup, 1.0, 0.0)]
            t_b = _normalize(_cross(up_t, n_b))
            b_b = _cross(n_b, t_b)
            mapped = _normalize([t_b[c] * tn[0] + b_b[c] * tn[1] + n_b[c] * tn[2]
                                 for c in range(3)])
            wgt_n = _clip01(map_mask)
            cand = _normalize([nb + (mp - nb) * wgt_n for nb, mp in zip(n_b, mapped)])
            live = map_mask > 0.001
            if cfg.has_wm:
                live = live & ~is_water
            sn = [where(live, a, b) for a, b in zip(cand, sn)]
        if mmf[1]:
            rmap = _bilinear(u["mm_rough"], mm_u, mm_v)[0]
            roughness = roughness + (rmap - roughness) * _clip01(map_mask)

    roughness = where(is_water, torch.clamp(roughness, 0.02, 1.0),
                      torch.clamp(roughness, 0.25, 1.0))
    f0 = where(is_water, F0_WATER, 0.04)

    # CSM / PCSS shadows (S5)
    shadow_h = _clip01(fdiv(torch.clamp(samp(hm, _clip01(uu), _clip01(vv))[0], lo, hi) - lo,
                            rng))
    rs = u["shadow_rspan"]
    sp = [(uu - 0.5) * rs, (vv - 0.5) * rs, shadow_h * zsc]
    vis = _pcss(u["shadow_depth"], u["shadow_lvp"], sp, blended, u["pcss_ld"])
    shadow_factor = f32(1.0 - SHADOW_IBL_FACTOR) + f32(SHADOW_IBL_FACTOR) * vis

    # IBL (eval_ibl_split)
    n = sn
    ibl_i = u["ibl_intensity"]
    ndv_raw = _dot(n, vd)
    ndv = _clip01(ndv_raw)
    rc2 = _clip01(roughness)
    refl = _normalize([(2.0 * ndv_raw) * nc - v for nc, v in zip(n, vd)])
    omc = _clip01(1.0 - ndv)
    o2 = omc * omc
    pow5 = omc * (o2 * o2)
    F_ibl = f0 + (torch.maximum(1.0 - rc2, f0) - f0) * pow5
    kD = 1.0 - F_ibl
    irr = _cube_sample(u["ibl_irradiance"], n)
    ibl_alb = [where(is_water, 0.0, a) for a in albedo] if cfg.has_wm else albedo
    ibl_diffuse = [kD * a * i for a, i in zip(ibl_alb, irr)]
    pref = _cube_sample_mips(u["ibl_spec"], refl, rc2 * rc2 * 9.0)
    brdf = _bilinear(u["ibl_brdf"], ndv, rc2)
    spec_brdf = F_ibl * brdf[0] + brdf[1]
    ibl_spec = [p * spec_brdf for p in pref]
    ibl_occl = where(is_water, 1.0, torch.clamp(occl, 0.65, 1.0))
    ibl_contrib = [(d * shadow_factor + s) * ibl_i * ibl_occl
                   for d, s in zip(ibl_diffuse, ibl_spec)]

    # beauty composition
    lcol = u["lcol"]
    shaded_w = None
    if cfg.has_wm:
        ndv_w = torch.clamp(ndv_raw, min=0.001)
        ndl_w = torch.clamp(_dot(n, ldir), min=0.0)
        hv_ = _normalize([v + l_ for v, l_ in zip(vd, ldir)])
        ndh = torch.clamp(_dot(n, hv_), min=0.0)
        vdh = torch.clamp(_dot(vd, hv_), min=0.001)
        alpha = roughness * roughness
        a2 = torch.clamp(alpha * alpha, min=1e-8)
        den = ndh * ndh * (a2 - 1.0) + 1.0
        Dt = a2 / (f32(math.pi) * den * den)
        om = 1.0 - vdh
        om2 = om * om
        fres = f0 + (1.0 - f0) * (om * (om2 * om2))
        kk = fdiv(alpha, 2.0)
        G = (ndv_w / (ndv_w * (1.0 - kk) + kk)) * (ndl_w / (ndl_w * (1.0 - kk) + kk))
        dspec = (Dt * G / (4.0 * ndv_w * ndl_w + 1e-4)) * fres
        sun_spec = [dspec * sc * lcol[2] * ndl_w for sc in (1.0, 0.98, 0.95)]
        depth_atten = 1.0 + f32(WATER_DEPTH_ATTEN_DEEP - 1.0) * wdv
        comb = ibl_contrib
        if cfg.has_refl:
            comb = _planar_reflection_blend(ibl_contrib, u, world, sn, vd, wdv)
        tint = [_mul32(t, WATER_BASE_TINT_SCALE) for t in WATER_BASE_TINT]
        shaded_w = [(cr * WATER_COMBINED_REFLECTION_SCALE + ss * WATER_SUN_SPECULAR_SCALE)
                    * depth_atten + t + sc * WATER_SCATTER_SCALE
                    for cr, ss, t, sc in zip(comb, sun_spec, tint, scatter)]

    ndl = torch.clamp(_dot(sn, ldir), min=0.0)
    base_diffuse = (f32(0.32) + f32(0.10 - 0.32) * ndl) + f32(0.36 - 0.10) * ndl * u["sun_int"]
    slope_steep = 1.0 - sn[1].abs()
    ngrad = _quad_grad(sn)
    edge_sig = slope_steep * 0.3 + ngrad * 15.0
    edge_bright = torch.clamp(edge_sig * (ndl + 0.3), 0.0, 0.25)
    edge_dark = torch.clamp(edge_sig * (1.0 - ndl) * 0.5, 0.0, 0.15)
    diffuse_raw = base_diffuse + edge_bright - edge_dark
    combined_shadow = torch.clamp(shadow_factor, min=0.30)
    diffuse_lit = diffuse_raw * (torch.clamp(occl, min=0.65) * combined_shadow)
    ibl_dfac = _norm(ibl_diffuse) * ibl_i
    lighting = diffuse_lit + ibl_dfac * u["ibl_fill"]
    terrain = [a * lighting + torch.minimum(s * ibl_i * 0.12, a * 0.20)
               for a, s in zip(albedo, ibl_spec)]
    if cfg.sss_on:
        ndl_s = _clip01(_dot(sn, ldir))
        wrap_w = 0.45 * sss_strength
        wrapped = _clip01((ndl_s + wrap_w) / (1.0 + wrap_w))
        wrap_boost = torch.clamp(wrapped - ndl_s, min=0.0)
        vb = _clip01(_dot(vd, [-c for c in ldir]))
        vb2 = vb * vb
        view_back = vb2 * vb2
        backscatter = view_back * (0.25 + 0.75 * (1.0 - ndl_s))
        profile = torch.maximum(wrap_boost * 1.35, backscatter * 0.30)
        bleed = 0.20 + 0.80 * _clip01(combined_shadow)
        fill = ibl_dfac * (0.02 + 0.06 * sss_strength) * (1.0 - ndl_s * 0.5)
        amount = profile * bleed + fill
        scale = 0.16 + 0.44 * sss_strength
        terrain = [t_ + where(sss_strength > 0.0, torch.clamp(
            a * (1.0 + (tn - 1.0) * 0.85), 0.0, 1.5) * amount * scale, 0.0)
            for t_, a, tn in zip(terrain, albedo, sss_tint)]
    shaded = [where(is_water, w_, t_) for w_, t_ in zip(shaded_w, terrain)] \
        if cfg.has_wm else terrain
    shaded = [s * u["exposure"] for s in shaded]
    if cfg.sky is not None:   # S6: the sky and the aerial perspective
        sky = sky_plain(u["sky"], W, H, dev)
        shaded = _aerial_blend(u["sky"], shaded, sky, world, cam)
    shaded = torch.stack(shaded, -1)

    final = tonemap_filmic_terrain(shaded)
    encoded = srgb_encode(final) if cfg.encode == "srgb" else gamma_correct(final, 2.2)
    rgba = torch.full((H, W, 4), 255, dtype=torch.uint8, device=dev)
    rgba[..., :3] = torch.round(_clip01(encoded) * 255.0).to(torch.uint8)
    return {"rgba": rgba, "albedo": torch.stack(albedo, -1), "normal": torch.stack(sn, -1),
            "height": height_norm}


def _quad_grad(n):
    """|dpdxCoarse(n)| + |dpdyCoarse(n)| (screen.py:897-906, 1455-1458):
    per 2x2 quad, top-right minus top-left and bottom-left minus top-left,
    broadcast to the quad. Needs even H and W."""
    def rep(d):
        return d.repeat_interleave(2, 0).repeat_interleave(2, 1)
    ddx = [rep(c[0::2, 1::2] - c[0::2, 0::2]) for c in n]
    ddy = [rep(c[1::2, 0::2] - c[0::2, 0::2]) for c in n]
    return _norm(ddx) + _norm(ddy)


def _planar_reflection_blend(ibl_contrib, u, world, sn, vd, wdv):
    """P4 planar water reflection blend (screen.py:1566-1600), with the
    half-res mirrored pass's u8 image as u["refl_tex"] (floats / 255)."""
    R = np.asarray(u["refl_rvp"], np.float32)
    clip4 = [world[0] * float(R[0, j]) + world[1] * float(R[1, j]) + world[2] * float(R[2, j])
             + float(R[3, j]) for j in range(4)]
    w_ok = clip4[3].abs() >= 0.001
    wdiv = torch.where(w_ok, clip4[3], 1.0)
    ndc = [c / wdiv for c in clip4[:3]]
    ru = ndc[0] * 0.5 + 0.5
    rv = 1.0 - (ndc[1] * 0.5 + 0.5)
    wave = u["refl_wave_strength"]
    shore_w = f32(max(u["refl_shore_w"], 1e-6))
    t = _clip01(fdiv(wdv - 0.0, shore_w - 0.0))
    shore_f = t * t * (3.0 - 2.0 * t)
    ru = torch.clamp(ru + sn[0] * wave * shore_f, 0.001, 0.999)
    rv = torch.clamp(rv + sn[2] * wave * shore_f, 0.001, 0.999)
    refl_rgb = _bilinear(u["refl_tex"], ru, rv)
    ndv = torch.clamp(_dot(sn, vd), min=0.0)
    fres = _clip01(torch.pow(1.0 - ndv, u["refl_fresnel_power"]))
    blend = fres * u["refl_intensity"] * shore_f
    return [torch.where(w_ok, b + (r - b) * blend, b) for b, r in zip(ibl_contrib, refl_rgb)]


def _shade_kernel(cfg: ShadeCfg, u: dict) -> Dict[str, torch.Tensor]:
    dev = u["hm"].device
    H, W = cfg.height, cfg.width
    out = {"rgba": torch.empty((H, W, 4), dtype=torch.uint8, device=dev),
           "albedo": torch.empty((H, W, 3), dtype=_F32, device=dev),
           "normal": torch.empty((H, W, 3), dtype=_F32, device=dev),
           "height": torch.empty((H, W), dtype=_F32, device=dev)}
    args, keep = screen_args(cfg, u)
    _kernels.require_cuda("S8 shade", *keep, *out.values())
    tex = u.get("shadow_tex") or shadow_texture(u["shadow_depth"])
    if tex.res != args.shadow_res:
        raise ValueError(f"S8 shade: the shadow texture is {tex.res}^2, the map "
                         f"{args.shadow_res}^2")
    args.shadow_tex = tex.handle
    planes = _kernels.ScreenOut(*(out[k].data_ptr() for k in ("rgba", "albedo", "normal",
                                                              "height")))
    err = _kernels.lib().f3d_screen_shade(args, planes, _kernels.stream_ptr(dev))
    _kernels.check(err, "S8 shade")
    shade.launches += 1
    return out


def shade(cfg: ShadeCfg, u: dict) -> Dict[str, torch.Tensor]:
    """S8: one screen-mode shade of every pixel, PCSS (S5) inside. Returns
    {"rgba", "albedo", "normal", "height"} on the uniforms' device. CPU
    tensors run the plain version."""
    if u["hm"].device.type == "cpu":
        return shade_plain(cfg, u)
    return _shade_kernel(cfg, u)


shade.launches = 0


def screen_args(cfg, u: dict):
    """The argument block (ScreenArgs in csrc/screen.cuh) of S8 (a ShadeCfg)
    or S9 (a ClipCfg), and the tensors it points into."""
    a = _kernels.ScreenArgs()
    keep = []

    def tex(name, t):
        t = t.contiguous()
        keep.append(t)
        setattr(a, name, t.data_ptr())
        return t

    hm = tex("hm", u["hm"])
    a.hm_h, a.hm_w = hm.shape
    lut = tex("lut", u["lut"])
    a.lut_n = lut.shape[0]
    if cfg.has_wm:
        wm = tex("wm", u["water_mask"])
        a.wm_h, a.wm_w = wm.shape[:2]
    if cfg.has_mat_albedo:
        ma = tex("mat_albedo", u["material_albedo"])
        if ma.numel() not in (3, 3 * cfg.width * cfg.height):
            raise ValueError("material_albedo_rgb must hold one rgb or one per pixel")
        a.mat_albedo_stride = 0 if ma.numel() == 3 else 3
    for flag, key, name in zip(cfg.mm_flags, ("mm_normal", "mm_rough", "mm_mask"),
                               ("mmn", "mmr", "mmk")):
        if flag:
            t = tex(name, u[key])
            setattr(a, name + "_h", t.shape[0])
            setattr(a, name + "_w", t.shape[1])
    sd = tex("shadow", u["shadow_depth"])
    a.shadow_res = sd.shape[0]
    irr = tex("irr", u["ibl_irradiance"])
    a.irr_size = irr.shape[1]
    for m, t in enumerate(u["ibl_spec"]):
        keep.append(t.contiguous())
        a.spec[m] = keep[-1].data_ptr()
        a.spec_size[m] = t.shape[1]
    brdf = tex("brdf", u["ibl_brdf"])
    a.brdf_h, a.brdf_w = brdf.shape[:2]
    if cfg.has_refl:
        rt = tex("refl", u["refl_tex"])
        a.refl_h, a.refl_w = rt.shape[:2]
        a.rvp = (_kernels._F * 16)(*np.asarray(u["refl_rvp"], np.float32).reshape(-1).tolist())
        a.refl_wave, a.refl_intensity = u["refl_wave_strength"], u["refl_intensity"]
        a.refl_shore_w = f32(max(u["refl_shore_w"], 1e-6))
        a.refl_fresnel = u["refl_fresnel_power"]

    a.width, a.height = cfg.width, cfg.height
    a.has_wm, a.has_mat_albedo, a.has_refl = cfg.has_wm, cfg.has_mat_albedo, cfg.has_refl
    a.albedo_mode = ALBEDO_MODES.index(cfg.albedo_mode)
    a.hue_on, a.filterable, a.srgb = cfg.hue_on, cfg.filterable, cfg.encode == "srgb"
    a.mm_normal, a.mm_rough, a.mm_mask = cfg.mm_flags
    for k in ("dom_lo", "dom_hi", "dom_rng", "z_scale", "exposure", "ibl_intensity",
              "colormap_strength", "hue_strength", "ibl_fill", "vert", "sun_int"):
        setattr(a, k, u[k])
    a.texel = (_kernels._F * 2)(*u["texel"])
    if "z_corners" in u:   # S8's screen-space geometry
        a.shadow_rspan = u["shadow_rspan"]
        a.z_corners = _kernels._F3(*u["z_corners"])
        a.wave_cs = (_kernels._F * 2)(*u["wave_cs"])
    for k in ("ldir", "lcol", "camera_pos", "pcss_ld"):
        setattr(a, k, _kernels._F3(*u[k]))
    a.lvp = (_kernels._F * 12)(*np.asarray(u["shadow_lvp"], np.float32)[:3].reshape(-1).tolist())
    a.f0_water = F0_WATER
    a.ml = (_kernels._F * 12)(*_MATERIAL_LINEAR.reshape(-1).tolist())
    a.filmic = (_kernels._F * 7)(*FILMIC)
    mats = cfg.mats_dict
    if mats is not None:
        k = layer_consts(mats)
        a.mats_on, a.snow_on, a.sss_on = True, k["snow_on"], cfg.sss_on
        a.snow_alt_min, a.snow_alt_div, a.snow_slope_f = (k["snow_alt_min"], k["snow_alt_div"],
                                                          k["snow_slope_f"])
        a.wet_scale, a.rock_mix = k["wet_scale"], k["rock_mix"]
        a.rock_c, a.snow_c = _kernels._F3(*k["rock_c"]), _kernels._F3(*k["snow_c"])
        a.layer_w = (_kernels._F * 2)(*k["weights"])
        a.sss_strength = _kernels._F3(*k["strengths"])
        a.sss_tint = (_kernels._F * 9)(*[x for t in k["tints"] for x in t])
    pom = cfg.pom_dict
    if pom is not None:
        a.pom_on, a.pom_occl, a.pom_layer = True, pom["occlusion"], pom["layer_height"]
        a.pom_min, a.pom_max, a.pom_refine = pom["min_steps"], pom["max_steps"], pom["refine_steps"]
        a.pom_scale = pom["height_scale"]
    if cfg.sky is not None:
        for k, v in u["sky"].items():
            setattr(a.sky, k, (_kernels._F * len(v))(*v) if isinstance(v, list) else v)
    return a, keep


# ---------------------------------------------------------------------------
# The driver (screen.py:1619-1812)
# ---------------------------------------------------------------------------

def _f32_triple(v) -> Tuple[float, float, float]:
    return tuple(float(c) for c in np.asarray(v, np.float32).reshape(3))


def prepare_shade(
    heightmap, lut_rgb, *, size_px, device, terrain_span=2.8, z_scale=1.45,
    exposure=1.0, light_azimuth_deg=135.0, light_elevation_deg=24.0,
    sun_intensity=2.4, sun_color=(1.0, 1.0, 1.0), ibl_intensity=1.0,
    cam_radius=5.0, cam_phi_deg=138.0, cam_theta_deg=63.0, fov_y_deg=54.0,
    clip=(0.1, 6000.0), albedo_mode="colormap", colormap_strength=1.0,
    hue_variation_strength=0.08, water_mask=None, sky=None,
    hdr_rgb=None, material_albedo_rgb=None, materials=None, pom=None,
    reflection=None, domain=(0.0, 1.0), _camera_pos=None,
    height_filterable=False, generation="family", encode="gamma",
    material_maps=None,
) -> Tuple[ShadeCfg, dict]:
    """render_screen_scene's host work on `device` (a torch.device): the
    refusals, the sky's cooked uniforms, the IBL pyramid (S1-S3) and the
    shadow map (S4) from their caches or built, the uniforms, and the
    mirrored reflection pass (a first S8 launch) where the scene has one.
    Returns S8's (cfg, u)."""
    W, H = int(size_px[0]), int(size_px[1])
    if W % 2 or H % 2 or W < 2 or H < 2:
        raise ValueError(f"screen mode renders even sizes only (its normal derivatives are "
                         f"taken per 2x2 pixel quad): got {W}x{H}")
    if albedo_mode not in ALBEDO_MODES:
        raise ValueError(f"albedo_mode must be one of {ALBEDO_MODES}")
    hm = np.asarray(heightmap, np.float32)
    eye = orbit_eye(cam_radius, cam_phi_deg, cam_theta_deg)
    view = look_at_rh(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    proj = perspective_proj(fov_y_deg, W / H, clip[0], clip[1])
    camera_pos = eye if _camera_pos is None else np.asarray(_camera_pos, np.float32)
    ldir = light_direction(light_azimuth_deg, light_elevation_deg)
    sky_model, sky_k = None, None
    if sky is not None and sky.get("enabled", False):
        # cooked first: a sky missing a setting raises JAX's KeyError before
        # the prepasses are built
        cooked = _cook_sky_uniforms(sky, ldir)
        if sky.get("aerial_perspective", True):
            sky_model = str(sky.get("model", "hosek-wilkie"))
            cooked.update(sky_aerial_density=np.float32(max(sky.get("aerial_density", 1.0), 0.0)),
                          sky_sun_intensity_raw=np.float32(max(sky.get("sun_intensity", 1.0), 0.0)),
                          sky_sun_size_raw=np.float32(max(sky.get("sun_size", 1.0), 0.0)))
            sky_k = {**sky_consts(cooked, sky_model, np.linalg.inv(view), np.linalg.inv(proj)),
                     **aerial_consts(cooked, ldir)}
    if hdr_rgb is None:
        hdr_rgb = decode_test_hdr()
    ibl = build_ibl(hdr_rgb, device=device)
    lcol = np.asarray(sun_color, np.float32) * float(sun_intensity)
    dom_lo, dom_hi = float(domain[0]), float(domain[1])

    # shadow depth-pass world span: the terrain span for the "family"
    # golden generation, 1 for "consistent" (screen.py:1653-1666)
    shadow_world = terrain_span if generation == "family" else 1.0
    depth_map, lvp, _texel = build_shadow_map(
        hm, terrain_span=shadow_world, z_scale=z_scale, sun_dir=-ldir,
        domain=(dom_lo, dom_hi), device=device)

    mats = None
    if materials is not None:
        mats = dict(default_material_layers())
        mats.update(materials)
    has_refl = (reflection is not None and reflection.get("enabled", False)
                and _camera_pos is None and water_mask is not None)
    hv_host = float(np.clip(hue_variation_strength, 0.0, 0.2))
    mm = dict(material_maps or {})
    mm_flags = (mm.get("normal") is not None, mm.get("roughness") is not None,
                mm.get("mask") is not None)
    cfg = ShadeCfg(W, H, water_mask is not None, albedo_mode, hv_host > 0.0, _freeze(mats),
                   material_albedo_rgb is not None, has_refl, bool(height_filterable),
                   str(encode), mm_flags, pom=_freeze(pom_config(pom, generation)), sky=sky_model)

    t = lambda a: torch.as_tensor(np.array(a, np.float32, order="C"),  # noqa: E731
                                  device=device)
    lo32, hi32 = np.float32(dom_lo), np.float32(dom_hi)
    zs32 = np.float32(z_scale)
    corners = (hm[0, 0], hm[0, hm.shape[1] - 1], hm[hm.shape[0] - 1, 0])
    wave = torch.tensor(0.7, dtype=_F32)
    l32 = np.asarray(lcol, np.float32)
    u = {
        "hm": t(hm), "lut": t(lut_rgb),
        "dom_lo": float(lo32), "dom_hi": float(hi32),
        "dom_rng": float(max(hi32 - lo32, np.float32(1e-6))),
        "z_scale": float(zs32),
        "z_corners": tuple(float(np.float32(min(max(c, lo32), hi32)) * zs32) for c in corners),
        "texel": (f32(1.0 / hm.shape[1]), f32(1.0 / hm.shape[0])),
        "vert": float(max(zs32 * np.float32(0.5), np.float32(1e-3))),
        "wave_cs": (float(torch.cos(wave)), float(torch.sin(wave))),
        "shadow_rspan": 1.0,
        "ibl_fill": f32(0.18 * 0.35) if generation == "family" else f32(0.22),
        "ldir": _f32_triple(ldir), "lcol": _f32_triple(lcol),
        "sun_int": float(np.sqrt(l32[0] * l32[0] + l32[1] * l32[1] + l32[2] * l32[2])),
        "pcss_ld": light_dir_unit(-ldir),
        "camera_pos": _f32_triple(camera_pos),
        "exposure": float(max(np.float32(exposure), np.float32(0.0))),
        "ibl_intensity": f32(ibl_intensity),
        "colormap_strength": float(np.clip(np.float32(colormap_strength), 0.0, 1.0)),
        "hue_strength": float(np.clip(np.float32(hue_variation_strength), 0.0, 0.2)),
        "shadow_depth": depth_map, "shadow_lvp": lvp,
        "ibl_irradiance": ibl["irradiance"], "ibl_spec": ibl["spec_mips"],
        "ibl_brdf": ibl["brdf"], "sky": sky_k,
    }
    if depth_map.device.type == "cuda":   # S8's PCSS taps read the map through it
        u["shadow_tex"] = shadow_texture(depth_map)
    for flag, key, src in zip(mm_flags, ("mm_normal", "mm_rough", "mm_mask"),
                              ("normal", "roughness", "mask")):
        if flag:
            u[key] = t(mm[src])
    if water_mask is not None:
        u["water_mask"] = t(water_mask)
    if material_albedo_rgb is not None:
        u["material_albedo"] = t(material_albedo_rgb)

    if has_refl:
        # the mirrored half-res pass (a second S8 launch), blended inside
        # the main one (screen.py:1758-1799)
        plane_h = float(reflection.get("water_plane_height", 0.0))
        view_arr = np.asarray(view, np.float32).T
        proj_arr = np.asarray(proj, np.float32).T
        reflect_arr = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                                [0, 0, -1, 2.0 * plane_h], [0, 0, 0, 1]],
                               np.float32)
        mirrored = view_arr @ reflect_arr
        rvp = proj_arr @ mirrored
        mm_ = mirrored
        cam2 = -np.array([
            mm_[0, 0] * mm_[3, 0] + mm_[0, 1] * mm_[3, 1] + mm_[0, 2] * mm_[3, 2],
            mm_[1, 0] * mm_[3, 0] + mm_[1, 1] * mm_[3, 1] + mm_[1, 2] * mm_[3, 2],
            mm_[2, 0] * mm_[3, 0] + mm_[2, 1] * mm_[3, 1] + mm_[2, 2] * mm_[3, 2],
        ], np.float32)
        rw, rh = max(W // 2, 1), max(H // 2, 1)
        refl_img = render_screen_tensors(
            heightmap, lut_rgb, size_px=(rw, rh), device=device,
            terrain_span=terrain_span, z_scale=z_scale, exposure=exposure,
            light_azimuth_deg=light_azimuth_deg,
            light_elevation_deg=light_elevation_deg,
            sun_intensity=sun_intensity, sun_color=sun_color,
            ibl_intensity=ibl_intensity, cam_radius=cam_radius,
            cam_phi_deg=cam_phi_deg, cam_theta_deg=cam_theta_deg,
            fov_y_deg=fov_y_deg, clip=clip, albedo_mode=albedo_mode,
            colormap_strength=colormap_strength,
            hue_variation_strength=hue_variation_strength,
            water_mask=water_mask, sky=sky, hdr_rgb=hdr_rgb,
            material_albedo_rgb=material_albedo_rgb, materials=materials,
            pom=pom, reflection=None, domain=domain, _camera_pos=cam2)["rgba"]
        u["refl_tex"] = fdiv(refl_img[..., :3].to(_F32), 255.0).contiguous()
        u["refl_rvp"] = rvp
        u["refl_wave_strength"] = f32(reflection.get("wave_strength", 0.0))
        u["refl_shore_w"] = f32(reflection.get("shore_atten_width", 0.0))
        u["refl_fresnel_power"] = f32(reflection.get("fresnel_power", 5.0))
        u["refl_intensity"] = f32(reflection.get("intensity", 1.0))
    return cfg, u


def render_screen_tensors(heightmap, lut_rgb, *, size_px, device, **kw) -> Dict[str, torch.Tensor]:
    """render_screen_scene on `device` (a torch.device), returning the S8
    outputs as tensors there: {"rgba", "albedo", "normal", "height"}."""
    return shade(*prepare_shade(heightmap, lut_rgb, size_px=size_px, device=device, **kw))


def render_screen_scene(heightmap, lut_rgb, *, size_px, return_aov=False, device="cuda", **kw):
    """TerrainRenderer.render_terrain_pbr_pom in screen mode, with every
    argument of the JAX function (screen.py:1619-1630), on the card unless
    device="cpu". Returns (H, W, 4) u8, or (u8, aov dict) with return_aov;
    the AOVs are (H, W, 3) albedo and normal and the (H, W) normalised
    height as "depth"."""
    from ..pt.terrain_ref import resolve_device

    out = render_screen_tensors(heightmap, lut_rgb, size_px=size_px,
                                device=resolve_device(device), **kw)
    img = out["rgba"].cpu().numpy()
    if return_aov:
        return img, {"albedo": out["albedo"].cpu().numpy(),
                     "normal": out["normal"].cpu().numpy(),
                     "depth": out["height"].cpu().numpy()}
    return img


# ---------------------------------------------------------------------------
# S9: the clipmap camera mode (screen.py:1836-2125). The ring mesh is
# rasterized into a per-pixel G-buffer on the host (terrain/clipmap_mesh.py,
# word for word the JAX package's); S9 shades it.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ClipCfg:
    """The static switches of S9 (screen.py:2083-2085)."""

    width: int
    height: int
    albedo_mode: str
    hue_on: bool
    pom: Optional[tuple]         # _freeze(pom_config(...)) or None
    encode: str                  # "gamma" | "srgb"
    # the switches of S8 that S9 does not have
    has_wm = has_mat_albedo = has_refl = filterable = sss_on = False
    mm_flags = (False, False, False)
    mats = mats_dict = sky = None
    pom_dict = ShadeCfg.pom_dict


CLIP_BACKGROUND = (25, 25, 38)   # floor((0.1, 0.1, 0.15) * 255), screen.py:2023


def clipmap_shade_plain(cfg: ClipCfg, u: dict) -> torch.Tensor:
    """Plain PyTorch version of S9 (screen.py:_build_clipmap_shade_fn.shade),
    PCSS (S5) and POM (S7) included: (H, W, 4) u8."""
    H, W = cfg.height, cfg.width
    hm = u["hm"]
    dev = hm.device
    lo, hi, rng = u["dom_lo"], u["dom_hi"], u["dom_rng"]
    uu, vv = u["gb_uv"][..., 0], u["gb_uv"][..., 1]
    world = [u["gb_world"][..., c] for c in range(3)]
    vd = _normalize([c - w for c, w in zip(u["camera_pos"], world)])
    ones = torch.ones_like(uu)
    t0, t1 = u["texel"]

    def geom(a, b):
        return torch.clamp(_nearest(hm, _clip01(a), _clip01(b))[0], lo, hi)

    tl, tc, tr = geom(uu - t0, vv - t1), geom(uu, vv - t1), geom(uu + t0, vv - t1)
    lc, rc_ = geom(uu - t0, vv), geom(uu + t0, vv)
    bl, bc, br = geom(uu - t0, vv + t1), geom(uu, vv + t1), geom(uu + t0, vv + t1)
    dx = (tr + 2.0 * rc_ + br) - (tl + 2.0 * lc + bl)
    dy = (bl + 2.0 * bc + br) - (tl + 2.0 * tc + tr)
    w0, w1 = u["wtex"]
    hn = _normalize([fdiv(-dx, w0), torch.full_like(dx, u["vert"]), fdiv(-dy, w1)])
    apron = uu <= 0.0
    n = [torch.where(apron, base, c) for base, c in zip((0.0, 0.0, 1.0), hn)]

    pom = cfg.pom_dict
    pu, pv, occl = uu, vv, ones
    if pom is not None:
        pu, pv, layer, crossed = _pom_uv(hm, uu, vv, n, vd, **_pom_kw(pom))
    hs = _nearest(hm, _clip01(pu), _clip01(pv))[0]
    if pom is not None and pom["layer_height"]:
        hs = torch.where(crossed, 1.0 - layer, hs)
    hs = torch.clamp(hs, lo, hi)
    if pom is not None and pom["occlusion"]:
        occl = torch.clamp(hs, 0.65, 1.0)
    height_norm = _clip01(fdiv(hs - lo, rng))

    centers = (0.0, f32(1.0 / 3.0), f32(2.0 / 3.0), 1.0)
    wgt = []
    for cn, sm in zip(centers, (1.5, 0.5, 1.0, 1.0)):
        d = height_norm - cn
        wgt.append(torch.exp(fdiv(-(d * d), f32(2.0 * 0.1875 * 0.1875))) * sm)
    wsum = torch.clamp(wgt[0] + wgt[1] + wgt[2] + wgt[3], min=1e-5)
    wgt = [x / wsum for x in wgt]
    rough = torch.clamp(wgt[0] * 0.50 + wgt[1] * 0.85 + wgt[2] * 0.50 + wgt[3] * 0.25, 0.25, 1.0)
    ML = _MATERIAL_LINEAR
    mat_alb = [wgt[0] * float(ML[0, c]) + wgt[1] * float(ML[1, c]) + wgt[2] * float(ML[2, c])
               + wgt[3] * float(ML[3, c]) for c in range(3)]
    overlay = _lut_sample(u["lut"], height_norm)
    if cfg.albedo_mode == "colormap":
        final = overlay
    elif cfg.albedo_mode == "material":
        final = mat_alb
    else:
        final = [m + (o - m) * u["colormap_strength"] for m, o in zip(mat_alb, overlay)]
    albedo = [_clip01(c) for c in final]
    if cfg.hue_on:
        albedo = _hue_variation(albedo, height_norm, u["hue_strength"])

    # PCSS (S5) at the undisplaced height, in the spacing's frame
    shadow_h = _clip01(fdiv(geom(uu, vv) - lo, rng))
    sp_ = u["spacing"]
    sp = [(uu - 0.5) * sp_, (vv - 0.5) * sp_, shadow_h * u["z_scale"]]
    vis = _pcss(u["shadow_depth"], u["shadow_lvp"], sp, n, u["pcss_ld"])
    combined_shadow = torch.clamp(f32(0.8) + f32(0.2) * vis, min=0.30)

    # split-sum IBL
    ibl_i = u["ibl_intensity"]
    ndv_raw = _dot(n, vd)
    ndv = _clip01(ndv_raw)
    rc2 = _clip01(rough)
    refl = _normalize([(2.0 * ndv_raw) * nc - v for nc, v in zip(n, vd)])
    omc = _clip01(1.0 - ndv)
    o2 = omc * omc
    F_ibl = 0.04 + (torch.clamp(1.0 - rc2, min=0.04) - 0.04) * (omc * (o2 * o2))
    irr = _cube_sample(u["ibl_irradiance"], n)
    ibl_diffuse = [(1.0 - F_ibl) * a * i for a, i in zip(albedo, irr)]
    pref = _cube_sample_mips(u["ibl_spec"], refl, rc2 * rc2 * 9.0)
    brdf = _bilinear(u["ibl_brdf"], ndv, rc2)
    spec_brdf = F_ibl * brdf[0] + brdf[1]

    # beauty composition (P2-S4)
    ndl = torch.clamp(_dot(n, u["ldir"]), min=0.0)
    base_diffuse = (f32(0.32) + f32(0.10 - 0.32) * ndl) + f32(0.36 - 0.10) * ndl * u["sun_int"]
    edge_sig = (1.0 - n[1].abs()) * 0.3 + _quad_grad(n) * 15.0
    edge_bright = torch.clamp(edge_sig * (ndl + 0.3), 0.0, 0.25)
    edge_dark = torch.clamp(edge_sig * (1.0 - ndl) * 0.5, 0.0, 0.15)
    diffuse_lit = (base_diffuse + edge_bright - edge_dark) \
        * (torch.clamp(occl, min=0.65) * combined_shadow)
    lighting = diffuse_lit + _norm(ibl_diffuse) * ibl_i * u["ibl_fill"]
    shaded = torch.stack([(a * lighting + torch.minimum(p * spec_brdf * ibl_i * 0.12, a * 0.20))
                          * u["exposure"] for a, p in zip(albedo, pref)], -1)
    final = tonemap_filmic_terrain(shaded)
    # S8's sRGB encode clamps c to 1e-8 inside the power, JAX's S9 encode does
    # not: the power's branch has c > 0.0031308, so both give the same values
    encoded = srgb_encode(final) if cfg.encode == "srgb" else gamma_correct(final, 2.2)
    rgb = torch.round(_clip01(encoded) * 255.0).to(torch.uint8)
    bg = torch.tensor(CLIP_BACKGROUND, dtype=torch.uint8, device=dev)
    rgba = torch.full((H, W, 4), 255, dtype=torch.uint8, device=dev)
    rgba[..., :3] = torch.where(u["gb_valid"].bool()[..., None], rgb, bg)
    return rgba


def _clip_args(u: dict):
    g = _kernels.ClipArgs()
    keep = [u["gb_uv"].contiguous(), u["gb_world"].contiguous(),
            u["gb_valid"].to(torch.uint8).contiguous()]
    g.uv, g.world, g.valid = (t.data_ptr() for t in keep)
    g.spacing = u["spacing"]
    g.wtex = (_kernels._F * 2)(*u["wtex"])
    return g, keep


def _clipmap_kernel(cfg: ClipCfg, u: dict) -> torch.Tensor:
    dev = u["hm"].device
    out = torch.empty((cfg.height, cfg.width, 4), dtype=torch.uint8, device=dev)
    a, keep = screen_args(cfg, u)
    g, keep_g = _clip_args(u)
    _kernels.require_cuda("S9 clipmap_shade", *keep, *keep_g, out)
    tex = u.get("shadow_tex") or shadow_texture(u["shadow_depth"])
    if tex.res != a.shadow_res:
        raise ValueError(f"S9 clipmap_shade: the shadow texture is {tex.res}^2, the map "
                         f"{a.shadow_res}^2")
    a.shadow_tex = tex.handle
    err = _kernels.lib().f3d_clipmap_shade(a, g, _kernels.ptr(out), _kernels.stream_ptr(dev))
    _kernels.check(err, "S9 clipmap_shade")
    clipmap_shade.launches += 1
    return out


def clipmap_shade(cfg: ClipCfg, u: dict) -> torch.Tensor:
    """S9: the clipmap shade of every pixel of the G-buffer, PCSS (S5) and
    POM (S7) inside: (H, W, 4) u8 on the uniforms' device. CPU tensors run
    the plain version."""
    if u["hm"].device.type == "cpu":
        return clipmap_shade_plain(cfg, u)
    return _clipmap_kernel(cfg, u)


clipmap_shade.launches = 0


def prepare_clipmap(
    heightmap, lut_rgb, *, size_px, camera_mode, device, terrain_span=1.0,
    z_scale=1.0, exposure=1.0, light_azimuth_deg=135.0,
    light_elevation_deg=25.0, sun_intensity=1.0,
    sun_color=(1.0, 1.0, 1.0), ibl_intensity=1.0, cam_radius=1.44,
    cam_phi_deg=135.0, cam_theta_deg=45.0, fov_y_deg=55.0,
    clip=(0.1, 6000.0), albedo_mode="mix", colormap_strength=0.5,
    hue_variation_strength=0.08, hdr_rgb=None, domain=(0.0, 1.0),
    pom=None, generation="recipe", encode="gamma", gbuffer=None,
) -> Tuple[ClipCfg, dict]:
    """render_clipmap_scene's host work on `device` (a torch.device): the IBL
    pyramid (S1-S3) and the shadow map (S4) from their caches or built, the
    host G-buffer (clipmap_mesh.rasterize_clipmap_gbuffer's, or `gbuffer`
    where the caller has it), uploaded once, and the uniforms. Returns S9's
    (cfg, u)."""
    from .clipmap_mesh import rasterize_clipmap_gbuffer

    W, H = int(size_px[0]), int(size_px[1])
    if W % 2 or H % 2 or W < 2 or H < 2:
        raise ValueError(f"the clipmap mode renders even sizes only (its normal derivatives "
                         f"are taken per 2x2 pixel quad): got {W}x{H}")
    if albedo_mode not in ALBEDO_MODES:
        raise ValueError(f"albedo_mode must be one of {ALBEDO_MODES}")
    hm = np.asarray(heightmap, np.float32)
    dom_lo, dom_hi = float(domain[0]), float(domain[1])
    if hdr_rgb is None:
        hdr_rgb = decode_test_hdr()
    ibl = build_ibl(hdr_rgb, device=device)
    gb = gbuffer if gbuffer is not None else rasterize_clipmap_gbuffer(
        hm, size_px=(W, H), camera_mode=camera_mode, terrain_span=terrain_span,
        z_scale=z_scale, domain=(dom_lo, dom_hi), cam_radius=cam_radius,
        cam_phi_deg=cam_phi_deg, cam_theta_deg=cam_theta_deg, fov_y_deg=fov_y_deg, clip=clip)
    ldir = light_direction(light_azimuth_deg, light_elevation_deg)
    lcol = np.asarray(sun_color, np.float32) * float(sun_intensity)
    spacing = float(max(terrain_span, 1e-3))
    shadow_world = terrain_span if generation == "family" else spacing
    depth_map, lvp, _texel = build_shadow_map(
        hm, terrain_span=shadow_world, z_scale=z_scale, sun_dir=-ldir,
        domain=(dom_lo, dom_hi), device=device)
    hv = float(np.clip(np.float32(hue_variation_strength), 0.0, 0.2))
    cfg = ClipCfg(W, H, str(albedo_mode), hv > 0.0, _freeze(pom_config(pom, generation)),
                  str(encode))
    t = lambda a: torch.as_tensor(np.array(a, np.float32, order="C"),  # noqa: E731
                                  device=device)
    lo32, hi32, zs32, sp32 = (np.float32(dom_lo), np.float32(dom_hi), np.float32(z_scale),
                              np.float32(spacing))
    texel = (np.float32(1.0 / hm.shape[1]), np.float32(1.0 / hm.shape[0]))
    l32 = np.asarray(lcol, np.float32)
    u = {
        "hm": t(hm), "lut": t(lut_rgb),
        "dom_lo": float(lo32), "dom_hi": float(hi32),
        "dom_rng": float(max(hi32 - lo32, np.float32(1e-6))),
        "z_scale": float(zs32), "spacing": float(sp32),
        "texel": tuple(float(x) for x in texel),
        "wtex": tuple(float(x * sp32) for x in texel),
        "vert": float(max(zs32 * np.float32(0.5), np.float32(1e-3))),
        "ibl_fill": f32(0.18 * 0.35) if generation == "family" else f32(0.22),
        "ldir": _f32_triple(ldir), "lcol": _f32_triple(lcol),
        "sun_int": float(np.sqrt(l32[0] * l32[0] + l32[1] * l32[1] + l32[2] * l32[2])),
        "pcss_ld": light_dir_unit(-ldir),
        "camera_pos": _f32_triple(gb["eye"]),
        "exposure": float(max(np.float32(exposure), np.float32(0.0))),
        "ibl_intensity": f32(ibl_intensity),
        "colormap_strength": float(np.clip(np.float32(colormap_strength), 0.0, 1.0)),
        "hue_strength": hv,
        "shadow_depth": depth_map, "shadow_lvp": lvp,
        "ibl_irradiance": ibl["irradiance"], "ibl_spec": ibl["spec_mips"],
        "ibl_brdf": ibl["brdf"],
        "gb_uv": t(gb["uv"]), "gb_world": t(gb["world_pos"]),
        "gb_valid": torch.as_tensor(np.ascontiguousarray(gb["valid"], np.uint8), device=device),
    }
    if depth_map.device.type == "cuda":   # S9's PCSS taps read the map through it
        u["shadow_tex"] = shadow_texture(depth_map)
    return cfg, u


def render_clipmap_scene(
    heightmap, lut_rgb, *, size_px, camera_mode, terrain_span=1.0,
    z_scale=1.0, exposure=1.0, light_azimuth_deg=135.0,
    light_elevation_deg=25.0, sun_intensity=1.0,
    sun_color=(1.0, 1.0, 1.0), ibl_intensity=1.0, cam_radius=1.44,
    cam_phi_deg=135.0, cam_theta_deg=45.0, fov_y_deg=55.0,
    clip=(0.1, 6000.0), albedo_mode="mix", colormap_strength=0.5,
    hue_variation_strength=0.08, hdr_rgb=None, domain=(0.0, 1.0),
    pom=None, generation="recipe", encode="gamma", device="cuda", **_ignored,
):
    """TerrainRenderer's clipmap camera mode, with every argument of the JAX
    function (screen.py:2030-2039; others are ignored, as there), on the card
    unless device="cpu". Returns (H, W, 4) u8."""
    from ..pt.terrain_ref import resolve_device

    cfg, u = prepare_clipmap(
        heightmap, lut_rgb, size_px=size_px, camera_mode=camera_mode,
        device=resolve_device(device), terrain_span=terrain_span, z_scale=z_scale,
        exposure=exposure, light_azimuth_deg=light_azimuth_deg,
        light_elevation_deg=light_elevation_deg, sun_intensity=sun_intensity,
        sun_color=sun_color, ibl_intensity=ibl_intensity, cam_radius=cam_radius,
        cam_phi_deg=cam_phi_deg, cam_theta_deg=cam_theta_deg, fov_y_deg=fov_y_deg, clip=clip,
        albedo_mode=albedo_mode, colormap_strength=colormap_strength,
        hue_variation_strength=hue_variation_strength, hdr_rgb=hdr_rgb, domain=domain,
        pom=pom, generation=generation, encode=encode)
    return clipmap_shade(cfg, u).cpu().numpy()
