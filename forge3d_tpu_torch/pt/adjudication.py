# forge3d_tpu_torch/pt/adjudication.py
# Kernel P4: the built-in AEQUITAS adjudication scene of
# forge3d_tpu/pt/adjudication.py, rendered through both lanes: the
# deterministic raster twin (`_raster_frame`: pixel-centre rays, sun NEE and
# a 24 x 48 midpoint cosine quadrature with the analytic secondary closure)
# and the path tracer (`_pt_sample`: a 16-vertex Lambert path with sun and
# MIS environment NEE and Russian roulette, its uniforms from jax.random's
# threefry stream), each resolved by the shared Reinhard + sRGB tonemap.
#
# Every helper has its plain PyTorch version here, over (..., 3) tensors.
# `raster_lane` and `pt_lane` run the plain versions on the CPU and launch
# the CUDA kernels (csrc/adjudication.cu over csrc/adjudication.cuh) on the
# card, counted in `raster_lane.launches` and `pt_lane.launches`.
#
# Numerics: the scene's constant products, which XLA folds while compiling,
# are computed once on the host in float32 (`adj_constants`) and read by
# both versions. Dot products and norms are rounded as XLA reduces them
# (x*x, then two multiply-adds); everything else rounds each operation, so
# the plain version and the kernel agree operation for operation, while
# JAX's jitted lanes fuse some other multiply-adds and its cos, sin and pow
# may differ by an ulp: the parity gates against JAX are the float rule for
# the raster HDR and the whole-render rule for the tonemapped lanes.

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from .. import _kernels
from ..ops import rng
from ..ops.shading import fdiv, fma32, sqrt32
from ..ops.tonemap import srgb_eotf_inv

_F32 = torch.float32

# --- the committed scene (literal constants) -------------------------------

CAM_ORIGIN = (0.0, 2.2, 6.5)
CAM_LOOK_AT = (0.0, 0.9, 0.0)
CAM_UP = (0.0, 1.0, 0.0)
FOV_Y_DEG = 40.0

SPHERES = np.array([
    # cx, cy, cz, radius
    [-1.15, 1.0, 0.0, 1.0],
    [1.30, 0.8, 0.55, 0.8],
    [0.25, 0.5, -1.45, 0.5],
], np.float32)
# material slots 0..2 = spheres, 3 = ground plane
MAT_ALBEDO = np.array([
    [0.63, 0.28, 0.22],
    [0.24, 0.40, 0.62],
    [0.78, 0.68, 0.30],
    [0.42, 0.42, 0.42],
], np.float32)
MAT_ROUGH = np.array([0.70, 0.55, 0.85, 0.90], np.float32)
PLANE_HALF_EXTENT = 40.0

SUN_DIR = np.array([-0.45, -0.80, -0.30], np.float32)   # travel direction
SUN_INTENSITY = 3.2
SUN_COLOR = np.array([1.0, 0.97, 0.92], np.float32)
AMBIENT = np.array([0.40, 0.48, 0.62], np.float32)       # env-NEE constant
SKY = np.array([0.35, 0.45, 0.70], np.float32)           # miss constant

ENV_QUAD_U = 24
ENV_QUAD_V = 48
MAX_DEPTH = 16
RR_START_DEPTH = 4
_PI = math.pi
_PI32 = float(np.float32(_PI))

_SUN_WI = tuple((-SUN_DIR / np.linalg.norm(SUN_DIR)).tolist())
_R2 = tuple(float(np.float32(float(r) * float(r))) for r in SPHERES[:, 3])


def _c(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


def _dot(a, b):
    """jnp.sum(a * b, -1) as XLA reduces it: x0*y0, then two multiply-adds."""
    return fma32(a[..., 2], b[..., 2], fma32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _normalize(v):
    return v / torch.clamp(sqrt32(_dot(v, v)), min=1e-12)[..., None]


def _nearest_hit(ro, rd, tmin=1e-3, tmax=1e30):
    """Nearest hit over 3 spheres + the finite ground quad (the t0-else-t1
    branch order). Returns (t, kind): kind -1=miss, 0..2=sphere, 3=plane."""
    tbest = torch.full(ro.shape[:-1], float(np.float32(tmax)), dtype=_F32, device=ro.device)
    kind = torch.full(ro.shape[:-1], -1, dtype=torch.int32, device=ro.device)
    tmin = float(np.float32(tmin))
    for i in range(3):
        oc = ro - _c(SPHERES[i, :3], ro)
        b = _dot(oc, rd)
        disc = b * b - (_dot(oc, oc) - _R2[i])
        sq = sqrt32(torch.clamp(disc, min=0.0))
        t0 = -b - sq
        t1 = -b + sq
        ok0 = (disc > 0.0) & (t0 > tmin) & (t0 < tbest)
        ok1 = (disc > 0.0) & ~ok0 & (t1 > tmin) & (t1 < tbest)
        ok = ok0 | ok1
        tbest = torch.where(ok, torch.where(ok0, t0, t1), tbest)
        kind = torch.where(ok, i, kind)
    denom = rd[..., 1]
    tp = fdiv(-ro[..., 1], torch.where(denom.abs() < 1e-7, float(np.float32(1e-7)), denom))
    px = ro[..., 0] + tp * rd[..., 0]
    pz = ro[..., 2] + tp * rd[..., 2]
    okp = ((denom.abs() > 1e-7) & (tp > tmin) & (tp < tbest)
           & (px.abs() <= PLANE_HALF_EXTENT) & (pz.abs() <= PLANE_HALF_EXTENT))
    return torch.where(okp, tp, tbest), torch.where(okp, 3, kind)


def _occluded(ro, rd, tmin=1e-3, tmax=1e30):
    """Any-hit: either sphere root in range, or the ground quad."""
    tmin, tmax = float(np.float32(tmin)), float(np.float32(tmax))
    occ = torch.zeros(ro.shape[:-1], dtype=torch.bool, device=ro.device)
    for i in range(3):
        oc = ro - _c(SPHERES[i, :3], ro)
        b = _dot(oc, rd)
        disc = b * b - (_dot(oc, oc) - _R2[i])
        sq = sqrt32(torch.clamp(disc, min=0.0))
        t0 = -b - sq
        t1 = -b + sq
        hit0 = (t0 > tmin) & (t0 < tmax)
        hit1 = (t1 > tmin) & (t1 < tmax)
        occ = occ | ((disc > 0.0) & (hit0 | hit1))
    denom = rd[..., 1]
    tp = fdiv(-ro[..., 1], torch.where(denom.abs() < 1e-7, float(np.float32(1e-7)), denom))
    px = ro[..., 0] + tp * rd[..., 0]
    pz = ro[..., 2] + tp * rd[..., 2]
    return occ | ((denom.abs() > 1e-7) & (tp > tmin) & (tp < tmax)
                  & (px.abs() <= PLANE_HALF_EXTENT) & (pz.abs() <= PLANE_HALF_EXTENT))


def _surface(ro, rd, t, kind):
    """Hit point, normal, material by kind (plane kind 3: +Y, slot 3)."""
    pos = ro + t[..., None] * rd
    n = _c([0.0, 1.0, 0.0], pos).expand(pos.shape)
    alb = _c(MAT_ALBEDO[3], pos).expand(pos.shape)
    rough = torch.full(pos.shape[:-1], float(MAT_ROUGH[3]), dtype=_F32, device=pos.device)
    for i in range(3):
        sel = (kind == i)[..., None]
        n = torch.where(sel, _normalize(pos - _c(SPHERES[i, :3], pos)), n)
        alb = torch.where(sel, _c(MAT_ALBEDO[i], pos), alb)
        rough = torch.where(kind == i, float(MAT_ROUGH[i]), rough)
    return pos, n, alb, rough


def _tangent_basis(n):
    """Branchless ONB. Returns (t, b)."""
    sign = torch.where(n[..., 2] < 0, -1.0, 1.0).to(_F32)
    a = fdiv(-1.0, sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * (n[..., 0] * n[..., 0]) * a, sign * b, -sign * n[..., 0]], -1)
    bt = torch.stack([b, sign + (n[..., 1] * n[..., 1]) * a, -n[..., 1]], -1)
    return t, bt


def _cosine_local(u1, u2):
    r = sqrt32(u1)
    phi = float(np.float32(2.0 * _PI)) * u2
    return r * torch.cos(phi), r * torch.sin(phi), sqrt32(torch.clamp(1.0 - u1, min=0.0))


def _to_world(n, x, y, z):
    t, bt = _tangent_basis(n)
    return _normalize(x[..., None] * t + y[..., None] * bt + z[..., None] * n)


def _bsdf_eval_pdf(wo, wi, n, albedo, rough):
    """Isotropic Lambert+GGX eval + the (diffuse) mixture pdf."""
    ndl = torch.clamp(_dot(n, wi), min=0.0)
    ndv = torch.clamp(_dot(n, wo), min=0.0)
    valid = (ndl > 0.0) & (ndv > 0.0)
    fd = fdiv(albedo, _PI32)
    pdf_d = fdiv(ndl, _PI32)
    m = torch.clamp(rough * rough, min=0.02)
    h = _normalize(wi + wo)
    ndh = torch.clamp(_dot(n, h), min=0.0)
    vdh = torch.clamp(_dot(wo, h), min=0.0)
    a2 = m * m
    q = ndh * ndh * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp(_PI32 * (q * q), min=1e-6)
    mk = m + 1.0
    k = fdiv(mk * mk, 8.0)
    g = (ndl / (ndl * (1.0 - k) + k)) * (ndv / (ndv * (1.0 - k) + k))
    f = 0.04 + 0.96 * torch.pow(1.0 - torch.clamp(vdh, 0.0, 1.0), 5.0)
    spec = d * g / torch.clamp(4.0 * ndl * ndv, min=1e-6)
    fs = (spec * f)[..., None]
    ftot = torch.where(valid[..., None], fd + fs, 0.0)
    pdf = torch.where(valid, torch.clamp(pdf_d, min=1e-8), 0.0)
    return ftot, pdf


def _power_cosine_pdf_up(wi, m=16.0):
    c = torch.clamp(wi[..., 1], min=0.0)
    return fdiv(float(np.float32(m + 1.0)) * torch.pow(c, m), float(np.float32(2.0 * _PI)))


def _env_mixture_pdf(n, wi):
    pdf_up = _power_cosine_pdf_up(wi)
    pdf_cos = fdiv(torch.clamp(_dot(n, wi), min=0.0), _PI32)
    return 0.5 * pdf_up + 0.5 * pdf_cos


def _sun_nee(pos, n, wo, alb, rough):
    """Sun NEE with the full isotropic BRDF and analytic occlusion."""
    wi = _c(_SUN_WI, pos).expand(pos.shape)
    cos_surf = torch.clamp(_dot(n, wi), min=0.0)
    f, _ = _bsdf_eval_pdf(wo, wi, n, alb, rough)
    vis = ~_occluded(pos + n * 1e-3, wi)
    li = _c(adj_constants()["li"], pos)
    return f * li * (cos_surf * vis.to(_F32))[..., None]


def _plane_exit_radiance(qx, qz):
    """Radiance leaving the ground plane at (qx, 0, qz): Lambert sun NEE with
    occlusion, the MIS-weighted ambient and the sky, attenuated by the
    solid-angle AO of the spheres."""
    k = adj_constants()
    q = torch.stack([qx, torch.zeros_like(qx), qz], -1)
    vis = ~_occluded(q + _c([0.0, 1e-3, 0.0], q), _c(_SUN_WI, q).expand(q.shape))
    l_sun = _c(k["pe_sun"], q) * vis.to(_F32)[..., None]
    ao = torch.ones_like(qx)
    for i in range(3):
        d = _c(SPHERES[i, :3], q) - q
        d2 = _dot(d, d)
        cosf = torch.clamp(d[..., 1] / sqrt32(torch.clamp(d2, min=1e-12)), 0.0, 1.0)
        ao = ao - torch.where(d2 > _R2[i], fdiv(_R2[i], torch.clamp(d2, min=1e-12)) * cosf, 0.0)
    ao = torch.clamp(ao, 0.0, 1.0)[..., None]
    return l_sun + _c(k["pe_amb"], q) * ao + _c(k["pe_sky"], q) * ao


def _sphere_plane_exit():
    """plane_exit_radiance below each sphere centre (scene constants)."""
    xs = torch.as_tensor(SPHERES[:, 0])
    zs = torch.as_tensor(SPHERES[:, 2])
    return _plane_exit_radiance(xs, zs)


def _secondary_radiance(p2, n2, idx2, wo2):
    """Analytic secondary-vertex closure: sun NEE + the cosine-hemisphere
    partition into open sky / plane-blocked / sphere-blocked fractions."""
    idx_c = torch.clamp(idx2, 0, 3).to(torch.int64)
    alb2 = _c(MAT_ALBEDO, p2)[idx_c]
    rough2 = _c(MAT_ROUGH, p2)[idx_c]
    l = _sun_nee(p2, n2, wo2, alb2, rough2)
    ny = n2[..., 1]
    fp = torch.where(idx2 != 3, 0.5 * (1.0 - ny), 0.0)
    ao = 1.0 - fp
    fss = []
    for i in range(3):
        d = _c(SPHERES[i, :3], p2) - p2
        d2 = _dot(d, d)
        cosf = torch.clamp(_dot(n2, d) / sqrt32(torch.clamp(d2, min=1e-12)), 0.0, 1.0)
        f = fdiv(_R2[i], torch.clamp(d2, min=1e-12)) * cosf
        f = torch.where((idx2 != i) & (d2 > _R2[i]), f, 0.0)
        fss.append(f)
        ao = ao - f
    ao = torch.clamp(ao, 0.0, 1.0)
    c = torch.clamp(ny, -1.0, 1.0)
    tmis = 0.35583 + c * (0.06546 + c * (0.03152 - c * 0.01529))
    l = l + alb2 * _c(AMBIENT, p2) * (tmis * ao)[..., None]
    l = l + alb2 * _c(SKY, p2) * ao[..., None]
    l = l + alb2 * _plane_exit_radiance(p2[..., 0], p2[..., 2]) * fp[..., None]
    pe_s = _c(_pe_s(), p2).reshape(3, 3)
    for i in range(3):
        l = l + alb2 * _c(MAT_ALBEDO[i], p2) * pe_s[i] * fss[i][..., None]
    return l


def _camera_rays(width, height, jx, jy):
    k = adj_constants(width, height)
    dev = jx.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev),
                            indexing="ij")
    u = (fdiv(xs.to(_F32) + jx, float(width)) * 2.0 - 1.0) * k["half_w"]
    v = (1.0 - fdiv(ys.to(_F32) + jy, float(height)) * 2.0) * k["half_h"]
    rd = _normalize(u[..., None] * _c(k["right"], jx) + v[..., None] * _c(k["up"], jx)
                    + _c(k["fwd"], jx))
    ro = _c(CAM_ORIGIN, jx).expand(rd.shape)
    return ro, rd


def adj_constants(width: int = 1, height: int = 1) -> Dict[str, object]:
    """The scene's float32 constants and the products of constants JAX's
    compiler folds (in JAX's order), as the kernels' AdjArgs carries them."""
    f = np.float32
    eye = np.asarray(CAM_ORIGIN, f)
    fwd = np.asarray(CAM_LOOK_AT, f) - eye
    fwd = fwd / max(f(np.sqrt(f(fwd[2] * fwd[2] + f(fwd[1] * fwd[1] + fwd[0] * fwd[0])))), f(1e-12))
    right = np.cross(fwd, np.asarray(CAM_UP, f)).astype(f)
    right = right / max(f(np.sqrt(f(right[2] * right[2] + f(right[1] * right[1]
                                                             + right[0] * right[0])))), f(1e-12))
    up = np.cross(right, fwd).astype(f)
    half_h = math.tan(math.radians(FOV_Y_DEG) * 0.5)
    alb_p = MAT_ALBEDO[3]
    li = f(SUN_INTENSITY) * SUN_COLOR
    pe_sun = (alb_p / f(_PI)) * f(SUN_INTENSITY) * SUN_COLOR * f(_SUN_WI[1])
    k = {
        "li": li, "pe_sun": pe_sun, "pe_amb": alb_p * AMBIENT * f(0.43752),
        "pe_sky": alb_p * SKY, "right": right, "up": up, "fwd": fwd,
        "half_h": float(f(half_h)), "half_w": float(f(half_h * width / height)),
        "quad_w": float(f(_PI / float(ENV_QUAD_U * ENV_QUAD_V))),
    }
    return k


@functools.lru_cache(maxsize=None)
def _pe_s() -> np.ndarray:
    """(9,) float32: _sphere_plane_exit, computed once on the CPU."""
    return _sphere_plane_exit().numpy().reshape(-1)


def quadrature_table(device="cpu") -> torch.Tensor:
    """(1152, 3) float32: _cosine_local of each quadrature node, in the
    scan's order (u1 over 24 rows, u2 over 48 columns)."""
    ii, jj = np.meshgrid(np.arange(ENV_QUAD_U), np.arange(ENV_QUAD_V), indexing="ij")
    u1 = torch.as_tensor(((ii.ravel() + 0.5) / ENV_QUAD_U).astype(np.float32), device=device)
    u2 = torch.as_tensor(((jj.ravel() + 0.5) / ENV_QUAD_V).astype(np.float32), device=device)
    return torch.stack(_cosine_local(u1, u2), -1).contiguous()


#: quadrature directions a plain raster frame processes at once (bounds the
#: (chunk, H, W, 3) temporaries)
QUAD_CHUNK_ELEMENTS = 1 << 22


def _raster_frame(width, height, device="cpu"):
    """Plain version of the raster twin's HDR frame (H, W, 3): pixel-centre
    rays, sun NEE, the 1,152-direction quadrature summed in scan order."""
    half = torch.full((height, width), 0.5, dtype=_F32, device=device)
    ro, rd = _camera_rays(width, height, half, half)
    t, kind = _nearest_hit(ro, rd)
    hit = kind >= 0
    pos, n, alb, rough = _surface(ro, rd, t, kind)
    wo = _normalize(_c(CAM_ORIGIN, pos) - pos)
    radiance = _sun_nee(pos, n, wo, alb, rough)
    shadow_o = pos + n * 1e-3
    tvec, btvec = _tangent_basis(n)
    quad = quadrature_table(device)
    alb_pi = fdiv(alb, _PI32)
    accum = torch.zeros_like(pos)
    chunk = max(1, QUAD_CHUNK_ELEMENTS // max(1, width * height))
    for q0 in range(0, quad.shape[0], chunk):
        qc = quad[q0:q0 + chunk]
        x, y, z = (qc[:, k, None, None, None] for k in range(3))
        wi = _normalize(x * tvec + y * btvec + z * n)
        cos_surf = torch.clamp(_dot(n, wi), min=0.0)
        live = cos_surf > 0.0
        so = shadow_o.expand(wi.shape)
        t2, kind2 = _nearest_hit(so, wi)
        escaped = kind2 < 0
        f, pdf_b = _bsdf_eval_pdf(wo.expand(wi.shape), wi, n.expand(wi.shape),
                                  alb.expand(wi.shape), rough.expand(wi.shape[:-1]))
        pdf_l = _env_mixture_pdf(n.expand(wi.shape), wi)
        w_mis = pdf_l / torch.clamp(pdf_l + pdf_b, min=1e-8)
        esc = f * _c(AMBIENT, wi) * w_mis[..., None] + alb_pi * _c(SKY, wi)
        p2 = so + t2[..., None] * wi
        n2 = _c([0.0, 1.0, 0.0], p2).expand(p2.shape)
        for i in range(3):
            n2 = torch.where((kind2 == i)[..., None], _normalize(p2 - _c(SPHERES[i, :3], p2)), n2)
        sec = alb_pi * _secondary_radiance(p2, n2, kind2, -wi)
        contrib = torch.where(live[..., None], torch.where(escaped[..., None], esc, sec), 0.0)
        on = live & hit
        _raster_frame.escaped += int((on & escaped).sum())
        _raster_frame.blocked += int((on & ~escaped).sum())
        for k in range(contrib.shape[0]):   # the scan's order, one direction at a time
            accum = accum + contrib[k]
    radiance = radiance + accum * adj_constants()["quad_w"]
    _raster_frame.hits += int(hit.sum())
    return torch.where(hit[..., None], radiance, _c(SKY, radiance))


# The work the data needed, summed over calls (hit pixels; live quadrature
# directions that escaped to the sky and that hit the scene): read by
# chip_smoke.py for the kernel's bound.
_raster_frame.hits = 0
_raster_frame.escaped = 0
_raster_frame.blocked = 0


def _warp_cost(cls, weights, layout):
    """(lanes' work, the warps' issued work) of a (chunk, H, W) tensor of
    per-(direction, pixel) work classes: a warp runs each class's code for
    a direction if any of its lanes needs it, so it issues the class's
    weight for all 32 lanes. Warps are 32 pixels of a row ("row") or 8x4
    (K6's); pixels past the frame are idle lanes."""
    c, h, w = cls[0].shape
    wy, wx = (1, 32) if layout == "row" else (4, 8)
    ph, pw = -h % wy, -w % wx
    useful = issued = 0.0
    for mask, weight in zip(cls, weights):
        m = torch.nn.functional.pad(mask, (0, pw, 0, ph))
        m = m.reshape(c, (h + ph) // wy, wy, (w + pw) // wx, wx)
        useful += weight * float(m.sum())
        issued += weight * 32.0 * float(m.any(4).any(2).sum())
    return useful, issued


def raster_work(width: int, height: int, device="cpu", weights=None) -> Dict[str, float]:
    """The work of P4 raster at (width, height), counted from the plain
    version's masks in its order: pixels that hit the scene and those whose
    sun NEE is lit (cos_surf > 0); live directions of hit pixels that escape
    and that hit the scene ("blocked"); of the blocked, those that hit the
    ground, those with a plane-exit share (fp != 0) and those whose
    secondary sun NEE is lit. With `weights` (escaped, blocked; the kernel's
    blocked base, plane share, lit sun NEE) it adds the lane efficiency of
    warps of a row of 32 pixels and of 8x4 pixels: the lanes' work over the
    warps' issued work, for the parent's cost (escaped, blocked) and the
    kernel's (escaped, base, plane, sun)."""
    half = torch.full((height, width), 0.5, dtype=_F32, device=device)
    ro, rd = _camera_rays(width, height, half, half)
    t, kind = _nearest_hit(ro, rd)
    hit = kind >= 0
    pos, n, _, _ = _surface(ro, rd, t, kind)
    sun = _c(_SUN_WI, pos)
    so = pos + n * 1e-3
    tvec, btvec = _tangent_basis(n)
    quad = quadrature_table(device)
    keys = ("escaped", "blocked", "blocked_ground", "plane_exit", "sun_lit")
    out = {k: 0 for k in keys}
    out["hits"] = int(hit.sum())
    out["primary_lit"] = int((hit & (torch.clamp(_dot(n, sun.expand(n.shape)), min=0.0) > 0)).sum())
    eff = {}
    chunk = max(1, QUAD_CHUNK_ELEMENTS // max(1, width * height))
    for q0 in range(0, quad.shape[0], chunk):
        qc = quad[q0:q0 + chunk]
        x, y, z = (qc[:, k, None, None, None] for k in range(3))
        wi = _normalize(x * tvec + y * btvec + z * n)
        live = (torch.clamp(_dot(n, wi), min=0.0) > 0.0) & hit
        t2, kind2 = _nearest_hit(so.expand(wi.shape), wi)
        p2 = so + t2[..., None] * wi
        n2 = _c([0.0, 1.0, 0.0], p2).expand(p2.shape)
        for i in range(3):
            n2 = torch.where((kind2 == i)[..., None], _normalize(p2 - _c(SPHERES[i, :3], p2)), n2)
        fp = torch.where(kind2 != 3, 0.5 * (1.0 - n2[..., 1]), 0.0)
        esc = live & (kind2 < 0)
        blk = live & (kind2 >= 0)
        plane = blk & (fp != 0.0)
        lit = blk & (torch.clamp(_dot(n2, sun.expand(n2.shape)), min=0.0) > 0.0)
        for k, m in zip(keys, (esc, blk, blk & (kind2 == 3), plane, lit)):
            out[k] += int(m.sum())
        if weights is not None:
            for model, cls, wts in (("parent", (esc, blk), weights[:2]),
                                    ("kernel", (esc, blk, plane, lit),
                                     (weights[0], *weights[2:]))):
                for layout in ("row", "8x4"):
                    u, i = _warp_cost(cls, wts, layout)
                    a, b = eff.get((model, layout), (0.0, 0.0))
                    eff[(model, layout)] = (a + u, b + i)
    for (model, layout), (u, i) in eff.items():
        out[f"lanes_{model}_{layout}"] = u / i if i else 1.0
    return out


def _sample_keys(key) -> np.ndarray:
    """(98, 2) uint32: the keys of one sample's draws, in the kernels'
    order: fold_in(kj, 0), fold_in(kj, 1), then fold_in(fold_in(kpath,
    depth), j) for depth 0..15 and j 0..5."""
    kj, kpath = rng.split(key)
    out = [rng.fold_in(kj, 0), rng.fold_in(kj, 1)]
    for depth in range(MAX_DEPTH):
        kd = rng.fold_in(kpath, depth)
        out.extend(rng.fold_in(kd, j) for j in range(6))
    return np.stack(out)


@functools.lru_cache(maxsize=8)
def key_table(seed: int, spp: int) -> np.ndarray:
    """(spp, 98, 2) uint32: the keys of each sample i under
    fold_in(PRNGKey(seed), i). Cached: the 98 * spp hashes run in numpy on
    the host (~0.18 s at spp 64), and a seed's table never changes."""
    base = rng.prng_key(seed)
    table = np.stack([_sample_keys(rng.fold_in(base, i)) for i in range(spp)])
    table.setflags(write=False)
    return table


def _pt_sample(keys, width, height, device="cpu"):
    """Plain version of one spp of the path-traced lane: `keys` is the
    sample's (98, 2) key table. Returns the (H, W, 3) HDR sample."""
    shape = (height, width)

    def u(k):
        return rng.uniform_tensor(keys[k], shape, device)

    ro, rd = _camera_rays(width, height, u(0), u(1))
    thr = torch.ones(ro.shape, dtype=_F32, device=device)
    alive = torch.ones(shape, dtype=torch.bool, device=device)
    acc = torch.zeros(ro.shape, dtype=_F32, device=device)
    sky = _c(SKY, ro)
    for depth in range(MAX_DEPTH):
        kd = 2 + 6 * depth
        t, kind = _nearest_hit(ro, rd)
        miss = kind < 0
        acc = acc + torch.where((alive & miss)[..., None], thr * sky, 0.0)
        alive = alive & ~miss
        n_alive = int(alive.sum())
        if n_alive == 0:
            break                   # every later update is masked by alive
        _pt_sample.vertices += n_alive
        pos, n, alb, rough = _surface(ro, rd, t, kind)
        wo = -rd
        sun = _sun_nee(pos, n, wo, alb, rough)
        acc = acc + torch.where(alive[..., None], thr * sun, 0.0)
        u1, u2, u3 = u(kd), u(kd + 1), u(kd + 2)
        cos_t = torch.pow(1.0 - u2, float(np.float32(1.0 / 17.0)))
        sin_t = sqrt32(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = float(np.float32(2.0 * _PI)) * u3
        wi_up = torch.stack([sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi)], -1)
        wi_cos = _to_world(n, *_cosine_local(u2, u3))
        wi_l = torch.where((u1 < 0.5)[..., None], wi_up, wi_cos)
        cos_surf = torch.clamp(_dot(n, wi_l), min=0.0)
        pdf_l = _env_mixture_pdf(n, wi_l)
        f, pdf_b = _bsdf_eval_pdf(wo, wi_l, n, alb, rough)
        w_mis = pdf_l / torch.clamp(pdf_l + pdf_b, min=1e-8)
        vis = ~_occluded(pos + n * 1e-3, wi_l)
        env_c = (f * _c(AMBIENT, f)
                 * (cos_surf / torch.clamp(pdf_l, min=1e-8) * w_mis * vis.to(_F32))[..., None])
        acc = acc + torch.where((alive & (cos_surf > 0.0))[..., None], thr * env_c, 0.0)
        d = _to_world(n, *_cosine_local(u(kd + 3), u(kd + 4)))
        thr_new = thr * alb
        max_c = thr_new.amax(-1)
        q = (torch.clamp(1.0 - max_c, 0.0, 0.95) if depth >= RR_START_DEPTH
             else torch.zeros_like(max_c))
        alive = alive & (u(kd + 5) >= q) & (depth + 1 < MAX_DEPTH)
        thr = thr_new / torch.clamp(1.0 - q, min=1e-6)[..., None]
        ro, rd = pos + n * 1e-3, d
    return acc


# The work the data needed, summed over calls (path vertices shaded): read
# by chip_smoke.py for the kernel's bound.
_pt_sample.vertices = 0


def pt_paths(width: int, height: int, spp: int, seed: int, device="cpu"):
    """(iters, verts), each (spp, H, W) int32: the nearest-hit steps and the
    shaded vertices of each sample's path, from the plain lane's masks
    (`_pt_sample`'s rays, alive mask and roulette, without its radiance)."""
    keys = key_table(seed, spp)
    shape = (height, width)
    iters = torch.zeros((spp, *shape), dtype=torch.int32, device=device)
    verts = torch.zeros_like(iters)
    for i in range(spp):
        def u(k):
            return rng.uniform_tensor(keys[i][k], shape, device)

        ro, rd = _camera_rays(width, height, u(0), u(1))
        thr = torch.ones(ro.shape, dtype=_F32, device=device)
        alive = torch.ones(shape, dtype=torch.bool, device=device)
        for depth in range(MAX_DEPTH):
            kd = 2 + 6 * depth
            t, kind = _nearest_hit(ro, rd)
            iters[i] += alive.to(torch.int32)
            alive = alive & (kind >= 0)
            if not bool(alive.any()):
                break
            verts[i] += alive.to(torch.int32)
            pos, n, alb, _ = _surface(ro, rd, t, kind)
            d = _to_world(n, *_cosine_local(u(kd + 3), u(kd + 4)))
            thr_new = thr * alb
            q = (torch.clamp(1.0 - thr_new.amax(-1), 0.0, 0.95) if depth >= RR_START_DEPTH
                 else torch.zeros_like(t))
            alive = alive & (u(kd + 5) >= q) & (depth + 1 < MAX_DEPTH)
            thr = thr_new / torch.clamp(1.0 - q, min=1e-6)[..., None]
            ro, rd = pos + n * 1e-3, d
    return iters, verts


def _warp_lanes(x, layout: str) -> torch.Tensor:
    """(..., H, W) -> (..., warps, 32): warps of 32 pixels of a row ("row")
    or of 8x4 pixels ("8x4"), row-major; pixels past the frame are zeros
    (idle lanes)."""
    h, w = x.shape[-2:]
    wy, wx = (1, 32) if layout == "row" else (4, 8)
    x = torch.nn.functional.pad(x, (0, -w % wx, 0, -h % wy))
    lead = x.shape[:-2]
    x = x.reshape(*lead, x.shape[-2] // wy, wy, x.shape[-1] // wx, wx)
    x = x.movedim(-3, -2).reshape(*lead, -1, wy * wx)
    return x


def _lane_steps(iters, verts):
    """Each lane's steps over its samples in order: (pixels, K) bool, True
    where the step shades a vertex, and (pixels, K) bool, True where the
    lane has a step; iters, verts (spp, pixels)."""
    end = torch.cumsum(iters, 0)
    start = end - iters
    k_max = int(end[-1].max()) if end.numel() else 0
    n = iters.shape[1]
    diff = torch.zeros((n, k_max + 1), dtype=torch.int32, device=iters.device)
    ones = torch.ones(start.T.shape, dtype=torch.int32, device=iters.device)
    diff.scatter_add_(1, start.T.long(), ones)
    diff.scatter_add_(1, (start + verts).T.long(), -ones)
    vert = torch.cumsum(diff, 1)[:, :k_max] > 0
    step = torch.arange(k_max, device=iters.device)[None, :] < end[-1][:, None]
    return vert, step


def _queue_passes(verts_px, lead_px, tail_px, lanes: int):
    """The hit loop with a pixel queue: `lanes` lanes (warps of 32) take
    pixels in order, one each at the start and the next when a pixel's
    vertices are done, lanes asking in the same pass in lane order. In a
    pass a lane shades one vertex, after its cheap steps: the steps of its
    pixel up to that vertex, and when it takes pixels, the trailing steps
    of the one it ends and every step of any that has no vertex. verts_px
    (P,) vertices a pixel; lead_px (V,) the steps up to each vertex, pixel
    by pixel in queue order; tail_px (P,) the steps after a pixel's last
    vertex. Returns (issued vertex steps, issued iterations) of the warps."""
    dev = verts_px.device
    n_px = verts_px.numel()
    first = torch.cumsum(verts_px, 0) - verts_px   # each pixel's first entry in lead_px
    lanes = -(-lanes // 32) * 32
    pix = torch.full((lanes,), -1, dtype=torch.long, device=dev)
    k = torch.zeros(lanes, dtype=torch.long, device=dev)
    live = torch.ones(lanes, dtype=torch.bool, device=dev)
    nxt = 0
    issued_v = issued_i = 0
    while bool(live.any()):
        cost = torch.zeros(lanes, dtype=torch.long, device=dev)
        ends = live & ((pix < 0) | (k >= verts_px[pix.clamp(min=0)]))
        cost += torch.where(ends & (pix >= 0), tail_px[pix.clamp(min=0)], 0)
        ask = ends
        while bool(ask.any()):
            idx = torch.nonzero(ask).flatten()
            got = torch.arange(nxt, nxt + idx.numel(), device=dev)
            nxt += idx.numel()
            ok = got < n_px
            live[idx[~ok]] = False
            idx, got = idx[ok], got[ok]
            pix[idx], k[idx] = got, 0
            empty = verts_px[got] == 0
            cost[idx[empty]] += tail_px[got[empty]]
            ask = torch.zeros_like(ask)
            ask[idx[empty]] = True
        shade = live & (pix >= 0)
        cost += torch.where(shade, lead_px[(first[pix.clamp(min=0)] + k).clamp(max=max(
            lead_px.numel() - 1, 0))] if lead_px.numel() else 0, 0)
        k += shade.to(torch.long)
        issued_v += int(shade.reshape(-1, 32).any(1).sum())
        issued_i += int(cost.reshape(-1, 32).amax(1).sum())
    return issued_v, issued_i


def pt_work(width: int, height: int, spp: int, seed: int, layout: str = "8x4",
            lanes=None, device="cpu") -> Dict[str, float]:
    """The lanes' share of the warps' vertex steps and of their iterations
    (nearest-hit steps) for P4 pt at (width, height, spp, seed), counted from
    the plain lane's masks (pt_paths), under four designs: "serial" (a lane
    a pixel, its samples in turn, each path's depth loop until the warp's
    longest path ends), "regen" (a lane starts its next sample as soon as a
    path ends, shading at whichever step it is), "hit_loop" (a lane runs
    cheap steps until it holds a vertex, then the warp shades together) and
    "queue" (the hit loop, `lanes` lanes taking the next pixel in the
    layout's order when theirs is done; default a lane a pixel). Warps are
    32 pixels of a row or 8x4 (`layout`). Returns, for each design, the
    shares (`<design>_vertex`, `<design>_iter`) and the issued vertex steps
    relative to serial's (`<design>_steps`), with the totals `vertices`,
    `iterations` and `pixels_sky` (pixels that shade no vertex)."""
    iters, verts = pt_paths(width, height, spp, seed, device)
    out = {"vertices": int(verts.sum()), "iterations": int(iters.sum()),
           "pixels_sky": int((verts.sum(0) == 0).sum())}
    it_w, vt_w = _warp_lanes(iters, layout), _warp_lanes(verts, layout)   # (spp, warps, 32)
    issued = {"serial": (int(vt_w.amax(2).sum()), int(it_w.amax(2).sum()))}
    # the lanes' steps in order (warp-major), for regen and the hit loop
    it_l, vt_l = it_w.reshape(spp, -1), vt_w.reshape(spp, -1)
    vert, step = _lane_steps(it_l, vt_l)
    issued["regen"] = (int(vert.reshape(-1, 32, vert.shape[1]).any(1).sum()),
                       int(step.reshape(-1, 32, step.shape[1]).any(1).sum()))
    # hit loop: step k belongs to pass (vertices before it) + 1
    before = torch.cumsum(vert.to(torch.int32), 1) - vert.to(torch.int32)
    n_pass = int(before.max()) + 1 if before.numel() else 1
    per_pass = torch.zeros((vert.shape[0], n_pass), dtype=torch.int32, device=device)
    per_pass.scatter_add_(1, before.long(), step.to(torch.int32))
    issued["hit_loop"] = (int(vt_l.sum(0).reshape(-1, 32).amax(1).sum()),
                          int(per_pass.reshape(-1, 32, n_pass).amax(1).sum()))
    # the queue: pixels in the layout's order (the lanes above, the frame's
    # padding left out); each vertex's steps since the pixel's previous one
    real = _warp_lanes(torch.ones((height, width), dtype=torch.int32, device=device),
                       layout).reshape(-1) > 0
    row, pos = torch.nonzero(vert).T
    prev = torch.cat([pos.new_full((1,), -1), pos[:-1]])
    prev[torch.cat([row.new_ones(1, dtype=torch.bool), row[1:] != row[:-1]])] = -1
    last = torch.full((vert.shape[0],), -1, dtype=torch.long, device=device)
    last.scatter_reduce_(0, row, pos, "amax")
    v_px = vt_l.sum(0)
    issued["queue"] = _queue_passes(v_px[real], (pos - prev)[real[row]],
                                    (step.sum(1) - 1 - last)[real],
                                    width * height if lanes is None else int(lanes))
    for name, (v, i) in issued.items():
        out[f"{name}_vertex"] = out["vertices"] / (32.0 * v) if v else 1.0
        out[f"{name}_iter"] = out["iterations"] / (32.0 * i) if i else 1.0
        out[f"{name}_steps"] = v / issued["serial"][0] if issued["serial"][0] else 1.0
    return out


def _tonemap(hdr):
    """The shared resolve: Reinhard, then the exact piecewise sRGB encode,
    +0.5 round. (H, W, 3) float32 -> (H, W, 4) uint8."""
    x = torch.clamp(hdr, min=0.0)
    y = x / (1.0 + x)
    srgb = torch.clamp(srgb_eotf_inv(y), 0.0, 1.0)
    rgb = torch.clamp(srgb * 255.0 + 0.5, 0, 255).to(torch.uint8)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8, device=rgb.device)
    return torch.cat([rgb, alpha], -1)


# ---------------------------------------------------------------------------
# The lanes: plain versions on the CPU, kernels on the card
# ---------------------------------------------------------------------------

def adj_args(width: int, height: int, spp: int = 1) -> "_kernels.AdjArgs":
    k = adj_constants(width, height)
    a = _kernels.AdjArgs()
    a.width, a.height, a.spp, a.n_quad = width, height, spp, ENV_QUAD_U * ENV_QUAD_V
    fields = {"sph": SPHERES.reshape(-1), "r2": _R2, "alb": MAT_ALBEDO.reshape(-1),
              "rough": MAT_ROUGH, "sun_wi": _SUN_WI, "li": k["li"], "amb": AMBIENT, "sky": SKY,
              "pe_sun": k["pe_sun"], "pe_amb": k["pe_amb"], "pe_sky": k["pe_sky"],
              "pe_s": _pe_s(), "cam_o": CAM_ORIGIN, "right": k["right"], "up": k["up"],
              "fwd": k["fwd"]}
    for name, vals in fields.items():
        getattr(a, name)[:] = [float(np.float32(v)) for v in np.asarray(vals).reshape(-1)]
    a.half_w, a.half_h, a.quad_w = k["half_w"], k["half_h"], k["quad_w"]
    return a


def raster_lane_plain(width: int, height: int, device="cpu"):
    """(rgba (H, W, 4) u8, hdr (H, W, 3) f32) of the raster twin."""
    hdr = _raster_frame(width, height, device)
    return _tonemap(hdr), hdr


def _raster_lane_kernel(width: int, height: int, device):
    quad = quadrature_table(device)
    rgba = torch.empty(height, width, 4, dtype=torch.uint8, device=device)
    hdr = torch.empty(height, width, 3, dtype=_F32, device=device)
    _kernels.require_cuda("adj_raster", quad, rgba, hdr)
    err = _kernels.lib().f3d_adj_raster(adj_args(width, height), _kernels.ptr(quad),
                                        _kernels.ptr(rgba), _kernels.ptr(hdr),
                                        _kernels.stream_ptr(quad.device))
    _kernels.check(err, "P4 raster")
    raster_lane.launches += 1
    return rgba, hdr


def raster_lane(width: int, height: int, device):
    """The raster twin at (width, height): kernel P4 raster on "cuda", the
    plain version on "cpu"."""
    if torch.device(device).type == "cpu":
        return raster_lane_plain(width, height, device)
    return _raster_lane_kernel(width, height, device)


raster_lane.launches = 0


def pt_lane_plain(width: int, height: int, spp: int, seed: int, device="cpu"):
    """(rgba, hdr) of the path-traced lane: spp samples summed in order,
    divided by spp, tone mapped."""
    keys = key_table(seed, spp)
    hdr = torch.zeros(height, width, 3, dtype=_F32, device=device)
    for i in range(spp):
        hdr = hdr + _pt_sample(keys[i], width, height, device)
    hdr = hdr / float(spp)
    return _tonemap(hdr), hdr


def _pt_lane_kernel(width: int, height: int, spp: int, seed: int, device):
    keys = torch.as_tensor(key_table(seed, spp).view(np.int32).copy(), device=device)
    rgba = torch.empty(height, width, 4, dtype=torch.uint8, device=device)
    hdr = torch.empty(height, width, 3, dtype=_F32, device=device)
    _kernels.require_cuda("adj_pt", keys, rgba, hdr)
    err = _kernels.lib().f3d_adj_pt(adj_args(width, height, spp), _kernels.ptr(keys),
                                    _kernels.ptr(rgba), _kernels.ptr(hdr),
                                    _kernels.stream_ptr(keys.device))
    _kernels.check(err, "P4 pt")
    pt_lane.launches += 1
    return rgba, hdr


def pt_lane(width: int, height: int, spp: int, seed: int, device):
    """The path-traced lane: kernel P4 pt on "cuda", the plain version on
    "cpu"."""
    if torch.device(device).type == "cpu":
        return pt_lane_plain(width, height, spp, seed, device)
    return _pt_lane_kernel(width, height, spp, seed, device)


pt_lane.launches = 0


def render_adjudication_builtin(width: int = 512, height: int = 512, *, spp: int = 64,
                                seed: int = 7, device="cuda") -> Tuple[np.ndarray, np.ndarray,
                                                                       Dict]:
    """Render the committed adjudication scene through both lanes.

    Returns (pt_rgba, raster_rgba, meta) in the native seam's contract."""
    from .terrain_ref import resolve_device

    dev = resolve_device(device)
    width, height, spp = int(width), int(height), max(int(spp), 1)
    pt_rgba, _ = pt_lane(width, height, spp, int(seed), dev)
    raster_rgba, _ = raster_lane(width, height, dev)
    meta_common = {
        "cam_origin": CAM_ORIGIN, "cam_look_at": CAM_LOOK_AT,
        "fov_y_deg": FOV_Y_DEG,
        "sun_intensity": SUN_INTENSITY,
        "ambient_r": float(AMBIENT[0]), "ambient_g": float(AMBIENT[1]),
        "ambient_b": float(AMBIENT[2]),
        "sky_r": float(SKY[0]), "sky_g": float(SKY[1]),
        "sky_b": float(SKY[2]),
    }
    return (pt_rgba.cpu().numpy(), raster_rgba.cpu().numpy(),
            {"pt": dict(meta_common), "raster": dict(meta_common)})
