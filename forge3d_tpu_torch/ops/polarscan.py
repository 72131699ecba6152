# forge3d_tpu_torch/ops/polarscan.py
# Polar primary-visibility scan (forge3d_tpu/ops/polarscan.py), on PyTorch:
# all primary rays share one origin, so each vertical plane through the
# camera (one azimuth column) meets the heightfield in a 1D profile sampled
# at the camera-aligned grid's rows; the first crossing of a ray at reduced
# elevation tangent Q is the first sample whose running-max tangent passes Q.
#
# These are the plain PyTorch versions of the pieces of kernels K3 (profile
# extraction, tangents, first-crossing contraction, miss directions) and K4
# (the screen warp). They keep the JAX package's dense forms: hat-weight
# contractions over the grid columns and over azimuth, and the soft
# cumulative crossing indicator over (E, K, A), chunked so that the bench
# shape fits in device memory. The kernels (csrc/sweep.cuh) evaluate the
# same sums with their two non-zero taps.

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .shading import fdiv, rsqrt, sqrt32
from .traversal import f32

_F32 = torch.float32
NEG32 = f32(-1.0e30)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class PolarStatic:
    """Static polar-scan geometry (Python floats). Polar rows are
    screen-aligned: row e sits at ndc_y = 1 - (e + 0.5) * y_step, and a ray's
    elevation test uses the reduced tangent Q(y) = dy(y) / cv(y)."""

    a_count: int       # azimuth columns
    e_count: int       # elevation rows = row_ss * height + pad
    e_pad: int         # trailing pad rows (ignored by the resolve)
    row_ss: int        # vertical supersampling factor (rows per pixel row)
    k_count: int       # radial samples (camera-aligned grid rows)
    k0: int            # first rotated-grid row index used (floor(cam_iv))
    t_lo: float        # tan(beta) of azimuth column 0
    t_step: float
    y_step: float      # ndc-y per polar row (rows run top -> bottom)
    hw: float          # tan(fov_x/2)
    fy: float          # fwd . y-hat
    uyhh: float        # (up . y-hat) * tan(fov_y/2)
    fv: float          # fwd . e_v
    uvhh: float        # (up . e_v) * tan(fov_y/2)
    cam_y: float
    e_u: Tuple[float, float, float]
    e_v: Tuple[float, float, float]
    cam_iu: float
    cam_iv: float
    spacing: float

    def ndc_rows(self, je=0.0, device="cpu"):
        """ndc-y of each polar row center (+ sub-row jitter je)."""
        e = torch.arange(self.e_count, dtype=_F32, device=device)
        return 1.0 - (e + 0.5 + je) * f32(self.y_step)

    def q_rows(self, je=0.0, device="cpu"):
        """Reduced elevation tangent Q = dy/cv of each polar row."""
        ndc = self.ndc_rows(je, device)
        cv = torch.clamp(f32(self.fv) + ndc * f32(self.uvhh), min=f32(0.02))
        return fdiv(f32(self.fy) + ndc * f32(self.uyhh), cv)


def plan_polar(*, width: int, height: int, fov_y_deg: float,
               right, up, fwd, cam_y: float,
               rg_n_v: int, rg_n_u: int, rg_spacing: float,
               e_u, e_v, cam_iu: float, cam_iv: float,
               density: float = 1.3, max_axis: int = 4096,
               row_ss: int = 2) -> PolarStatic:
    """Size the polar grid from the camera frustum. Raises ValueError for a
    rolled camera or a frustum with near-vertical rays."""
    right = np.asarray(right, np.float64)
    up_v = np.asarray(up, np.float64)
    fwd = np.asarray(fwd, np.float64)
    e_u3 = np.asarray(e_u, np.float64)
    e_v3 = np.asarray(e_v, np.float64)
    if abs(float(right[1])) > 1e-3:
        raise ValueError("polar scan requires a roll-free camera")
    hh = math.tan(math.radians(fov_y_deg) * 0.5)
    hw = hh * (width / height)
    xs = np.linspace(-1.0, 1.0, 9)
    ys = np.linspace(-1.0, 1.0, 9)
    gx, gy = np.meshgrid(xs, ys)
    d = (fwd[None, None, :]
         + gx[..., None] * hw * right[None, None, :]
         + gy[..., None] * hh * up_v[None, None, :])
    cu = d @ e_u3
    cv = d @ e_v3
    if float(cv.min()) < 0.05:
        raise ValueError(
            "frustum contains near-vertical rays; polar scan unsupported "
            "(fall back to traversal='dda'/'mxu')")
    tanb = cu / cv
    t_margin = 0.02 * (tanb.max() - tanb.min() + 1e-6)
    t_lo, t_hi = float(tanb.min() - t_margin), float(tanb.max() + t_margin)
    dt_pix = (2.0 * hw / width) / float(cv.max())
    a_count = _round_up(int(math.ceil((t_hi - t_lo) / (dt_pix / density))), 128)
    a_count = min(a_count, max_axis)
    rows = int(row_ss) * int(height)
    e_count = _round_up(rows, 8)
    k0 = min(max(int(math.floor(cam_iv)), 0), max(rg_n_v - 12, 0))
    k_count = max(rg_n_v - k0 - 3, 8)
    return PolarStatic(
        a_count=a_count, e_count=e_count, e_pad=e_count - rows,
        row_ss=int(row_ss), k_count=k_count, k0=k0,
        t_lo=t_lo, t_step=(t_hi - t_lo) / a_count,
        y_step=2.0 / rows, hw=float(hw),
        fy=float(fwd[1]), uyhh=float(hh * up_v[1]),
        fv=float(fwd @ e_v3), uvhh=float(hh * (up_v @ e_v3)),
        cam_y=float(cam_y), e_u=tuple(map(float, e_u3)),
        e_v=tuple(map(float, e_v3)), cam_iu=float(cam_iu),
        cam_iv=float(cam_iv), spacing=float(rg_spacing))


def azimuth_tangents(ps: PolarStatic, ja=0.0, device="cpu"):
    """tan(beta) of each azimuth column center (+ sub-texel jitter ja)."""
    a = torch.arange(ps.a_count, dtype=_F32, device=device)
    return f32(ps.t_lo) + (a + 0.5 + ja) * f32(ps.t_step)


def radial_base(ps: PolarStatic) -> float:
    """float32(k0 + 1 - cam_iv): radial sample k sits k + base + xi rows
    past the camera."""
    return f32(ps.k0 + 1.0 - ps.cam_iv)


def source_rows(ps: PolarStatic, n_v: int) -> Tuple[int, int]:
    """First rows of the two K-row slices the radial lerp reads; clamped
    into the grid as lax.dynamic_slice clamps its start."""
    top = n_v - ps.k_count
    return min(ps.k0 + 1, top), min(ps.k0 + 2, top)


def polar_directions(ps: PolarStatic, ja=0.0, je=0.0, device="cpu"):
    """World-frame unit direction of each (elevation, azimuth) polar texel
    center: (dx, dy, dz) of shape (E, A), plus t (A,) and Q (E,)."""
    t = azimuth_tangents(ps, ja, device)
    qr = ps.q_rows(je, device)
    inv_sec = rsqrt(1.0 + t * t)
    q = qr[:, None] * inv_sec[None, :]
    hx = (f32(ps.e_v[0]) + t * f32(ps.e_u[0])) * inv_sec
    hz = (f32(ps.e_v[2]) + t * f32(ps.e_u[2])) * inv_sec
    inv = rsqrt(1.0 + q * q)
    return hx[None, :] * inv, q * inv, hz[None, :] * inv, t, qr


def extract_profiles(rotbuf: torch.Tensor, ps: PolarStatic, *, xi=0.0, ja=0.0,
                     chunk: int = 128) -> torch.Tensor:
    """Per-azimuth profiles (K, A, C) from the rotated channel buffer
    (n_v, n_u, C), channel 0 being world height: a row lerp by the radial
    phase xi, then a hat-weight contraction over the grid columns. Samples
    outside the grid get height -1e30."""
    n_v, n_u, C = rotbuf.shape
    K, A = ps.k_count, ps.a_count
    dev = rotbuf.device
    t = azimuth_tangents(ps, ja, dev)
    r1, r2 = source_rows(ps, n_v)
    src = (1.0 - xi) * rotbuf[r1:r1 + K] + xi * rotbuf[r2:r2 + K]
    iota_j = torch.arange(n_u, dtype=_F32, device=dev)
    base = radial_base(ps)
    out = []
    for k0 in range(0, K, chunk):
        k1 = min(k0 + chunk, K)
        koff = torch.arange(k0, k1, dtype=_F32, device=dev) + base + xi
        p = f32(ps.cam_iu) + koff[:, None] * t[None, :]                    # (kc, A)
        w = torch.clamp(1.0 - torch.abs(p[:, None, :] - iota_j[None, :, None]), min=0.0)
        prof = torch.einsum("kjc,kja->kac", src[k0:k1], w)
        oob = (p < 0.0) | (p > n_u - 1)
        h = torch.where(oob, NEG32, prof[..., 0])
        out.append(torch.cat([h[..., None], prof[..., 1:]], dim=-1))
    return torch.cat(out)


def profile_hit_tangents(h_prof: torch.Tensor, ps: PolarStatic, xi=0.0, ja=0.0):
    """Reduced elevation tangent (clipped to +-1e4; -1e4 at and behind the
    camera) and ray distance of each profile sample: (q_red, t_dist)."""
    K, A = h_prof.shape
    dev = h_prof.device
    t = azimuth_tangents(ps, ja, dev)
    sec2 = (1.0 + t * t)[None, :]
    koff = torch.arange(K, dtype=_F32, device=dev) + radial_base(ps) + xi
    s_f = (koff * f32(ps.spacing))[:, None]
    rise = h_prof - f32(ps.cam_y)
    q_red = fdiv(rise, torch.clamp(s_f, min=f32(1e-6)))
    q_red = torch.clamp(q_red, -1e4, 1e4)
    q_red = torch.where(koff[:, None] > 0.25, q_red, -1e4)
    t_dist = torch.clamp(s_f, min=f32(1e-6)) * sqrt32(sec2 + q_red * q_red)
    return q_red, t_dist


def synthesize_polar(values: torch.Tensor, q_prof: torch.Tensor, miss_values: torch.Tensor,
                     ps: PolarStatic, je=0.0, a_chunk: int = 128) -> torch.Tensor:
    """First-hit contraction (E, A, C): the values at the first profile
    sample whose running-max tangent crosses Q(e), lerped across the
    crossing through the soft cumulative indicator
    alpha[k] = clip((M[k+1] - Q) / max(M[k+1] - M[k], 1e-9), 0, 1); rays
    with no crossing blend to miss_values by 1 - alpha[K-1]."""
    K, A, C = values.shape
    dev = values.device
    M = torch.cummax(q_prof, dim=0).values
    q_e = ps.q_rows(je, dev)
    m_next = torch.cat([M[1:], M[-1:]], dim=0)
    m_rden = fdiv(1.0, torch.clamp(m_next - M, min=f32(1e-9)))
    out = []
    for a0 in range(0, A, a_chunk):
        a1 = min(a0 + a_chunk, A)
        alpha = torch.clamp((m_next[None, :, a0:a1] - q_e[:, None, None])
                            * m_rden[None, :, a0:a1], 0.0, 1.0)        # (E, K, ac)
        cross = alpha - torch.cat([torch.zeros_like(alpha[:, :1]), alpha[:, :-1]], dim=1)
        o = torch.einsum("eka,kac->eac", cross, values[:, a0:a1])
        hit_any = alpha[:, -1, :]
        out.append(o + (1.0 - hit_any[..., None]) * miss_values[:, a0:a1])
    return torch.cat(out, dim=1)


def warp_to_screen(polar: torch.Tensor, ps: PolarStatic, *, width: int, height: int,
                   supersample: int = 2, row_chunk: int = 8) -> torch.Tensor:
    """Resolve the screen-aligned polar image (E, A, C) to the screen
    (height, width, C): per polar row a hat-weight resample in azimuth at
    `supersample` box-filtered sub-positions, then the box average of
    row_ss rows per pixel row."""
    E, A, C = polar.shape
    if height * ps.row_ss != E - ps.e_pad:
        raise ValueError(f"polar rows {E}-{ps.e_pad} do not match height {height} * "
                         f"row_ss {ps.row_ss}")
    dev = polar.device
    ss = max(int(supersample), 1)
    cv_rows, ndc_x = warp_tables(ps, width, ss, dev)
    iota_a = torch.arange(A, dtype=_F32, device=dev)
    rows = E - ps.e_pad
    out = []
    for r0 in range(0, rows, row_chunk):
        r1 = min(r0 + row_chunk, rows)
        tanb = ndc_x[None, :, :] * fdiv(f32(ps.hw), cv_rows[r0:r1])[:, None, None]
        a_f = fdiv(tanb - f32(ps.t_lo), f32(ps.t_step)) - 0.5
        a_f = torch.clamp(a_f, 0.0, A - 1.0)                                # (R, W, ss)
        w = torch.clamp(1.0 - torch.abs(a_f[:, None] - iota_a[None, :, None, None]), min=0.0)
        w = w.sum(dim=-1) * f32(1.0 / ss)                                  # (R, A, W)
        out.append(torch.einsum("raw,rac->rwc", w, polar[r0:r1]))
    out = torch.cat(out)
    return out.reshape(height, ps.row_ss, width, C).mean(dim=1)


def warp_tables(ps: PolarStatic, width: int, ss: int, device="cpu"):
    """The warp's float32 tables, computed in double and rounded once as the
    JAX version does: cv of each polar row (E,) and the sub-pixel ndc-x
    positions (width, ss)."""
    ndc_rows = 1.0 - (np.arange(ps.e_count, dtype=np.float64) + 0.5) * ps.y_step
    cv = np.maximum(ps.fv + ndc_rows * ps.uvhh, 0.02).astype(np.float32)
    sub = (np.arange(ss, dtype=np.float64) + 0.5) / ss
    ndc_x = (((np.arange(width, dtype=np.float64)[:, None] + sub[None, :]) / width) * 2.0
             - 1.0).astype(np.float32)
    return torch.as_tensor(cv, device=device), torch.as_tensor(ndc_x, device=device)
