# forge3d_tpu_torch/metrics.py
# Mean SSIM over a box window (Wang et al. 2004), as forge3d_tpu/utils/
# metrics.py computes it: luma of RGB inputs, u8 read as [0, 1], an edge-
# clamped box filter through cumulative sums, all in float64 numpy.
# Re-declared here so that nothing of the port, chip_smoke.py included,
# imports the JAX package's modules. The golden-gate bundle below
# (mean_abs_error, CIEDE2000 over sRGB -> Lab, image_metrics) is copied
# from the same module.

from __future__ import annotations

import numpy as np

__all__ = ["ssim", "mean_abs_error", "delta_e2000", "image_metrics"]


def _to_gray(img) -> np.ndarray:
    a = np.asarray(img)
    a = a.astype(np.float64) / 255.0 if a.dtype == np.uint8 else a.astype(np.float64)
    if a.ndim == 3:
        a = 0.2126 * a[..., 0] + 0.7152 * a[..., 1] + 0.0722 * a[..., 2]
    return a


def _box_filter(a: np.ndarray, r: int) -> np.ndarray:
    """Mean over a (2r+1)^2 window, edges clamped."""
    H, W = a.shape
    c = np.pad(np.cumsum(np.cumsum(np.pad(a, r, mode="edge"), 0), 1), ((1, 0), (1, 0)))
    k = 2 * r + 1
    return ((c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k))[:H, :W]


def ssim(a, b, *, window: int = 7, data_range: float = 1.0) -> float:
    """Mean SSIM of two images (H, W) or (H, W, 3), u8 or float."""
    x, y = _to_gray(a), _to_gray(b)
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {x.shape} vs {y.shape}")
    r = window // 2
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mx, my = _box_filter(x, r), _box_filter(y, r)
    vx = np.maximum(_box_filter(x * x, r) - mx * mx, 0)
    vy = np.maximum(_box_filter(y * y, r) - my * my, 0)
    cxy = _box_filter(x * y, r) - mx * my
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / ((mx * mx + my * my + c1) * (vx + vy + c2))
    return float(s.mean())


def mean_abs_error(a: np.ndarray, b: np.ndarray) -> float:
    """Mean |a-b| in normalized [0,1] units (the reference's 2/255 gate)."""
    x = np.asarray(a)
    y = np.asarray(b)
    if x.dtype == np.uint8:
        x = x.astype(np.float64) / 255.0
    if y.dtype == np.uint8:
        y = y.astype(np.float64) / 255.0
    return float(np.abs(x.astype(np.float64) - y.astype(np.float64)).mean())


def _srgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    c = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    M = np.array([[0.4124564, 0.3575761, 0.1804375],
                  [0.2126729, 0.7151522, 0.0721750],
                  [0.0193339, 0.1191920, 0.9503041]])
    xyz = c @ M.T
    white = np.array([0.95047, 1.0, 1.08883])
    t = xyz / white
    f = np.where(t > (6 / 29) ** 3, np.cbrt(t), t / (3 * (6 / 29) ** 2) + 4 / 29)
    L = 116 * f[..., 1] - 16
    a = 500 * (f[..., 0] - f[..., 1])
    b = 200 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], -1)


def delta_e2000(img_a: np.ndarray, img_b: np.ndarray) -> np.ndarray:
    """Per-pixel CIEDE2000 between two RGB images (u8 or [0,1] float)."""
    x = np.asarray(img_a)
    y = np.asarray(img_b)
    if x.dtype == np.uint8:
        x = x.astype(np.float64) / 255.0
    if y.dtype == np.uint8:
        y = y.astype(np.float64) / 255.0
    lab1 = _srgb_to_lab(x[..., :3].astype(np.float64))
    lab2 = _srgb_to_lab(y[..., :3].astype(np.float64))
    L1, a1, b1 = lab1[..., 0], lab1[..., 1], lab1[..., 2]
    L2, a2, b2 = lab2[..., 0], lab2[..., 1], lab2[..., 2]
    C1 = np.hypot(a1, b1)
    C2 = np.hypot(a2, b2)
    Cb = (C1 + C2) / 2
    G = 0.5 * (1 - np.sqrt(Cb ** 7 / (Cb ** 7 + 25.0 ** 7)))
    ap1 = (1 + G) * a1
    ap2 = (1 + G) * a2
    Cp1 = np.hypot(ap1, b1)
    Cp2 = np.hypot(ap2, b2)
    hp1 = np.degrees(np.arctan2(b1, ap1)) % 360
    hp2 = np.degrees(np.arctan2(b2, ap2)) % 360
    dLp = L2 - L1
    dCp = Cp2 - Cp1
    dhp = hp2 - hp1
    dhp = np.where(dhp > 180, dhp - 360, np.where(dhp < -180, dhp + 360, dhp))
    dhp = np.where((Cp1 * Cp2) == 0, 0.0, dhp)
    dHp = 2 * np.sqrt(Cp1 * Cp2) * np.sin(np.radians(dhp) / 2)
    Lbp = (L1 + L2) / 2
    Cbp = (Cp1 + Cp2) / 2
    hsum = hp1 + hp2
    hbp = np.where(np.abs(hp1 - hp2) > 180,
                   np.where(hsum < 360, (hsum + 360) / 2, (hsum - 360) / 2),
                   hsum / 2)
    hbp = np.where((Cp1 * Cp2) == 0, hsum, hbp)
    T = (1 - 0.17 * np.cos(np.radians(hbp - 30))
         + 0.24 * np.cos(np.radians(2 * hbp))
         + 0.32 * np.cos(np.radians(3 * hbp + 6))
         - 0.20 * np.cos(np.radians(4 * hbp - 63)))
    d_theta = 30 * np.exp(-(((hbp - 275) / 25) ** 2))
    Rc = 2 * np.sqrt(Cbp ** 7 / (Cbp ** 7 + 25.0 ** 7))
    Sl = 1 + 0.015 * (Lbp - 50) ** 2 / np.sqrt(20 + (Lbp - 50) ** 2)
    Sc = 1 + 0.045 * Cbp
    Sh = 1 + 0.015 * Cbp * T
    Rt = -np.sin(np.radians(2 * d_theta)) * Rc
    return np.sqrt((dLp / Sl) ** 2 + (dCp / Sc) ** 2 + (dHp / Sh) ** 2
                   + Rt * (dCp / Sc) * (dHp / Sh))


def image_metrics(a: np.ndarray, b: np.ndarray) -> dict:
    """The golden-gate bundle: SSIM + mean abs + dE2000 stats."""
    de = delta_e2000(a, b) if (np.asarray(a).ndim == 3) else None
    return {
        "ssim": ssim(a, b),
        "mean_abs": mean_abs_error(a, b),
        "delta_e_mean": float(de.mean()) if de is not None else None,
        "delta_e_max": float(de.max()) if de is not None else None,
    }
