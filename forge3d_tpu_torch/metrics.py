# forge3d_tpu_torch/metrics.py
# Mean SSIM over a box window (Wang et al. 2004), as forge3d_tpu/utils/
# metrics.py computes it: luma of RGB inputs, u8 read as [0, 1], an edge-
# clamped box filter through cumulative sums, all in float64 numpy.
# Re-declared here so that nothing of the port, chip_smoke.py included,
# imports the JAX package's modules beyond its jax-free host helpers.

from __future__ import annotations

import numpy as np

__all__ = ["ssim"]


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
