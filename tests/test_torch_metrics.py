# The port's SSIM (forge3d_tpu_torch/metrics.py) against the JAX package's
# numpy SSIM (forge3d_tpu/utils/metrics.py) on images made from a numpy
# seed. Both are float64 numpy with the same operation order: |d| <= 1e-12.
import numpy as np
import pytest

from forge3d_tpu.utils.metrics import ssim as ref_ssim
from forge3d_tpu_torch.metrics import ssim


def images(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "u8_rgb":
        a = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
        b = np.clip(a.astype(int) + rng.integers(-12, 13, a.shape), 0, 255).astype(np.uint8)
    elif kind == "float_rgb":
        a = rng.uniform(0, 1, (33, 47, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    elif kind == "gray":
        a = rng.uniform(0, 1, (24, 31))
        b = a * 0.9 + 0.05
    else:  # identical
        a = rng.uniform(0, 1, (16, 20, 3)).astype(np.float32)
        b = a.copy()
    return a, b


@pytest.mark.parametrize("kind", ["u8_rgb", "float_rgb", "gray", "identical"])
@pytest.mark.parametrize("window", [7, 5])
def test_ssim_matches_jax_package(kind, window):
    a, b = images(kind, 3)
    want = ref_ssim(a, b, window=window)
    assert abs(ssim(a, b, window=window) - want) <= 1e-12
    if kind == "identical":
        assert abs(want - 1.0) <= 1e-12


def test_ssim_shape_mismatch():
    with pytest.raises(ValueError, match="shape mismatch"):
        ssim(np.zeros((4, 4)), np.zeros((4, 5)))
