# forge3d_tpu_torch/io/image.py
# numpy <-> PNG, copies of forge3d_tpu/io/image.py:numpy_to_png and
# png_to_numpy.

from __future__ import annotations

import numpy as np

from ..errors import UploadError
from . import png as _png


def numpy_to_png(path, array: np.ndarray) -> None:
    """Write an array to PNG deterministically.

    Accepts (H,W) or (H,W,{1,3,4}) uint8/uint16, or float arrays in [0,1]
    which are quantized to uint8 with round-half-up (the reference's u8
    quantizer: clamp*255+0.5 truncated).
    """
    a = np.asarray(array)
    if a.ndim not in (2, 3):
        raise UploadError(f"expected 2D or 3D array, got shape {a.shape}")
    if a.dtype in (np.float32, np.float64):
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    elif a.dtype not in (np.uint8, np.uint16):
        raise UploadError(f"unsupported dtype {a.dtype}")
    _png.write_png(path, a)


def png_to_numpy(path) -> np.ndarray:
    """Read a PNG into (H, W, C) uint8 (or uint16 for 16-bit files)."""
    return _png.read_png(path)
