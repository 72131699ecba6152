# forge3d_tpu_torch/camera.py
# The look-at basis of forge3d_tpu/camera.py, copied (numpy, float32):
#   forward = normalize(look_at - origin), right = forward x up,
#   up = right x forward.

from __future__ import annotations

from typing import Tuple

import numpy as np


def _normalize(v: np.ndarray) -> np.ndarray:
    n = float(np.linalg.norm(v))
    if n == 0.0:
        raise ValueError("cannot normalize zero vector")
    return v / n


def camera_basis(origin, look_at, up) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (right, up, forward) unit vectors, reference convention."""
    origin = np.asarray(origin, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up_in = np.asarray(up, np.float32)
    fwd = _normalize(look_at - origin)
    right = _normalize(np.cross(fwd, up_in))
    up_v = _normalize(np.cross(right, fwd))
    return right.astype(np.float32), up_v.astype(np.float32), fwd.astype(np.float32)
