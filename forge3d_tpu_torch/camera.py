# forge3d_tpu_torch/camera.py
# The look-at basis and the orbit origin of forge3d_tpu/camera.py, copied
# (numpy): forward = normalize(look_at - origin), right = forward x up,
# up = right x forward, in float32.

from __future__ import annotations

import math
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


def orbit_camera_origin(target, radius: float, phi_deg: float, theta_deg: float):
    """Orbit camera position from spherical angles about a target, in
    float64, rounded once to float32. phi = azimuth (deg, about +Y),
    theta = elevation (deg above horizon)."""
    phi = math.radians(phi_deg)
    theta = math.radians(theta_deg)
    t = np.asarray(target, np.float64)
    offs = np.array(
        [
            radius * math.cos(theta) * math.cos(phi),
            radius * math.sin(theta),
            radius * math.cos(theta) * math.sin(phi),
        ]
    )
    return (t + offs).astype(np.float32)
