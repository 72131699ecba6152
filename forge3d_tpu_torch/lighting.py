# forge3d_tpu_torch/lighting.py
# Typed lights (forge3d_tpu/lighting.py): the six light types, the `Light`
# record with its validation, and the struct-of-arrays `LightBuffer` that
# the per-ray estimator's light sampling (ops/lightsample.py, kernel K10)
# reads. Values are rounded to float32 where the JAX package rounds them.

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

__all__ = ["Light", "LightBuffer", "LIGHT_TYPES"]

LIGHT_TYPES = ("directional", "point", "spot", "rect", "disk", "sphere")
_TYPE_ID = {t: i for i, t in enumerate(LIGHT_TYPES)}


@dataclass
class Light:
    """One typed light (reference: PyLight)."""

    type: str = "directional"
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    direction: Tuple[float, float, float] = (0.0, -1.0, 0.0)
    position: Tuple[float, float, float] = (0.0, 10.0, 0.0)
    radius: float = 1.0                 # disk/sphere radius, rect half-size
    extent: Tuple[float, float] = (1.0, 1.0)   # rect half extents
    inner_cone_deg: float = 20.0
    outer_cone_deg: float = 30.0

    def __post_init__(self):
        if self.type not in LIGHT_TYPES:
            raise ValueError(f"unknown light type {self.type!r}; "
                             f"one of {LIGHT_TYPES}")
        if self.intensity < 0:
            raise ValueError("intensity must be >= 0")
        if self.type == "spot" and not (
                0 < self.inner_cone_deg <= self.outer_cone_deg <= 90):
            raise ValueError("require 0 < inner <= outer <= 90 degrees")


@dataclass(frozen=True)
class LightBuffer:
    """Struct-of-arrays light set on one device; each field has L rows."""

    type_id: torch.Tensor    # (L,) i32
    color: torch.Tensor      # (L, 3) premultiplied by intensity
    direction: torch.Tensor  # (L, 3) normalized
    position: torch.Tensor   # (L, 3)
    radius: torch.Tensor     # (L,)
    extent: torch.Tensor     # (L, 2)
    cones: torch.Tensor      # (L, 2) cos(inner), cos(outer)

    @staticmethod
    def from_lights(lights: List[Light], device="cuda") -> "LightBuffer":
        """The lights' rows on `device`, the card unless device="cpu"."""
        from .pt.terrain_ref import resolve_device

        if not lights:
            raise ValueError("empty light list")
        device = resolve_device(device)
        d = np.asarray([l.direction for l in lights], np.float32)
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)

        def f32(rows):
            return torch.as_tensor(np.asarray(rows, np.float64).astype(np.float32),
                                   device=device)

        return LightBuffer(
            type_id=torch.as_tensor(np.asarray([_TYPE_ID[l.type] for l in lights], np.int32),
                                    device=device),
            color=f32([np.asarray(l.color) * l.intensity for l in lights]),
            direction=torch.as_tensor(d, device=device),
            position=f32([l.position for l in lights]),
            radius=f32([l.radius for l in lights]),
            extent=f32([l.extent for l in lights]),
            cones=f32([(math.cos(math.radians(l.inner_cone_deg)),
                        math.cos(math.radians(l.outer_cone_deg))) for l in lights]),
        )

    @property
    def count(self) -> int:
        return int(self.type_id.shape[0])

    def to(self, device) -> "LightBuffer":
        return LightBuffer(*(getattr(self, f).to(device) for f in self.__dataclass_fields__))
