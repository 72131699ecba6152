# forge3d_tpu_torch/frame.py
# The render result types of forge3d_tpu/frame.py: Frame (RGBA8 +
# metadata), AovFrame (named AOV planes) and HdrFrame (float HDR radiance),
# all host numpy arrays. HdrFrame.tonemapped goes through the port's
# tonemap operators on `device` ("cuda" by default).

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class Frame:
    """RGBA8 render result."""

    rgba: np.ndarray                 # (H, W, 4) uint8
    metadata: Dict = field(default_factory=dict)

    @property
    def width(self) -> int:
        return int(self.rgba.shape[1])

    @property
    def height(self) -> int:
        return int(self.rgba.shape[0])

    def to_numpy(self) -> np.ndarray:
        return self.rgba

    def save_png(self, path) -> None:
        from .io.image import numpy_to_png

        numpy_to_png(path, self.rgba)


@dataclass
class AovFrame:
    """Named AOV planes from one render (float32 host arrays)."""

    aovs: Dict[str, np.ndarray]
    metadata: Dict = field(default_factory=dict)

    def get(self, name: str) -> Optional[np.ndarray]:
        return self.aovs.get(name)

    def names(self):
        return sorted(self.aovs)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.aovs[name]

    def __contains__(self, name: str) -> bool:
        return name in self.aovs


def ldr_to_rgba(ldr: np.ndarray) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1] -> (H, W, 4) u8: clip * 255 + 0.5,
    truncated, alpha 255."""
    return np.concatenate(
        [(np.clip(ldr, 0, 1) * 255 + 0.5).astype(np.uint8),
         np.full((*ldr.shape[:2], 1), 255, np.uint8)],
        axis=-1,
    )


@dataclass
class HdrFrame:
    """Linear HDR radiance result (pre-tonemap)."""

    rgb: np.ndarray                  # (H, W, 3) float32
    metadata: Dict = field(default_factory=dict)

    @property
    def width(self) -> int:
        return int(self.rgb.shape[1])

    @property
    def height(self) -> int:
        return int(self.rgb.shape[0])

    def tonemapped(self, mode: str = "reinhard", exposure: float = 1.0, *,
                   device="cuda") -> Frame:
        """Tonemap on `device` ("cuda" raises DeviceError without CUDA;
        "cpu" runs on the host)."""
        import torch

        from .ops import tonemap as tm
        from .pt.terrain_ref import resolve_device

        rgb = torch.as_tensor(np.asarray(self.rgb, np.float32), device=resolve_device(device))
        ldr = tm.apply(mode, rgb, exposure=exposure).cpu().numpy()
        return Frame(rgba=ldr_to_rgba(ldr), metadata={**self.metadata, "tonemap": mode})
