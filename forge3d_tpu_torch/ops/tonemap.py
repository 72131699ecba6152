# forge3d_tpu_torch/ops/tonemap.py
# The resolve of the terrain path tracer: Reinhard, the float16 round trip
# of the reference's RGBA16F target, and the u8 quantizer
# (forge3d_tpu/ops/tonemap.py).

from __future__ import annotations

import torch


def reinhard(color: torch.Tensor, exposure: float = 1.0) -> torch.Tensor:
    """exposed / (1 + exposed), per channel."""
    exposed = color * exposure
    return exposed / (1.0 + exposed)


def f16_round(x: torch.Tensor) -> torch.Tensor:
    """Round trip through float16 (round to nearest even)."""
    return x.to(torch.float16).to(torch.float32)


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """clamp(0, 1) * 255 + 0.5; the caller truncates to uint8."""
    return torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5
