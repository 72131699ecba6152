# forge3d_tpu_torch/ops/tonemap.py
# Tonemap operators and the sRGB transfer (forge3d_tpu/ops/tonemap.py):
# Reinhard, extended Reinhard, Hejl-Burgess-Dawson filmic, the Narkowicz
# ACES fit, the sRGB encode/decode, `apply` by name, the float16 round
# trip of the reference's RGBA16F target and the u8 quantizer. Float32,
# with the JAX functions' operation order; `exposure` and `white_point`
# may be Python numbers or float32 tensors. Divisions by a number go
# through `fdiv`, which rounds once on every device.

from __future__ import annotations

import torch

from .shading import fdiv


def reinhard(color: torch.Tensor, exposure=1.0) -> torch.Tensor:
    """exposed / (1 + exposed), per channel."""
    exposed = color * exposure
    return exposed / (1.0 + exposed)


def reinhard_extended(color: torch.Tensor, exposure=1.0, white_point=4.0) -> torch.Tensor:
    c = color * exposure
    w2 = white_point * white_point
    return c * (1.0 + fdiv(c, w2)) / (1.0 + c)


def filmic_hejl(color: torch.Tensor, exposure=1.0) -> torch.Tensor:
    """Hejl-Burgess-Dawson filmic approximation (includes its own sRGB)."""
    c = torch.clamp(color * exposure - 0.004, min=0.0)
    return (c * (6.2 * c + 0.5)) / (c * (6.2 * c + 1.7) + 0.06)


def aces(color: torch.Tensor, exposure=1.0) -> torch.Tensor:
    """Narkowicz ACES fit."""
    c = color * exposure
    a, b, cc, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((c * (a * c + b)) / (c * (cc * c + d) + e), 0.0, 1.0)


def srgb_eotf_inv(linear: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB encode."""
    linear = torch.clamp(linear, 0.0, 1.0)
    lo = linear * 12.92
    hi = 1.055 * torch.pow(torch.clamp(linear, min=1e-7), 1.0 / 2.4) - 0.055
    return torch.where(linear <= 0.0031308, lo, hi)


def srgb_eotf(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear decode."""
    srgb = torch.clamp(srgb, 0.0, 1.0)
    lo = fdiv(srgb, 12.92)
    hi = torch.pow(fdiv(srgb + 0.055, 1.055), 2.4)
    return torch.where(srgb <= 0.04045, lo, hi)


_OPERATORS = {
    "reinhard": reinhard,
    "reinhard_extended": reinhard_extended,
    "filmic": filmic_hejl,
    "aces": aces,
}


def apply(name: str, color: torch.Tensor, exposure=1.0, **kw) -> torch.Tensor:
    try:
        fn = _OPERATORS[name]
    except KeyError:
        raise ValueError(f"unknown tonemap operator {name!r}; have {sorted(_OPERATORS)}")
    return fn(color, exposure=exposure, **kw)


def f16_round(x: torch.Tensor) -> torch.Tensor:
    """Round trip through float16 (round to nearest even)."""
    return x.to(torch.float16).to(torch.float32)


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """clamp(0, 1) * 255 + 0.5; the caller truncates to uint8."""
    return torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5
