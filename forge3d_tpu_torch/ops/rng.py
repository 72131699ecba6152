# forge3d_tpu_torch/ops/rng.py
# Per-pixel u32 xorshift32 stream of the terrain path tracer, bit for bit
# the stream of forge3d_tpu/ops/rng.py.
#
# PyTorch on the CPU has no `<<` for uint32, so the plain versions hold each
# u32 word in an int64 tensor and mask to 32 bits after every shift and
# multiply. The CUDA kernels carry the same arithmetic in `uint32_t`
# (csrc/common.cuh: xorshift32, tent_offset).

from __future__ import annotations

import torch

from .shading import sqrt32

MASK32 = 0xFFFFFFFF


def seed_state(seed_hi: int, seed_lo: int, x: torch.Tensor, y: torch.Tensor,
               frame_index: int) -> torch.Tensor:
    """Initial per-pixel state (int64 holding a u32):
    seed_hi ^ x*1664525 ^ y*1013904223 ^ frame*92837111 ^ seed_lo."""
    x = x.to(torch.int64)
    y = y.to(torch.int64)
    frame_word = (int(frame_index) * 92837111) & MASK32
    return (
        ((x * 1664525) & MASK32)
        ^ ((y * 1013904223) & MASK32)
        ^ ((int(seed_hi) & MASK32) ^ frame_word ^ (int(seed_lo) & MASK32))
    )


def xorshift32(state: torch.Tensor):
    """One xorshift32 step on int64-held u32 words. Returns (state, u) with
    u = float32(state) / 2**32, which rounds to 1.0 for state >= 0xFFFFFF80
    exactly as the reference does."""
    x = state
    x = x ^ ((x << 13) & MASK32)
    x = x ^ (x >> 17)
    x = x ^ ((x << 5) & MASK32)
    u = x.to(torch.float32) / 4294967296.0  # power of two: exact scaling
    return x, u


def tent_offset(u: torch.Tensor) -> torch.Tensor:
    """Zero-mean tent sample in [-1, 1] by inverse CDF."""
    lo = sqrt32(2.0 * u) - 1.0
    hi = 1.0 - sqrt32(torch.clamp(2.0 * (1.0 - u), min=0.0))
    return torch.where(u < 0.5, lo, hi)


def derive_seed_lo(seed: int) -> int:
    """seed_lo companion word of the per-pixel seed."""
    return (int(seed) ^ 0x85EBCA6B) & MASK32
