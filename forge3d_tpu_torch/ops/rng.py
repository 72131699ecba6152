# forge3d_tpu_torch/ops/rng.py
# Random streams, bit for bit those of the JAX package: the per-pixel u32
# xorshift32 stream of the per-ray path tracer (forge3d_tpu/ops/rng.py),
# and jax.random's threefry key stream, which the sweep estimator draws its
# per-frame jitter from (below).
#
# PyTorch on the CPU has no `<<` for uint32, so the plain versions hold each
# u32 word in an int64 tensor and mask to 32 bits after every shift and
# multiply. The CUDA kernels carry the same arithmetic in `uint32_t`
# (csrc/common.cuh: xorshift32, tent_offset).

from __future__ import annotations

import numpy as np
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


# ---------------------------------------------------------------------------
# Threefry-2x32: jax.random's default key stream (jax 0.9 defaults, with
# jax_threefry_partitionable=True), as far as the sweep estimator draws from
# it. Keys are numpy uint32 pairs; everything runs on the host, in numpy,
# which has uint32 shifts.
# ---------------------------------------------------------------------------

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(key, x1, x2):
    """The 20-round Threefry-2x32 hash of the counter pairs (x1, x2) under
    `key`; returns the two output words (arrays shaped like x1)."""
    k1, k2 = _U32(key[0]), _U32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey for a 32-bit seed: the pair [0, seed]."""
    return np.array([0, int(seed) & MASK32], _U32)


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in: the hash of the counter pair [0, data]."""
    a, b = threefry2x32(key, _U32(0), _U32(int(data) & MASK32))
    return np.array([a, b], _U32)


def _counters(shape):
    """iota_2x32_shape: the row-major index of each element as (hi, lo)
    words."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(MASK32)).astype(_U32)


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split: (num, 2) uint32 keys."""
    a, b = threefry2x32(key, *_counters((num,)))
    return np.stack([a, b], axis=1)


def random_bits(key, shape=()) -> np.ndarray:
    """32 random bits per element: bits1 ^ bits2 of the counter hash."""
    a, b = threefry2x32(key, *_counters(shape))
    return np.asarray(a ^ b, _U32).reshape(shape)


def uniform(key, shape=()) -> np.ndarray:
    """jax.random.uniform(key, shape, float32) on [0, 1): the top 23 bits as
    the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    return np.maximum(np.float32(0.0), bits.view(np.float32) - np.float32(1.0))


# ---------------------------------------------------------------------------
# Threefry-2x32 on tensors: the same hash over per-element counters, on the
# CPU or the card. PyTorch has no uint32 arithmetic to speak of, so each u32
# word is held in an int64 tensor and masked to 32 bits after every add and
# shift. Keys stay numpy pairs on the host.
# ---------------------------------------------------------------------------

def _rotl_t(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & MASK32) | (v >> (32 - r))


def threefry2x32_tensor(key, x1: torch.Tensor, x2: torch.Tensor):
    """`threefry2x32` of int64-held u32 counter words (x1, x2) under `key`:
    the two output words, int64-held."""
    k1, k2 = int(key[0]) & MASK32, int(key[1]) & MASK32
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl_t(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK32
    return x[0], x[1]


def random_bits_tensor(key, shape, device="cpu") -> torch.Tensor:
    """`random_bits` on `device`: int64-held u32 bits per element."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry2x32_tensor(key, idx >> 32, idx & MASK32)
    return (a ^ b).reshape(shape)


def uniform_tensor(key, shape, device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) on `device`, bit for bit."""
    bits = (random_bits_tensor(key, shape, device) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)
