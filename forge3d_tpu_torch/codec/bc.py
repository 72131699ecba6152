# forge3d_tpu_torch/codec/bc.py
# BC7 mode-6 / BC5 texture codec surface (ctypes over native/bc.cpp), a
# copy of forge3d_tpu/codec/bc.py: deterministic, the same pixels give the
# same blocks. Fidelity gates (BASELINE.md): BC7 SSIM >= 0.98; BC5 normal
# reconstruction angular error < 1 deg mean / < 4 deg max.

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from ._build import build_native

__all__ = ["encode_bc7_rgba8", "decode_bc7", "encode_bc5_rg8", "decode_bc5"]

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path = build_native("bc", Path(__file__).parent / "native" / "bc.cpp")
        lib = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        for fn in ("bc7_encode", "bc7_decode", "bc5_encode", "bc5_decode"):
            f = getattr(lib, fn)
            f.restype = None
            f.argtypes = [u8p, ctypes.c_uint32, ctypes.c_uint32, u8p]
        _lib = lib
    return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def encode_bc7_rgba8(rgba: np.ndarray) -> bytes:
    """RGBA8 (H, W, 4) -> BC7 mode-6 blocks (16 bytes per 4x4)."""
    img = np.ascontiguousarray(rgba, np.uint8)
    if img.ndim != 3 or img.shape[2] != 4:
        raise ValueError("expected (H, W, 4) uint8")
    H, W = img.shape[:2]
    bw, bh = (W + 3) // 4, (H + 3) // 4
    out = np.empty(bw * bh * 16, np.uint8)
    _load().bc7_encode(_u8p(img), W, H, _u8p(out))
    return out.tobytes()


def decode_bc7(blocks: bytes, width: int, height: int) -> np.ndarray:
    bw, bh = (width + 3) // 4, (height + 3) // 4
    if len(blocks) != bw * bh * 16:
        raise ValueError("block data size mismatch")
    src = np.frombuffer(blocks, np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    _load().bc7_decode(_u8p(src), width, height, _u8p(out))
    return out


def encode_bc5_rg8(rg: np.ndarray) -> bytes:
    """RG8 (H, W, 2) -> BC5 blocks (16 bytes per 4x4). For tangent-space
    normals store XY; reconstruct Z = sqrt(1 - x² - y²)."""
    img = np.ascontiguousarray(rg, np.uint8)
    if img.ndim != 3 or img.shape[2] != 2:
        raise ValueError("expected (H, W, 2) uint8")
    H, W = img.shape[:2]
    bw, bh = (W + 3) // 4, (H + 3) // 4
    out = np.empty(bw * bh * 16, np.uint8)
    _load().bc5_encode(_u8p(img), W, H, _u8p(out))
    return out.tobytes()


def decode_bc5(blocks: bytes, width: int, height: int) -> np.ndarray:
    bw, bh = (width + 3) // 4, (height + 3) // 4
    if len(blocks) != bw * bh * 16:
        raise ValueError("block data size mismatch")
    src = np.frombuffer(blocks, np.uint8)
    out = np.empty((height, width, 2), np.uint8)
    _load().bc5_decode(_u8p(src), width, height, _u8p(out))
    return out
