# forge3d_tpu_torch/codec/f3dz.py
# The F3DZ codec's host surface (ctypes over native/f3dz.cpp), a copy of
# forge3d_tpu/codec/f3dz.py: compress_dem(heights, max_error) -> bytes,
# decompress_dem(bytes) -> float32 heights, verify_dem(bytes, heights) ->
# report, f3dz_info(bytes) -> header; decode fails closed on corruption.

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from ..errors import RenderError
from ._build import build_native

__all__ = ["compress_dem", "decompress_dem", "verify_dem", "f3dz_info",
           "F3dzError"]


class F3dzError(RenderError):
    """F3DZ codec failure (corrupt stream, CRC mismatch, bad inputs)."""


_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path = build_native("f3dz", Path(__file__).parent / "native" / "f3dz.cpp")
        lib = ctypes.CDLL(str(path))
        lib.f3dz_encode.restype = ctypes.c_longlong
        lib.f3dz_encode.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_float, ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong]
        lib.f3dz_decode.restype = ctypes.c_int
        lib.f3dz_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint32, ctypes.c_uint32]
        lib.f3dz_info.restype = ctypes.c_int
        lib.f3dz_info.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_float)]
        lib.f3dz_crc32.restype = ctypes.c_uint32
        lib.f3dz_crc32.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.c_longlong]
        _lib = lib
    return _lib


def compress_dem(heights: np.ndarray, max_error: float = 0.1) -> bytes:
    """Compress a DEM with guaranteed |reconstructed - original| <= max_error.

    Deterministic: identical inputs produce identical bytes. Refuses
    non-finite heights (fail-closed, like the reference encoder).
    """
    lib = _load()
    h = np.ascontiguousarray(heights, np.float32)
    if h.ndim != 2:
        raise F3dzError("heights must be 2D")
    if not np.isfinite(h).all():
        raise F3dzError("heights contain non-finite values; F3DZ refuses")
    if not (max_error > 0):
        raise F3dzError("max_error must be positive")
    H, W = h.shape
    cap = h.nbytes + 4096 + 64 * ((W // 256 + 1) * (H // 256 + 1))
    out = np.empty(cap, np.uint8)
    n = lib.f3dz_encode(
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), W, H,
        ctypes.c_float(max_error),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:  # needed more space (highly incompressible data)
        cap = -n
        out = np.empty(cap, np.uint8)
        n = lib.f3dz_encode(
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), W, H,
            ctypes.c_float(max_error),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n <= 0:
        raise F3dzError("F3DZ encode failed")
    return bytes(out[:n].tobytes())


def f3dz_info(data: bytes) -> dict:
    """Header probe: width/height/max_error without decoding."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    e = ctypes.c_float()
    ok = lib.f3dz_info(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       len(data), ctypes.byref(w), ctypes.byref(h),
                       ctypes.byref(e))
    if not ok:
        raise F3dzError("not an F3DZ stream")
    return {"width": int(w.value), "height": int(h.value),
            "max_error": float(e.value), "compressed_bytes": len(data)}


def decompress_dem(data: bytes) -> np.ndarray:
    """Decode an F3DZ stream -> (H, W) float32. Fail-closed: any CRC or
    structural mismatch raises F3dzError."""
    lib = _load()
    info = f3dz_info(data)
    W, H = info["width"], info["height"]
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((H, W), np.float32)
    ok = lib.f3dz_decode(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         len(data),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         W, H)
    if not ok:
        raise F3dzError("F3DZ decode failed: corrupt or truncated stream "
                        "(fail-closed)")
    return out


def verify_dem(data: bytes, heights: np.ndarray) -> dict:
    """Round-trip verification report (reference seam: verify_dem)."""
    h = np.ascontiguousarray(heights, np.float32)
    dec = decompress_dem(data)
    info = f3dz_info(data)
    if dec.shape != h.shape:
        return {"ok": False, "reason": "shape_mismatch", **info}
    err = np.abs(dec - h)
    max_err = float(err.max()) if err.size else 0.0
    ok = max_err <= info["max_error"] * (1 + 1e-6) + 1e-7
    return {
        "ok": bool(ok),
        "max_abs_error": max_err,
        "mean_abs_error": float(err.mean()) if err.size else 0.0,
        "error_bound": info["max_error"],
        "compression_ratio": float(h.nbytes) / max(len(data), 1),
        **info,
    }
