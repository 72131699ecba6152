# forge3d_tpu_torch/codec/f3dz_pylane.py
# The second F3DZ decode lane, a copy of forge3d_tpu/codec/f3dz_pylane.py:
# an independent pure-Python decoder of the same wire format, which the
# tests hold byte for byte against the C++ decoder and the device lane, and
# which decodes pages whose sides are not multiples of the 256-pixel tile
# for the device lane. Slow by design: clarity over speed.

from __future__ import annotations

import struct
import zlib

import numpy as np

from .f3dz import F3dzError

__all__ = ["decompress_dem_pylane"]

_MAGIC = 0x5A443346
_VERSION = 1
_PROB_BITS = 12
_PROB_SCALE = 1 << _PROB_BITS
_ESCAPE = 255


def _rans_decode(stream: bytes, freq: np.ndarray, n_syms: int) -> np.ndarray:
    """Order-0 rANS decode (8-bit symbols, table normalized to 2^12)."""
    if len(stream) < 4:
        raise F3dzError("rANS stream truncated")
    cum = np.zeros(257, np.uint32)
    np.cumsum(freq, out=cum[1:])
    slot2sym = np.repeat(np.arange(256, dtype=np.uint8), freq)
    if slot2sym.size != _PROB_SCALE:
        raise F3dzError("corrupt frequency table")
    state = int.from_bytes(stream[:4], "big")
    pos = 4
    out = np.empty(n_syms, np.uint8)
    mask = _PROB_SCALE - 1
    fr = freq.tolist()
    cm = cum.tolist()
    data = stream
    n = len(data)
    lo = 1 << 23
    for i in range(n_syms):
        slot = state & mask
        s = int(slot2sym[slot])
        out[i] = s
        state = fr[s] * (state >> _PROB_BITS) + slot - cm[s]
        while state < lo:
            if pos >= n:
                raise F3dzError("rANS stream exhausted")
            state = (state << 8) | data[pos]
            pos += 1
    return out


def _med_reconstruct(z: np.ndarray, tw: int, th: int) -> np.ndarray:
    """Invert MED (LOCO-I) prediction over zig-zag residuals."""
    d = (z >> np.uint32(1)).astype(np.int64) ^ -(z & np.uint32(1)).astype(np.int64)
    q = np.zeros((th, tw), np.int64)
    for y in range(th):
        for x in range(tw):
            if x == 0 and y == 0:
                pred = 0
            elif y == 0:
                pred = q[0, x - 1]
            elif x == 0:
                pred = q[y - 1, 0]
            else:
                a = q[y, x - 1]
                b = q[y - 1, x]
                c = q[y - 1, x - 1]
                mx, mn = (a, b) if a > b else (b, a)
                pred = mn if c >= mx else (mx if c <= mn else a + b - c)
            q[y, x] = pred + d[y * tw + x]
    return q


def decompress_dem_pylane(blob: bytes) -> np.ndarray:
    """Decode an F3DZ stream with the independent Python lane.

    Fail-closed on any structural or CRC inconsistency, like the native
    decoder."""
    b = memoryview(bytes(blob))
    if len(b) < 40:
        raise F3dzError("stream too short")
    magic, version, width, height = struct.unpack_from("<4I", b, 0)
    if magic != _MAGIC or version != _VERSION:
        raise F3dzError("bad magic/version")
    (_max_error,) = struct.unpack_from("<f", b, 16)
    (step,) = struct.unpack_from("<d", b, 20)
    tile, ntx, nty = struct.unpack_from("<3I", b, 28)
    if tile == 0 or ntx != -(-width // tile) or nty != -(-height // tile):
        raise F3dzError("bad tiling")
    pos = 40
    out = np.zeros((height, width), np.float32)
    for ty in range(nty):
        for tx in range(ntx):
            rec_size, crc_expect = struct.unpack_from("<2I", b, pos)
            pos += 8
            rec = bytes(b[pos: pos + rec_size])
            if len(rec) != rec_size:
                raise F3dzError("truncated tile record")
            if (zlib.crc32(rec) & 0xFFFFFFFF) != crc_expect:
                raise F3dzError("tile CRC mismatch (fail-closed)")
            n_tokens, stream_size, extra_size, nz = struct.unpack_from(
                "<3IH", rec, 0)
            freq = np.zeros(256, np.uint32)
            off = 14
            for _ in range(nz):
                s = rec[off]
                (f,) = struct.unpack_from("<H", rec, off + 1)
                freq[s] = f
                off += 3
            if int(freq.sum()) != _PROB_SCALE:
                raise F3dzError("frequency table does not normalize")
            stream = rec[off: off + stream_size]
            extras = rec[off + stream_size: off + stream_size + extra_size]
            tokens = _rans_decode(stream, freq, n_tokens)

            x0, y0 = tx * tile, ty * tile
            tw = min(tile, width - x0)
            th = min(tile, height - y0)
            if tw * th != n_tokens:
                raise F3dzError("token count mismatch")
            z = tokens.astype(np.uint32)
            esc = z == _ESCAPE
            n_esc = int(esc.sum())
            if n_esc * 4 != len(extras):
                raise F3dzError("escape payload size mismatch")
            if n_esc:
                z[esc] = np.frombuffer(extras, "<u4", count=n_esc)
            q = _med_reconstruct(z, tw, th)
            out[y0: y0 + th, x0: x0 + tw] = (q.astype(np.float64)
                                             * step).astype(np.float32)
            pos += rec_size
    return out
