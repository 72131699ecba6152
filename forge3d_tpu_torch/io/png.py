# forge3d_tpu_torch/io/png.py
# Deterministic PNG encode/decode, a copy of forge3d_tpu/io/png.py. Pure
# Python + zlib: byte-identical output for identical pixels on every
# platform, which the determinism golden hashes rely on.
#
# Supports 8-bit and 16-bit RGB/RGBA/Gray, no ancillary chunks (no tIME, no
# text), fixed zlib level 6: the encoded byte stream is a pure function of
# the pixel data.

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type (gray/RGB/RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(img: np.ndarray) -> bytes:
    """Encode (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8/uint16 pixels."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"unsupported image shape {img.shape}")
    if img.dtype == np.uint8:
        depth = 8
    elif img.dtype == np.uint16:
        depth = 16
    else:
        raise ValueError(f"unsupported dtype {img.dtype}; use uint8 or uint16")
    h, w, ch = img.shape
    if h == 0 or w == 0:
        raise ValueError("empty image")

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)

    if depth == 16:
        raw = img.astype(">u2").tobytes()
        stride = w * ch * 2
    else:
        raw = np.ascontiguousarray(img).tobytes()
        stride = w * ch
    # Filter type 0 (None) per scanline: simplest and fully deterministic.
    lines = bytearray()
    for y in range(h):
        lines.append(0)
        lines += raw[y * stride:(y + 1) * stride]
    comp = zlib.compress(bytes(lines), 6)

    return b"".join([
        _MAGIC,
        _chunk(b"IHDR", ihdr),
        _chunk(b"IDAT", comp),
        _chunk(b"IEND", b""),
    ])


def write_png(path, img: np.ndarray) -> None:
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def _unfilter(raw: bytes, h: int, w: int, ch: int, bpp_bytes: int) -> np.ndarray:
    stride = w * ch * bpp_bytes
    fbpp = ch * bpp_bytes
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[pos]
        pos += 1
        line = np.frombuffer(raw[pos:pos + stride], np.uint8).astype(np.int32)
        pos += stride
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub
            cur = line.copy()
            for i in range(fbpp, stride):
                cur[i] = (cur[i] + cur[i - fbpp]) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = line.copy()
            for i in range(stride):
                left = cur[i - fbpp] if i >= fbpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = line.copy()
            for i in range(stride):
                a = cur[i - fbpp] if i >= fbpp else 0
                b = prev[i]
                c = prev[i - fbpp] if i >= fbpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """Decode a PNG byte string to (H, W, C) uint8/uint16 (non-interlaced)."""
    if data[:8] != _MAGIC:
        raise ValueError("not a PNG file")
    pos = 8
    ihdr = None
    idat = bytearray()
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG missing IHDR")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if interlace != 0:
        raise ValueError("interlaced PNG not supported")
    if ctype == 3:
        if depth != 8 or palette is None:
            raise ValueError("unsupported palette PNG")
        ch, bpp = 1, 1
    else:
        if ctype not in _CHANNELS or depth not in (8, 16):
            raise ValueError(f"unsupported PNG color type {ctype} depth {depth}")
        ch = _CHANNELS[ctype]
        bpp = depth // 8
    raw = zlib.decompress(bytes(idat))
    arr = _unfilter(raw, h, w, ch, bpp)
    if depth == 16:
        pairs = arr.reshape(h, w, ch, 2)  # big-endian byte pairs
        img = ((pairs[..., 0].astype(np.uint16) << 8) | pairs[..., 1]).astype(np.uint16)
    else:
        img = arr.reshape(h, w, ch)
    if ctype == 3:
        img = palette[img[..., 0]]
    return img


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
