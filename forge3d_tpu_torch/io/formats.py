# forge3d_tpu_torch/io/formats.py
# The OpenEXR writer of forge3d_tpu/io/formats.py (numpy_to_exr, single-part
# scanline, FLOAT or HALF, uncompressed or ZIP with the OpenEXR pre-filter),
# copied for save_aovs: host code, numpy and zlib. The port reads no EXR.

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from ..errors import RenderError

__all__ = ["numpy_to_exr", "FormatError"]


class FormatError(RenderError):
    pass


# ---------------------------------------------------------------------------
# OpenEXR (single-part scanline, uncompressed)

_EXR_MAGIC = 0x01312F76
_PIX_FLOAT = 2
_PIX_HALF = 1


def _exr_attr(name: str, atype: str, data: bytes) -> bytes:
    return (name.encode() + b"\0" + atype.encode() + b"\0"
            + struct.pack("<I", len(data)) + data)


def _exr_zip_compress(raw: bytes) -> bytes:
    """OpenEXR ZIP pre-filter + deflate: split bytes into two interleaved
    planes, delta-encode (+384 bias), then zlib (ImfZip semantics)."""
    import zlib

    b = np.frombuffer(raw, np.uint8)
    n = len(b)
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = b[0::2]
    t[half:] = b[1::2]
    d = t.astype(np.int16)
    d[1:] = (d[1:] - t[:-1].astype(np.int16) + 384) & 0xFF
    return zlib.compress(d.astype(np.uint8).tobytes())


def numpy_to_exr(path, array: np.ndarray, *, half: bool = False,
                 channel_names: Optional[Tuple[str, ...]] = None,
                 compression: str = "none") -> None:
    """Write (H, W) or (H, W, C<=4) float data as an EXR
    (reference seam: numpy_to_exr). compression: "none" | "zips"
    (per-scanline deflate with the OpenEXR ZIP pre-filter)."""
    a = np.asarray(array)
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] > 4:
        raise FormatError("expected (H, W) or (H, W, C<=4)")
    H, W, C = a.shape
    names = list(channel_names or (["Y"] if C == 1
                                   else ["R", "G", "B", "A"][:C]))
    if len(names) != C:
        raise FormatError("channel_names length mismatch")
    dtype = np.float16 if half else np.float32
    ptype = _PIX_HALF if half else _PIX_FLOAT
    data = a.astype(dtype)

    # channels appear alphabetically in EXR
    order = sorted(range(C), key=lambda i: names[i])
    chan_list = b""
    for i in order:
        chan_list += (names[i].encode() + b"\0"
                      + struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1))
    chan_list += b"\0"

    comp = {"none": 0, "zips": 2}.get(str(compression).lower())
    if comp is None:
        raise FormatError(f"unsupported EXR compression: {compression}")
    header = b""
    header += _exr_attr("channels", "chlist", chan_list)
    header += _exr_attr("compression", "compression", bytes([comp]))
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header += _exr_attr("dataWindow", "box2i", box)
    header += _exr_attr("displayWindow", "box2i", box)
    header += _exr_attr("lineOrder", "lineOrder", b"\x00")
    header += _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _exr_attr("screenWindowCenter", "v2f",
                        struct.pack("<2f", 0, 0))
    header += _exr_attr("screenWindowWidth", "float",
                        struct.pack("<f", 1.0))
    header += b"\0"

    psize = np.dtype(dtype).itemsize
    scan_bytes = W * C * psize
    blocks = []
    for y in range(H):
        raw = b"".join(np.ascontiguousarray(
            data[y, :, i]).astype(dtype).tobytes() for i in order)
        if comp == 2:
            z = _exr_zip_compress(raw)
            # the EXR contract: store raw when compression doesn't shrink
            blocks.append(z if len(z) < len(raw) else raw)
        else:
            blocks.append(raw)
    offset_table_pos = 8 + len(header)
    data_start = offset_table_pos + 8 * H
    offsets = []
    pos = data_start
    for blk in blocks:
        offsets.append(pos)
        pos += 8 + len(blk)

    with open(path, "wb") as fh:
        fh.write(struct.pack("<I", _EXR_MAGIC))
        fh.write(struct.pack("<I", 2))          # version 2, no flags
        fh.write(header)
        for off in offsets:
            fh.write(struct.pack("<Q", off))
        for y, blk in enumerate(blocks):
            fh.write(struct.pack("<iI", y, len(blk)))
            fh.write(blk)
