# forge3d_tpu_torch/gis/geotiff.py
# A host copy of forge3d_tpu/gis/geotiff.py for the PyTorch port: the port
# imports no module of the JAX package, so it keeps its own copy, held against
# the original by tests/test_torch_host_copies.py. The original's notes
# follow.
#
# Minimal-but-real GeoTIFF reader/writer in pure Python + numpy: classic
# TIFF, striped or tiled layouts, None/Deflate/PackBits compression, windowed
# reads that touch only intersecting strips/tiles, and the GeoTIFF tags
# needed for georeferencing (pixel scale, tiepoint, GeoKey directory).
#
# Parity notes (reference behavior, not code): the reference reads DEM
# rasters with windowed access and exposes bounds/crs/resolution/transform
# (forge3d:src/gis/{raster_read,raster_window,raster_write}.rs and
# python/forge3d/gis.py). Its COG path streams HTTP ranges
# (src/gis/cog_range.rs) — the same strip/tile-granular logic here reads
# through any "range reader" callable, so a future HTTP range source plugs
# in unchanged.

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..errors import UploadError

# TIFF tag ids
T_IMAGE_WIDTH = 256
T_IMAGE_LENGTH = 257
T_BITS_PER_SAMPLE = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_STRIP_OFFSETS = 273
T_SAMPLES_PER_PIXEL = 277
T_ROWS_PER_STRIP = 278
T_STRIP_BYTE_COUNTS = 279
T_PLANAR_CONFIG = 284
T_PREDICTOR = 317
T_TILE_WIDTH = 322
T_TILE_LENGTH = 323
T_TILE_OFFSETS = 324
T_TILE_BYTE_COUNTS = 325
T_SAMPLE_FORMAT = 339
T_NODATA = 42113  # GDAL_NODATA (ASCII)
T_MODEL_PIXEL_SCALE = 33550
T_MODEL_TIEPOINT = 33922
T_GEO_KEY_DIRECTORY = 34735
T_GEO_ASCII_PARAMS = 34737

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q", 18: "Q"}

# GeoKey ids
GK_MODEL_TYPE = 1024
GK_RASTER_TYPE = 1025
GK_GEOGRAPHIC_TYPE = 2048
GK_PROJECTED_CS_TYPE = 3072


@dataclass
class RasterInfo:
    width: int
    height: int
    count: int               # bands
    dtype: str
    nodata: Optional[float]
    transform: Tuple[float, float, float, float, float, float]
    # affine (a, b, c, d, e, f): x = a*col + b*row + c; y = d*col + e*row + f
    crs: Optional[str]       # "EPSG:xxxx" when derivable
    tiled: bool
    block_size: Tuple[int, int]
    compression: int

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        a, b, c, d, e, f = self.transform
        xs = [c, c + a * self.width + b * self.height]
        ys = [f, f + d * self.width + e * self.height]
        return (min(xs), min(ys), max(xs), max(ys))

    @property
    def resolution(self) -> Tuple[float, float]:
        a, b, c, d, e, f = self.transform
        return (abs(a), abs(e))


def _np_dtype(bits: int, sample_format: int) -> np.dtype:
    if sample_format == 3:
        return {16: np.float16, 32: np.float32, 64: np.float64}[bits]
    if sample_format == 2:
        return {8: np.int8, 16: np.int16, 32: np.int32}[bits]
    return {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]


class _Reader:
    def __init__(self, data_or_path):
        if isinstance(data_or_path, (bytes, bytearray)):
            self._data = bytes(data_or_path)
            self._read_range = lambda off, n: self._data[off:off + n]
        elif callable(data_or_path):
            self._read_range = data_or_path  # (offset, length) -> bytes
        else:
            f = open(data_or_path, "rb")
            self._f = f

            def rr(off, n):
                f.seek(off)
                return f.read(n)

            self._read_range = rr
        head = self._read_range(0, 8)
        if len(head) < 8:
            raise UploadError("not a TIFF: truncated header")
        if head[:2] == b"II":
            self.e = "<"
        elif head[:2] == b"MM":
            self.e = ">"
        else:
            raise UploadError("not a TIFF: bad byte order mark")
        magic = struct.unpack(self.e + "H", head[2:4])[0]
        if magic == 43:
            # BigTIFF (TIFF 6.0 supplement): 8-byte offsets, 20-byte IFD
            # entries, u64 entry counts
            self.big = True
            big_head = self._read_range(4, 12)
            off_size, pad = struct.unpack(self.e + "HH", big_head[:4])
            if off_size != 8 or pad != 0:
                raise UploadError("not a BigTIFF: bad offset size header")
            self.ifd_offset = struct.unpack(self.e + "Q", big_head[4:12])[0]
        elif magic == 42:
            self.big = False
            self.ifd_offset = struct.unpack(self.e + "I", head[4:8])[0]
        else:
            raise UploadError("not a TIFF: bad magic")
        self.tags = self._parse_ifd(self.ifd_offset)

    def _parse_ifd(self, off) -> Dict[int, tuple]:
        if self.big:
            n = struct.unpack(self.e + "Q", self._read_range(off, 8))[0]
            entry, inline, cfmt, ofmt = 20, 8, "HHQ", "Q"
            raw = self._read_range(off + 8, n * entry)
        else:
            n = struct.unpack(self.e + "H", self._read_range(off, 2))[0]
            entry, inline, cfmt, ofmt = 12, 4, "HHI", "I"
            raw = self._read_range(off + 2, n * entry)
        tags = {}
        head_size = struct.calcsize(self.e + cfmt)
        for i in range(n):
            tag, typ, cnt = struct.unpack(
                self.e + cfmt, raw[i * entry:i * entry + head_size])
            val_bytes = raw[i * entry + head_size:(i + 1) * entry]
            size = _TYPE_SIZES.get(typ, 1) * cnt
            if size > inline:
                ptr = struct.unpack(self.e + ofmt, val_bytes[:inline])[0]
                payload = self._read_range(ptr, size)
            else:
                payload = val_bytes[:size]
            tags[tag] = (typ, cnt, payload)
        return tags

    def tag_values(self, tag, default=None):
        if tag not in self.tags:
            return default
        typ, cnt, payload = self.tags[tag]
        if typ == 2:  # ascii
            return payload.rstrip(b"\x00").decode("latin1")
        if typ in (5, 10):  # rationals
            fmt = self.e + ("II" if typ == 5 else "ii")
            out = []
            for i in range(cnt):
                num, den = struct.unpack_from(fmt, payload, i * 8)
                out.append(num / den if den else 0.0)
            return out
        fmt = _TYPE_FMT.get(typ)
        if fmt is None:
            return payload
        return list(struct.unpack(self.e + fmt * cnt, payload))

    def tag_scalar(self, tag, default=None):
        v = self.tag_values(tag)
        if v is None:
            return default
        if isinstance(v, list):
            return v[0] if v else default
        return v


def _decompress(buf: bytes, compression: int, expected: int,
                predictor: int, row_bytes: int, dtype: np.dtype,
                samples: int) -> bytes:
    if compression == 1:
        out = buf
    elif compression in (8, 32946):  # Deflate / zlib
        out = zlib.decompress(buf)
    elif compression == 32773:  # PackBits
        res = bytearray()
        i = 0
        while i < len(buf) and len(res) < expected:
            n = buf[i]
            i += 1
            if n < 128:
                res += buf[i:i + n + 1]
                i += n + 1
            elif n > 128:
                res += buf[i:i + 1] * (257 - n)
                i += 1
        out = bytes(res)
    else:
        raise UploadError(f"unsupported TIFF compression {compression}")
    if predictor == 2:
        arr = np.frombuffer(out, dtype=dtype)
        ncols = row_bytes // dtype.itemsize
        arr = arr.reshape(-1, ncols // samples, samples) if samples > 1 else arr.reshape(-1, ncols)
        arr = np.cumsum(arr, axis=1, dtype=arr.dtype)
        out = arr.tobytes()
    return out


def raster_info(path) -> RasterInfo:
    r = _Reader(path)
    return _info_from_reader(r)


def _info_from_reader(r: _Reader) -> RasterInfo:
    w = int(r.tag_scalar(T_IMAGE_WIDTH))
    h = int(r.tag_scalar(T_IMAGE_LENGTH))
    spp = int(r.tag_scalar(T_SAMPLES_PER_PIXEL, 1))
    bits = r.tag_values(T_BITS_PER_SAMPLE, [8])
    bits0 = bits[0] if isinstance(bits, list) else bits
    sf = int(r.tag_scalar(T_SAMPLE_FORMAT, 1))
    comp = int(r.tag_scalar(T_COMPRESSION, 1))
    dtype = _np_dtype(int(bits0), sf)

    tiled = T_TILE_OFFSETS in r.tags
    if tiled:
        bw = int(r.tag_scalar(T_TILE_WIDTH))
        bh = int(r.tag_scalar(T_TILE_LENGTH))
    else:
        bw = w
        bh = int(r.tag_scalar(T_ROWS_PER_STRIP, h))

    nodata = r.tag_values(T_NODATA)
    if isinstance(nodata, str):
        try:
            nodata = float(nodata.strip())
        except ValueError:
            nodata = None

    scale = r.tag_values(T_MODEL_PIXEL_SCALE)
    tie = r.tag_values(T_MODEL_TIEPOINT)
    if scale and tie and len(tie) >= 6:
        sx, sy = float(scale[0]), float(scale[1])
        ox = float(tie[3]) - float(tie[0]) * sx
        oy = float(tie[4]) + float(tie[1]) * sy
        transform = (sx, 0.0, ox, 0.0, -sy, oy)
    else:
        transform = (1.0, 0.0, 0.0, 0.0, -1.0, float(h))

    crs = None
    gkd = r.tag_values(T_GEO_KEY_DIRECTORY)
    if gkd and len(gkd) >= 4:
        n_keys = int(gkd[3])
        for i in range(n_keys):
            base = 4 + i * 4
            if base + 3 >= len(gkd):
                break
            key, loc, cnt, val = (int(gkd[base + j]) for j in range(4))
            if key == GK_PROJECTED_CS_TYPE and loc == 0:
                crs = f"EPSG:{val}"
            elif key == GK_GEOGRAPHIC_TYPE and loc == 0 and crs is None:
                crs = f"EPSG:{val}"

    return RasterInfo(width=w, height=h, count=spp, dtype=np.dtype(dtype).name,
                      nodata=nodata, transform=transform, crs=crs, tiled=tiled,
                      block_size=(bw, bh), compression=comp)


def read_raster(path, window: Optional[Tuple[int, int, int, int]] = None,
                band: Optional[int] = None) -> np.ndarray:
    """Read a (windowed) raster. window = (col_off, row_off, width, height).

    Returns (H, W) for single-band (or selected band), else (H, W, C).
    Only blocks intersecting the window are read and decoded.
    """
    r = _Reader(path)
    info = _info_from_reader(r)
    w, h, spp = info.width, info.height, info.count
    dtype = np.dtype(info.dtype)
    bw, bh = info.block_size
    predictor = int(r.tag_scalar(T_PREDICTOR, 1))
    planar = int(r.tag_scalar(T_PLANAR_CONFIG, 1))
    if planar != 1 and spp > 1:
        raise UploadError("planar TIFF not supported")

    if window is None:
        cx, cy, cw, ch = 0, 0, w, h
    else:
        cx, cy, cw, ch = (int(v) for v in window)
        if cx < 0 or cy < 0 or cw <= 0 or ch <= 0 or cx + cw > w or cy + ch > h:
            raise UploadError(f"window {window} outside raster {w}x{h}")

    out = np.zeros((ch, cw, spp), dtype)

    if info.tiled:
        offsets = r.tag_values(T_TILE_OFFSETS)
        counts = r.tag_values(T_TILE_BYTE_COUNTS)
        tiles_x = (w + bw - 1) // bw
        ty0, ty1 = cy // bh, (cy + ch - 1) // bh
        tx0, tx1 = cx // bw, (cx + cw - 1) // bw
        for ty in range(ty0, ty1 + 1):
            for tx in range(tx0, tx1 + 1):
                ti = ty * tiles_x + tx
                raw = r._read_range(offsets[ti], counts[ti])
                dec = _decompress(raw, info.compression, bw * bh * spp * dtype.itemsize,
                                  predictor, bw * spp * dtype.itemsize, dtype, spp)
                tile = np.frombuffer(dec, dtype, count=bw * bh * spp).reshape(bh, bw, spp)
                gx0, gy0 = tx * bw, ty * bh
                sx0 = max(cx, gx0)
                sy0 = max(cy, gy0)
                sx1 = min(cx + cw, gx0 + bw)
                sy1 = min(cy + ch, gy0 + bh)
                out[sy0 - cy:sy1 - cy, sx0 - cx:sx1 - cx] = tile[
                    sy0 - gy0:sy1 - gy0, sx0 - gx0:sx1 - gx0
                ]
    else:
        offsets = r.tag_values(T_STRIP_OFFSETS)
        counts = r.tag_values(T_STRIP_BYTE_COUNTS)
        s0, s1 = cy // bh, (cy + ch - 1) // bh
        for si in range(s0, s1 + 1):
            raw = r._read_range(offsets[si], counts[si])
            rows = min(bh, h - si * bh)
            dec = _decompress(raw, info.compression, rows * w * spp * dtype.itemsize,
                              predictor, w * spp * dtype.itemsize, dtype, spp)
            strip = np.frombuffer(dec, dtype, count=rows * w * spp).reshape(rows, w, spp)
            gy0 = si * bh
            sy0 = max(cy, gy0)
            sy1 = min(cy + ch, gy0 + rows)
            out[sy0 - cy:sy1 - cy, :] = strip[sy0 - gy0:sy1 - gy0, cx:cx + cw]

    if band is not None:
        return out[..., int(band)]
    return out[..., 0] if spp == 1 else out


def write_raster(path, array: np.ndarray,
                 transform: Optional[Tuple[float, ...]] = None,
                 crs: Optional[str] = None,
                 nodata: Optional[float] = None,
                 compress: str = "deflate") -> None:
    """Write a striped (Geo)TIFF: (H, W) or (H, W, C) arrays, little-endian,
    deflate or uncompressed."""
    a = np.asarray(array)
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3:
        raise UploadError("array must be 2D or 3D")
    h, w, spp = a.shape
    dt = a.dtype
    if dt == np.float64:
        sf = 3
    elif dt in (np.float32, np.float16):
        sf = 3
    elif dt in (np.int8, np.int16, np.int32):
        sf = 2
    elif dt in (np.uint8, np.uint16, np.uint32):
        sf = 1
    else:
        raise UploadError(f"unsupported dtype {dt}")
    bits = dt.itemsize * 8
    comp_id = {"deflate": 8, "none": 1}.get(compress)
    if comp_id is None:
        raise UploadError(f"unsupported compression {compress!r}")

    rows_per_strip = max(1, min(h, (1 << 16) // max(1, w * spp * dt.itemsize)))
    strips = []
    for y0 in range(0, h, rows_per_strip):
        chunk = np.ascontiguousarray(a[y0:y0 + rows_per_strip]).astype(dt.newbyteorder("<")).tobytes()
        strips.append(zlib.compress(chunk, 6) if comp_id == 8 else chunk)

    tags: List[tuple] = []  # (tag, type, count, value-bytes or int list)

    def tag_short(tid, vals):
        tags.append((tid, 3, vals if isinstance(vals, list) else [vals]))

    def tag_long(tid, vals):
        tags.append((tid, 4, vals if isinstance(vals, list) else [vals]))

    def tag_double(tid, vals):
        tags.append((tid, 12, vals))

    def tag_ascii(tid, s):
        tags.append((tid, 2, s.encode() + b"\x00"))

    tag_short(T_IMAGE_WIDTH, w)
    tag_short(T_IMAGE_LENGTH, h)
    tag_short(T_BITS_PER_SAMPLE, [bits] * spp)
    tag_short(T_COMPRESSION, comp_id)
    tag_short(T_PHOTOMETRIC, 1 if spp == 1 else 2)
    tag_short(T_SAMPLES_PER_PIXEL, spp)
    tag_short(T_ROWS_PER_STRIP, rows_per_strip)
    tag_short(T_PLANAR_CONFIG, 1)
    tag_short(T_SAMPLE_FORMAT, [sf] * spp)
    if transform is not None:
        aa, bb, cc, dd, ee, ff = (float(v) for v in transform)
        tag_double(T_MODEL_PIXEL_SCALE, [abs(aa), abs(ee), 0.0])
        tag_double(T_MODEL_TIEPOINT, [0.0, 0.0, 0.0, cc, ff, 0.0])
    if crs is not None and crs.upper().startswith("EPSG:"):
        code = int(crs.split(":")[1])
        is_geog = 4000 <= code <= 4999
        keys = [1, 1, 0, 2,
                GK_MODEL_TYPE, 0, 1, 2 if is_geog else 1,
                (GK_GEOGRAPHIC_TYPE if is_geog else GK_PROJECTED_CS_TYPE), 0, 1, code]
        tag_short(T_GEO_KEY_DIRECTORY, keys)
    if nodata is not None:
        tag_ascii(T_NODATA, repr(float(nodata)))

    # layout: header(8) | IFD | tag payloads | strip data
    n_extra_tags = 2  # strip offsets + byte counts
    n_tags = len(tags) + n_extra_tags
    ifd_off = 8
    ifd_size = 2 + n_tags * 12 + 4
    payload_off = ifd_off + ifd_size

    encoded: List[tuple] = []
    payloads = bytearray()
    for tid, typ, val in tags:
        if typ == 2:
            data = val
        elif typ == 3:
            data = b"".join(struct.pack("<H", v) for v in val)
        elif typ == 4:
            data = b"".join(struct.pack("<I", v) for v in val)
        elif typ == 12:
            data = b"".join(struct.pack("<d", v) for v in val)
        cnt = len(val) if typ != 2 else len(val)
        if len(data) <= 4:
            encoded.append((tid, typ, cnt, data.ljust(4, b"\x00"), None))
        else:
            encoded.append((tid, typ, cnt, None, len(payloads)))
            payloads += data

    # strip offsets/counts go after other payloads
    strip_counts = [len(s) for s in strips]
    strip_table_off = payload_off + len(payloads)
    # the offset/count tables are only materialized when they don't fit
    # inline (more than one strip)
    table_bytes = 8 * len(strips) if len(strips) > 1 else 0
    data_off = strip_table_off + table_bytes
    strip_offsets = []
    acc = data_off
    for c in strip_counts:
        strip_offsets.append(acc)
        acc += c

    def enc_tag_long_list(tid, vals, table_off):
        if len(vals) == 1:
            return (tid, 4, 1, struct.pack("<I", vals[0]), None)
        return (tid, 4, len(vals), None, table_off - payload_off)

    off_entry = enc_tag_long_list(T_STRIP_OFFSETS, strip_offsets, strip_table_off)
    cnt_entry = enc_tag_long_list(T_STRIP_BYTE_COUNTS, strip_counts,
                                  strip_table_off + 4 * len(strips))
    if len(strips) > 1:
        payload_extra = b"".join(struct.pack("<I", v) for v in strip_offsets)
        payload_extra += b"".join(struct.pack("<I", v) for v in strip_counts)
    else:
        payload_extra = b""

    all_entries = sorted(encoded + [off_entry, cnt_entry], key=lambda t: t[0])

    out = bytearray()
    out += b"II" + struct.pack("<HI", 42, ifd_off)
    out += struct.pack("<H", n_tags)
    for tid, typ, cnt, inline, ploc in all_entries:
        out += struct.pack("<HHI", tid, typ, cnt)
        if inline is not None:
            out += inline
        else:
            out += struct.pack("<I", payload_off + ploc)
    out += struct.pack("<I", 0)  # next IFD
    out += payloads
    out += payload_extra
    for s in strips:
        out += s

    with open(path, "wb") as f:
        f.write(out)
