# forge3d_tpu_torch/codec/f3dz_device.py
# The third F3DZ decode lane, on the card (forge3d_tpu/codec/f3dz_device.py):
# the host parses the header and the per-tile records, checks every tile's
# CRC (fail-closed, like the other lanes), reads the frequency tables and
# lays the streams and escape payloads out padded; kernel C1 (csrc/codec.cu)
# then decodes every tile: C1 entropy, the tile's rANS chain with the escape
# substitution (one block a tile), and C1 reconstruction, the MED (LOCO-I)
# reconstruction with the height scale, written straight into the page.
# The plain PyTorch versions sit beside the kernels: CPU tensors run them,
# CUDA tensors launch the kernels; nothing falls back.
#
# Pages whose sides are not multiples of the tile decode through the Python
# lane, as in the JAX package; so do streams whose tile is not 256 pixels,
# which the encoder never writes.
#
# What the lane computes. The integers (residuals, quantized heights) equal
# JAX's device lane bit for bit. The heights are the C++ and Python lanes'
# (float)((double)q * step), so the three lanes of the port agree byte for
# byte; JAX's device lane scales by a double-float sum in float32 and
# differs from them by one ulp on some heights.

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import _kernels
from .f3dz import F3dzError

__all__ = ["decompress_dem_device"]

_MAGIC = 0x5A443346
_VERSION = 1
_PROB_BITS = 12
_PROB_SCALE = 1 << _PROB_BITS
_ESCAPE = 255
_RANS_LO = 1 << 23
_MASK32 = 0xFFFFFFFF
TILE = 256    # the tile of every stream native/f3dz.cpp writes, and C1's
_FREQ = np.dtype([("s", "u1"), ("f", "<u2")])


@dataclass(frozen=True)
class TilePage:
    """A parsed stream of full tiles, as the kernels take it: per tile the
    stream zero-padded to `cap` bytes (a multiple of 4: C1 entropy reads it
    a word at a time), its length, the frequency table and the escape
    payload zero-padded to `ecap` words (int32 holding the u32 bits)."""

    width: int
    height: int
    ntx: int
    nty: int
    step: float
    stream: np.ndarray    # (T, cap) uint8
    lens: np.ndarray      # (T,) int32
    freq: np.ndarray      # (T, 256) int32
    extras: np.ndarray    # (T, ecap) int32

    def tensors(self, device):
        return tuple(torch.as_tensor(a, device=device)
                     for a in (self.stream, self.lens, self.freq, self.extras))


def parse_page(blob: bytes):
    """The host part of the lane (JAX's decompress_dem_device up to the
    launch): a TilePage, or None for a page the Python lane decodes.
    Raises F3dzError on a bad header, a truncated record, a CRC mismatch,
    a wrong token count or a frequency table that does not sum to 4096."""
    b = memoryview(bytes(blob))
    if len(b) < 40:
        raise F3dzError("stream too short")
    magic, version, width, height = struct.unpack_from("<4I", b, 0)
    if magic != _MAGIC or version != _VERSION:
        raise F3dzError("bad magic/version")
    (step,) = struct.unpack_from("<d", b, 20)
    tile, ntx, nty = struct.unpack_from("<3I", b, 28)
    if tile == 0 or ntx != -(-width // tile) or nty != -(-height // tile):
        raise F3dzError("bad tiling")
    if width % tile or height % tile or tile != TILE:
        return None

    pos = 40
    n_tiles = ntx * nty
    n_tokens = tile * tile
    recs = []
    for _ in range(n_tiles):
        rec_size, crc_expect = struct.unpack_from("<2I", b, pos)
        pos += 8
        rec = bytes(b[pos: pos + rec_size])
        if len(rec) != rec_size:
            raise F3dzError("truncated tile record")
        if (zlib.crc32(rec) & _MASK32) != crc_expect:
            raise F3dzError("tile CRC mismatch (fail-closed)")
        nt, stream_size, extra_size, nz = struct.unpack_from("<3IH", rec, 0)
        if nt != n_tokens:
            raise F3dzError("token count mismatch")
        table = np.frombuffer(rec, _FREQ, count=nz, offset=14)
        freq = np.zeros(256, np.int64)
        freq[table["s"]] = table["f"]     # a symbol listed twice keeps its last entry
        if int(freq.sum()) != _PROB_SCALE:
            raise F3dzError("frequency table does not normalize")
        off = 14 + 3 * nz
        stream = np.frombuffer(rec, np.uint8, count=stream_size, offset=off)
        extra = np.frombuffer(rec, "<u4", count=extra_size // 4, offset=off + stream_size)
        recs.append((stream, freq, extra))
        pos += rec_size

    cap = -(-max([4] + [len(s) for s, _, _ in recs]) // 4) * 4
    ecap = max([1] + [len(e) for _, _, e in recs])
    stream_arr = np.zeros((n_tiles, cap), np.uint8)
    extra_arr = np.zeros((n_tiles, ecap), np.uint32)
    lens = np.zeros(n_tiles, np.int32)
    for i, (s, _, e) in enumerate(recs):
        stream_arr[i, :len(s)] = s
        extra_arr[i, :len(e)] = e
        lens[i] = len(s)
    freq = np.stack([f for _, f, _ in recs]).astype(np.int32)
    return TilePage(int(width), int(height), int(ntx), int(nty), float(step), stream_arr, lens,
                    freq, extra_arr.view(np.int32))


# ---------------------------------------------------------------------------
# C1 entropy
# ---------------------------------------------------------------------------


def _rans_tile(stream: bytes, n: int, freq, extras, out) -> None:
    """One tile's chain in Python ints (the plain version's body): JAX's
    rans_step, 65,536 times."""
    cum, c = [], 0
    for f in freq:
        cum.append(c)
        c += f
    tab = []
    for s, f in enumerate(freq):
        tab += [(s, f, j) for j in range(f)]
    data = stream
    last = len(extras) - 1
    lo = _RANS_LO
    state = 0
    for p in range(4):
        state = (state << 8) | (data[p] if p < n else 0)
    pos, n_esc = 4, 0
    for i in range(TILE * TILE):
        s, f, off = tab[state & (_PROB_SCALE - 1)]
        state = (f * (state >> _PROB_BITS) + off) & _MASK32
        if state < lo:
            state = (state << 8) | (data[pos] if pos < n else 0)
            pos += 1
            if state < lo:
                state = (state << 8) | (data[pos] if pos < n else 0)
                pos += 1
                if state < lo:
                    state = (state << 8) | (data[pos] if pos < n else 0)
                    pos += 1
                    if state < lo:
                        state = (state << 8) | (data[pos] if pos < n else 0)
                        pos += 1
        if s == _ESCAPE:
            z = extras[n_esc if n_esc < last else last]
            n_esc += 1
        else:
            z = s
        out[i] = (z >> 1) ^ -(z & 1)


def rans_decode_plain(stream, lens, freq, extras) -> torch.Tensor:
    """Plain version of C1 entropy: (T, 65536) int32 residuals, one tile's
    chain at a time in Python ints, as the Python lane decodes."""
    T = stream.shape[0]
    st, ln, fr = stream.cpu().numpy(), lens.cpu().tolist(), freq.cpu().tolist()
    ex = (extras.cpu().numpy().view(np.uint32)).tolist()
    out = np.empty((T, TILE * TILE), np.int64)
    for t in range(T):
        row = [0] * (TILE * TILE)
        _rans_tile(st[t].tobytes(), ln[t], fr[t], ex[t], row)
        out[t] = row
    return torch.as_tensor(out.astype(np.int32), device=stream.device)


def _rans_kernel(stream, lens, freq, extras) -> torch.Tensor:
    _kernels.require_cuda("rans_decode", stream, lens, freq, extras)
    if stream.dtype != torch.uint8 or any(t.dtype != torch.int32 for t in (lens, freq, extras)):
        raise ValueError("rans_decode: stream must be uint8 and lens, freq, extras int32")
    T, cap = stream.shape
    if lens.shape != (T,) or freq.shape != (T, 256) or extras.dim() != 2 or extras.shape[0] != T \
            or extras.shape[1] < 1 or cap % 4:
        raise ValueError("rans_decode: expected stream (T, cap) with cap a multiple of 4, lens "
                         "(T,), freq (T, 256), extras (T, ecap)")
    dev = stream.device
    d = torch.empty((T, TILE * TILE), dtype=torch.int32, device=dev)
    err = _kernels.lib().f3d_rans_decode(
        _kernels.ptr(stream), _kernels.ptr(lens), int(cap), _kernels.ptr(freq),
        _kernels.ptr(extras), int(extras.shape[1]), int(T), _kernels.ptr(d),
        _kernels.stream_ptr(dev))
    _kernels.check(err, "C1 rans_decode")
    rans_decode.launches += 1
    return d


def rans_decode(stream, lens, freq, extras) -> torch.Tensor:
    """C1 entropy: every tile's rANS chain, the escapes substituted, the
    tokens zig-zag decoded to (T, 65536) int32 residuals. CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    if stream.device.type == "cpu":
        return rans_decode_plain(stream, lens, freq, extras)
    return _rans_kernel(stream, lens, freq, extras)


rans_decode.launches = 0


# ---------------------------------------------------------------------------
# C1 reconstruction
# ---------------------------------------------------------------------------


def _place(tiles: torch.Tensor, ntx: int, nty: int) -> torch.Tensor:
    return tiles.reshape(nty, ntx, TILE, TILE).permute(0, 2, 1, 3).reshape(nty * TILE,
                                                                         ntx * TILE)


def med_reconstruct_plain(d, ntx: int, nty: int, step: float) -> torch.Tensor:
    """Plain version of C1 reconstruction: the MED prediction inverted over
    every tile at once, one anti-diagonal a step (the kernel's wavefront),
    in int32, then (float)((double)q * step), the tiles in their places."""
    T = d.shape[0]
    dev = d.device
    dd = d.reshape(T, TILE, TILE)
    q = torch.zeros((T, TILE, TILE), dtype=torch.int32, device=dev)
    for k in range(2 * TILE - 1):
        y = torch.arange(max(0, k - TILE + 1), min(k, TILE - 1) + 1, device=dev)
        x = k - y
        ym, xm = (y - 1).clamp(min=0), (x - 1).clamp(min=0)
        left = torch.where(x > 0, q[:, y, xm], 0)
        up = torch.where(y > 0, q[:, ym, x], 0)
        upleft = q[:, ym, xm]
        mx, mn = torch.maximum(left, up), torch.minimum(left, up)
        med = torch.where(upleft >= mx, mn, torch.where(upleft <= mn, mx, left + up - upleft))
        pred = torch.where(y == 0, left, torch.where(x == 0, up, med))
        q[:, y, x] = pred + dd[:, y, x]
    return _place((q.double() * float(step)).float(), ntx, nty)


def _med_kernel(d, ntx: int, nty: int, step: float) -> torch.Tensor:
    _kernels.require_cuda("med_reconstruct", d)
    if d.dtype != torch.int32 or d.shape != (ntx * nty, TILE * TILE):
        raise ValueError(f"med_reconstruct: d must be int32 of shape ({ntx * nty}, "
                         f"{TILE * TILE})")
    dev = d.device
    out = torch.empty((nty * TILE, ntx * TILE), dtype=torch.float32, device=dev)
    err = _kernels.lib().f3d_med_reconstruct(
        _kernels.ptr(d), int(ntx * nty), int(ntx), int(ntx * TILE), float(step),
        _kernels.ptr(out), _kernels.stream_ptr(dev))
    _kernels.check(err, "C1 med_reconstruct")
    med_reconstruct.launches += 1
    return out


def med_reconstruct(d, ntx: int, nty: int, step: float) -> torch.Tensor:
    """C1 reconstruction: residuals (T, 65536) int32 of an nty x ntx grid of
    tiles to the (nty * 256, ntx * 256) float32 page. CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    if d.device.type == "cpu":
        return med_reconstruct_plain(d, ntx, nty, step)
    return _med_kernel(d, ntx, nty, step)


med_reconstruct.launches = 0


def decompress_dem_device(blob: bytes, *, device="cuda") -> np.ndarray:
    """Decode an F3DZ stream with the device lane: the host parses the
    records and checks their CRCs (fail-closed), C1 decodes every tile on
    `device` ("cuda" launches the kernels, "cpu" runs their plain versions).
    Returns the (H, W) float32 heights, byte-identical to decompress_dem."""
    from ..pt.terrain_ref import resolve_device

    dev = resolve_device(device)
    page = parse_page(blob)
    if page is None:
        from .f3dz_pylane import decompress_dem_pylane

        return decompress_dem_pylane(blob)
    stream, lens, freq, extras = page.tensors(dev)
    d = rans_decode(stream, lens, freq, extras)
    return med_reconstruct(d, page.ntx, page.nty, page.step).cpu().numpy()
