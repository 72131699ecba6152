# forge3d_tpu_torch/terrain/vt.py
# TESSELLA: the virtual texture store of forge3d_tpu/terrain/vt.py, a host
# copy: content-addressed (SHA-256), Morton-ordered, BC-compressed pages in
# one packed file, and a residency set under a hard byte budget that serves
# page requests with LRU eviction. The file format is the JAX package's
# byte for byte: a store packed by either package reads in the other. The
# reference's evidence gates ask for >= 256 GiB of logical texels under a
# 512 MiB budget with zero fallback texels after settling.

from __future__ import annotations

import hashlib
import io
import json
import struct
import zlib
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..errors import RenderError
from .stats import record_vt_event

__all__ = ["morton_encode", "morton_decode", "vt_pack", "VTStore",
           "VtError", "PAGE_SIZE"]

PAGE_SIZE = 128        # texels per page side
_MAGIC = b"F3DVT1\n"


class VtError(RenderError):
    pass


def morton_encode(x: int, y: int) -> int:
    """Interleave bits of (x, y) -> Morton code (page ordering)."""
    def spread(v: int) -> int:
        v &= 0xFFFFFFFF
        v = (v | (v << 16)) & 0x0000FFFF0000FFFF
        v = (v | (v << 8)) & 0x00FF00FF00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
        v = (v | (v << 2)) & 0x3333333333333333
        v = (v | (v << 1)) & 0x5555555555555555
        return v

    return spread(x) | (spread(y) << 1)


def morton_decode(code: int) -> Tuple[int, int]:
    def compact(v: int) -> int:
        v &= 0x5555555555555555
        v = (v | (v >> 1)) & 0x3333333333333333
        v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0F
        v = (v | (v >> 4)) & 0x00FF00FF00FF00FF
        v = (v | (v >> 8)) & 0x0000FFFF0000FFFF
        v = (v | (v >> 16)) & 0xFFFFFFFF
        return v

    return compact(code), compact(code >> 1)


_KINDS = {"albedo": ("bc7", 4), "normal": ("bc5", 2), "mask": ("bc7", 4),
          "height": ("raw", 1)}


def _encode_page(kind: str, texels: np.ndarray) -> bytes:
    codec, ch = _KINDS[kind]
    t = np.ascontiguousarray(texels)
    if t.shape[:2] != (PAGE_SIZE, PAGE_SIZE):
        raise VtError(f"page must be {PAGE_SIZE}x{PAGE_SIZE}")
    if codec == "bc7":
        from ..codec.bc import encode_bc7_rgba8

        if t.ndim == 2:
            t = np.stack([t] * 3 + [np.full_like(t, 255)], -1)
        if t.shape[2] == 3:
            t = np.concatenate([t, np.full((*t.shape[:2], 1), 255,
                                           t.dtype)], -1)
        return encode_bc7_rgba8(t.astype(np.uint8))
    if codec == "bc5":
        from ..codec.bc import encode_bc5_rg8

        return encode_bc5_rg8(t[..., :2].astype(np.uint8))
    return zlib.compress(t.astype("<f4").tobytes(), 6)


def _decode_page(kind: str, blob: bytes) -> np.ndarray:
    codec, _ = _KINDS[kind]
    if codec == "bc7":
        from ..codec.bc import decode_bc7

        return decode_bc7(blob, PAGE_SIZE, PAGE_SIZE)
    if codec == "bc5":
        from ..codec.bc import decode_bc5

        return decode_bc5(blob, PAGE_SIZE, PAGE_SIZE)
    return np.frombuffer(zlib.decompress(blob), "<f4").reshape(
        PAGE_SIZE, PAGE_SIZE)


def vt_pack(store_path, pages: Dict[Tuple[str, int, int, int], np.ndarray]
            ) -> dict:
    """Offline packer (reference seam: forge3d-vtpack): pages keyed by
    (kind, level, px, py) -> packed store file with a Morton-ordered
    index and SHA-256 content addresses. Returns the manifest."""
    entries = []
    blobs = io.BytesIO()
    order = sorted(pages, key=lambda k: (k[0], k[1],
                                         morton_encode(k[2], k[3])))
    for key in order:
        kind, level, px, py = key
        blob = _encode_page(kind, pages[key])
        digest = hashlib.sha256(blob).hexdigest()
        entries.append({"kind": kind, "level": level, "x": px, "y": py,
                        "offset": blobs.tell(), "size": len(blob),
                        "sha256": digest})
        blobs.write(blob)
    manifest = {"format": "forge3d-vt/1", "page_size": PAGE_SIZE,
                "entries": entries}
    mjson = json.dumps(manifest, sort_keys=True).encode()
    with open(store_path, "wb") as fh:
        fh.write(_MAGIC)
        fh.write(struct.pack("<I", len(mjson)))
        fh.write(mjson)
        fh.write(blobs.getvalue())
    return manifest


class VTStore:
    """Residency-managed page cache over a packed VT store file
    (reference seam: VTStore, terrain.py:11)."""

    def __init__(self, store_path, *, budget_bytes: int = 64 * 1024 * 1024):
        self.path = Path(store_path)
        raw = self.path.open("rb")
        if raw.read(len(_MAGIC)) != _MAGIC:
            raise VtError("not a forge3d VT store")
        (mlen,) = struct.unpack("<I", raw.read(4))
        self.manifest = json.loads(raw.read(mlen))
        self._base = raw.tell()
        self._fh = raw
        self.index = {(e["kind"], e["level"], e["x"], e["y"]): e
                      for e in self.manifest["entries"]}
        self.budget_bytes = int(budget_bytes)
        self._resident: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._resident_bytes = 0
        self.fallback_texels = 0
        self.evictions = 0
        self.feedback_requests = 0
        self._upload_ms_total = 0.0
        self._upload_count = 0

    @property
    def logical_texels(self) -> int:
        return len(self.index) * PAGE_SIZE * PAGE_SIZE

    def request(self, kind: str, level: int, px: int, py: int) -> np.ndarray:
        """Sampler feedback request: returns the decoded page, streaming +
        evicting under the budget. Missing pages raise (fail-closed) and
        count fallback texels."""
        key = (kind, level, px, py)
        self.feedback_requests += 1
        page = self._resident.get(key)
        if page is not None:
            self._resident.move_to_end(key)
            record_vt_event(hit=True, resident_pages=len(self._resident))
            return page
        entry = self.index.get(key)
        if entry is None:
            self.fallback_texels += PAGE_SIZE * PAGE_SIZE
            record_vt_event(hit=False)
            raise VtError(f"page not in store: {key}")
        if entry["size"] + 64 > self.budget_bytes:
            raise VtError("page larger than the whole residency budget")
        import time as _time

        _t0 = _time.perf_counter()
        self._fh.seek(self._base + entry["offset"])
        blob = self._fh.read(entry["size"])
        if hashlib.sha256(blob).hexdigest() != entry["sha256"]:
            raise VtError(f"page digest mismatch (corrupt store): {key}")
        page = _decode_page(kind, blob)
        while self._resident_bytes + page.nbytes > self.budget_bytes \
                and self._resident:
            _, old = self._resident.popitem(last=False)
            self._resident_bytes -= old.nbytes
            self.evictions += 1
        self._resident[key] = page
        self._resident_bytes += page.nbytes
        record_vt_event(hit=False, bytes_streamed=entry["size"],
                        resident_pages=len(self._resident))
        self._upload_ms_total += (_time.perf_counter() - _t0) * 1e3
        self._upload_count += 1
        return page

    def stats(self) -> dict:
        return {
            "pages_in_store": len(self.index),
            "logical_texels": self.logical_texels,
            "resident_pages": len(self._resident),
            "resident_bytes": self._resident_bytes,
            "budget_bytes": self.budget_bytes,
            "evictions": self.evictions,
            "fallback_texels": self.fallback_texels,
            "feedback_requests": self.feedback_requests,
            # reference bench contract (material_vt_stats.avg_upload_ms)
            "avg_upload_ms": (self._upload_ms_total / self._upload_count
                              if self._upload_count else 0.0),
        }

    def close(self):
        self._fh.close()
