# forge3d_tpu_torch/terrain/stats.py
# Terrain observability endpoints, a host copy of forge3d_tpu/terrain/
# stats.py: culling, visibility, virtual-texture and seam statistics
# (the reference's terrain_culling_stats, terrain_visibility_stats,
# terrain_vt_stats and terrain_seam_stats). The VT store records each page
# request here; "culling" reports the DDA's early-exit economics of the
# last trace, visibility the hit rate per frame, seam stats the tile-border
# continuity of a DEM mosaic.

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

__all__ = ["record_frame_stats", "terrain_culling_stats",
           "terrain_visibility_stats", "terrain_vt_stats",
           "terrain_seam_stats", "reset_stats"]

_LOCK = threading.Lock()
_STATE: Dict[str, dict] = {
    "culling": {"frames": 0, "rays": 0, "hits": 0,
                "blocks_total": 0, "blocks_tested": 0},
    "visibility": {"frames": 0, "visible_fraction": 0.0,
                   "mean_depth": 0.0},
    "vt": {"requests": 0, "hits": 0, "misses": 0, "bytes_streamed": 0,
           "resident_pages": 0},
}


def reset_stats() -> None:
    with _LOCK:
        _STATE["culling"] = {"frames": 0, "rays": 0, "hits": 0,
                             "blocks_total": 0, "blocks_tested": 0}
        _STATE["visibility"] = {"frames": 0, "visible_fraction": 0.0,
                                "mean_depth": 0.0}
        _STATE["vt"] = {"requests": 0, "hits": 0, "misses": 0,
                        "bytes_streamed": 0, "resident_pages": 0}


def record_frame_stats(hit: np.ndarray, t: np.ndarray, *,
                       blocks_total: int = 0,
                       blocks_tested: int = 0) -> None:
    """Record one traced frame's hit/depth buffers into the global stats
    (renderers call this after each trace)."""
    hit = np.asarray(hit)
    t = np.asarray(t)
    with _LOCK:
        c = _STATE["culling"]
        c["frames"] += 1
        c["rays"] += int(hit.size)
        c["hits"] += int(hit.sum())
        c["blocks_total"] += int(blocks_total)
        c["blocks_tested"] += int(blocks_tested)
        v = _STATE["visibility"]
        n = v["frames"]
        frac = float(hit.mean()) if hit.size else 0.0
        depth = float(t[hit].mean()) if hit.any() else 0.0
        v["visible_fraction"] = (v["visible_fraction"] * n + frac) / (n + 1)
        v["mean_depth"] = (v["mean_depth"] * n + depth) / (n + 1)
        v["frames"] = n + 1


def record_vt_event(*, hit: bool, bytes_streamed: int = 0,
                    resident_pages: Optional[int] = None) -> None:
    with _LOCK:
        vt = _STATE["vt"]
        vt["requests"] += 1
        vt["hits" if hit else "misses"] += 1
        vt["bytes_streamed"] += int(bytes_streamed)
        if resident_pages is not None:
            vt["resident_pages"] = int(resident_pages)


def terrain_culling_stats() -> dict:
    with _LOCK:
        c = dict(_STATE["culling"])
    tested = c["blocks_tested"]
    total = c["blocks_total"]
    c["culled_fraction"] = (1.0 - tested / total) if total else 0.0
    return c


def terrain_visibility_stats() -> dict:
    with _LOCK:
        return dict(_STATE["visibility"])


def terrain_vt_stats() -> dict:
    with _LOCK:
        vt = dict(_STATE["vt"])
    req = vt["requests"]
    vt["hit_rate"] = vt["hits"] / req if req else 0.0
    return vt


def terrain_seam_stats(tiles: Dict[tuple, np.ndarray]) -> dict:
    """Validate mosaic continuity: max/mean |edge difference| between
    adjacent DEM tiles keyed by (tx, tz) (reference seam:
    terrain_seam_stats). 0 seams = watertight mosaic."""
    max_err = 0.0
    sum_err = 0.0
    edges = 0
    cracks = 0
    for (tx, tz), tile in tiles.items():
        right = tiles.get((tx + 1, tz))
        if right is not None:
            d = np.abs(np.asarray(tile)[:, -1].astype(np.float64)
                       - np.asarray(right)[:, 0])
            max_err = max(max_err, float(d.max()))
            sum_err += float(d.sum())
            edges += d.size
            cracks += int((d > 1e-5).sum())
        down = tiles.get((tx, tz + 1))
        if down is not None:
            d = np.abs(np.asarray(tile)[-1, :].astype(np.float64)
                       - np.asarray(down)[0, :])
            max_err = max(max_err, float(d.max()))
            sum_err += float(d.sum())
            edges += d.size
            cracks += int((d > 1e-5).sum())
    return {"edges_checked": edges, "cracks": cracks,
            "max_seam_error": max_err,
            "mean_seam_error": sum_err / edges if edges else 0.0}
