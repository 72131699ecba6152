# forge3d_tpu_torch/ops/pyramid.py
# Min-max quadtree pyramid over a DEM, built on the host with numpy. It is
# re-declared here, equal array for array to forge3d_tpu/ops/pyramid.py:
# the port imports no module of the JAX package.
#
# Level 0 holds the min/max of each bilinear cell's four corners, padded to
# power-of-two dims with (+inf, -inf) sentinels so the traversal's shift
# arithmetic is exact; each coarser level reduces 2x2 children with
# edge-clamped indices. All levels are flattened finest first.

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..errors import UploadError


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x - 1).bit_length())


def build_minmax_levels(heights: np.ndarray) -> Tuple[List[np.ndarray], List[Tuple[int, int]], int, int]:
    """Per-level (h, w, 2) min/max arrays, finest first, with their padded
    (w, h) dims and the logical cell counts."""
    heights = np.asarray(heights, dtype=np.float32)
    if heights.ndim != 2:
        raise UploadError(f"heightfield must be 2D, got shape {heights.shape}")
    h, w = heights.shape
    if w < 2 or h < 2:
        raise UploadError(f"terrain heightfield must be at least 2x2 texels, got {w}x{h}")
    if not np.isfinite(heights).all():
        raise UploadError("terrain heightfield contains non-finite samples")

    cw, ch = w - 1, h - 1
    pw, ph = _next_pow2(cw), _next_pow2(ch)

    c00 = heights[:-1, :-1]
    c10 = heights[:-1, 1:]
    c01 = heights[1:, :-1]
    c11 = heights[1:, 1:]
    lo = np.minimum(np.minimum(c00, c10), np.minimum(c01, c11))
    hi = np.maximum(np.maximum(c00, c10), np.maximum(c01, c11))

    level0 = np.empty((ph, pw, 2), dtype=np.float32)
    level0[..., 0] = np.inf
    level0[..., 1] = -np.inf
    level0[:ch, :cw, 0] = lo
    level0[:ch, :cw, 1] = hi

    levels = [level0]
    dims = [(pw, ph)]
    while dims[-1][0] > 1 or dims[-1][1] > 1:
        lw, lh = dims[-1]
        nw, nh = max(lw // 2, 1), max(lh // 2, 1)
        prev = levels[-1]
        xi = np.minimum(2 * np.arange(nw), lw - 1)
        xi1 = np.minimum(xi + 1, lw - 1)
        yi = np.minimum(2 * np.arange(nh), lh - 1)
        yi1 = np.minimum(yi + 1, lh - 1)
        q00 = prev[np.ix_(yi, xi)]
        q10 = prev[np.ix_(yi, xi1)]
        q01 = prev[np.ix_(yi1, xi)]
        q11 = prev[np.ix_(yi1, xi1)]
        nxt = np.empty((nh, nw, 2), dtype=np.float32)
        nxt[..., 0] = np.minimum(np.minimum(q00[..., 0], q10[..., 0]), np.minimum(q01[..., 0], q11[..., 0]))
        nxt[..., 1] = np.maximum(np.maximum(q00[..., 1], q10[..., 1]), np.maximum(q01[..., 1], q11[..., 1]))
        levels.append(nxt)
        dims.append((nw, nh))
    return levels, dims, cw, ch


@dataclass(frozen=True)
class MinMaxPyramid:
    """Flattened min-max pyramid + DEM. `level_offset[L]` is the flat index
    of level L's texel (0, 0); `level_w`/`level_h` are its padded dims."""

    heights: np.ndarray            # (h, w) f32 DEM texels
    mm_min: np.ndarray             # (total,) f32
    mm_max: np.ndarray             # (total,) f32
    level_offset: np.ndarray       # (mips,) int32
    level_w: np.ndarray            # (mips,) int32
    level_h: np.ndarray            # (mips,) int32
    cell_w: int
    cell_h: int
    mip_count: int
    h_min: float
    h_max: float

    @property
    def nbytes(self) -> int:
        return int(
            self.heights.nbytes + self.mm_min.nbytes + self.mm_max.nbytes
            + self.level_offset.nbytes + self.level_w.nbytes + self.level_h.nbytes
        )


def build_pyramid(heights: np.ndarray) -> MinMaxPyramid:
    heights = np.ascontiguousarray(np.asarray(heights, dtype=np.float32))
    levels, dims, cw, ch = build_minmax_levels(heights)
    offsets = []
    mins = []
    maxs = []
    acc = 0
    for lv, (lw, lh) in zip(levels, dims):
        offsets.append(acc)
        mins.append(lv[..., 0].ravel())
        maxs.append(lv[..., 1].ravel())
        acc += lw * lh
    return MinMaxPyramid(
        heights=heights,
        mm_min=np.concatenate(mins).astype(np.float32),
        mm_max=np.concatenate(maxs).astype(np.float32),
        level_offset=np.asarray(offsets, dtype=np.int32),
        level_w=np.asarray([d[0] for d in dims], dtype=np.int32),
        level_h=np.asarray([d[1] for d in dims], dtype=np.int32),
        cell_w=int(cw),
        cell_h=int(ch),
        mip_count=len(levels),
        h_min=float(heights.min()),
        h_max=float(heights.max()),
    )
