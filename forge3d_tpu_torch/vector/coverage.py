# forge3d_tpu_torch/vector/coverage.py
# Kernel E4: analytic anti-aliased coverage of vector primitives, the port
# of forge3d_tpu/vector/coverage.py (stroke_coverage 53, disc_coverage 73,
# polygon_coverage 90) with VectorScene.render's composite
# (forge3d_tpu/vector/__init__.py:140-156) fused in.
#
# Per pixel centre (iota + 0.5): the least distance to a layer's segments,
# discs or ring edges (and, for a polygon, the winding count of the
# half-open crossing test), then coverage = clip(0.5 - signed distance, 0,
# 1), composited source-over into rgb and alpha, and the layer's pick id
# written where coverage > 0.5.
#
# `vector_layers` composites a whole layer list in one launch of the CUDA
# kernel (csrc/vector.cu over csrc/vector.cuh: it bins each primitive to the
# 16x16 pixel tiles it can change, then one CTA a tile takes every layer in
# order, composite in registers); `vector_layer` runs one layer, with an
# optional coverage plane, through the same kernel. Both run the plain
# PyTorch versions on CPU tensors, and E4's launches are counted in
# `vector_layer.launches`. The plain versions compute JAX's float32
# expressions in JAX's order over (chunk, H, W) broadcasts, with the minimum
# over each chunk and an int32 sum for the winding; minima and integer sums
# are exact in any order, so chunking changes no bit, nor does the kernel's
# cull (vector.cuh says why). XLA compiles JAX's scan
# bodies with every a*b + c fused into one multiply-add, rounded once; the
# plain versions round those sums once too (`ops.shading.fma32`), as the kernel's fmaf
# does, so all three agree bit for bit.

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..ops.shading import fma32, sqrt32

_F32 = torch.float32

#: primitive kinds, as csrc/vector.cuh numbers them
STROKE, DISC, POLYGON = 0, 1, 2
RULES = ("nonzero", "evenodd")

#: elements of one (chunk, H, W) plane of the plain versions
CHUNK_ELEMENTS = 1 << 24


def _pixel_grid(width: int, height: int, device):
    xs = torch.arange(width, dtype=_F32, device=device) + 0.5
    ys = torch.arange(height, dtype=_F32, device=device) + 0.5
    return xs[None, :].expand(height, width), ys[:, None].expand(height, width)


def _chunk(width: int, height: int) -> int:
    return max(1, CHUNK_ELEMENTS // max(1, width * height))


def _cols(prims: torch.Tensor):
    """The (C, 1, 1) columns of a (C, 4) chunk."""
    return [prims[:, k, None, None] for k in range(4)]


def _seg_distance(px, py, x1, y1, x2, y2):
    """coverage.py:_seg_distance over a chunk of segments: (C, H, W)."""
    vx = x2 - x1
    vy = y2 - y1
    wx = px - x1
    wy = py - y1
    denom = torch.clamp(fma32(vx, vx, vy * vy), min=1e-12)
    t = torch.clamp(fma32(wx, vx, wy * vy) / denom, 0.0, 1.0)
    dx = fma32(-t, vx, wx)
    dy = fma32(-t, vy, wy)
    return sqrt32(fma32(dx, dx, dy * dy))


def _as_prims(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(_F32).reshape(-1, 4)
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a, np.float32).reshape(-1, 4)))


def stroke_coverage_plain(width: int, height: int, segments, stroke_width: float):
    """Coverage (H, W) of round-capped strokes; segments (E, 4) [x1, y1, x2,
    y2] in pixels."""
    segs = _as_prims(segments)
    px, py = _pixel_grid(width, height, segs.device)
    half = float(np.float32(stroke_width * 0.5))
    dmin = torch.full((height, width), 1e30, dtype=_F32, device=segs.device)
    step = _chunk(width, height)
    for lo in range(0, segs.shape[0], step):
        x1, y1, x2, y2 = _cols(segs[lo:lo + step])
        dmin = torch.minimum(dmin, _seg_distance(px, py, x1, y1, x2, y2).amin(0))
    return torch.clamp(0.5 - (dmin - half), 0.0, 1.0)


def disc_prims(centers, radii) -> np.ndarray:
    """(N, 4) [cx, cy, r, 0] float32 discs from centres (N, 2) and radii (N,)
    (a scalar radius is broadcast)."""
    ctr = np.asarray(centers, np.float32).reshape(-1, 2)
    rad = np.broadcast_to(np.asarray(radii, np.float32).reshape(-1), (ctr.shape[0],))
    out = np.zeros((ctr.shape[0], 4), np.float32)
    out[:, :2] = ctr
    out[:, 2] = rad
    return out


def disc_coverage_plain(width: int, height: int, discs):
    """Coverage (H, W) of point discs; discs (N, 4) as `disc_prims` gives."""
    d4 = _as_prims(discs)
    px, py = _pixel_grid(width, height, d4.device)
    dmin = torch.full((height, width), 1e30, dtype=_F32, device=d4.device)
    step = _chunk(width, height)
    for lo in range(0, d4.shape[0], step):
        cx, cy, r, _ = _cols(d4[lo:lo + step])
        dx = px - cx
        dy = py - cy
        dmin = torch.minimum(dmin, (sqrt32(fma32(dx, dx, dy * dy)) - r).amin(0))
    return torch.clamp(0.5 - dmin, 0.0, 1.0)


def ring_edges(rings) -> np.ndarray:
    """(E, 4) float32 edges [x1, y1, x2, y2] of every ring, each closed with
    np.roll as coverage.py:polygon_coverage closes them."""
    all_edges = []
    for ring in rings:
        r = np.asarray(ring, np.float32).reshape(-1, 2)
        if len(r) < 3:
            raise ValueError("polygon ring needs >= 3 vertices")
        all_edges.append(np.concatenate([r, np.roll(r, -1, axis=0)], axis=1))
    if not all_edges:
        return np.zeros((0, 4), np.float32)
    return np.ascontiguousarray(np.concatenate(all_edges, axis=0), np.float32)


def polygon_coverage_plain(width: int, height: int, edges, rule: str = "nonzero"):
    """Coverage (H, W) of a filled polygon given its ring edges (E, 4)."""
    if rule not in RULES:
        raise ValueError(f"unknown fill rule {rule!r}; use one of {RULES}")
    e4 = _as_prims(edges)
    px, py = _pixel_grid(width, height, e4.device)
    dmin = torch.full((height, width), 1e30, dtype=_F32, device=e4.device)
    winding = torch.zeros((height, width), dtype=torch.int32, device=e4.device)
    step = _chunk(width, height)
    for lo in range(0, e4.shape[0], step):
        x1, y1, x2, y2 = _cols(e4[lo:lo + step])
        dmin = torch.minimum(dmin, _seg_distance(px, py, x1, y1, x2, y2).amin(0))
        cond_up = (y1 <= py) & (y2 > py)
        cond_dn = (y2 <= py) & (y1 > py)
        dy = y2 - y1
        t = (py - y1) / torch.where(dy.abs() > 1e-12, dy, torch.ones_like(dy))
        xint = fma32(t, (x2 - x1).expand_as(t), x1.expand_as(t))
        left = px < xint
        w = (cond_up & left).to(torch.int32) - (cond_dn & left).to(torch.int32)
        winding = winding + w.sum(0, dtype=torch.int32)
    inside = (winding & 1) != 0 if rule == "evenodd" else winding != 0
    sd = torch.where(inside, -dmin, dmin)
    return torch.clamp(0.5 - sd, 0.0, 1.0)


def composite_plain(cov, rgb, alpha, pick, color, opacity: float, pick_id: int) -> None:
    """VectorScene.render's composite of one layer, in place."""
    a = cov * float(opacity)
    col = torch.tensor([float(c) for c in color], dtype=_F32, device=cov.device)
    rgb.copy_(rgb * (1.0 - a[..., None]) + col * a[..., None])
    alpha.copy_(alpha + a * (1.0 - alpha))
    pick.copy_(torch.where(cov > 0.5, torch.full_like(pick, int(pick_id)), pick))


def coverage_plain(kind: int, prims, width: int, height: int, *, stroke_width: float = 0.0,
                   rule: str = "nonzero"):
    if kind == STROKE:
        return stroke_coverage_plain(width, height, prims, stroke_width)
    if kind == DISC:
        return disc_coverage_plain(width, height, prims)
    if kind == POLYGON:
        return polygon_coverage_plain(width, height, prims, rule)
    raise ValueError(f"unknown primitive kind {kind}")


def vector_layer_plain(kind: int, prims, width: int, height: int, *,
                       stroke_width: float = 0.0, rule: str = "nonzero",
                       color=(0.0, 0.0, 0.0), opacity: float = 1.0, pick_id: int = 0,
                       cov=None, rgb=None, alpha=None, pick=None) -> None:
    """The plain version of `vector_layer`."""
    c = coverage_plain(kind, prims, width, height, stroke_width=stroke_width, rule=rule)
    if cov is not None:
        cov.copy_(c)
    if rgb is not None:
        composite_plain(c, rgb, alpha, pick, color, opacity, pick_id)


#: words of one VecLayer (csrc/vector.cuh): kind, offset, count, evenodd,
#: pick_id, bd_slot, then half, opacity, color[3] and a pad as float32
LAYER_WORDS = 12
#: the kernel's pixel tile (F3D_VEC_TILE)
TILE = 16


def _style(style) -> dict:
    kw = dict(stroke_width=0.0, rule="nonzero", color=(0.0, 0.0, 0.0), opacity=1.0, pick_id=0)
    unknown = set(style) - set(kw)
    if unknown:
        raise ValueError(f"E4: unknown layer settings {sorted(unknown)}")
    kw.update(style)
    if kw["rule"] not in RULES:
        raise ValueError(f"unknown fill rule {kw['rule']!r}; use one of {RULES}")
    return kw


def _table(specs) -> np.ndarray:
    """The (L, 12) words of the kernel's layer table, as float32, from
    (kind, offset, count, style) per layer; each polygon layer gets the next
    backdrop plane."""
    words = np.zeros((len(specs), LAYER_WORDS), np.int32)
    floats = words.view(np.float32)
    n_poly = 0
    for j, (kind, offset, count, style) in enumerate(specs):
        if kind not in (STROKE, DISC, POLYGON):
            raise ValueError(f"unknown primitive kind {kind}")
        kw = _style(style)
        words[j, :6] = (kind, offset, count, kw["rule"] == "evenodd", int(kw["pick_id"]),
                        n_poly if kind == POLYGON else -1)
        floats[j, 6:11] = (np.float32(kw["stroke_width"] * 0.5), kw["opacity"], *kw["color"])
        n_poly += kind == POLYGON
    return floats


def pack_layers(layers) -> tuple:
    """(table, prims, n_poly) of a layer list [(kind, prims (n, 4), style
    dict of stroke_width, rule, color, opacity, pick_id)]: the (L, 12) words
    of the kernel's layer table as float32, the primitives concatenated in
    layer order as one (N, 4) float32 array, and the number of polygon
    layers (each gets its own backdrop plane)."""
    parts = [np.asarray(p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else p,
                        np.float32).reshape(-1, 4) for _, p, _ in layers]
    offsets = np.cumsum([0] + [len(p) for p in parts])
    table = _table([(k, int(o), len(p), st)
                    for (k, _, st), o, p in zip(layers, offsets, parts)])
    prims = np.concatenate(parts) if parts else np.zeros((0, 4), np.float32)
    return table, np.ascontiguousarray(prims), sum(k == POLYGON for k, _, _ in layers)


def _null_or_ptr(t):
    return None if t is None else _kernels.ptr(t)


def _check_planes(width, height, cov, rgb, alpha, pick, one_layer: bool):
    planes = [t for t in (cov, rgb, alpha, pick) if t is not None]
    if rgb is not None:
        if alpha is None or pick is None:
            raise ValueError("E4: the composite needs rgb, alpha and pick")
        if rgb.dtype != _F32 or alpha.dtype != _F32 or pick.dtype != torch.int32:
            raise ValueError("E4: rgb and alpha are float32, pick int32")
        if rgb.shape != (height, width, 3) or alpha.shape != (height, width) \
                or pick.shape != (height, width):
            raise ValueError("E4: planes must be (H, W, 3) and (H, W)")
        if not all(t.is_contiguous() for t in (rgb, alpha, pick)):
            raise ValueError("E4: planes must be contiguous")
    if cov is not None:
        if not one_layer:
            raise ValueError("E4: a coverage plane is written for one layer only")
        if cov.dtype != _F32 or cov.shape != (height, width) or not cov.is_contiguous():
            raise ValueError("E4: cov must be a contiguous (H, W) float32 plane")
    return planes


def bin_counts(table: torch.Tensor, prims: torch.Tensor, n_poly: int, width: int,
               height: int):
    """The binning's first pass on the card: (counts (tiles, layers) int32,
    the primitives of each layer kept in each tile; backdrop (n_poly,
    height, tiles_x) int32, each polygon edge's winding at the tile next
    left of its tiles, before the sums from the right)."""
    n_layers = table.numel() // LAYER_WORDS
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    counts = torch.zeros((tiles_y * tiles_x, n_layers), dtype=torch.int32, device=table.device)
    backdrop = torch.zeros((n_poly, height, tiles_x), dtype=torch.int32, device=table.device)
    err = _kernels.lib().f3d_vector_count(
        _kernels.ptr(table), n_layers, _kernels.ptr(prims), int(prims.numel() // 4), width,
        height, _kernels.ptr(counts), _kernels.ptr(backdrop), _kernels.stream_ptr(table.device))
    _kernels.check(err, "E4 vector_layers (count)")
    return counts, backdrop


def _vector_layers_kernel(table: torch.Tensor, prims: torch.Tensor, n_poly: int, width: int,
                          height: int, *, cov=None, rgb=None, alpha=None, pick=None,
                          mark=None) -> None:
    """Kernel E4 over a packed layer list (`pack_layers`' table and
    primitives, on the card): bin, then composite every layer in order.
    `mark(stage)`, where given, is called after the count and scan are
    queued ("binned"), after the host has read the list's size ("sized")
    and after the rest is queued ("composited"), for timing."""
    n_layers = table.numel() // LAYER_WORDS
    planes = _check_planes(width, height, cov, rgb, alpha, pick, n_layers == 1)
    _kernels.require_cuda("E4 vector_layers", table, prims, *planes)
    if table.dtype != _F32 or prims.dtype != _F32 or not prims.is_contiguous():
        raise ValueError("E4: the table and primitives must be contiguous float32")
    if width <= 0 or height <= 0 or n_layers == 0:
        return
    counts, backdrop = bin_counts(table, prims, n_poly, width, height)
    offs = torch.zeros(counts.numel() + 1, dtype=torch.int32, device=table.device)
    torch.cumsum(counts.view(-1), 0, dtype=torch.int32, out=offs[1:])
    if mark is not None:
        mark("binned")
    entries = torch.empty((int(offs[-1]), 4), dtype=_F32, device=table.device)   # the list's size
    if mark is not None:
        mark("sized")
    err = _kernels.lib().f3d_vector_compose(
        _kernels.ptr(table), n_layers, _kernels.ptr(prims), int(prims.numel() // 4), n_poly,
        width, height, _kernels.ptr(counts), _kernels.ptr(offs), _kernels.ptr(entries),
        _kernels.ptr(backdrop), _null_or_ptr(cov), _null_or_ptr(rgb), _null_or_ptr(alpha),
        _null_or_ptr(pick), _kernels.stream_ptr(table.device))
    _kernels.check(err, "E4 vector_layers")
    if mark is not None:
        mark("composited")
    vector_layer.launches += 1


def vector_layers_plain(layers, width: int, height: int, *, rgb, alpha, pick) -> None:
    """The plain version of `vector_layers`: each layer through
    `vector_layer_plain`, in order, on the planes' device."""
    for kind, prims, style in layers:
        vector_layer_plain(kind, _as_prims(prims).to(rgb.device), width, height,
                           **_style(style), rgb=rgb, alpha=alpha, pick=pick)


def vector_layers(layers, width: int, height: int, *, rgb, alpha, pick) -> None:
    """Kernel E4 over a whole layer list [(kind, prims (n, 4), style dict of
    stroke_width, rule, color, opacity, pick_id)]: every layer composited
    into rgb (H, W, 3), alpha (H, W) and pick (H, W) int32 in place, in
    order, as `vector_layer` would one at a time. The planes' device decides:
    CPU tensors run the plain version; on the card the primitives and the
    layer table go up in one copy, and one E4 launch (binning included)
    composites them all."""
    if rgb.device.type == "cpu":
        return vector_layers_plain(layers, width, height, rgb=rgb, alpha=alpha, pick=pick)
    table, prims, n_poly = pack_layers(layers)
    buf = torch.as_tensor(np.concatenate([table.ravel(), prims.ravel()])).to(rgb.device)
    _vector_layers_kernel(buf[:table.size], buf[table.size:].view(-1, 4), n_poly, width,
                          height, rgb=rgb, alpha=alpha, pick=pick)


def _vector_layer_kernel(kind: int, prims, width: int, height: int, *,
                         stroke_width: float = 0.0, rule: str = "nonzero",
                         color=(0.0, 0.0, 0.0), opacity: float = 1.0, pick_id: int = 0,
                         cov=None, rgb=None, alpha=None, pick=None) -> None:
    if kind not in (STROKE, DISC, POLYGON):
        raise ValueError(f"unknown primitive kind {kind}")
    prims = prims.reshape(-1, 4)
    _kernels.require_cuda("E4 vector_layer", prims)
    if prims.dtype != _F32:
        raise ValueError("E4 vector_layer: primitives must be float32")
    table = _table([(kind, 0, prims.shape[0], dict(stroke_width=stroke_width, rule=rule,
                                                   color=color, opacity=opacity,
                                                   pick_id=pick_id))])
    _vector_layers_kernel(torch.as_tensor(table.ravel()).to(prims.device), prims.contiguous(),
                          int(kind == POLYGON), width, height, cov=cov, rgb=rgb, alpha=alpha,
                          pick=pick)


def vector_layer(kind: int, prims, width: int, height: int, *, stroke_width: float = 0.0,
                 rule: str = "nonzero", color=(0.0, 0.0, 0.0), opacity: float = 1.0,
                 pick_id: int = 0, cov=None, rgb=None, alpha=None, pick=None) -> None:
    """One layer of kernel E4: the coverage of `prims` ((n, 4) float32:
    segments for STROKE, `disc_prims` for DISC, `ring_edges` for POLYGON)
    over a width x height grid, written to `cov` (H, W) and composited into
    rgb (H, W, 3), alpha (H, W) and pick (H, W) int32 in place, each where
    given. CPU tensors run the plain versions; CUDA tensors launch the
    kernel (the one `vector_layers` launches, with one layer).
    `vector_layer.launches` counts E4's launches from either entry point."""
    if prims.device.type == "cpu":
        return vector_layer_plain(kind, prims, width, height, stroke_width=stroke_width,
                                  rule=rule, color=color, opacity=opacity, pick_id=pick_id,
                                  cov=cov, rgb=rgb, alpha=alpha, pick=pick)
    return _vector_layer_kernel(kind, prims, width, height, stroke_width=stroke_width,
                                rule=rule, color=color, opacity=opacity, pick_id=pick_id,
                                cov=cov, rgb=rgb, alpha=alpha, pick=pick)


vector_layer.launches = 0


# ---------------------------------------------------------------------------
# The JAX module's functions, on a device: coverage (H, W) float32 tensors
# ---------------------------------------------------------------------------

def _coverage(kind, prims: np.ndarray, width, height, device, **kw) -> torch.Tensor:
    from ..pt.terrain_ref import resolve_device

    dev = resolve_device(device)
    cov = torch.empty((height, width), dtype=_F32, device=dev)
    vector_layer(kind, torch.as_tensor(prims, device=dev), width, height, cov=cov, **kw)
    return cov


def stroke_coverage(width: int, height: int, segments, stroke_width: float, *,
                    device="cuda") -> torch.Tensor:
    """Coverage in [0,1] of a round-capped stroke set; segments (E, 4)."""
    segs = np.ascontiguousarray(np.asarray(segments, np.float32).reshape(-1, 4))
    return _coverage(STROKE, segs, width, height, device, stroke_width=stroke_width)


def disc_coverage(width: int, height: int, centers, radii, *, device="cuda") -> torch.Tensor:
    """Coverage of point discs. centers (N, 2), radii (N,) in pixels."""
    return _coverage(DISC, disc_prims(centers, radii), width, height, device)


def polygon_coverage(width: int, height: int, rings, rule: str = "nonzero", *,
                     device="cuda") -> torch.Tensor:
    """AA coverage of a filled polygon (list of rings, each (V, 2) pixel
    coords; holes by winding)."""
    edges = ring_edges(rings)
    if len(edges) == 0:
        raise ValueError("need at least one array to concatenate")
    return _coverage(POLYGON, edges, width, height, device, rule=rule)


__all__ = ["STROKE", "DISC", "POLYGON", "vector_layer", "vector_layer_plain", "vector_layers",
           "vector_layers_plain", "pack_layers", "bin_counts",
           "stroke_coverage_plain", "disc_coverage_plain", "polygon_coverage_plain",
           "composite_plain", "disc_prims", "ring_edges", "stroke_coverage", "disc_coverage",
           "polygon_coverage"]
