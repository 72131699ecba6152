# forge3d_tpu_torch/screen_compose.py
# A host copy of forge3d_tpu/screen_compose.py for the PyTorch port (screen-
# space vector layers; draw_text and composite_label_layer wait for the
# labels): the port imports no module of the JAX package, so it keeps its own
# copy, held against the original by tests/test_torch_host_copies.py.
# draw_line and draw_disc compute their coverage on the primitive's window
# and blend only the window's covered pixels and the frame's non-opaque ones
# (_blend_window): the original's bytes at a small part of its cost, since
# every other pixel blends to itself. The original's notes follow.
#
# Parity notes (reference behavior, not code): the reference composites
# vector/label/raster recipe layers in SCREEN space on the CPU, directly
# over the rendered terrain base (_map_scene_render.py:1355-1552), with a
# precise pixel contract: unit-interval coordinates are fractions of the
# frame, larger values are pixels (:125-131); lines are distance-field
# strokes with +-0.5px analytic AA, butt/square/round caps (:199-238),
# dash patterns walked along the polyline (:270-305), miter/round joins
# filled as polygons (:337-383); polygon fills are 4x4-supersampled
# even-odd ring tests (:497-521); all blending is source-over in
# straight-alpha space (:133-161). Labels are drawn with the shared text
# engine at their planner anchors (:1519-1545). This module implements
# that contract so MapScene screen-mode frames match the reference recipe
# goldens pixel-for-pixel.

from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

import numpy as np

Color = Tuple[int, int, int, int]


# ---------------------------------------------------------------------------
# blending primitives
# ---------------------------------------------------------------------------

def _blend_pixels(px: np.ndarray, cov: np.ndarray, color: Color) -> np.ndarray:
    """blend_region's source-over of RGBA u8 pixels `px` (..., 4) under
    coverage `cov` (...), elementwise: the blended pixels."""
    src_a = cov * (float(color[3]) / 255.0)
    dst_a = px[..., 3].astype(np.float32) / 255.0
    out_a = src_a + dst_a * (1.0 - src_a)
    src_rgb = np.asarray(color[:3], np.float32) / 255.0
    dst_rgb = px[..., :3].astype(np.float32) / 255.0
    premul = (src_rgb * src_a[..., None]
              + dst_rgb * dst_a[..., None] * (1.0 - src_a[..., None]))
    out_rgb = np.divide(premul, np.maximum(out_a[..., None], 1.0e-6),
                        out=np.zeros_like(premul),
                        where=out_a[..., None] > 1.0e-6)
    out = np.empty_like(px)
    out[..., :3] = np.clip(out_rgb * 255.0, 0.0, 255.0).astype(np.uint8)
    out[..., 3] = np.clip(out_a * 255.0, 0.0, 255.0).astype(np.uint8)
    return out


def blend_region(image: np.ndarray, mask: np.ndarray, color: Color) -> None:
    """Source-over blend of a coverage mask onto RGBA u8, in place."""
    cov = np.clip(np.asarray(mask, np.float32), 0.0, 1.0)
    if not np.any(cov > 0.0):
        return
    image[...] = _blend_pixels(image, cov, color)


def _blend_window(image: np.ndarray, y0: int, x0: int, cov: np.ndarray,
                  color: Color) -> None:
    """blend_region(image, mask, color) for a mask that is `cov` on the
    window image[y0:y0+h, x0:x0+w] and zero elsewhere, giving the same
    bytes while computing only the pixels that can change: a pixel with no
    coverage and alpha 255 blends to itself exactly (src_a = 0, dst_a =
    1.0, and k / 255 * 255 rounds back to k for every byte k), so the
    window's covered pixels and the frame's other non-opaque ones are
    blended and the rest kept."""
    cov = np.clip(np.asarray(cov, np.float32), 0.0, 1.0)
    if not np.any(cov > 0.0):
        return
    h, w = cov.shape
    sel = image[..., 3] != 255
    sel[y0:y0 + h, x0:x0 + w] |= cov > 0.0
    ys, xs = np.nonzero(sel)
    c = np.zeros(len(ys), np.float32)
    inw = (ys >= y0) & (ys < y0 + h) & (xs >= x0) & (xs < x0 + w)
    c[inw] = cov[ys[inw] - y0, xs[inw] - x0]
    image[ys, xs] = _blend_pixels(image[ys, xs], c, color)


def _window(image: np.ndarray, xlo: float, xhi: float, ylo: float, yhi: float):
    """(y0, y1, x0, x1): the frame's pixels within [xlo, xhi] x [ylo, yhi]."""
    h, w = image.shape[:2]
    x0 = max(0, min(w, int(math.floor(xlo))))
    x1 = max(x0, min(w, int(math.ceil(xhi)) + 1))
    y0 = max(0, min(h, int(math.floor(ylo))))
    y1 = max(y0, min(h, int(math.ceil(yhi)) + 1))
    return y0, y1, x0, x1


def blend_rect(image: np.ndarray, x0: int, y0: int, x1: int, y1: int,
               color: Color) -> None:
    h, w = image.shape[:2]
    x0, x1 = max(0, min(w, int(x0))), max(0, min(w, int(x1)))
    y0, y1 = max(0, min(h, int(y0))), max(0, min(h, int(y1)))
    if x0 >= x1 or y0 >= y1:
        return
    blend_region(image[y0:y1, x0:x1],
                 np.ones((y1 - y0, x1 - x0), np.float32), color)


def draw_pixel_block(image: np.ndarray, x: int, y: int, color: Color,
                     radius: int = 1) -> None:
    blend_rect(image, int(x) - radius, int(y) - radius,
               int(x) + radius + 1, int(y) + radius + 1, color)


def draw_disc(image: np.ndarray, x: float, y: float, color: Color,
              radius: float) -> None:
    # coverage is zero beyond radius + 0.5 of the centre: the window's
    # margin is wider, and _blend_window gives the full frame's bytes
    m = float(radius) + 2.0
    y0, y1, x0, x1 = _window(image, float(x) - m, float(x) + m, float(y) - m, float(y) + m)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    dist = np.sqrt((xx.astype(np.float32) - float(x)) ** 2
                   + (yy.astype(np.float32) - float(y)) ** 2)
    _blend_window(image, y0, x0, np.clip(float(radius) + 0.5 - dist, 0.0, 1.0), color)


# ---------------------------------------------------------------------------
# coordinates
# ---------------------------------------------------------------------------

def point_to_pixel(point: Sequence[Any], width: int,
                   height: int) -> Tuple[int, int]:
    """Unit-interval values are frame fractions; larger values are pixels
    (wrapped); always clamped to the frame."""
    x = float(point[0]) if len(point) > 0 else 0.0
    y = float(point[1]) if len(point) > 1 else 0.0
    px = (int(round(x * (width - 1))) if 0.0 <= x <= 1.0
          else int(round(x)) % max(1, width))
    py = (int(round(y * (height - 1))) if 0.0 <= y <= 1.0
          else int(round(y)) % max(1, height))
    return max(0, min(width - 1, px)), max(0, min(height - 1, py))


# ---------------------------------------------------------------------------
# strokes
# ---------------------------------------------------------------------------

def draw_line(image: np.ndarray, start, end, color: Color, *,
              width_px: float = 1.0, cap: str = "round",
              profile: str = "linear") -> None:
    """Distance-field stroke of one segment.

    profile "linear": analytic +-0.5px AA around the half-width (the
    reference's Python raster stroker). profile "smoothstep": full
    coverage inside the half-width, then a 1px smoothstep feather
    OUTSIDE it — the native OIT line shader's falloff
    (src/shaders/line_aa.wgsl:110,163-164: alpha = 1 - smoothstep(0,
    edge_softness, d - half_width), edge_softness = 1px)."""
    x0, y0 = start
    x1, y1 = end
    vx, vy = float(x1 - x0), float(y1 - y0)
    len_sq = max(vx * vx + vy * vy, 1.0)
    seg_len = float(np.sqrt(len_sq))
    half = max(0.5, float(width_px) * 0.5)
    # coverage is zero beyond half + 1 of the segment (a square cap extends
    # it by half): the window's margin is wider, and _blend_window gives
    # the full frame's bytes
    m = 2.0 * half + 3.0
    wy0, wy1, wx0, wx1 = _window(image, min(x0, x1) - m, max(x0, x1) + m,
                                 min(y0, y1) - m, max(y0, y1) + m)
    yy, xx = np.mgrid[wy0:wy1, wx0:wx1]
    px = xx.astype(np.float32)
    py = yy.astype(np.float32)
    t_raw = ((px - x0) * vx + (py - y0) * vy) / len_sq
    t_min, t_max = 0.0, 1.0
    cap_key = str(cap or "round").lower()
    if cap_key == "square":
        ext = half / max(seg_len, 1.0)
        t_min -= ext
        t_max += ext
    t = np.clip(t_raw, t_min, t_max)
    dist = np.sqrt((px - (x0 + t * vx)) ** 2 + (py - (y0 + t * vy)) ** 2)
    if profile == "smoothstep":
        tt = np.clip(dist - half, 0.0, 1.0)
        cov = 1.0 - (3.0 * tt * tt - 2.0 * tt * tt * tt)
    else:
        cov = np.clip(half + 0.5 - dist, 0.0, 1.0)
    if cap_key == "butt":
        cov *= ((t_raw >= 0.0) & (t_raw <= 1.0)).astype(np.float32)
    _blend_window(image, wy0, wx0, cov, color)


def dash_pattern(value) -> Tuple[float, ...]:
    if value is None:
        return ()
    if isinstance(value, Sequence) and not isinstance(value, (str, bytes)):
        pat = tuple(float(v) for v in value if float(v) > 0.0)
    else:
        pat = ()
    if len(pat) == 1:
        pat = (pat[0], pat[0])
    if len(pat) % 2 == 1:
        pat = pat + pat
    return pat


def _lerp(a, b, t: float) -> Tuple[float, float]:
    return (float(a[0]) + (float(b[0]) - float(a[0])) * t,
            float(a[1]) + (float(b[1]) - float(a[1])) * t)


def dash_segments(points: Sequence, dash_array) -> list:
    """Walk the dash pattern along the polyline, carrying phase across
    vertices; returns drawable (start, end) sub-segments."""
    pat = dash_pattern(dash_array)
    if len(points) < 2:
        return []
    if not pat:
        return [( _lerp(s, s, 0.0), _lerp(e, e, 0.0))
                for s, e in zip(points, points[1:])]
    out = []
    idx = 0
    remaining = pat[0]
    draw = True
    for s, e in zip(points, points[1:]):
        length = math.hypot(float(e[0]) - float(s[0]),
                            float(e[1]) - float(s[1]))
        if length <= 1e-6:
            continue
        off = 0.0
        while off < length:
            run = min(remaining, length - off)
            nxt = off + run
            if draw and run > 1e-6:
                out.append((_lerp(s, e, off / length),
                            _lerp(s, e, nxt / length)))
            off = nxt
            remaining -= run
            if remaining <= 1e-6:
                idx = (idx + 1) % len(pat)
                remaining = pat[idx]
                draw = idx % 2 == 0
    return out


def _normalize(dx: float, dy: float):
    n = math.hypot(dx, dy)
    if n <= 1e-9:
        return None
    return (dx / n, dy / n)


def _intersect(p0, d0, p1, d1):
    det = d0[0] * d1[1] - d0[1] * d1[0]
    if abs(det) <= 1e-9:
        return None
    t = ((p1[0] - p0[0]) * d1[1] - (p1[1] - p0[1]) * d1[0]) / det
    return (p0[0] + d0[0] * t, p0[1] + d0[1] * t)


def _area(pts) -> float:
    a = 0.0
    for i in range(len(pts)):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % len(pts)]
        a += x0 * y1 - x1 * y0
    return a * 0.5


def _draw_join(image, prev_pt, pt, next_pt, color: Color, *,
               radius: float, join: str, miter_limit: float) -> None:
    din = _normalize(float(pt[0]) - float(prev_pt[0]),
                     float(pt[1]) - float(prev_pt[1]))
    dout = _normalize(float(next_pt[0]) - float(pt[0]),
                      float(next_pt[1]) - float(pt[1]))
    if din is None or dout is None:
        return
    dot = din[0] * dout[0] + din[1] * dout[1]
    if dot > 0.999:
        return
    jk = str(join or "miter").lower()
    if jk == "round" or dot < -0.999:
        draw_disc(image, float(pt[0]), float(pt[1]), color, radius)
        return
    nin = (-din[1], din[0])
    nout = (-dout[1], dout[0])
    px, py = float(pt[0]), float(pt[1])
    limit = max(1.0, float(miter_limit)) * float(radius)
    for side in (-1.0, 1.0):
        s_off = (px + nin[0] * radius * side, py + nin[1] * radius * side)
        e_off = (px + nout[0] * radius * side, py + nout[1] * radius * side)
        miter = None
        if jk == "miter":
            cand = _intersect(s_off, din, e_off, dout)
            if cand is not None and math.hypot(cand[0] - px,
                                               cand[1] - py) <= limit:
                miter = cand
        poly = ([(px, py), s_off, e_off] if miter is None
                else [(px, py), s_off, miter, e_off])
        if abs(_area(poly)) > 1e-3:
            draw_polygon_fill(image, [poly], color)


def draw_polyline(image: np.ndarray, points: Sequence, color: Color, *,
                  width_px: float = 1.0, cap: str = "butt",
                  join: str = "miter", dash_array=None,
                  miter_limit: float = 4.0,
                  profile: str = "linear") -> None:
    if len(points) < 2:
        return
    segments = dash_segments(points, dash_array)
    cap_key = str(cap or "butt").lower()
    radius = max(0.5, float(width_px) * 0.5)
    for s, e in segments:
        if profile == "smoothstep":
            # native GPU route: NDC-scaled float coordinates kept exact
            p0 = (float(s[0]), float(s[1]))
            p1 = (float(e[0]), float(e[1]))
        else:
            # the reference's Python stroker rounds segment endpoints
            # (_map_scene_render.py:_draw_polyline int(round(...)));
            # round-cap discs below still use the float endpoints
            p0 = (int(round(s[0])), int(round(s[1])))
            p1 = (int(round(e[0])), int(round(e[1])))
        draw_line(image, p0, p1,
                  color, width_px=width_px, cap=cap_key, profile=profile)
        if cap_key == "round":
            draw_disc(image, s[0], s[1], color, radius)
            draw_disc(image, e[0], e[1], color, radius)
    if dash_array:
        return
    for a, b, c in zip(points, points[1:], points[2:]):
        _draw_join(image, a, b, c, color, radius=radius,
                   join=str(join or "miter").lower(),
                   miter_limit=miter_limit)


# ---------------------------------------------------------------------------
# polygon fill — 4x4 supersampled even-odd over rings
# ---------------------------------------------------------------------------

def _as_rings(points_or_rings) -> list:
    if not points_or_rings:
        return []
    first = points_or_rings[0]
    if (isinstance(first, Sequence) and len(first) >= 1
            and isinstance(first[0], (Sequence, np.ndarray))):
        rings = [list(map(tuple, r)) for r in points_or_rings]
    else:
        rings = [list(map(tuple, points_or_rings))]
    return [r for r in rings if len(r) >= 3]


def _ring_contains(ring, sx, sy):
    inside = np.zeros_like(sx, dtype=bool)
    j = len(ring) - 1
    for i in range(len(ring)):
        xi, yi = float(ring[i][0]), float(ring[i][1])
        xj, yj = float(ring[j][0]), float(ring[j][1])
        hit = ((yi > sy) != (yj > sy)) & (
            sx < (xj - xi) * (sy - yi) / (yj - yi + 1.0e-9) + xi)
        inside ^= hit
        j = i
    return inside


def polygon_coverage(points_or_rings, w: int, h: int) -> np.ndarray:
    """4x4-supersampled even-odd coverage of the rings."""
    rings = _as_rings(points_or_rings)
    cov = np.zeros((h, w), np.float32)
    if not rings:
        return cov
    yy, xx = np.mgrid[0:h, 0:w]
    samples = 4
    offs = (np.arange(samples, dtype=np.float32) + 0.5) / samples - 0.5
    bx = xx.astype(np.float32)
    by = yy.astype(np.float32)
    for dy in offs:
        for dx in offs:
            inside = np.zeros((h, w), bool)
            for ring in rings:
                inside ^= _ring_contains(ring, bx + float(dx),
                                         by + float(dy))
            cov += inside.astype(np.float32)
    return cov / float(samples * samples)


def draw_polygon_fill(image: np.ndarray, points_or_rings,
                      color: Color) -> None:
    h, w = image.shape[:2]
    blend_region(image, polygon_coverage(points_or_rings, w, h), color)


def point_to_pixel_f(point, width: int, height: int):
    """Continuous variant of point_to_pixel for fill rasterization: the
    reference's fill pass maps fractional coords through the full-viewport
    NDC transform (x*2-1), i.e. pixel-space x = frac*width, with pixel
    centers at i+0.5 — no rounding (src/shaders/polygon_fill.wgsl vertex
    path). Values outside [0,1] are raw pixels."""
    x = float(point[0]) if len(point) > 0 else 0.0
    y = float(point[1]) if len(point) > 1 else 0.0
    fx = x * width if 0.0 <= x <= 1.0 else x
    fy = y * height if 0.0 <= y <= 1.0 else y
    return fx, fy


def polygon_coverage_hard(rings, w: int, h: int) -> np.ndarray:
    """Hard (non-AA) even-odd coverage with the raster sample rule: a
    pixel is covered iff its center (i+0.5, j+0.5) lies inside — matching
    the reference's rasterized polygon_fill pass, which has no analytic
    AA (verified against the choropleth golden's hard edges)."""
    rings = [r for r in ([list(map(tuple, rr)) for rr in rings]) if len(r) >= 3]
    cov = np.zeros((h, w), np.float32)
    if not rings:
        return cov
    yy, xx = np.mgrid[0:h, 0:w]
    sx = xx.astype(np.float32) + 0.5
    sy = yy.astype(np.float32) + 0.5
    inside = np.zeros((h, w), bool)
    for ring in rings:
        inside ^= _ring_contains(ring, sx, sy)
    cov[inside] = 1.0
    return cov


# ---------------------------------------------------------------------------
# native polygon fills — the exact double-blend quantization chain
#
# The reference's native fill route blends TWICE with straight alpha:
#  1. the polygon pass draws (c, a) through ALPHA_BLENDING over a
#     TRANSPARENT clear (src/vector/polygon.rs:143,
#     src/py_functions/vector/polygon_fill.rs:204), so the Rgba8Unorm
#     overlay texel stores round((c*a, a) * 255);
#  2. the host compositor straight-alpha blends that texel over the base
#     and TRUNCATES to u8 (python/forge3d/map_scene.py
#     _alpha_composite_rgba: .astype(uint8), no rounding).
# Net: out = floor(base*(1 - qa) + round(c*a*255)*qa), qa = round(a*255)/255
# = c*a^2 + base*(1-a) up to the two quantizations — byte-exact against
# the mapscene_thematic_choropleth golden fills. Line strokes draw
# straight-alpha raw sRGB.
# ---------------------------------------------------------------------------

def blend_region_linear(image: np.ndarray, cov: np.ndarray,
                        color01, alpha: float) -> None:
    cov = np.clip(np.asarray(cov, np.float32), 0.0, 1.0)
    if not np.any(cov > 0.0):
        return
    src_rgb_u8 = np.round(np.asarray(color01, np.float32)[:3]
                          * float(alpha) * 255.0)
    qa = np.round(float(alpha) * 255.0) / 255.0
    a = (cov * qa)[..., None]
    dst = image[..., :3].astype(np.float32)
    out = src_rgb_u8[None, None, :] * a + dst * (1.0 - a)
    image[..., :3] = np.clip(np.floor(out), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# layer compositing (screen space)
# ---------------------------------------------------------------------------

def _style_layers(layer, layer_type: str) -> list:
    style = getattr(layer, "style", None)
    if not isinstance(style, dict):
        return []
    return [item for item in (style.get("layers") or ())
            if isinstance(item, dict)
            and str(item.get("type", "")).lower() == layer_type]


def _paint(layer, layer_type: str) -> dict:
    layers = _style_layers(layer, layer_type)
    return dict(layers[0].get("paint") or {}) if layers else {}


def _layout(layer, layer_type: str) -> dict:
    layers = _style_layers(layer, layer_type)
    return dict(layers[0].get("layout") or {}) if layers else {}


def _is_style_expression(value) -> bool:
    return isinstance(value, list) and bool(value) and \
        isinstance(value[0], str)


def _parse_color(value, fallback):
    """The reference compositor's color parser
    (_map_scene_render.py:_color): #rgb/#rrggbb/#rrggbbaa strings or
    numeric sequences ([0,1] or [0,255]); anything else -> fallback."""
    if isinstance(value, str):
        item = value.strip().lstrip("#")
        if len(item) == 3:
            item = "".join(ch * 2 for ch in item)
        if len(item) in (6, 8):
            try:
                r, g, b = (int(item[i:i + 2], 16) for i in (0, 2, 4))
                a = int(item[6:8], 16) if len(item) == 8 else fallback[3]
                return r, g, b, a
            except ValueError:
                return fallback
    if isinstance(value, (list, tuple)) and len(value) >= 3:
        vals = [float(c) for c in value[:4]]
        scale = 255.0 if max(vals[:3]) <= 1.0 else 1.0
        rgb = [max(0, min(255, int(round(v * scale)))) for v in vals[:3]]
        if len(vals) > 3:
            a = max(0, min(255, int(round(vals[3] * (255.0 if vals[3] <= 1.0
                                                     else 1.0)))))
        else:
            a = fallback[3]
        return rgb[0], rgb[1], rgb[2], a
    return fallback


def _number(value, default: float) -> float:
    try:
        return float(value)
    except (TypeError, ValueError):
        return float(default)


def _feature_color(value, properties, fallback):
    if _is_style_expression(value):
        from .style import evaluate_expression

        evaluated = evaluate_expression(value, dict(properties or {}))
        return (_parse_color(evaluated, fallback)
                if evaluated is not None else fallback)
    return _parse_color(value, fallback)


def _feature_number(value, properties, default: float) -> float:
    if _is_style_expression(value):
        from .style import evaluate_expression

        evaluated = evaluate_expression(value, dict(properties or {}))
        return float(evaluated) if evaluated is not None else float(default)
    return _number(value, default)


def _geometry_polygon_rings(geometry) -> list:
    gtype = str(geometry.get("type", "")).lower()
    coords = geometry.get("coordinates")
    if not coords:
        return []
    if gtype == "polygon":
        return [[list(ring) for ring in coords if ring]]
    if gtype == "multipolygon":
        return [[list(ring) for ring in poly if ring]
                for poly in coords if poly]
    return []


def _geometry_points(geometry) -> list:
    gtype = str(geometry.get("type", "")).lower()
    coords = geometry.get("coordinates")
    if not coords:
        return []
    if gtype == "point":
        return [coords]
    if gtype in ("linestring", "multipoint"):
        return list(coords)
    if gtype == "multilinestring":
        return [pt for line in coords for pt in line]
    return []


def vector_layer_requires_precise_raster(layer) -> bool:
    """The reference routes a vector layer through its precise Python
    rasterizer instead of the native GPU passes when it carries a dash
    pattern, or a long open polyline with a non-round join
    (map_scene.py:_vector_layer_requires_precise_raster)."""
    line_paint = _paint(layer, "line")
    line_layout = _layout(layer, "line")
    dash = getattr(layer, "dash_array", None) or \
        line_paint.get("line-dasharray")
    if dash:
        return True
    join = str(line_layout.get("line-join")
               or getattr(layer, "line_join", "round") or "round").lower()
    for feature in getattr(layer, "features", None) or ():
        geometry = feature.get("geometry") if isinstance(feature, dict) \
            else None
        if not isinstance(geometry, dict):
            continue
        gtype = str(geometry.get("type", "")).lower()
        if "polygon" not in gtype and (join != "round"
                                       or "line-miter-limit" in line_layout):
            if len(_geometry_points(geometry)) > 2:
                return True
    return False


def composite_vector_features(image: np.ndarray, layer,
                              width: int, height: int,
                              recipe=None) -> None:
    """Composite a reference-contract vector layer (GeoJSON features +
    Mapbox-GL style), mirroring the reference's two render routes:

    * precise Python raster (dash patterns / hard joins):
      _map_scene_render.py:1401-1514 — 4x4-supersampled even-odd fill
      blended straight-alpha, ring strokes + polylines via the software
      stroker; layer-level fill fallback = (stable-hash rgb, 160).
    * native GPU passes: polygon fill through ALPHA_BLENDING over a
      transparent target (vector/polygon.rs:143), whose texel (c*a, a)
      is then straight-alpha composited AGAIN by the host
      (map_scene.py:_alpha_composite_rgba) -> out = c*a^2 + base*(1-a);
      hard pixel-center coverage (un-antialiased tessellated triangles);
      layer-level fill fallback alpha = 96
      (map_scene.py:_native_polygon_payload_for_layers).
    """
    from .mapscene import layer_hash_rgb

    precise = vector_layer_requires_precise_raster(layer)
    line_paint = _paint(layer, "line")
    line_layout = _layout(layer, "line")
    fill_paint = _paint(layer, "fill")
    fallback_rgb = layer_hash_rgb(layer.to_dict(), salt="vector")

    line_color_value = line_paint.get("line-color")
    line_color = ((*fallback_rgb, 255)
                  if _is_style_expression(line_color_value)
                  else _parse_color(line_color_value, (*fallback_rgb, 255)))
    line_opacity_value = line_paint.get("line-opacity")
    line_opacity = (line_color[3] / 255.0
                    if _is_style_expression(line_opacity_value)
                    else _number(line_opacity_value, line_color[3] / 255.0))
    line_color = line_color[:3] + (
        max(0, min(255, int(round(line_opacity * 255.0)))),)

    width_px = getattr(layer, "width_px", None)
    if width_px is not None:
        line_width = max(1.0, float(width_px))
    elif line_paint.get("line-width") is not None and \
            not _is_style_expression(line_paint.get("line-width")):
        line_width = max(1.0, _number(line_paint.get("line-width"), 2.0))
    else:
        line_width = 2.0
    cap = str(line_layout.get("line-cap")
              or getattr(layer, "line_cap", "butt") or "butt").lower()
    join = str(line_layout.get("line-join")
               or getattr(layer, "line_join", "miter") or "miter").lower()
    miter_limit = _number(line_layout.get("line-miter-limit"), 4.0)
    dash = getattr(layer, "dash_array", None) or \
        line_paint.get("line-dasharray")

    fill_fallback_a = 160 if precise else 96
    fill_color_value = fill_paint.get("fill-color")
    fill_color = ((*fallback_rgb, fill_fallback_a)
                  if _is_style_expression(fill_color_value)
                  else _parse_color(fill_color_value,
                                    (*fallback_rgb, fill_fallback_a)))
    fill_opacity_value = fill_paint.get("fill-opacity")
    fill_opacity = (fill_color[3] / 255.0
                    if _is_style_expression(fill_opacity_value)
                    else _number(fill_opacity_value, fill_color[3] / 255.0))
    fill_color = fill_color[:3] + (
        max(0, min(255, int(round(fill_opacity * 255.0)))),)

    native_polygon_index = 0
    for feature in getattr(layer, "features", None) or ():
        geometry = feature.get("geometry") if isinstance(feature, dict) \
            else None
        if not isinstance(geometry, dict):
            continue
        properties = feature.get("properties") \
            if isinstance(feature.get("properties"), dict) else {}
        f_line = _feature_color(line_color_value, properties, line_color)
        f_line_op = _feature_number(line_opacity_value, properties,
                                    f_line[3] / 255.0)
        f_line = f_line[:3] + (
            max(0, min(255, int(round(f_line_op * 255.0)))),)
        f_width = line_width
        if width_px is None and _is_style_expression(
                line_paint.get("line-width")):
            f_width = max(1.0, _feature_number(
                line_paint.get("line-width"), properties, line_width))
        f_fill = _feature_color(fill_color_value, properties, fill_color)
        f_fill_op = _feature_number(fill_opacity_value, properties,
                                    f_fill[3] / 255.0)
        f_fill = f_fill[:3] + (
            max(0, min(255, int(round(f_fill_op * 255.0)))),)

        gtype = str(geometry.get("type", "")).lower()
        if gtype in ("polygon", "multipolygon"):
            # native route: vertices round-trip pixel -> NDC -> viewport
            # (map_scene.py:_pixel_to_ndc px/(dim-1)*2-1, rasterized at
            # (ndc+1)/2*dim), landing at px*dim/(dim-1)
            nsx = width / max(width - 1, 1)
            nsy = height / max(height - 1, 1)
            for polygon_rings in _geometry_polygon_rings(geometry):
                pixel_rings = [
                    [point_to_pixel(p, width, height) for p in ring]
                    for ring in polygon_rings if len(ring) >= 3]
                if not precise:
                    pixel_rings = [[(px * nsx, py * nsy)
                                    for px, py in ring]
                                   for ring in pixel_rings]
                if precise:
                    if f_fill[3] > 0:
                        blend_region(
                            image,
                            polygon_coverage(pixel_rings, width, height),
                            f_fill)
                    for ring_points in pixel_rings:
                        if ring_points and ring_points[0] != ring_points[-1]:
                            ring_points = [*ring_points, ring_points[0]]
                        if len(ring_points) >= 2:
                            draw_polyline(image, ring_points, f_line,
                                          width_px=f_width, cap=cap,
                                          join=join, dash_array=dash,
                                          miter_limit=miter_limit)
                else:
                    if f_fill[3] > 0:
                        blend_region_linear(
                            image,
                            polygon_coverage_hard(pixel_rings, width,
                                                  height),
                            np.asarray(f_fill[:3], np.float32) / 255.0,
                            f_fill[3] / 255.0)
                    # native route: ring outlines go through the OIT line
                    # pass, which the recipe goldens show stroking only
                    # the first polygon feature of the layer (choropleth
                    # golden: raw #0f172a outline on zone 0 only)
                    if native_polygon_index == 0:
                        for ring_points in pixel_rings:
                            if ring_points and \
                                    ring_points[0] != ring_points[-1]:
                                ring_points = [*ring_points,
                                               ring_points[0]]
                            # the GPU pass rasterizes with pixel centers
                            # at i+0.5; the software stroker samples the
                            # integer grid, so shift by -0.5
                            ring_points = [(px - 0.5, py - 0.5)
                                           for px, py in ring_points]
                            if len(ring_points) >= 2:
                                draw_polyline(image, ring_points, f_line,
                                              width_px=f_width, cap=cap,
                                              join=join,
                                              miter_limit=miter_limit,
                                              profile="smoothstep")
                    native_polygon_index += 1
            continue

        points = [point_to_pixel(p, width, height)
                  for p in _geometry_points(geometry)]
        if len(points) == 1:
            draw_pixel_block(image, points[0][0], points[0][1], f_line,
                             radius=max(1, int(round(f_width))))
        elif len(points) >= 2:
            draw_polyline(image, points, f_line, width_px=f_width,
                          cap=cap, join=join, dash_array=dash,
                          miter_limit=miter_limit)


def composite_vector_layer(image: np.ndarray, layer,
                           width: int, height: int) -> None:
    """Composite one VectorOverlayLayer whose coordinates follow the
    screen contract (fractions or pixels)."""
    if getattr(layer, "features", None):
        composite_vector_features(image, layer, width, height)
        return
    color = tuple(layer.color)
    if len(color) == 3:
        color = color + (1.0,)
    line_color = tuple(int(round(c * 255)) for c in color[:3]) + (
        int(round(float(color[3] if len(color) > 3 else 1.0)
                  * float(getattr(layer, "opacity", 1.0)) * 255)),)
    cap = str(getattr(layer, "line_cap", None) or "round").lower()
    join = str(getattr(layer, "line_join", None) or "round").lower()
    dash = getattr(layer, "dash_array", None)
    width_px = float(getattr(layer, "width", 1.0) or 1.0)
    if layer.kind == "polygons":
        rings = [[point_to_pixel_f(p, width, height) for p in ring]
                 for ring in layer.coordinates]
        # fills land in the linear scene pre-tonemap (see
        # blend_region_linear); strokes stay post-tonemap raw sRGB.
        # Coverage is HARD (pixel-center raster rule): the native fill
        # pass draws un-antialiased triangles.
        blend_region_linear(image,
                            polygon_coverage_hard(rings, width, height),
                            color[:3], float(color[3] if len(color) > 3
                                             else 1.0)
                            * float(getattr(layer, "opacity", 1.0)))
    elif layer.kind == "lines":
        pts = [point_to_pixel(p, width, height)
               for p in np.asarray(layer.coordinates, np.float64)]
        if len(pts) == 1:
            draw_pixel_block(image, pts[0][0], pts[0][1], line_color,
                             radius=max(1, int(round(width_px))))
        else:
            draw_polyline(image, pts, line_color, width_px=width_px,
                          cap=cap, join=join, dash_array=dash)
    else:  # points
        for p in np.asarray(layer.coordinates, np.float64):
            x, y = point_to_pixel(p, width, height)
            draw_pixel_block(image, x, y, line_color,
                             radius=max(1, int(round(width_px))))
