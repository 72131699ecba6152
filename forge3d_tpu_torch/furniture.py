# forge3d_tpu_torch/furniture.py
# A host copy of forge3d_tpu/furniture.py for the PyTorch port: the port
# imports no module of the JAX package, so it keeps its own copy, held against
# the original by tests/test_torch_host_copies.py. The original's notes
# follow.
#
# Cartographic map furniture: legend, scale bar, north arrow, graticule,
# title plate — host-side compositing onto rendered frames.
#
# Parity notes (reference behavior, not code):
#   forge3d:python/forge3d/{legend,scale_bar,north_arrow,graticule,
#   map_plate}.py — deterministic raster furniture composited after the
#   native render in MapScene.
#
# Text uses PIL's bundled bitmap font (version-pinned in the image) until
# the MSDF text stack lands; all drawing is plain numpy alpha compositing.

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import colormaps


def _text_mask(text: str, scale: int = 1) -> np.ndarray:
    """Rasterize text to a float alpha mask via PIL's default font."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    dummy = Image.new("L", (1, 1))
    d = ImageDraw.Draw(dummy)
    bbox = d.textbbox((0, 0), text, font=font)
    w = max(1, bbox[2] - bbox[0])
    h = max(1, bbox[3] - bbox[1])
    img = Image.new("L", (w + 2, h + 2), 0)
    d = ImageDraw.Draw(img)
    d.text((1 - bbox[0], 1 - bbox[1]), text, fill=255, font=font)
    mask = np.asarray(img, np.float32) / 255.0
    if scale > 1:
        mask = np.kron(mask, np.ones((scale, scale), np.float32))
    return mask


def _blend(dst: np.ndarray, src_rgb, alpha: np.ndarray, x: int, y: int) -> None:
    """In-place source-over of a colored alpha mask at (x, y) on (H,W,3/4)."""
    H, W = dst.shape[:2]
    h, w = alpha.shape
    x0, y0 = max(0, x), max(0, y)
    x1, y1 = min(W, x + w), min(H, y + h)
    if x1 <= x0 or y1 <= y0:
        return
    a = alpha[y0 - y:y1 - y, x0 - x:x1 - x, None]
    region = dst[y0:y1, x0:x1, :3].astype(np.float32)
    col = np.asarray(src_rgb, np.float32) * (255.0 if dst.dtype == np.uint8 else 1.0)
    out = region * (1 - a) + col * a
    dst[y0:y1, x0:x1, :3] = out.astype(dst.dtype)


@dataclass
class LegendSpec:
    colormap: str = "viridis"
    vmin: float = 0.0
    vmax: float = 1.0
    label: str = ""
    units: str = ""
    width: int = 22
    height: int = 140
    ticks: int = 5


def draw_legend(frame: np.ndarray, spec: LegendSpec, x: int, y: int) -> None:
    """Draw a vertical colormap legend with tick labels onto the frame.
    The bar shrinks (and shifts) to fit small frames."""
    lut = colormaps.get_lut(spec.colormap)
    H, W = frame.shape[:2]
    h = min(spec.height, max(8, H - 24))
    w = min(spec.width, max(4, W - 30))
    y = min(max(y, 12), max(0, H - h - 8))
    x = min(max(x, 2), max(0, W - w - 4))
    t = np.linspace(1.0, 0.0, h)[:, None]
    idx = (t * (len(lut) - 1)).astype(int)
    bar = lut[idx][:, 0, :].reshape(h, 1, 3).repeat(w, axis=1)
    # frame border
    _blend(frame, (1, 1, 1), np.ones((h + 4, w + 4), np.float32) * 0.85,
           x - 2, y - 2)
    scale = 255.0 if frame.dtype == np.uint8 else 1.0
    frame[y:y + h, x:x + w, :3] = (bar * scale).astype(frame.dtype)
    for i in range(spec.ticks):
        frac = i / (spec.ticks - 1)
        val = spec.vmax + (spec.vmin - spec.vmax) * frac
        ty = y + int(frac * (h - 1))
        _blend(frame, (0, 0, 0), _text_mask(f"{val:g}"), x + w + 4, ty - 4)
    if spec.label:
        _blend(frame, (0, 0, 0), _text_mask(spec.label), x - 2, y - 14)


@dataclass
class ScaleBarSpec:
    meters_per_pixel: float = 1.0
    max_width_px: int = 160
    units: str = "m"


def _nice_length(meters: float) -> float:
    """Largest 1/2/5*10^k value <= meters."""
    if meters <= 0:
        return 1.0
    exp = np.floor(np.log10(meters))
    for m in (5.0, 2.0, 1.0):
        v = m * 10.0**exp
        if v <= meters:
            return v
    return 10.0 ** (exp - 1) * 5.0


def draw_scale_bar(frame: np.ndarray, spec: ScaleBarSpec, x: int, y: int) -> None:
    max_m = spec.max_width_px * spec.meters_per_pixel
    nice_m = _nice_length(max_m)
    px = int(round(nice_m / spec.meters_per_pixel))
    if nice_m >= 1000 and spec.units == "m":
        label = f"{nice_m / 1000:g} km"
    else:
        label = f"{nice_m:g} {spec.units}"
    # alternating black/white segments
    segs = 4
    seg = max(1, px // segs)
    _blend(frame, (1, 1, 1), np.ones((10, px + 4), np.float32) * 0.8, x - 2, y - 2)
    for i in range(segs):
        col = (0, 0, 0) if i % 2 == 0 else (1, 1, 1)
        _blend(frame, col, np.ones((6, seg), np.float32), x + i * seg, y)
    _blend(frame, (0, 0, 0), _text_mask(label), x, y + 9)


def draw_north_arrow(frame: np.ndarray, x: int, y: int, size: int = 28,
                     rotation_deg: float = 0.0) -> None:
    """Classic split north arrow + 'N'."""
    s = size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    cx = cy = (s - 1) / 2.0
    ux = xx - cx
    uy = yy - cy
    if rotation_deg:
        r = np.radians(rotation_deg)
        ux, uy = ux * np.cos(r) - uy * np.sin(r), ux * np.sin(r) + uy * np.cos(r)
    half = s * 0.42
    inside = (np.abs(ux) <= (half - (-uy)) * 0.35) & (uy <= half * 0.35) & (-uy <= half)
    left = inside & (ux <= 0)
    right = inside & (ux > 0)
    _blend(frame, (0, 0, 0), left.astype(np.float32), x, y)
    _blend(frame, (0.95, 0.95, 0.95), right.astype(np.float32) * 0.9, x, y)
    _blend(frame, (0, 0, 0), _text_mask("N"), x + s // 2 - 3, y + s + 2)


@dataclass
class GraticuleSpec:
    """Lat/lon (or world-unit) grid lines over the frame."""

    spacing: float = 10.0            # in world units along each axis
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    opacity: float = 0.35
    label: bool = True


def draw_graticule(frame: np.ndarray, spec: GraticuleSpec,
                   world_bounds: Tuple[float, float, float, float]) -> None:
    """Draw grid lines for world_bounds=(minx, miny, maxx, maxy) mapped
    linearly onto the frame."""
    H, W = frame.shape[:2]
    minx, miny, maxx, maxy = world_bounds
    if maxx <= minx or maxy <= miny:
        raise ValueError("invalid world bounds")
    col = spec.color
    a = spec.opacity

    x0 = np.ceil(minx / spec.spacing) * spec.spacing
    xs = np.arange(x0, maxx + 1e-9, spec.spacing)
    for wx in xs:
        px = int((wx - minx) / (maxx - minx) * (W - 1))
        _blend(frame, col, np.full((H, 1), a, np.float32), px, 0)
        if spec.label:
            _blend(frame, col, _text_mask(f"{wx:g}"), px + 2, 2)
    y0 = np.ceil(miny / spec.spacing) * spec.spacing
    for wy in np.arange(y0, maxy + 1e-9, spec.spacing):
        py = int((maxy - wy) / (maxy - miny) * (H - 1))
        _blend(frame, col, np.full((1, W), a, np.float32), 0, py)
        if spec.label:
            _blend(frame, col, _text_mask(f"{wy:g}"), 2, py + 2)


def draw_title_plate(frame: np.ndarray, title: str, subtitle: str = "",
                     scale: int = 2) -> None:
    """Title along the top edge (reference: map_plate.py): centered dark
    text with a light halo; a full-width plate band only on large frames."""
    W = frame.shape[1]
    mask = _text_mask(title, scale=scale)
    h = mask.shape[0] + (14 if subtitle else 6)
    if W >= 400:
        _blend(frame, (1, 1, 1),
               np.full((h + 8, W), 0.65, np.float32), 0, 0)
    x = max(2, (W - mask.shape[1]) // 2)
    # halo: dilated mask underneath
    halo = np.minimum(1.0, (
        np.pad(mask, 1)[:-2, 1:-1] + np.pad(mask, 1)[2:, 1:-1]
        + np.pad(mask, 1)[1:-1, :-2] + np.pad(mask, 1)[1:-1, 2:] + mask))
    _blend(frame, (0.95, 0.96, 0.97), halo * 0.85, x, 3)
    _blend(frame, (0.08, 0.1, 0.12), mask, x, 3)
    if subtitle:
        sub = _text_mask(subtitle)
        _blend(frame, (0.15, 0.15, 0.15), sub,
               max(2, (W - sub.shape[1]) // 2), 6 + mask.shape[0])
