# forge3d_tpu_torch/vector — the vector overlay engine of the port.
#
# The port of forge3d_tpu/vector/__init__.py: the same add_points /
# add_lines / add_polygons / clear_vectors + render seam and the flat
# vector_render_* functions. render() runs every layer through kernel E4
# (vector/coverage.py:vector_layers: one launch for all the layers, the
# composite fused in) on `device`, "cuda" unless the caller asks for the CPU, and
# returns JAX's numpy planes: rgb (H,W,3) f32, alpha (H,W) f32, pick (H,W)
# i32. The dash walk and the payload parsing are the JAX package's host code.

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from .coverage import (  # noqa: F401
    DISC,
    POLYGON,
    STROKE,
    disc_coverage,
    disc_prims,
    polygon_coverage,
    ring_edges,
    stroke_coverage,
    vector_layer,
    vector_layers,
)


@dataclass
class _Layer:
    kind: str           # points|lines|polygons
    data: object
    color: Tuple[float, float, float]
    opacity: float
    width: float = 1.0  # stroke width / point radius
    pick_id: int = 0


def _dash_segments(pl: np.ndarray, dash: List[float]) -> np.ndarray:
    """Split a polyline into on-dash segments by arclength.

    dash = [on, off, on, off, ...] pixel lengths, cycled; the pattern
    phase runs continuously along the whole polyline."""
    period = float(sum(dash))
    if period <= 0:
        return np.concatenate([pl[:-1], pl[1:]], axis=1)
    # prefix pattern: intervals [start, end) that are "on" within a period
    ons = []
    acc = 0.0
    for i, d in enumerate(dash):
        if i % 2 == 0 and d > 0:
            ons.append((acc, acc + d))
        acc += d
    out = []
    s = 0.0                                   # arclength at segment start
    for a, b in zip(pl[:-1], pl[1:]):
        seg_len = float(np.hypot(*(b - a)))
        if seg_len <= 1e-9:
            continue
        dirv = (b - a) / seg_len
        # walk the dash pattern across this segment
        pos = 0.0
        while pos < seg_len - 1e-9:
            phase = (s + pos) % period
            # find the on-interval containing/after the phase
            nxt = None
            for o0, o1 in ons:
                if phase < o1:
                    nxt = (max(phase, o0), o1)
                    break
            if nxt is None:                   # rest of period is off
                pos += period - phase
                continue
            o0, o1 = nxt
            if phase < o0:                    # skip the off gap
                pos += o0 - phase
                phase = o0
            run = min(o1 - phase, seg_len - pos)
            p0 = a + dirv * pos
            p1 = a + dirv * (pos + run)
            out.append([p0[0], p0[1], p1[0], p1[1]])
            pos += run
        s += seg_len
    if not out:
        return np.zeros((0, 4), np.float32)
    return np.asarray(out, np.float32)


def _layer_prims(layer: _Layer) -> Tuple[int, np.ndarray]:
    """(E4 kind, (n, 4) float32 primitives) of a layer, as the JAX
    package's _layer_coverage hands them to its coverage functions."""
    if layer.kind == "points":
        return DISC, disc_prims(layer.data, np.full(len(layer.data), layer.width * 0.5))
    if layer.kind == "lines":
        return STROKE, np.ascontiguousarray(np.asarray(layer.data, np.float32).reshape(-1, 4))
    edges = ring_edges(layer.data)
    if len(edges) == 0:
        raise ValueError("need at least one array to concatenate")
    return POLYGON, edges


@dataclass
class VectorScene:
    """Retained vector overlay scene; render() produces an RGBA overlay and
    a pick-id map (reference: vector_render_oit_and_pick_py)."""

    layers: List[_Layer] = field(default_factory=list)
    _next_pick: int = 1

    def add_points(self, points, color=(1.0, 0.2, 0.1), size: float = 4.0,
                   opacity: float = 1.0) -> int:
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        pid = self._next_pick
        self._next_pick += 1
        self.layers.append(_Layer("points", pts, tuple(color), float(opacity),
                                  float(size), pid))
        return pid

    def add_lines(self, polyline, color=(0.1, 0.3, 0.9), width: float = 2.0,
                  opacity: float = 1.0, dash_array=None) -> int:
        """Add an AA polyline. dash_array=[on_px, off_px, ...] splits the
        stroke into dash segments by arclength (reference: the Mapbox GL
        line-dasharray semantics the CPU vector compositor honors)."""
        pl = np.asarray(polyline, np.float32).reshape(-1, 2)
        if len(pl) < 2:
            raise ValueError("polyline needs >= 2 vertices")
        segs = np.concatenate([pl[:-1], pl[1:]], axis=1)
        if dash_array:
            segs = _dash_segments(pl, [float(d) for d in dash_array])
        pid = self._next_pick
        self._next_pick += 1
        self.layers.append(_Layer("lines", segs, tuple(color), float(opacity),
                                  float(width), pid))
        return pid

    def add_polygons(self, rings, color=(0.2, 0.7, 0.3), opacity: float = 1.0) -> int:
        rings = [np.asarray(r, np.float32).reshape(-1, 2) for r in rings]
        pid = self._next_pick
        self._next_pick += 1
        self.layers.append(_Layer("polygons", rings, tuple(color),
                                  float(opacity), 0.0, pid))
        return pid

    def clear_vectors(self) -> None:
        self.layers.clear()
        self._next_pick = 1

    def render_tensors(self, width: int, height: int, base_rgb=None, *, device="cuda"):
        """Composite all layers on `device`: (rgb (H,W,3) f32, alpha (H,W)
        f32, pick (H,W) int32) tensors there. `base_rgb` may be a tensor
        (used in place when it is a contiguous float32 one on `device`)."""
        from ..pt.terrain_ref import resolve_device

        dev = resolve_device(device)
        if base_rgb is None:
            rgb = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
        elif isinstance(base_rgb, torch.Tensor):
            rgb = base_rgb.to(device=dev, dtype=torch.float32).contiguous()
        else:
            rgb = torch.tensor(np.asarray(base_rgb, np.float32), device=dev)
        if tuple(rgb.shape) != (height, width, 3):
            raise ValueError(f"base_rgb must be ({height}, {width}, 3), got {tuple(rgb.shape)}")
        alpha = torch.zeros((height, width), dtype=torch.float32, device=dev)
        pick = torch.zeros((height, width), dtype=torch.int32, device=dev)
        vector_layers([(*_layer_prims(layer), dict(stroke_width=layer.width, color=layer.color,
                                                   opacity=layer.opacity, pick_id=layer.pick_id))
                       for layer in self.layers], width, height, rgb=rgb, alpha=alpha, pick=pick)
        return rgb, alpha, pick

    def render(self, width: int, height: int,
               base_rgb: Optional[np.ndarray] = None, *, device="cuda"):
        """Composite all layers. Returns (rgb (H,W,3) f32, alpha (H,W) f32,
        pick (H,W) int32) numpy arrays."""
        rgb, alpha, pick = self.render_tensors(width, height, base_rgb, device=device)
        return rgb.cpu().numpy(), alpha.cpu().numpy(), pick.cpu().numpy()

    def pick_at(self, pick_map: np.ndarray, x: int, y: int) -> int:
        return int(pick_map[int(y), int(x)])


def _straight(rgb, alpha) -> np.ndarray:
    safe = np.maximum(alpha, 1e-6)[..., None]
    straight = np.where(alpha[..., None] > 0, rgb / safe, 0.0)
    return np.concatenate([straight, alpha[..., None]], axis=-1)


def render_overlay_rgba(scene: VectorScene, width: int, height: int, *,
                        device="cuda") -> np.ndarray:
    """Overlay as straight-alpha RGBA float32 (H, W, 4)."""
    rgb, alpha, _ = scene.render(width, height, device=device)
    return _straight(rgb, alpha).astype(np.float32)


# ---------------------------------------------------------------------------
# Flat functional render surface (reference py_functions/vector parity:
# vector_render_oit_py / vector_render_oit_edl_py — width/height + point
# and polyline payloads -> RGBA u8 overlay).
# ---------------------------------------------------------------------------

def _scene_from_payload(points_xy=None, point_rgba=None, point_size=None,
                        polylines=None, polyline_rgba=None,
                        stroke_width=None) -> "VectorScene":
    vs = VectorScene()
    if points_xy:
        pts = np.asarray(points_xy, np.float64)
        rgba = list(point_rgba or [])
        sizes = list(point_size or [])
        for i in range(len(pts)):
            c = rgba[i] if i < len(rgba) else (1.0, 0.4, 0.1, 1.0)
            s = sizes[i] if i < len(sizes) else 4.0
            vs.add_points(pts[i:i + 1], color=tuple(c[:3]),
                          size=float(s), opacity=float(c[3]) if len(c) > 3
                          else 1.0)
    for k, pl in enumerate(polylines or ()):
        c = (polyline_rgba[k] if polyline_rgba and k < len(polyline_rgba)
             else (0.9, 0.9, 0.9, 1.0))
        w = (stroke_width[k] if stroke_width and k < len(stroke_width)
             else 2.0)
        vs.add_lines(np.asarray(pl, np.float64), color=tuple(c[:3]),
                     width=float(w),
                     opacity=float(c[3]) if len(c) > 3 else 1.0)
    return vs


def _to_u8(x) -> np.ndarray:
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def vector_render_oit(width: int, height: int, *, points_xy=None,
                      point_rgba=None, point_size=None, polylines=None,
                      polyline_rgba=None, stroke_width=None, device="cuda") -> np.ndarray:
    """Order-independent composite of points + polylines -> RGBA u8."""
    vs = _scene_from_payload(points_xy, point_rgba, point_size,
                             polylines, polyline_rgba, stroke_width)
    return _to_u8(render_overlay_rgba(vs, width, height, device=device))


def vector_render_oit_edl(width: int, height: int, *, edl_strength=1.5,
                          edl_radius_px=1.0, device="cuda", **payload) -> np.ndarray:
    """OIT render with eye-dome-lighting: isolated splats darken by the
    local alpha falloff (reference EDL point shading)."""
    vs = _scene_from_payload(**payload)
    rgb, alpha, _ = vs.render(width, height, device=device)
    r = max(int(round(edl_radius_px)), 1)
    pad = np.pad(alpha, r, mode="edge")
    neigh = np.zeros_like(alpha)
    for dy, dx in ((-r, 0), (r, 0), (0, -r), (0, r)):
        neigh += pad[r + dy:r + dy + alpha.shape[0],
                     r + dx:r + dx + alpha.shape[1]]
    occl = np.clip((alpha - neigh / 4.0) * float(edl_strength), 0.0, 1.0)
    rgb = rgb * (1.0 - occl[..., None])
    return _to_u8(_straight(rgb, alpha))


def vector_render_pick_map(width: int, height: int, *, device="cuda",
                           **payload) -> np.ndarray:
    """Pick-ID map of the payload (0 = background)."""
    vs = _scene_from_payload(**payload)
    _, _, pick = vs.render(width, height, device=device)
    return pick


def vector_render_oit_and_pick(width: int, height: int, *, device="cuda", **payload):
    vs = _scene_from_payload(**payload)
    rgb, alpha, pick = vs.render(width, height, device=device)
    return _to_u8(_straight(rgb, alpha)), pick
