# forge3d_tpu_torch/pt/path_tracer.py
# The PathTracer facade of forge3d_tpu/pt/path_tracer.py over the sphere
# engine P1 (pt/megakernel.py): both render_rgba overloads (the engine,
# with the luminance/firefly clamp, or the synthetic image behind the
# ExperimentalSyntheticOutput gate), render_aovs, build_bvh -> BvhHandle,
# iter_tiles and save_aovs (EXR or PNG per plane). Host code around the
# engine; the engine runs on the tracer's device, the card unless
# device="cpu".

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from ..errors import ExperimentalSyntheticOutput
from .megakernel import AOV_NAMES, pt_render_aovs, pt_render_gpu


def _require_synthetic_ok(synthetic_ok: bool, api: str) -> None:
    if not synthetic_ok:
        raise ExperimentalSyntheticOutput(
            f"{api} produces synthetic (non-path-traced) output; "
            "pass synthetic_ok=True to opt in."
        )


@dataclass(frozen=True)
class BvhHandle:
    """Opaque BVH handle (host-built; traversal lands with the mesh PT)."""

    triangle_count: int
    node_count: int
    world_aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]]
    build_stats: dict

    def __repr__(self) -> str:  # keep reprs stable for logging/tests
        return (
            f"BvhHandle(tris={self.triangle_count}, nodes={self.node_count})"
        )


def iter_tiles(width: int, height: int, tile: int = 64) -> Iterator[Tuple[int, int, int, int]]:
    """Deterministic row-major (x, y, w, h) tiles
    (reference: path_tracing.py:618)."""
    if tile <= 0:
        raise ValueError("tile must be positive")
    for y in range(0, height, tile):
        for x in range(0, width, tile):
            yield (x, y, min(tile, width - x), min(tile, height - y))


def _luminance_clamp(rgb: np.ndarray, clamp: float) -> np.ndarray:
    lum = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    scale = np.where(lum > clamp, clamp / np.maximum(lum, 1e-8), 1.0).astype(np.float32)
    return rgb * scale[..., None]


class PathTracer:
    """User-facing path tracer facade.

    >>> pt = PathTracer(128, 128)
    >>> img = pt.render_rgba(128, 128, scene=[{"center": (0, 1, 0),
    ...     "radius": 1.0}], camera={"origin": (0, 1.2, 3)}, use_gpu=True)
    """

    def __init__(self, width: int = 512, height: int = 512, *, seed: int = 1,
                 cache: bool = False, device="cuda"):
        from .terrain_ref import resolve_device

        self.device = resolve_device(device)
        self._width = int(width)
        self._height = int(height)
        self._seed = int(seed)
        self._cache_enabled = bool(cache)
        self._cache: dict = {}

    # -- rendering ---------------------------------------------------------
    def render_rgba(self, *args, spp: int = 1, **kwargs) -> np.ndarray:
        """Render RGBA.

        Overloads (reference contract):
          render_rgba(spp=..., synthetic_ok=True) — internal size, synthetic
          render_rgba(w, h, scene=..., camera=..., seed=..., frames=...,
                      use_gpu=True, luminance_clamp=...) — megakernel path
        """
        use_gpu = bool(kwargs.pop("use_gpu", True))
        synthetic_ok = bool(kwargs.pop("synthetic_ok", False))

        if len(args) >= 2:
            width, height = int(args[0]), int(args[1])
            scene = kwargs.get("scene") or []
            camera = kwargs.get("camera") or {}
            seed = int(kwargs.get("seed", self._seed))
            frames = int(kwargs.get("frames", 1))
            clamp = kwargs.get("luminance_clamp", kwargs.get("firefly_clamp"))
            if use_gpu:
                out = pt_render_aovs(width, height, scene, camera,
                                     seed=seed, frames=frames, aovs=(), device=self.device)
                rgba = out["rgba"]
                if clamp is not None and float(clamp) > 0:
                    rgb = rgba[..., :3].astype(np.float32) / 255.0
                    rgb = _luminance_clamp(rgb, float(clamp))
                    rgba = rgba.copy()
                    rgba[..., :3] = (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)
                return rgba
            _require_synthetic_ok(synthetic_ok, "PathTracer.render_rgba")
            return self._synthetic_rgba(width, height, seed, frames, clamp)

        _require_synthetic_ok(synthetic_ok, "PathTracer.render_rgba")
        return self._synthetic_rgba(self._width, self._height, self._seed, max(1, spp), None)

    def render_aovs(self, width: int, height: int, scene=None, camera=None, *,
                    aovs=AOV_NAMES, seed: int = 1, frames: int = 1) -> dict:
        """Megakernel render returning the requested AOV planes."""
        return pt_render_aovs(width, height, scene or [], camera or {},
                              seed=seed, frames=frames, aovs=tuple(aovs), device=self.device)

    def _synthetic_rgba(self, width, height, seed, frames, clamp) -> np.ndarray:
        """Deterministic synthetic gradient+noise image (the reference's CPU
        fallback contract; used by API-shape tests without hardware)."""
        key = (width, height, seed, frames)
        accum = self._cache.get(key) if self._cache_enabled else None
        if accum is None:
            y = np.linspace(0, 1, height, dtype=np.float32)[:, None]
            x = np.linspace(0, 1, width, dtype=np.float32)[None, :]
            base = np.clip(0.25 + 0.375 * (x + y), 0.0, 1.0)
            accum = np.zeros((height, width, 3), np.float32)
            for f in range(max(1, frames)):
                rng = np.random.default_rng(seed + f)
                noise = rng.normal(0.0, 0.08, size=(height, width, 3)).astype(np.float32)
                accum += np.clip(base[..., None] + noise, 0.0, 1.0)
            accum = accum / float(max(1, frames))
            if self._cache_enabled:
                self._cache[key] = accum
        rgb = accum
        if clamp is not None and float(clamp) > 0:
            rgb = _luminance_clamp(rgb, float(clamp))
        rgba = np.empty((height, width, 4), np.uint8)
        rgba[..., :3] = (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)
        rgba[..., 3] = 255
        return rgba

    # -- geometry ----------------------------------------------------------
    def build_bvh(self, vertices: np.ndarray, indices: np.ndarray) -> BvhHandle:
        """Build a SAH BVH over triangles; returns an opaque handle."""
        from ..ops.bvh import build_sah_bvh

        bvh = build_sah_bvh(np.asarray(vertices, np.float32),
                            np.asarray(indices, np.uint32))
        return BvhHandle(
            triangle_count=bvh.triangle_count,
            node_count=bvh.node_count,
            world_aabb=bvh.world_aabb,
            build_stats=bvh.stats,
        )

    def iter_tiles(self, width: Optional[int] = None, height: Optional[int] = None,
                   tile: int = 64):
        return iter_tiles(width or self._width, height or self._height, tile)


# Reference-parity module-level seams.
_pt_render_gpu = pt_render_gpu
render_aovs = pt_render_aovs


def save_aovs(path_prefix, aovs: dict, *, format: str = "exr") -> list:
    """Write AOV planes to disk (reference seam: save_aovs,
    path_tracing.py:512-722): one EXR (or PNG for u8) per AOV named
    `<prefix>_<aov>.<ext>`. Returns the written paths."""
    from ..io.formats import numpy_to_exr
    from ..io.image import numpy_to_png

    written = []
    for name, plane in aovs.items():
        arr = np.asarray(plane)
        if format == "exr" and arr.dtype != np.uint8:
            p = f"{path_prefix}_{name}.exr"
            numpy_to_exr(p, arr.astype(np.float32))
        else:
            p = f"{path_prefix}_{name}.png"
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255 + 0.5).astype(np.uint8)
            if arr.ndim == 3 and arr.shape[2] == 3:
                arr = np.concatenate(
                    [arr, np.full((*arr.shape[:2], 1), 255, np.uint8)], -1)
            numpy_to_png(p, arr)
        written.append(p)
    return written
