# forge3d_tpu_torch/brdf.py
# The offscreen BRDF tile harness and debug pattern frames of
# forge3d_tpu/brdf.py: a roughness x metallic sphere gallery rendered
# through the sphere engine P1, its override checks, and a deterministic
# numpy test pattern.

from __future__ import annotations

import numpy as np

__all__ = ["render_brdf_tile", "render_brdf_tile_overrides",
           "render_debug_pattern_frame"]


def render_brdf_tile(tile_px: int = 96, rows: int = 4, cols: int = 6, *,
                     albedo=(0.8, 0.2, 0.2), anisotropy: float = 0.0,
                     seed: int = 1, device="cuda") -> np.ndarray:
    """Sphere gallery: roughness sweeps across columns, metallic down rows
    (reference seam: render_brdf_tile). Returns (rows*tile, cols*tile, 4),
    rendered by P1 on `device`, the card unless device="cpu"."""
    from .pt.megakernel import pt_render_gpu

    W, H = cols * tile_px, rows * tile_px
    scene = []
    for r in range(rows):
        metallic = r / max(rows - 1, 1)
        for c in range(cols):
            rough = 0.05 + 0.9 * c / max(cols - 1, 1)
            # grid in camera space: x right, y up
            x = (c - (cols - 1) / 2) * 2.4
            y = ((rows - 1) / 2 - r) * 2.4 + 1.0
            scene.append({
                "center": (x, y, 0.0), "radius": 1.0,
                "albedo": tuple(albedo), "metallic": metallic,
                "roughness": rough,
                "ax": max(rough * (1 + anisotropy), 1e-3),
                "ay": max(rough * (1 - anisotropy), 1e-3),
            })
    cam = {"origin": (0.0, 1.0, max(rows, cols) * 2.6),
           "look_at": (0.0, 1.0, 0.0), "fov_y": 40.0}
    return pt_render_gpu(W, H, scene, cam, seed=seed, device=device)


def render_brdf_tile_overrides(overrides: dict, **kw) -> np.ndarray:
    """Gallery with per-parameter overrides dict (reference seam:
    render_brdf_tile_overrides)."""
    allowed = {"tile_px", "rows", "cols", "albedo", "anisotropy", "seed"}
    bad = set(overrides) - allowed
    if bad:
        raise ValueError(f"unknown BRDF tile overrides: {sorted(bad)}")
    return render_brdf_tile(**{**overrides, **kw})


def render_debug_pattern_frame(width: int = 256, height: int = 256, *,
                               kind: str = "gradient_checker") -> np.ndarray:
    """Deterministic debug pattern (reference seam:
    render_debug_pattern_frame): gradient + checker + color ramps, used by
    pipeline plumbing tests (byte-stable across platforms)."""
    W, H = int(width), int(height)
    y, x = np.mgrid[0:H, 0:W]
    out = np.zeros((H, W, 4), np.uint8)
    if kind == "gradient_checker":
        checker = (((x // 16) + (y // 16)) % 2).astype(np.float64)
        out[..., 0] = (x / max(W - 1, 1) * 255).astype(np.uint8)
        out[..., 1] = (y / max(H - 1, 1) * 255).astype(np.uint8)
        out[..., 2] = (checker * 255).astype(np.uint8)
    elif kind == "ramps":
        band = (y * 4) // max(H, 1)
        ramp = (x / max(W - 1, 1) * 255).astype(np.uint8)
        out[..., 0] = np.where(band % 4 == 0, ramp, 0)
        out[..., 1] = np.where(band % 4 == 1, ramp, 0)
        out[..., 2] = np.where(band % 4 == 2, ramp, 0)
        gray = np.where(band % 4 == 3, ramp, 0)
        out[..., 0] |= gray
        out[..., 1] |= gray
        out[..., 2] |= gray
    else:
        raise ValueError(f"unknown debug pattern {kind!r}")
    out[..., 3] = 255
    return out
