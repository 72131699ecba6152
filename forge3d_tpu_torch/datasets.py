# forge3d_tpu_torch/datasets.py
# A host copy of forge3d_tpu/datasets.py for the PyTorch port (the named
# DEM registry and fetch_dem, over the port's gis/geotiff.py): the port
# imports no module of the JAX package, so it keeps its own copy, held
# against the original by tests/test_torch_host_copies.py. The original's
# notes follow.
#
# Dataset registry: fetch_dem + bundled boundaries.
#
# Parity notes (reference behavior, not code):
# forge3d:python/forge3d/datasets.py fetches named DEMs
# (`fetch_dem("rainier")`) through pooch with checksum pinning, plus a
# bundled mini DEM for offline runs. This build runs in zero-egress
# environments, so named DEMs are deterministic procedural landforms
# modeled after the real sites (volcano / canyon / ridge / dunes), cached
# as GeoTIFF under FORGE3D_DATA_DIR (default ~/.cache/forge3d_tpu).
# Remote URLs are supported when the environment has network access;
# checksums are still enforced.

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from .gis.geotiff import read_raster, write_raster

__all__ = ["fetch_dem", "dataset_names", "data_dir", "mini_dem",
           "dataset_info"]


def data_dir() -> Path:
    d = os.environ.get("FORGE3D_DATA_DIR")
    p = Path(d) if d else Path.home() / ".cache" / "forge3d_tpu"
    p.mkdir(parents=True, exist_ok=True)
    return p


def _fbm(shape, seed, octaves=6, base_freq=3.0, gain=0.5):
    """Deterministic fractal value noise."""
    rng = np.random.default_rng(seed)
    H, W = shape
    out = np.zeros(shape, np.float64)
    amp = 1.0
    for o in range(octaves):
        freq = base_freq * (2 ** o)
        gh, gw = int(freq) + 2, int(freq) + 2
        grid = rng.normal(0, 1, (gh, gw))
        yy = np.linspace(0, gh - 1.001, H)
        xx = np.linspace(0, gw - 1.001, W)
        y0 = np.floor(yy).astype(int)
        x0 = np.floor(xx).astype(int)
        fy = (yy - y0)[:, None]
        fx = (xx - x0)[None, :]
        sy = fy * fy * (3 - 2 * fy)
        sx = fx * fx * (3 - 2 * fx)
        v = (grid[np.ix_(y0, x0)] * (1 - sy) * (1 - sx)
             + grid[np.ix_(y0, x0 + 1)] * (1 - sy) * sx
             + grid[np.ix_(y0 + 1, x0)] * sy * (1 - sx)
             + grid[np.ix_(y0 + 1, x0 + 1)] * sy * sx)
        out += amp * v
        amp *= gain
    return out


def _volcano(n: int, seed: int) -> np.ndarray:
    """Stratovolcano (Rainier-like): tall cone, crater, glacial valleys."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) / (n - 1) - 0.5
    r = np.hypot(x, y)
    cone = 2800.0 * np.exp(-(r * 3.2) ** 1.6)
    crater = -600.0 * np.exp(-(r * 22.0) ** 2)
    theta = np.arctan2(y, x)
    valleys = -180.0 * np.maximum(np.cos(theta * 7 + 1.3), 0.0) ** 3 \
        * np.exp(-(r * 2.0) ** 2) * (r * 4)
    rough = 120.0 * _fbm((n, n), seed, octaves=7, base_freq=5.0)
    base = 800.0 + 300.0 * _fbm((n, n), seed + 1, octaves=4, base_freq=2.0)
    return (base + cone + crater + valleys + rough * (0.3 + r)).astype(np.float32)


def _canyon(n: int, seed: int) -> np.ndarray:
    """Incised canyon (Grand-Canyon-like): meandering gorge in a plateau."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) / (n - 1)
    plateau = 2100.0 + 120.0 * _fbm((n, n), seed, octaves=5, base_freq=3.0)
    meander = 0.5 + 0.22 * np.sin(x * 9.0) * np.sin(x * 3.1 + 1.0)
    d = np.abs(y - meander)
    gorge = -1500.0 * np.exp(-(d * 9.0) ** 2)
    terraces = 140.0 * np.sin(np.clip(d * 9.0, 0, 3.0) * 6.0) \
        * np.exp(-(d * 6.0) ** 2)
    return (plateau + gorge + terraces).astype(np.float32)


def _ridge(n: int, seed: int) -> np.ndarray:
    """Alpine ridge line with cirques."""
    base = 1500.0 + 900.0 * np.abs(_fbm((n, n), seed, octaves=8,
                                        base_freq=3.0, gain=0.55))
    return base.astype(np.float32)


def _dunes(n: int, seed: int) -> np.ndarray:
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) / (n - 1)
    waves = 40.0 * np.abs(np.sin(x * 28.0 + 4.0 * _fbm((n, n), seed, 4, 2.0)))
    return (600.0 + waves + 10.0 * _fbm((n, n), seed + 2, 4, 6.0)).astype(np.float32)


_REGISTRY: Dict[str, dict] = {
    "rainier": {"maker": _volcano, "size": 1024, "seed": 14410,
                "bounds": (-121.92, 46.75, -121.60, 46.95), "crs": "EPSG:4326",
                "description": "Stratovolcano DEM (Mt. Rainier analogue)"},
    "grand_canyon": {"maker": _canyon, "size": 1024, "seed": 2600,
                     "bounds": (-112.30, 36.00, -111.90, 36.25),
                     "crs": "EPSG:4326",
                     "description": "Incised canyon DEM"},
    "alps_ridge": {"maker": _ridge, "size": 1024, "seed": 4807,
                   "bounds": (6.80, 45.80, 7.05, 45.95), "crs": "EPSG:4326",
                   "description": "Alpine ridge DEM"},
    "dunes": {"maker": _dunes, "size": 512, "seed": 77,
              "bounds": (-6.30, 31.10, -6.10, 31.25), "crs": "EPSG:4326",
              "description": "Sand dune field DEM"},
    "mini": {"maker": _ridge, "size": 129, "seed": 3,
             "bounds": (0.0, 0.0, 0.1, 0.1), "crs": "EPSG:4326",
             "description": "Tiny bundled DEM for tests"},
}


def dataset_names() -> list:
    return sorted(_REGISTRY)


def dataset_info(name: str) -> dict:
    try:
        e = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; available: "
                       f"{', '.join(dataset_names())}") from None
    return {"name": name, "size": e["size"], "bounds": e["bounds"],
            "crs": e["crs"], "description": e["description"]}


def fetch_dem(name: str = "rainier", *, size: Optional[int] = None,
              cache: bool = True) -> Tuple[np.ndarray, dict]:
    """Fetch a named DEM; returns (heights f32 (H, W), info dict).

    Reference seam: fetch_dem (datasets.py). Deterministic per
    (name, size); cached as GeoTIFF under data_dir(). The cached file's
    SHA-256 is checked on reuse (corrupt cache regenerates).
    """
    info = dataset_info(name)
    e = _REGISTRY[name]
    n = int(size or e["size"])
    info["size"] = n  # reflect a size= override so dem_spacing stays correct
    path = data_dir() / f"{name}_{n}.tif"
    digest_path = data_dir() / f"{name}_{n}.sha256"
    if cache and path.exists() and digest_path.exists():
        want = digest_path.read_text().strip()
        got = hashlib.sha256(path.read_bytes()).hexdigest()
        if want == got:
            arr = read_raster(path)
            return np.asarray(arr, np.float32), {**info, "path": str(path),
                                                 "cached": True}
        path.unlink()  # corrupt cache regenerates
    dem = e["maker"](n, e["seed"])
    west, south, east, north = e["bounds"]
    # rasterio-convention affine: (xres, 0, west, 0, -yres, north)
    write_raster(path, dem,
                 transform=((east - west) / n, 0.0, west,
                            0.0, -(north - south) / n, north),
                 crs=e["crs"])
    digest_path.write_text(hashlib.sha256(path.read_bytes()).hexdigest())
    return dem, {**info, "path": str(path), "cached": False}


def mini_dem() -> np.ndarray:
    """The bundled tiny DEM (always available, no cache required)."""
    e = _REGISTRY["mini"]
    return e["maker"](e["size"], e["seed"])


def dem_spacing(info: dict) -> Tuple[float, float]:
    """Meters-per-pixel (sx, sz) for a fetched DEM's geographic bounds —
    pass as `spacing=` to the renderers so heights and extent share units."""
    import math

    w, s, e, n = info["bounds"]
    # size from the fetched raster itself (fetch_dem records any size=
    # override in info["size"]); registry default only as a last resort
    size = info.get("size") or _REGISTRY[info["name"]]["size"]
    if "path" in info:
        try:
            from .gis.geotiff import raster_info

            ri = raster_info(info["path"])
            return (abs(ri.transform[0]) * 111320
                    * math.cos(math.radians((s + n) / 2)),
                    abs(ri.transform[4]) * 110540)
        except Exception:  # noqa: BLE001 — fall through to bounds math
            pass
    sx = (e - w) * 111320 * math.cos(math.radians((s + n) / 2)) / size
    sz = (n - s) * 110540 / size
    return (sx, sz)
