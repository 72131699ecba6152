# forge3d_tpu_torch/gis/osm.py
# A host copy of forge3d_tpu/gis/osm.py for the PyTorch port (the Terrarium
# DEM codec the wildfire-smoke path reads its DEM through, and the OSM
# helpers beside it): the port imports no module of the JAX package, so it
# keeps its own copy, held against the original by
# tests/test_torch_host_copies.py. The original's notes follow.
#
# OSM feature parsing/query + Terrarium DEM tile codec.
#
# Parity notes (reference behavior, not code): the reference registers
# parse_osm_features_py, query_osm_features_py, prepare_osm_scene_py,
# build/decode_terrarium_dem_py, fetch_remote_geodata_py, cache_geodata_py
# (SURVEY §A.7, src/gis/osm*, terrarium). OSM input: the Overpass JSON
# element format (nodes/ways/relations) or GeoJSON. Terrarium tiles encode
# elevation as RGB per the public Mapzen formula
# h = (R*256 + G + B/256) - 32768.

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..errors import RenderError

__all__ = ["parse_osm_features", "query_osm_features", "prepare_osm_scene",
           "build_terrarium_dem", "decode_terrarium_dem",
           "fetch_remote_geodata", "cache_geodata", "OsmError"]


class OsmError(RenderError):
    pass


def parse_osm_features(doc) -> dict:
    """Parse Overpass-JSON (elements) or GeoJSON into a GeoJSON
    FeatureCollection (reference seam: parse_osm_features_py).

    Ways with matching first/last node become Polygons when closed and
    tagged area-like; otherwise LineStrings. Node tags become Points.
    """
    if isinstance(doc, (str, Path)):
        doc = json.loads(Path(doc).read_text())
    if doc.get("type") == "FeatureCollection":
        return doc
    elements = doc.get("elements")
    if elements is None:
        raise OsmError("not an Overpass JSON or GeoJSON document")
    nodes: Dict[int, Tuple[float, float]] = {}
    for el in elements:
        if el.get("type") == "node":
            nodes[el["id"]] = (float(el["lon"]), float(el["lat"]))
    feats: List[dict] = []
    area_keys = ("building", "landuse", "natural", "leisure", "amenity",
                 "water", "area")
    for el in elements:
        tags = el.get("tags") or {}
        if el.get("type") == "node" and tags:
            feats.append({"type": "Feature", "id": f"node/{el['id']}",
                          "properties": tags,
                          "geometry": {"type": "Point",
                                       "coordinates": list(nodes[el["id"]])}})
        elif el.get("type") == "way":
            nds = el.get("nodes", [])
            coords = [list(nodes[n]) for n in nds if n in nodes]
            if len(coords) < 2:
                continue
            closed = len(coords) >= 4 and coords[0] == coords[-1]
            is_area = closed and (any(k in tags for k in area_keys)
                                  or tags.get("area") == "yes")
            geom = ({"type": "Polygon", "coordinates": [coords]}
                    if is_area else
                    {"type": "LineString", "coordinates": coords})
            feats.append({"type": "Feature", "id": f"way/{el['id']}",
                          "properties": tags, "geometry": geom})
    return {"type": "FeatureCollection", "features": feats}


def query_osm_features(collection: dict, *,
                       tags: Optional[dict] = None,
                       geometry_type: Optional[str] = None,
                       bbox: Optional[Sequence[float]] = None) -> dict:
    """Filter a parsed collection by tag equality (value None = presence),
    geometry type, and bbox (reference seam: query_osm_features_py)."""
    out = []
    for f in collection.get("features", []):
        props = f.get("properties") or {}
        g = f.get("geometry") or {}
        if tags:
            ok = True
            for k, v in tags.items():
                if k not in props or (v is not None and props[k] != v):
                    ok = False
                    break
            if not ok:
                continue
        if geometry_type and g.get("type") != geometry_type:
            continue
        if bbox:
            w, s, e, n = bbox
            pts = _all_points(g)
            if not pts or not any(w <= x <= e and s <= y <= n
                                  for x, y in pts):
                continue
        out.append(f)
    return {"type": "FeatureCollection", "features": out}


def _all_points(geom) -> List[Tuple[float, float]]:
    t = geom.get("type")
    c = geom.get("coordinates", [])
    if t == "Point":
        return [tuple(c[:2])]
    if t in ("LineString", "MultiPoint"):
        return [tuple(p[:2]) for p in c]
    if t in ("Polygon", "MultiLineString"):
        return [tuple(p[:2]) for ring in c for p in ring]
    if t == "MultiPolygon":
        return [tuple(p[:2]) for poly in c for ring in poly for p in ring]
    return []


def prepare_osm_scene(collection: dict, *,
                      origin: Optional[Tuple[float, float]] = None) -> dict:
    """Split an OSM collection into render-ready layers: buildings
    (extruded meshes), roads (polylines), water/landuse (polygons)
    in local meters (reference seam: prepare_osm_scene_py)."""
    from ..buildings import buildings_to_mesh, parse_osm_buildings

    feats = collection.get("features", [])
    pts = [p for f in feats for p in _all_points(f.get("geometry") or {})]
    if not pts:
        raise OsmError("empty OSM collection")
    if origin is None:
        arr = np.asarray(pts)
        origin = (float(arr[:, 0].mean()), float(arr[:, 1].mean()))
    import math

    lon0, lat0 = origin
    kx = 111320.0 * math.cos(math.radians(lat0))
    ky = 110540.0

    def to_local(coords):
        return [[(p[0] - lon0) * kx, (lat0 - p[1]) * ky] for p in coords]

    layers: dict = {"origin": origin, "roads": [], "water": [],
                    "landuse": [], "buildings_mesh": None,
                    "building_count": 0}
    bcoll = {"type": "FeatureCollection",
             "features": [f for f in feats
                          if "building" in (f.get("properties") or {})]}
    if bcoll["features"]:
        bs = parse_osm_buildings(bcoll, origin=origin)
        layers["buildings_mesh"] = buildings_to_mesh(bs)
        layers["building_count"] = len(bs)
    for f in feats:
        props = f.get("properties") or {}
        g = f.get("geometry") or {}
        if "highway" in props and g.get("type") == "LineString":
            layers["roads"].append({"kind": props["highway"],
                                    "points": to_local(g["coordinates"])})
        elif (props.get("natural") == "water" or "water" in props) \
                and g.get("type") == "Polygon":
            layers["water"].append(
                {"rings": [to_local(r) for r in g["coordinates"]]})
        elif "landuse" in props and g.get("type") == "Polygon":
            layers["landuse"].append(
                {"kind": props["landuse"],
                 "rings": [to_local(r) for r in g["coordinates"]]})
    return layers


# ---------------------------------------------------------------------------
# Terrarium DEM tiles (Mapzen RGB encoding)


def build_terrarium_dem(heights: np.ndarray) -> np.ndarray:
    """Encode elevation (m) as Terrarium RGB u8
    (reference seam: build_terrarium_dem_py)."""
    h = np.asarray(heights, np.float64)
    if not np.isfinite(h).all():
        raise OsmError("heights contain non-finite values")
    v = np.clip(h + 32768.0, 0.0, 65535.996)
    r = np.floor(v / 256.0)
    g = np.floor(v - r * 256.0)
    b = np.floor((v - np.floor(v)) * 256.0)
    return np.stack([r, g, b], -1).astype(np.uint8)


def decode_terrarium_dem(rgb: np.ndarray) -> np.ndarray:
    """Decode Terrarium RGB back to elevation meters
    (reference seam: decode_terrarium_dem_py)."""
    a = np.asarray(rgb)
    if a.ndim != 3 or a.shape[2] < 3:
        raise OsmError("expected (H, W, 3) terrarium RGB")
    a = a.astype(np.float64)
    return (a[..., 0] * 256.0 + a[..., 1] + a[..., 2] / 256.0
            - 32768.0).astype(np.float32)


# ---------------------------------------------------------------------------
# remote geodata fetch + cache (gated; zero-egress environments use cache)


def cache_geodata(data: bytes, *, cache_dir=None,
                  key: Optional[str] = None) -> str:
    """Store a geodata blob content-addressed; returns the cache path
    (reference seam: cache_geodata_py)."""
    from ..datasets import data_dir

    d = Path(cache_dir) if cache_dir else data_dir() / "geodata"
    d.mkdir(parents=True, exist_ok=True)
    k = key or hashlib.sha256(data).hexdigest()[:24]
    p = d / f"{k}.bin"
    p.write_bytes(data)
    return str(p)


def fetch_remote_geodata(url: str, *, cache_dir=None,
                         timeout: float = 30.0) -> bytes:
    """Fetch a remote geodata resource with content-addressed caching;
    cache hits never touch the network (reference seam:
    fetch_remote_geodata_py)."""
    from ..datasets import data_dir

    d = Path(cache_dir) if cache_dir else data_dir() / "geodata"
    d.mkdir(parents=True, exist_ok=True)
    k = hashlib.sha256(url.encode()).hexdigest()[:24]
    p = d / f"url-{k}.bin"
    if p.exists():
        return p.read_bytes()
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            data = resp.read()
    except Exception as e:  # noqa: BLE001 — offline environments
        raise OsmError(f"remote fetch failed (offline?): {e}") from e
    p.write_bytes(data)
    return data
