# forge3d_tpu_torch/buildings.py
# A host copy of forge3d_tpu/buildings.py for the PyTorch port (footprint
# extrusion, CityJSON and the OSM GeoJSON importer; the CityGML importer is
# not copied): the port imports no module of the JAX package, so it keeps
# its own copy, held against the original by tests/test_torch_host_copies.py.
# The original's notes follow.
#
# Building importers: footprint extrusion, CityJSON (LOD1/LOD2), OSM
# (GeoJSON building features).
#
# Parity notes (reference behavior, not code):
#   forge3d:src/import/osm_buildings.rs + src/import/cityjson/ +
#   python/forge3d/buildings.py (656 LoC) — parse building footprints with
#   height attributes, extrude to prisms, return render-ready meshes with
#   per-building material hooks. Host-side numpy; meshes feed the SAH BVH
#   and the mesh path tracer (pt/mesh_render.py) or MapScene building layers.

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .geometry import extrude_polygon
from .io.mesh import MeshData, merge_meshes

__all__ = ["Building", "extrude_footprints", "load_cityjson", "parse_osm_buildings",
           "buildings_to_mesh"]

_DEFAULT_LEVEL_HEIGHT_M = 3.0


@dataclass
class Building:
    """One building: footprint ring(s) in local XZ meters + height."""

    footprint: np.ndarray                 # (N, 2) exterior ring
    height: float
    base: float = 0.0
    holes: List[np.ndarray] = field(default_factory=list)
    id: str = ""
    properties: Dict[str, object] = field(default_factory=dict)

    def mesh(self) -> MeshData:
        m = extrude_polygon(self.footprint, self.height, base=self.base,
                            holes=self.holes)
        m.name = self.id or "building"
        return m


def extrude_footprints(footprints: Sequence, heights: Sequence[float], *,
                       bases: Optional[Sequence[float]] = None) -> MeshData:
    """Extrude many footprints into one merged mesh (batch seam used by
    MapScene building layers)."""
    bases = bases if bases is not None else [0.0] * len(footprints)
    meshes = [extrude_polygon(np.asarray(fp, np.float64), float(h), base=float(b))
              for fp, h, b in zip(footprints, heights, bases)]
    if not meshes:
        raise ValueError("no footprints")
    return merge_meshes(meshes)


def buildings_to_mesh(buildings: Sequence[Building]) -> MeshData:
    if not buildings:
        raise ValueError("no buildings")
    return merge_meshes([b.mesh() for b in buildings])


# ---------------------------------------------------------------------------
# CityJSON (https://www.cityjson.org/ v1.x/2.0) — Building / BuildingPart
# CityObjects with Solid or MultiSurface geometry; vertices are quantized
# ints decoded by the file "transform" {scale, translate}.


def load_cityjson(path_or_obj) -> List[MeshData]:
    """Parse CityJSON into one triangulated MeshData per Building object.

    Solid boundaries = [shell][surface][ring][vertex]; MultiSurface =
    [surface][ring][vertex]. Surfaces are fan-triangulated (LOD2 surfaces
    are planar convex in practice); inner rings are honored via the ear
    clipper when present.
    """
    if isinstance(path_or_obj, (str, Path)):
        cj = json.loads(Path(path_or_obj).read_text())
    else:
        cj = path_or_obj
    if "vertices" not in cj or "CityObjects" not in cj:
        raise ValueError("not a CityJSON document")
    tr = cj.get("transform", {})
    scale = np.asarray(tr.get("scale", [1.0, 1.0, 1.0]), np.float64)
    translate = np.asarray(tr.get("translate", [0.0, 0.0, 0.0]), np.float64)
    verts_all = np.asarray(cj["vertices"], np.float64) * scale + translate

    out: List[MeshData] = []
    for oid, obj in cj["CityObjects"].items():
        if obj.get("type") not in ("Building", "BuildingPart", "BuildingRoom",
                                   "BuildingStorey", None):
            continue
        # triangles as (3, 3) coordinate triples; welded at the end
        tri_pts: List[np.ndarray] = []

        def add_surface(rings: list):
            ext = rings[0]
            if len(ext) < 3:
                return
            if len(rings) == 1:
                p = verts_all[ext]
                for k in range(1, len(ext) - 1):  # fan
                    tri_pts.append(np.stack([p[0], p[k], p[k + 1]]))
                return
            # inner rings: project to the surface plane, ear-clip, lift back
            from .geometry import triangulate_polygon
            n = _newell_normal(verts_all[ext])
            u, v = _plane_basis(n)
            origin = verts_all[ext].mean(0)
            to2d = lambda ring: np.stack(
                [(verts_all[ring] - origin) @ u, (verts_all[ring] - origin) @ v], 1)
            v2, t2 = triangulate_polygon(to2d(ext), [to2d(r) for r in rings[1:]])
            lifted = origin + v2[:, 0:1] * u + v2[:, 1:2] * v
            for a, b, c in t2:
                tri_pts.append(np.stack([lifted[a], lifted[b], lifted[c]]))

        for geom in obj.get("geometry", []):
            gtype = geom.get("type")
            bnd = geom.get("boundaries", [])
            if gtype == "Solid":
                for shell in bnd:
                    for surface in shell:
                        add_surface(surface)
            elif gtype in ("MultiSurface", "CompositeSurface"):
                for surface in bnd:
                    add_surface(surface)
            elif gtype == "MultiSolid":
                for solid in bnd:
                    for shell in solid:
                        for surface in shell:
                            add_surface(surface)
        if not tri_pts:
            continue
        from .geometry import weld_mesh
        flat = np.concatenate(tri_pts).astype(np.float32)
        mesh = MeshData(
            vertices=flat,
            indices=np.arange(len(flat), dtype=np.uint32).reshape(-1, 3),
            name=str(oid),
        )
        mesh = weld_mesh(mesh, tolerance=1e-7)
        mesh.name = str(oid)
        mesh.materials["attributes"] = obj.get("attributes", {})
        mesh.compute_normals()
        out.append(mesh)
    if not out:
        raise ValueError("CityJSON contains no buildings")
    return out


def _newell_normal(pts: np.ndarray) -> np.ndarray:
    n = np.zeros(3)
    for i in range(len(pts)):
        a, b = pts[i], pts[(i + 1) % len(pts)]
        n += np.cross(a, b)
    ln = np.linalg.norm(n)
    return n / ln if ln > 1e-20 else np.array([0.0, 0.0, 1.0])


def _plane_basis(n: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    return u, np.cross(n, u)


# ---------------------------------------------------------------------------
# OSM buildings from GeoJSON (reference src/import/osm_buildings.rs derives
# heights from height= / building:levels= tags with a 3 m/level default).


def _osm_height(props: dict) -> float:
    for key in ("height", "building:height"):
        hv = props.get(key)
        if hv is not None:
            try:
                return float(str(hv).replace("m", "").strip())
            except ValueError:
                pass
    lv = props.get("building:levels", props.get("levels"))
    if lv is not None:
        try:
            return float(lv) * _DEFAULT_LEVEL_HEIGHT_M
        except ValueError:
            pass
    return 2.0 * _DEFAULT_LEVEL_HEIGHT_M


def parse_osm_buildings(geojson, *, origin: Optional[Tuple[float, float]] = None
                        ) -> List[Building]:
    """Parse GeoJSON building features into local-meter Buildings.

    `origin=(lon, lat)` anchors the local tangent plane; default = centroid
    of all footprints. Equirectangular local projection (adequate at city
    scale; for large extents reproject with geo.crs first).
    """
    if isinstance(geojson, (str, Path)):
        geojson = json.loads(Path(geojson).read_text())
    feats = geojson.get("features", [])
    polys = []
    for f in feats:
        geom = f.get("geometry") or {}
        props = f.get("properties") or {}
        if "building" not in props and "height" not in props \
                and "building:levels" not in props:
            continue
        gtype = geom.get("type")
        if gtype == "Polygon":
            polys.append((geom["coordinates"], props, f.get("id", "")))
        elif gtype == "MultiPolygon":
            for part in geom["coordinates"]:
                polys.append((part, props, f.get("id", "")))
    if not polys:
        raise ValueError("no building polygons in GeoJSON")

    if origin is None:
        all_pts = np.concatenate([np.asarray(p[0][0], np.float64)[:, :2]
                                  for p in polys])
        origin = (float(all_pts[:, 0].mean()), float(all_pts[:, 1].mean()))
    lon0, lat0 = origin
    kx = 111320.0 * math.cos(math.radians(lat0))
    ky = 110540.0

    def to_local(ring) -> np.ndarray:
        r = np.asarray(ring, np.float64)[:, :2]
        return np.stack([(r[:, 0] - lon0) * kx, (lat0 - r[:, 1]) * ky], 1)

    out = []
    for i, (rings, props, fid) in enumerate(polys):
        out.append(Building(
            footprint=to_local(rings[0]),
            holes=[to_local(r) for r in rings[1:]],
            height=_osm_height(props),
            id=str(fid or f"osm-{i}"),
            properties=dict(props),
        ))
    return out
