# forge3d_tpu_torch/geometry/__init__.py
# A host copy of forge3d_tpu/geometry/__init__.py for the PyTorch port (the
# polygon triangulation and extrusion and weld_mesh, which buildings.py uses):
# the port imports no module of the JAX package, so it keeps its own copy,
# held against the original by tests/test_torch_host_copies.py. The original's
# notes follow.
#
#
# Parity notes (reference behavior, not code): forge3d:src/geometry/
# mod.rs:10-37 exposes primitives, polygon extrusion (buildings), weld,
# simplify, subdivision, curves, displacement, validation/repair, measures,
# planar UV unwrap. All host-side numpy; outputs feed the SAH BVH and mesh
# path tracer. The exact-predicate boolean overlay (EUCLIDEA,
# src/geometry/exact/, overlay/) lives in geometry/overlay.py.

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..io.mesh import MeshData, merge_meshes

__all__ = ["extrude_polygon", "triangulate_polygon", "weld_mesh", "merge_meshes"]


# ---------------------------------------------------------------------------
# Polygon triangulation + extrusion (reference: src/geometry/extrude,
# src/import/osm_buildings.rs builds on this)


def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def triangulate_polygon(exterior: np.ndarray,
                        holes: Sequence[np.ndarray] = ()) -> Tuple[np.ndarray, np.ndarray]:
    """Ear-clipping triangulation of a simple polygon with holes.

    Holes are joined to the outer ring by max-x bridge edges (standard
    hole-cutting), then ears are clipped with robust orientation tests.
    Returns (vertices (N,2) float64, triangles (M,3) uint32).
    """
    outer = np.asarray(exterior, np.float64)[:, :2]
    if np.allclose(outer[0], outer[-1]):
        outer = outer[:-1]
    if _signed_area(outer) < 0:
        outer = outer[::-1]
    ring = list(map(tuple, outer))

    hole_list = []
    for h in holes:
        h = np.asarray(h, np.float64)[:, :2]
        if np.allclose(h[0], h[-1]):
            h = h[:-1]
        if _signed_area(h) > 0:
            h = h[::-1]  # holes clockwise
        hole_list.append(h)
    # join holes right-to-left by max-x vertex
    hole_list.sort(key=lambda h: -float(np.max(h[:, 0])))
    for h in hole_list:
        hi = int(np.argmax(h[:, 0]))
        hx, hy = h[hi]
        # nearest visible outer vertex to the right
        best, bestd = None, np.inf
        for i, (px, py) in enumerate(ring):
            if px >= hx:
                d = (px - hx) ** 2 + (py - hy) ** 2
                if d < bestd:
                    best, bestd = i, d
        if best is None:
            best = int(np.argmax([p[0] for p in ring]))
        bridge = ring[best]
        rotated = [tuple(p) for p in np.roll(h, -hi, axis=0)]
        ring = (ring[: best + 1] + rotated + [rotated[0], bridge] + ring[best + 1:])

    verts = np.asarray(ring, np.float64)
    n = len(verts)
    prev = list(range(-1, n - 1))
    nxt = list(range(1, n + 1))
    nxt[-1] = 0
    prev[0] = n - 1

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def point_in_tri(p, a, b, c):
        d1, d2, d3 = cross(a, b, p), cross(b, c, p), cross(c, a, p)
        neg = (d1 < 0) or (d2 < 0) or (d3 < 0)
        pos = (d1 > 0) or (d2 > 0) or (d3 > 0)
        return not (neg and pos)

    tris: List[List[int]] = []
    remaining = n
    i = 0
    guard = 0
    while remaining > 3 and guard < 4 * n * n:
        guard += 1
        p, q = prev[i], nxt[i]
        a, b, c = verts[p], verts[i], verts[q]
        if cross(a, b, c) > 1e-14:
            ear = True
            j = nxt[q]
            while j != p:
                if j != p and j != i and j != q:
                    vj = verts[j]
                    if (not (np.array_equal(vj, a) or np.array_equal(vj, b)
                             or np.array_equal(vj, c))
                            and point_in_tri(vj, a, b, c)):
                        ear = False
                        break
                j = nxt[j]
            if ear:
                tris.append([p, i, q])
                nxt[p], prev[q] = q, p
                remaining -= 1
                i = q
                continue
        i = nxt[i]
    if remaining == 3:
        tris.append([prev[i], i, nxt[i]])
    return verts, np.asarray(tris, np.uint32).reshape(-1, 3)


def extrude_polygon(polygon, height: float, *, base: float = 0.0,
                    holes: Sequence = (), cap_bottom: bool = True) -> MeshData:
    """Extrude a 2D footprint (x, z) to a prism [base, base+height] in y.

    Reference seam: `extrude_polygon_py` (src/py_module registration,
    SURVEY §A.7). The roof is ear-clip triangulated; walls are quads per
    edge with outward winding.
    """
    verts2, tris = triangulate_polygon(np.asarray(polygon, np.float64), holes)
    nv = len(verts2)
    top_y, bot_y = base + height, base
    top = np.column_stack([verts2[:, 0], np.full(nv, top_y), verts2[:, 1]])
    bot = np.column_stack([verts2[:, 0], np.full(nv, bot_y), verts2[:, 1]])
    parts = [MeshData(top.astype(np.float32), tris)]
    if cap_bottom:
        parts.append(MeshData(bot.astype(np.float32), tris[:, ::-1].copy()))

    def ring_walls(ring: np.ndarray, ccw: bool) -> MeshData:
        r = np.asarray(ring, np.float64)[:, :2]
        if np.allclose(r[0], r[-1]):
            r = r[:-1]
        if (_signed_area(r) > 0) != ccw:
            r = r[::-1]
        m = len(r)
        t = np.column_stack([r[:, 0], np.full(m, top_y), r[:, 1]])
        b = np.column_stack([r[:, 0], np.full(m, bot_y), r[:, 1]])
        vs = np.concatenate([b, t]).astype(np.float32)
        fs = []
        for k in range(m):
            k2 = (k + 1) % m
            # wall quad (bottom k, bottom k2, top k2, top k)
            fs += [[k, k2, m + k2], [k, m + k2, m + k]]
        return MeshData(vs, np.asarray(fs, np.uint32))

    parts.append(ring_walls(np.asarray(polygon, np.float64), ccw=True))
    for h in holes:
        parts.append(ring_walls(np.asarray(h, np.float64), ccw=False))
    mesh = merge_meshes(parts)
    mesh.compute_normals()
    mesh.name = "extrusion"
    return mesh


# ---------------------------------------------------------------------------
# Weld / simplify / subdivide (reference: src/geometry weld/simplify/subdivision)


def weld_mesh(mesh: MeshData, *, tolerance: float = 1e-6) -> MeshData:
    """Merge vertices closer than tolerance (grid quantization), drop
    degenerate triangles."""
    q = np.round(mesh.vertices / max(tolerance, 1e-30)).astype(np.int64)
    _, first, inv = np.unique(q, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    new_idx = rank[inv]
    verts = mesh.vertices[first[order]]
    faces = new_idx[mesh.indices.astype(np.int64)]
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    out = MeshData(verts, faces[ok].astype(np.uint32), name=mesh.name)
    if mesh.normals is not None:
        out.compute_normals()
    return out
