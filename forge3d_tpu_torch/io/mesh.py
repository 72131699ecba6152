# forge3d_tpu_torch/io/mesh.py
# A host copy of forge3d_tpu/io/mesh.py for the PyTorch port (MeshData and
# merge_meshes; the file readers and writers are not copied): the port imports
# no module of the JAX package, so it keeps its own copy, held against the
# original by tests/test_torch_host_copies.py. The original's notes follow.
#
# Mesh file I/O: OBJ, PLY (ascii + binary), STL (ascii + binary), glTF/GLB.
#
# Parity notes (reference behavior, not code): forge3d:src/io/mod.rs
# registers OBJ read/write, PLY read/write, STL write, glTF read (KHR
# extensions per Cargo.toml:88). Host-side and TPU-independent; meshes feed
# the SAH BVH (ops/bvh.py) and the mesh path tracer.

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["MeshData", "merge_meshes"]


@dataclass
class MeshData:
    """Triangle mesh interchange container.

    vertices: (N,3) float32; indices: (M,3) uint32; optional normals (N,3),
    uvs (N,2), vertex colors (N,3|4) in [0,1].
    """

    vertices: np.ndarray
    indices: np.ndarray
    normals: Optional[np.ndarray] = None
    uvs: Optional[np.ndarray] = None
    colors: Optional[np.ndarray] = None
    name: str = ""
    materials: Dict[str, dict] = field(default_factory=dict)

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, np.float32).reshape(-1, 3)
        self.indices = np.ascontiguousarray(self.indices, np.uint32).reshape(-1, 3)
        if self.normals is not None:
            self.normals = np.ascontiguousarray(self.normals, np.float32).reshape(-1, 3)
        if self.uvs is not None:
            self.uvs = np.ascontiguousarray(self.uvs, np.float32).reshape(-1, 2)

    @property
    def triangle_count(self) -> int:
        return int(self.indices.shape[0])

    @property
    def vertex_count(self) -> int:
        return int(self.vertices.shape[0])

    def compute_normals(self) -> np.ndarray:
        """Area-weighted smooth vertex normals (deterministic accumulation)."""
        v, f = self.vertices, self.indices.astype(np.int64)
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        n = np.zeros_like(v)
        for k in range(3):
            np.add.at(n, f[:, k], fn)
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        self.normals = (n / np.maximum(norm, 1e-20)).astype(np.float32)
        return self.normals


def merge_meshes(meshes: List[MeshData]) -> MeshData:
    """Concatenate meshes into one buffer (index-offset correct)."""
    vs, fs, off = [], [], 0
    all_n = all(m.normals is not None for m in meshes)
    all_t = all(m.uvs is not None for m in meshes)
    ns, ts = [], []
    for m in meshes:
        vs.append(m.vertices)
        fs.append(m.indices.astype(np.uint64) + off)
        if all_n:
            ns.append(m.normals)
        if all_t:
            ts.append(m.uvs)
        off += m.vertex_count
    return MeshData(
        vertices=np.concatenate(vs),
        indices=np.concatenate(fs).astype(np.uint32),
        normals=np.concatenate(ns) if all_n else None,
        uvs=np.concatenate(ts) if all_t else None,
        name=meshes[0].name if meshes else "",
    )
