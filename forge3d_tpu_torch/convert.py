# forge3d_tpu_torch/convert.py
# Carry state across from the JAX package as numpy arrays, so that a test
# can feed both implementations identical scene tables, reservoir history,
# sweep plans and sweep intermediates (rotated grid, sweep maps, polar
# accumulator), mesh BVHs, light sets and alias tables, terrain render
# parameters, MapScene recipes, SDF tapes, TLASes, hybrid scenes and smoke
# domains. Takes numpy arrays (or anything np.asarray accepts) and plain
# dicts, and never imports jax.

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.restir import Reservoirs
from .ops.traversal import TerrainScene, check_level_layout, f32


def scene_from_numpy(fields: dict, static: dict, device="cpu") -> TerrainScene:
    """`fields`: the JAX TerrainScene fields by name (h_pair, mm_pack,
    level_offset, level_w, origin_xz, spacing_xz, exaggeration);
    `static`: the TerrainSceneStatic fields by name."""

    def t(name, dtype):
        return torch.as_tensor(np.array(fields[name], dtype=dtype, copy=True), device=device)

    origin = np.asarray(fields["origin_xz"], np.float32)
    spacing = np.asarray(fields["spacing_xz"], np.float32)
    check_level_layout(fields["level_offset"], fields["level_w"], static["cell_w"],
                       static["cell_h"])
    return TerrainScene(
        h_pair=t("h_pair", np.float32),
        mm_pack=t("mm_pack", np.float32),
        level_offset=t("level_offset", np.int32),
        level_w=t("level_w", np.int32),
        origin_xz=(f32(origin[0]), f32(origin[1])),
        spacing_xz=(f32(spacing[0]), f32(spacing[1])),
        exaggeration=f32(np.asarray(fields["exaggeration"], np.float32)),
        dem_w=int(static["dem_w"]), dem_h=int(static["dem_h"]),
        cell_w=int(static["cell_w"]), cell_h=int(static["cell_h"]),
        mip_count=int(static["mip_count"]), max_iters=int(static["max_iters"]),
    )


def reservoirs_from_numpy(fields: dict, device="cpu") -> Reservoirs:
    """`fields`: the JAX Reservoirs fields by name. u32 fields become
    int32 (their values stay far below 2**31)."""
    out = {}
    for name in Reservoirs.__dataclass_fields__:
        a = np.asarray(fields[name])
        if name in ("light_type", "light_index", "m"):
            if a.size and int(a.max()) >= 2 ** 31:
                raise ValueError(f"reservoir field {name} exceeds int32")
            a = a.astype(np.int32)
        else:
            a = a.astype(np.float32)
        out[name] = torch.as_tensor(np.array(a, copy=True), device=device)
    return Reservoirs(**out)


def sweep_plan_from_jax_fields(plan, rg: dict, ps: dict):
    """`plan` (a SweepPlan of the same scene) with the JAX RotGridStatic and
    PolarStatic fields by name in place of its own geometry, so that a test
    runs the port's plain versions on exactly the JAX side's plan."""
    from .ops import polarscan, sweep

    rgs = sweep.RotGridStatic(**{k: tuple(v) if isinstance(v, (list, tuple)) else v
                                 for k, v in rg.items()})
    pss = polarscan.PolarStatic(**{k: tuple(v) if isinstance(v, (list, tuple)) else v
                                   for k, v in ps.items()})
    return dataclasses.replace(plan, rg=rgs, ps=pss, rot=sweep.RotateArgs.make(
        rgs, (0.0, 0.0), plan.spacing, plan.cam_xz, plan.exaggeration))


def tensor(a, device="cpu", dtype=np.float32) -> torch.Tensor:
    """A JAX-side intermediate (h_rot, du, dv, e_sky, z_sun, the corner
    pack, the polar accumulator, ...) as a contiguous tensor."""
    return torch.as_tensor(np.array(a, dtype=dtype, copy=True), device=device)


def sweep_maps(e_sky, z_sun, device="cpu"):
    """JAX SweepMaps fields as the port's SweepMaps."""
    from .ops.sweep import SweepMaps

    return SweepMaps(e_sky=tensor(e_sky, device), z_sun=tensor(z_sun, device))


def bvh_from_numpy(fields: dict, device="cpu"):
    """`fields`: the JAX MeshScene (or BvhArrays) fields by name
    (bounds_min, bounds_max, first, count, miss_link, tri_v0, tri_e1,
    tri_e2) -> (the port's MeshScene, n_nodes)."""
    from .ops.bvh import MeshScene, _SOA

    scene = MeshScene.from_arrays(device, **{k: np.asarray(fields[k]) for k in _SOA})
    return scene, scene.n_nodes


def light_buffer_from_numpy(fields: dict, device="cpu"):
    """`fields`: the JAX LightBuffer fields by name."""
    from .lighting import LightBuffer

    return LightBuffer(**{k: tensor(fields[k], device, np.int32 if k == "type_id" else np.float32)
                          for k in LightBuffer.__dataclass_fields__})


def alias_table_from_numpy(fields: dict, device="cpu"):
    """`fields`: the JAX AliasTable fields by name (prob, alias, pdf)."""
    from .ops.lightsample import AliasTable

    return AliasTable(prob=tensor(fields["prob"], device), alias=tensor(fields["alias"], device,
                                                                        np.int32),
                      pdf=tensor(fields["pdf"], device))


def terrain_params_from_dict(d: dict, env_map=None, height_curve_lut=None):
    """The port's TerrainRenderParams from the JAX params' `to_dict()` plus
    the two arrays `to_dict` drops (`ibl.env_map`, `height_curve_lut`):
    nested groups become the port's settings dataclasses, and the result is
    validated as make_terrain_params validates."""
    from .terrain.params import make_terrain_params

    p = make_terrain_params(**d)
    if env_map is not None:
        p.ibl.env_map = np.asarray(env_map, np.float32)
    if height_curve_lut is not None:
        p.height_curve_lut = np.asarray(height_curve_lut, np.float32)
    return p


def scene_recipe(obj):
    """The port's SceneRecipe (and every dataclass inside it) from an object
    with the JAX recipe's attribute names: SceneRecipe, TerrainSource,
    OrbitCamera, each layer dataclass, MapFurniture, OutputSpec, and a
    LightingPreset, LightSettings or MeshData inside them. Read duck-typed,
    by class name and attributes; numpy arrays are copied, plain values
    kept."""
    from . import mapscene as ms
    from .io.mesh import MeshData
    from .mapscene_screen import LightingPreset
    from .terrain.params import LightSettings

    classes = {c.__name__: c for c in (
        ms.SceneRecipe, ms.TerrainSource, ms.OrbitCamera, ms.VectorOverlayLayer,
        ms.RasterOverlayLayer, ms.BuildingLayer, ms.PointCloudLayer, ms.Tiles3DLayer,
        ms.LabelLayer, ms.MapFurniture, ms.OutputSpec, LightSettings, MeshData)}

    def conv(v):
        name = type(v).__name__
        if name in classes and hasattr(type(v), "__dataclass_fields__"):
            cls = classes[name]
            return cls(**{f.name: conv(getattr(v, f.name))
                          for f in dataclasses.fields(cls) if hasattr(v, f.name)})
        if name == "LightingPreset":
            return LightingPreset(name=v.name, sun_direction=conv(v.sun_direction),
                                  intensity=v.intensity, settings=conv(v.settings),
                                  overrides=conv(v.overrides))
        if isinstance(v, np.ndarray):
            return v.copy()
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(conv(x) for x in v)
        return v

    if type(obj).__name__ != "SceneRecipe":
        raise TypeError(f"scene_recipe takes a SceneRecipe, not {type(obj).__name__}")
    return conv(obj)


def sdf_scene_from_numpy(fields: dict, device="cpu"):
    """`fields`: a JAX SdfScene's tape arrays by name (is_op, kind, params,
    smoothing, material) with tape_len, stack_depth, primitive_count,
    node_count and bounds -> the port's SdfScene."""
    from .ops.sdf import SdfScene

    scene = SdfScene.from_arrays(
        *(np.asarray(fields[k]) for k in ("is_op", "kind", "params", "smoothing", "material")),
        int(fields["stack_depth"]), int(fields["primitive_count"]), int(fields["node_count"]),
        bounds=fields.get("bounds"), device=device)
    if scene.tape_len != int(fields["tape_len"]):
        raise ValueError(f"tape of {scene.tape_len} instructions, tape_len {fields['tape_len']}")
    return scene


def tlas_from_numpy(blases, instances, inv_mats, nrm_mats, device="cpu"):
    """`blases`: each BLAS's JAX MeshScene fields by name; `instances`:
    (blas_index, 4x4 transform) pairs; `inv_mats`, `nrm_mats`: the JAX
    Tlas's float64 matrices -> the port's Tlas."""
    from .ops.tlas import Instance, assemble_tlas

    return assemble_tlas([bvh_from_numpy(b, device) for b in blases],
                         [Instance(int(i), np.asarray(m)) for i, m in instances],
                         [np.asarray(m, np.float64) for m in inv_mats],
                         [np.asarray(m, np.float64) for m in nrm_mats])


def hybrid_scene_from_numpy(terrain=None, mesh=None, mesh_normals=None, sdf=None,
                            device="cpu"):
    """A JAX HybridScene's parts: `terrain` the (TerrainScene fields,
    TerrainSceneStatic fields) pair, `mesh` the MeshScene fields with
    `mesh_normals` (n_prims, 3), `sdf` as `sdf_scene_from_numpy` takes it;
    any may be None -> the port's HybridScene."""
    from .pt.hybrid import HybridScene

    tscene = scene_from_numpy(*terrain, device=device) if terrain is not None else None
    mscene, nodes = bvh_from_numpy(mesh, device) if mesh is not None else (None, 0)
    normals = tensor(mesh_normals, device) if mesh is not None else None
    return HybridScene(terrain_scene=tscene, terrain_static=tscene, mesh_scene=mscene,
                       mesh_nodes=nodes, mesh_normals=normals,
                       sdf_scene=sdf_scene_from_numpy(sdf, device) if sdf is not None else None)


def smoke_domain_from_numpy(state: dict, voxel_size, origin, time: float = 0.0,
                            steps: int = 0, device="cpu"):
    """A JAX SmokeDomain mid-simulation: `state` its grids by name (density,
    velocity, temperature, soot, emission, from its to_*_numpy methods),
    with its voxel size, origin, time and step count -> the port's
    SmokeDomain on `device`."""
    from .smoke import SmokeDomain

    dom = SmokeDomain.from_density(state["density"], voxel_size, origin, device=device)
    dom.set_velocity(state["velocity"])
    dom.set_temperature(state["temperature"])
    dom.set_soot(state["soot"])
    dom.set_emission(state["emission"])
    dom.time = float(time)
    dom.steps = int(steps)
    return dom
