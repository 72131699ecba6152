# forge3d_tpu_torch: the PyTorch + CUDA port of forge3d_tpu.
#
# The port runs the terrain path tracer on an NVIDIA H100 through
# hand-written CUDA kernels for sm_90a (csrc/), with a plain PyTorch version
# beside each kernel: the per-ray estimator (hybrid_render_terrain_reference
# with traversal="dda", kernels K5-K8, with meshes through the BVH walk K9
# and typed lights through the light sample K10), the sweep estimator
# (traversal="sweep" and hybrid_render_terrain_sequence, kernels K1-K4),
# the deterministic sphere and mesh engines (pt_render_gpu / pt_render_aovs,
# kernel P1; pt_render_gpu_mesh, kernel P2), the TerrainRenderer (kernel R1;
# its screen mode and terrain.screen's clipmap mode, kernels S1-S9) and
# MapScene (mapscene: its perspective route over R1, world vector layers
# through the coverage kernel E4 in vector/, buildings through K9; its
# screen, clipmap and mesh routes), and the other path-tracing engines:
# the SDF tracer (kernel P6), the TLAS walk (P5), the hybrid tracer (P3),
# the AEQUITAS adjudication pair (P4), PathTracer and the BRDF tiles, the
# render-to-texture Scene with the post-processing suite (E2, ops/post.py),
# the virtual-texture store (terrain/vt.py, resolved inside R1), the IBL
# bake (E1, ops/ibl.py), and the smoke domains of the wildfire path (smoke:
# the fluid step E8 step and the volume march E8 march, ops/smoke.py) with
# the named DEMs (datasets) and the Terrarium codec (gis/osm.py), and the
# leaf modules with kernels of their own (csrc/leaf.cu): the Preetham sky
# (sky, E5 Preetham), eval_lights (lighting, E6), the path-guiding cache
# (guiding, E7) and double-float arithmetic (precision, E9), with the CSM
# shadow state (shadows, over K5) and the ephemeris (astro). It imports
# torch and never jax nor any module of the JAX package, which stays the
# reference it is tested against.
#
# Entry points load lazily, so `import forge3d_tpu_torch` is cheap and
# builds nothing: the kernels are compiled at their first CUDA launch.

_ENTRY = {
    "hybrid_render_terrain_reference": "pt.terrain_ref",
    "hybrid_render_terrain_sequence": "pt.terrain_ref",
    "render_terrain_reference": "pt.terrain_ref",
    "TerrainRefDesc": "pt.terrain_ref",
    "pt_render_gpu": "pt.megakernel",
    "pt_render_aovs": "pt.megakernel",
    "pt_render_gpu_mesh": "pt.mesh_render",
    "Light": "lighting",
    "TerrainRenderer": "terrain.renderer",
    "MaterialSet": "terrain.renderer",
    "IBL": "terrain.renderer",
    "TerrainRenderParams": "terrain.params",
    "make_terrain_params": "terrain.params",
    "render_offline": "terrain.offline",
    "OfflineQualitySettings": "terrain.offline",
    "Frame": "frame",
    "AovFrame": "frame",
    "HdrFrame": "frame",
    "MapScene": "mapscene",
    "SceneRecipe": "mapscene",
    "TerrainSource": "mapscene",
    "OrbitCamera": "mapscene",
    "VectorOverlayLayer": "mapscene",
    "RasterOverlayLayer": "mapscene",
    "BuildingLayer": "mapscene",
    "PointCloudLayer": "mapscene",
    "Tiles3DLayer": "mapscene",
    "LabelLayer": "mapscene",
    "MapFurniture": "mapscene",
    "OutputSpec": "mapscene",
    "LightingPreset": "mapscene_screen",
    "VectorScene": "vector",
    "vector_render_oit": "vector",
    "vector_render_oit_edl": "vector",
    "vector_render_pick_map": "vector",
    "vector_render_oit_and_pick": "vector",
    "hybrid_render": "pt.hybrid",
    "build_hybrid_scene": "pt.hybrid",
    "render_adjudication_pair": "pt.hybrid",
    "render_adjudication_builtin": "pt.adjudication",
    "SdfSceneBuilder": "ops.sdf",
    "build_tlas": "ops.tlas",
    "trace_tlas": "ops.tlas",
    "Instance": "ops.tlas",
    "PathTracer": "pt.path_tracer",
    "render_brdf_tile": "brdf",
    "render_brdf_tile_overrides": "brdf",
    "render_debug_pattern_frame": "brdf",
    "Scene": "scene",
    "VTStore": "terrain.vt",
    "bake_ibl": "ops.ibl",
    "SmokeDomain": "smoke",
    "SmokeEmitter": "smoke",
    "SmokeStepSettings": "smoke",
    "SmokeRenderSettings": "smoke",
    "AtmosphericSmokeCube": "smoke",
    "domain_from_density": "smoke",
    "native_smoke_available": "smoke",
    "fetch_dem": "datasets",
    "dataset_names": "datasets",
    "mini_dem": "datasets",
    "build_terrarium_dem": "gis.osm",
    "decode_terrarium_dem": "gis.osm",
    "dd_selftest": "precision",
    "dd_harness": "precision",
    "dd_jitter_demo": "precision",
    "configure_csm": "shadows",
    "set_csm_enabled": "shadows",
    "set_csm_light_direction": "shadows",
    "set_csm_pcf_kernel": "shadows",
    "set_csm_bias_params": "shadows",
    "set_csm_debug_mode": "shadows",
    "get_csm_cascade_info": "shadows",
    "validate_csm_peter_panning": "shadows",
}

# modules the JAX package resolves by name at its top level
_MODULES = ("sky", "guiding", "precision", "shadows")


def __getattr__(name):
    if name in _ENTRY or name in _MODULES:
        import importlib

        if name in _MODULES:
            return importlib.import_module(f".{name}", __name__)
        return getattr(importlib.import_module(f".{_ENTRY[name]}", __name__), name)
    raise AttributeError(f"module 'forge3d_tpu_torch' has no attribute {name!r}")
