# forge3d_tpu_torch: the PyTorch + CUDA port of forge3d_tpu.
#
# The port runs the terrain path tracer on an NVIDIA H100 through
# hand-written CUDA kernels for sm_90a (csrc/), with a plain PyTorch version
# beside each kernel: the per-ray estimator (hybrid_render_terrain_reference
# with traversal="dda", kernels K5-K8) and the sweep estimator
# (traversal="sweep" and hybrid_render_terrain_sequence, kernels K1-K4). It imports torch and never jax; the
# JAX package stays the reference it is tested against.
#
# Entry points load lazily, so `import forge3d_tpu_torch` is cheap and
# builds nothing: the kernels are compiled at their first CUDA launch.

_ENTRY = {
    "hybrid_render_terrain_reference": "pt.terrain_ref",
    "hybrid_render_terrain_sequence": "pt.terrain_ref",
    "render_terrain_reference": "pt.terrain_ref",
    "TerrainRefDesc": "pt.terrain_ref",
}


def __getattr__(name):
    if name in _ENTRY:
        import importlib

        return getattr(importlib.import_module(f".{_ENTRY[name]}", __name__), name)
    raise AttributeError(f"module 'forge3d_tpu_torch' has no attribute {name!r}")
