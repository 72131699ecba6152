# forge3d_tpu_torch: the PyTorch + CUDA port of forge3d_tpu.
#
# The port runs the per-ray terrain path tracer (the JAX package's
# hybrid_render_terrain_reference with traversal="dda") on an NVIDIA H100
# through hand-written CUDA kernels for sm_90a (csrc/), with a plain
# PyTorch version beside each kernel. It imports torch and never jax; the
# JAX package stays the reference it is tested against.
#
# Entry points load lazily, so `import forge3d_tpu_torch` is cheap and
# builds nothing: the kernels are compiled at their first CUDA launch.

_ENTRY = {
    "hybrid_render_terrain_reference": "pt.terrain_ref",
    "render_terrain_reference": "pt.terrain_ref",
    "TerrainRefDesc": "pt.terrain_ref",
}


def __getattr__(name):
    if name in _ENTRY:
        import importlib

        return getattr(importlib.import_module(f".{_ENTRY[name]}", __name__), name)
    raise AttributeError(f"module 'forge3d_tpu_torch' has no attribute {name!r}")
