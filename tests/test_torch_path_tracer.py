# The port's PathTracer facade (forge3d_tpu_torch/pt/path_tracer.py) and
# BRDF tile harness (forge3d_tpu_torch/brdf.py), both over the sphere engine
# P1's plain version, against the JAX package's on the CPU: the two
# render_rgba overloads and the ExperimentalSyntheticOutput gate, the
# luminance (firefly) clamp, render_aovs, the synthetic image, build_bvh,
# iter_tiles, save_aovs' files, render_brdf_tile, its overrides and their
# refusal, and the debug patterns.
#
# Gates: engine images within one u8 step on every pixel (the CPU shows
# them byte-equal); the synthetic image, the debug patterns and the files
# save_aovs writes byte-equal; BvhHandle's fields equal.
import numpy as np
import pytest
import torch

import forge3d_tpu as f3d
from forge3d_tpu import brdf as jb
from forge3d_tpu.pt import path_tracer as jpt

from forge3d_tpu_torch import brdf as tb
from forge3d_tpu_torch import errors as terr
from forge3d_tpu_torch.pt import path_tracer as tpt

torch.set_num_threads(1)

SCENE = [{"center": (0, 1, 0), "radius": 1.0, "albedo": (0.8, 0.3, 0.2)},
         {"center": (1.6, 0.6, -0.5), "radius": 0.6, "metallic": 1.0, "roughness": 0.3}]
CAM = {"origin": (0, 1.2, 4.0), "look_at": (0, 0.8, 0)}


def within_one(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def test_render_rgba_overloads_and_gate():
    j, t = jpt.PathTracer(32, 24, seed=3), tpt.PathTracer(32, 24, seed=3, device="cpu")
    with pytest.raises(f3d.ExperimentalSyntheticOutput):
        j.render_rgba()
    with pytest.raises(terr.ExperimentalSyntheticOutput, match="synthetic_ok=True"):
        t.render_rgba()
    with pytest.raises(terr.ExperimentalSyntheticOutput):
        t.render_rgba(16, 8, use_gpu=False)
    np.testing.assert_array_equal(t.render_rgba(synthetic_ok=True, spp=3),
                                  j.render_rgba(synthetic_ok=True, spp=3))
    np.testing.assert_array_equal(
        t.render_rgba(20, 12, use_gpu=False, synthetic_ok=True, frames=2, luminance_clamp=0.4),
        j.render_rgba(20, 12, use_gpu=False, synthetic_ok=True, frames=2, luminance_clamp=0.4))
    within_one(j.render_rgba(48, 32, scene=SCENE, camera=CAM),
               t.render_rgba(48, 32, scene=SCENE, camera=CAM))


@pytest.mark.parametrize("key", ["luminance_clamp", "firefly_clamp"])
def test_luminance_clamp(key):
    bright = [{"center": (0, 1, 0), "radius": 1.0, "emissive": (50, 50, 50)}]
    j, t = jpt.PathTracer(), tpt.PathTracer(device="cpu")
    a = j.render_rgba(48, 32, scene=bright, camera=CAM, **{key: 0.2})
    b = t.render_rgba(48, 32, scene=bright, camera=CAM, **{key: 0.2})
    within_one(a, b)
    assert b[..., :3].mean() < t.render_rgba(48, 32, scene=bright, camera=CAM)[..., :3].mean()
    rgb = np.random.default_rng(1).random((8, 8, 3)).astype(np.float32) * 3
    np.testing.assert_array_equal(tpt._luminance_clamp(rgb, 0.7), jpt._luminance_clamp(rgb, 0.7))


def test_cached_synthetic_and_render_aovs():
    j, t = jpt.PathTracer(24, 16, cache=True), tpt.PathTracer(24, 16, cache=True, device="cpu")
    for _ in range(2):   # the second call reads the cache
        np.testing.assert_array_equal(t.render_rgba(synthetic_ok=True),
                                      j.render_rgba(synthetic_ok=True))
    a = j.render_aovs(40, 24, SCENE, CAM, aovs=("albedo", "depth", "visibility"))
    b = t.render_aovs(40, 24, SCENE, CAM, aovs=("albedo", "depth", "visibility"))
    assert sorted(a) == sorted(b)
    within_one(a["rgba"], b["rgba"])
    for k in ("albedo", "depth", "visibility"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-5)


def test_build_bvh_and_iter_tiles():
    v = np.random.default_rng(2).uniform(-1, 1, (90, 3)).astype(np.float32)
    i = np.arange(90, dtype=np.uint32).reshape(30, 3)
    a, b = jpt.PathTracer().build_bvh(v, i), tpt.PathTracer(device="cpu").build_bvh(v, i)
    assert (b.triangle_count, b.node_count, b.world_aabb, b.build_stats) == (
        a.triangle_count, a.node_count, a.world_aabb, a.build_stats)
    assert repr(b) == repr(a)
    assert list(tpt.iter_tiles(130, 70, 64)) == list(jpt.iter_tiles(130, 70, 64))
    assert list(tpt.PathTracer(100, 40, device="cpu").iter_tiles(tile=32)) == list(
        jpt.PathTracer(100, 40).iter_tiles(tile=32))
    with pytest.raises(ValueError, match="tile must be positive"):
        list(tpt.iter_tiles(8, 8, 0))


def test_save_aovs_files_byte_equal(tmp_path):
    rng = np.random.default_rng(3)
    aovs = {"depth": rng.random((12, 16)).astype(np.float32),
            "normal": rng.random((12, 16, 3)).astype(np.float32),
            "mask": (rng.random((12, 16)) > 0.5).astype(np.uint8) * 255,
            "rgb": rng.random((12, 16, 3)).astype(np.float32)}
    for fmt in ("exr", "png"):
        pj = jpt.save_aovs(str(tmp_path / f"j_{fmt}"), aovs, format=fmt)
        pt = tpt.save_aovs(str(tmp_path / f"t_{fmt}"), aovs, format=fmt)
        assert [p.replace("/t_", "/j_") for p in pt] == pj
        for a, b in zip(pj, pt):
            assert open(a, "rb").read() == open(b, "rb").read(), b


def test_brdf_tile_and_overrides():
    a = jb.render_brdf_tile(tile_px=24, rows=2, cols=3, anisotropy=0.3)
    b = tb.render_brdf_tile(tile_px=24, rows=2, cols=3, anisotropy=0.3, device="cpu")
    within_one(a, b)
    c = tb.render_brdf_tile_overrides({"rows": 2, "cols": 3, "tile_px": 24, "anisotropy": 0.3},
                                      device="cpu")
    np.testing.assert_array_equal(b, c)
    for fn in (jb.render_brdf_tile_overrides, tb.render_brdf_tile_overrides):
        with pytest.raises(ValueError, match=r"unknown BRDF tile overrides: \['volume'\]"):
            fn({"volume": 11})


@pytest.mark.parametrize("kind", ["gradient_checker", "ramps"])
def test_debug_patterns_byte_equal(kind):
    for w, h in ((64, 48), (33, 17), (1, 1)):
        np.testing.assert_array_equal(tb.render_debug_pattern_frame(w, h, kind=kind),
                                      jb.render_debug_pattern_frame(w, h, kind=kind))
    for fn in (jb.render_debug_pattern_frame, tb.render_debug_pattern_frame):
        with pytest.raises(ValueError, match="unknown debug pattern"):
            fn(8, 8, kind="plaid")
