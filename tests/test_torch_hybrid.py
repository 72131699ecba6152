# The port's hybrid tracer and adjudication pair (forge3d_tpu_torch/pt/
# hybrid.py: kernel P3's plain version over K5, K9 and P6) against the JAX
# package's (forge3d_tpu/pt/hybrid.py) on the CPU: hybrid_render in all four
# traversal modes over tests/test_hybrid_adjudication.py's 33^2 scene
# (terrain, a floating box, an SDF sphere) at 128x96 and 96x64, the
# unknown-mode refusal, render_adjudication_pair, image_metrics and
# hybrid_scene_from_numpy.
#
# Gates:
# - rgba within one u8 step on >= 99.5% of pixels; `kind` and `visibility`
#   equal on >= 99.9%; depth by the trace rule (|d|/t <= 1e-4 where both
#   hit); normals and albedo within 1e-5 * (1 + |ref|) on >= 99.5% (the
#   CPU shows the terrain's depth and normals an ulp off on a few pixels:
#   JAX's traversal is one jitted program whose sums XLA fuses; the SDF
#   normal goes through XLA's rsqrt);
# - render_adjudication_pair at 96x72, spp 2: both frames within one u8
#   step on >= 99.5% of pixels, every metric within 1e-3 of JAX's (of its
#   size, for pt_mean and raster_mean, which count u8 steps: one pixel a
#   step off moves pt_mean by 1.5e-3 at this size);
# - image_metrics, mean_abs_error and delta_e2000 equal to JAX's.
import dataclasses

import numpy as np
import pytest
import torch

from forge3d_tpu.geometry import primitive_mesh
from forge3d_tpu.ops.sdf import SdfSceneBuilder as JBuilder
from forge3d_tpu.pt import hybrid as jh
from forge3d_tpu.utils import metrics as jm

from forge3d_tpu_torch import metrics as tm
from forge3d_tpu_torch.convert import hybrid_scene_from_numpy
from forge3d_tpu_torch.errors import DeviceError
from forge3d_tpu_torch.ops.sdf import SdfSceneBuilder as TBuilder
from forge3d_tpu_torch.pt import hybrid as th

torch.set_num_threads(1)

CAM = {"origin": (16.0, 18.0, 52.0), "look_at": (16.0, 2.0, 16.0)}
AOVS = ("depth", "normal", "visibility", "kind", "albedo")


def dem33():
    y, x = np.mgrid[0:33, 0:33].astype(np.float32)
    return 2.0 * np.sin(x * 0.3) * np.cos(y * 0.3)


def box():
    m = primitive_mesh("box", size=(6, 6, 6))
    return m.vertices + np.array([16.0, 8.0, 16.0], np.float32), m.indices


def sdf(builder, **kw):
    b = builder()
    b.add_sphere((24.0, 6.0, 10.0), 3.0)
    return b.build(**kw)


@pytest.fixture(scope="module")
def scenes():
    v, f = box()
    j = jh.build_hybrid_scene(heightmap=dem33(), mesh_vertices=v, mesh_indices=f,
                              sdf_scene=sdf(JBuilder))
    t = th.build_hybrid_scene(heightmap=dem33(), mesh_vertices=v, mesh_indices=f,
                              sdf_scene=sdf(TBuilder, device="cpu"), device="cpu")
    return j, t


def u8_close(a, b):
    return float((np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1) <= 1).mean())


def float_close(a, b):
    return float((np.abs(b - a) <= 1e-5 * (1 + np.abs(a))).mean())


@pytest.mark.parametrize("size", [(128, 96), (96, 64)], ids=["128x96", "96x64"])
@pytest.mark.parametrize("mode", list(th.TRAVERSAL_MODES))
def test_hybrid_render_matches_jax(scenes, mode, size):
    j, t = scenes
    sun = {"azimuth": 120.0, "elevation": 35.0, "intensity": 3.0}
    a = jh.hybrid_render(*size, j, CAM, mode=mode, sun=sun, aovs=AOVS)
    b = th.hybrid_render(*size, t, CAM, mode=mode, sun=sun, aovs=AOVS)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    assert u8_close(a["rgba"], b["rgba"]) >= 0.995
    assert (a["kind"] == b["kind"]).mean() >= 0.999
    assert (a["visibility"] == b["visibility"]).mean() >= 0.999
    both_ = (a["visibility"] > 0) & (b["visibility"] > 0)
    assert np.all(np.abs(b["depth"][both_] - a["depth"][both_]) / a["depth"][both_] <= 1e-4)
    assert float_close(a["normal"], b["normal"]) >= 0.995
    assert float_close(a["albedo"], b["albedo"]) >= 0.995
    expect = {"hybrid": {0, 1, 2}, "terrain_only": {0}, "mesh_only": {1}, "sdf_only": {2}}[mode]
    assert set(np.unique(b["kind"][b["visibility"] > 0]).tolist()) == expect


def test_rgba_only_and_unknown_mode(scenes):
    j, t = scenes
    a = jh.hybrid_render(96, 64, j, CAM, exposure=1.7, env_intensity=0.6)
    b = th.hybrid_render(96, 64, t, CAM, exposure=1.7, env_intensity=0.6)
    assert sorted(b) == ["rgba"] and u8_close(a["rgba"], b["rgba"]) >= 0.995
    for fn, scene in ((jh.hybrid_render, j), (th.hybrid_render, t)):
        with pytest.raises(ValueError, match="unknown traversal mode 'warp'"):
            fn(32, 32, scene, CAM, mode="warp")


def test_scene_from_numpy(scenes):
    j, t = scenes
    ts, st = j.terrain_scene, j.terrain_static
    fields = {k: np.asarray(getattr(ts, k)) for k in ts._fields}
    static = dataclasses.asdict(st)
    mesh = {k: np.asarray(getattr(j.mesh_scene, k)) for k in j.mesh_scene._fields}
    tape = {k: np.asarray(getattr(j.sdf_scene.tape, k)) for k in j.sdf_scene.tape._fields}
    tape.update(tape_len=j.sdf_scene.tape_len, stack_depth=j.sdf_scene.stack_depth,
                primitive_count=j.sdf_scene.primitive_count,
                node_count=j.sdf_scene.node_count, bounds=None)
    c = hybrid_scene_from_numpy(terrain=(fields, static), mesh=mesh,
                                mesh_normals=np.asarray(j.mesh_normals), sdf=tape)
    np.testing.assert_array_equal(c.mesh_normals.numpy(), t.mesh_normals.numpy())
    a = th.hybrid_render(64, 48, t, CAM, aovs=AOVS)
    b = th.hybrid_render(64, 48, c, CAM, aovs=AOVS)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_render_adjudication_pair_matches_jax():
    dem = dem33() * 3.0
    kw = dict(spp=2, max_frames=16, variance_threshold=1e9)   # test_hybrid_adjudication's
    a = jh.render_adjudication_pair(dem, 96, 72, **kw)
    b = th.render_adjudication_pair(dem, 96, 72, device="cpu", **kw)
    assert sorted(a) == sorted(b) == ["metrics", "pt", "raster"]
    for k in ("pt", "raster"):
        assert a[k].shape == b[k].shape and u8_close(a[k], b[k]) >= 0.995, k
    assert sorted(a["metrics"]) == sorted(b["metrics"])
    for k, v in a["metrics"].items():
        assert abs(b["metrics"][k] - v) <= 1e-3 * max(1.0, abs(v)), k


def test_image_metrics_equal():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (40, 48, 3), np.uint8)
    noisy = np.clip(img.astype(int) + rng.integers(-12, 12, img.shape), 0, 255).astype(np.uint8)
    assert tm.image_metrics(img, noisy) == jm.image_metrics(img, noisy)
    assert tm.mean_abs_error(img, noisy) == jm.mean_abs_error(img, noisy)
    np.testing.assert_array_equal(tm.delta_e2000(img, noisy), jm.delta_e2000(img, noisy))
    gray = img[..., 0]
    assert tm.image_metrics(gray, gray[::-1]) == jm.image_metrics(gray, gray[::-1])
    f = rng.random((16, 16, 3))
    np.testing.assert_array_equal(tm._srgb_to_lab(f), jm._srgb_to_lab(f))


def test_hybrid_entries_default_to_cuda():
    """build_hybrid_scene and render_adjudication_pair as the JAX package
    calls them run on the card: without CUDA they raise DeviceError."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        th.build_hybrid_scene(heightmap=dem33())
    with pytest.raises(DeviceError, match="CUDA is not available"):
        th.render_adjudication_pair(dem33(), 16, 12)
