# The port's deterministic engines against the JAX package's on the CPU:
# the mesh engine `pt_render_gpu_mesh` (P2's plain version, through the BVH
# walk K9's plain version) and the sphere engine `pt_render_aovs` /
# `pt_render_gpu` (P1's plain version), on the golden scenes of
# tests/_golden_scenes.py and on variants that reach the other branches
# (a town of boxes with a material and a sun, anisotropic and emissive
# spheres, an empty sphere list).
#
# Tolerances: rgba within 1 u8 step on >= 99.5% of pixels; each AOV within
# 1e-5 * (1 + |ref|) on >= 99.5% of its elements (powf, sqrt and the
# camera's tan may round differently between XLA and PyTorch, and a pixel on
# a silhouette may flip).
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from forge3d_tpu.geometry import primitive_mesh, weld_mesh  # noqa: E402
from forge3d_tpu.pt import megakernel as jmk  # noqa: E402
from forge3d_tpu.pt import mesh_render as jmr  # noqa: E402

import forge3d_tpu_torch as f3t  # noqa: E402
from forge3d_tpu_torch.pt import megakernel as tmk  # noqa: E402
from forge3d_tpu_torch.errors import DeviceError  # noqa: E402
from forge3d_tpu_torch.pt import mesh_render as tmr  # noqa: E402

from tests.test_torch_bvh import box_town  # noqa: E402

U8_FRAC = 0.995
TOL, FRAC = 1e-5, 0.995


def assert_outputs_match(ref: dict, got: dict):
    assert sorted(ref) == sorted(got)
    a, b = ref["rgba"].astype(np.int32), got["rgba"].astype(np.int32)
    assert a.shape == b.shape and got["rgba"].dtype == np.uint8
    assert (np.abs(a - b).max(-1) <= 1).mean() >= U8_FRAC
    for k in ref:
        if k == "rgba":
            continue
        x, y = np.asarray(ref[k], np.float64), np.asarray(got[k], np.float64)
        assert x.shape == y.shape and got[k].dtype == np.float32, k
        assert (np.abs(x - y) <= TOL * (1.0 + np.abs(x))).mean() >= FRAC, k


def golden_box():
    m = weld_mesh(primitive_mesh("box"))
    return m.vertices, m.indices


MESH_CASES = {
    # tests/_golden_scenes.py:render_mesh_box
    "golden_box": lambda: (golden_box(), {"origin": (1.2, 1.0, 2.2), "look_at": (0, 0, 0)},
                           {}),
    "town_material_sun": lambda: (box_town(4), {"origin": (20, 45, 90), "look_at": (20, 2, 20),
                                                "fov_y": 50.0, "exposure": 1.4},
                                  dict(material={"albedo": (0.6, 0.5, 0.4), "metallic": 0.4,
                                                 "roughness": 0.3, "emissive": (0.05, 0.0, 0.0)},
                                       sun={"azimuth": 60.0, "elevation": 30.0,
                                            "intensity": 4.0})),
}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_pt_render_gpu_mesh_matches_jax(case):
    (v, i), cam, kw = MESH_CASES[case]()
    ref = jmr.pt_render_gpu_mesh(96, 72, v, i, cam, aovs=jmk.AOV_NAMES, **kw)
    got = f3t.pt_render_gpu_mesh(96, 72, v, i, cam, aovs=tmk.AOV_NAMES, device="cpu", **kw)
    assert_outputs_match(ref, got)
    vis = got["visibility"]
    assert 0.02 < vis.mean() < 0.98   # the mesh and the sky both in view
    assert got["rgba"][..., :3].std() > 5.0


def test_mesh_tracer_scene_and_refusals():
    v, i = box_town(3)
    ref = jmr.MeshTracerScene(v, i)
    got = tmr.MeshTracerScene(v, i, device="cpu")
    assert got.triangle_count == ref.triangle_count and got.n_nodes == ref.n_nodes
    np.testing.assert_array_equal(np.asarray(ref.face_normals), got.face_normals.numpy())
    # a scene built once renders as the vertices do
    a = f3t.pt_render_gpu_mesh(48, 32, v, i, {"origin": (15, 30, 60), "look_at": (15, 0, 15)},
                               device="cpu")
    b = f3t.pt_render_gpu_mesh(48, 32, None, None, {"origin": (15, 30, 60),
                                                    "look_at": (15, 0, 15)},
                               scene=got, device="cpu")
    np.testing.assert_array_equal(a["rgba"], b["rgba"])
    for fn in (jmr.pt_render_gpu_mesh, f3t.pt_render_gpu_mesh):
        with pytest.raises(ValueError, match="positive"):
            fn(0, 8, v, i)
    with pytest.raises(ValueError, match="lies on"):
        tmr.pt_render_gpu_mesh(8, 8, None, None, scene=_FakeScene(torch.device("meta")),
                               device="cpu")


class _FakeScene:
    """A mesh scene that claims another device."""

    def __init__(self, device):
        self.device = device


GOLDEN_SPHERES = [  # tests/_golden_scenes.py:render_megakernel_spheres
    {"center": (0, 1, 0), "radius": 1.0, "albedo": (0.8, 0.2, 0.2), "roughness": 0.3},
    {"center": (2.2, 0.7, -1), "radius": 0.7, "albedo": (0.2, 0.4, 0.8), "metallic": 1.0,
     "roughness": 0.15},
    {"center": (-2.0, 0.5, 0.5), "radius": 0.5, "albedo": (0.9, 0.8, 0.3), "roughness": 0.6},
]

SPHERE_CASES = {
    "golden": (GOLDEN_SPHERES, {"origin": (0, 1.5, 5.5)}),
    "aniso_emissive": ([{"center": (0, 1, 0), "radius": 1.0, "ax": 0.05, "ay": 0.5,
                         "metallic": 0.7, "emissive": (0.3, 0.1, 0.0)},
                        {"center": (1.8, 0.6, 0.4), "radius": 0.6, "ax": 0.4, "ay": 0.1,
                         "roughness": 0.9},
                        {"center": (-1.5, 0.4, 1.0), "radius": 0.4, "roughness": 0.0,
                         "albedo": (1.2, -0.1, 0.5)}],
                       {"origin": (0.5, 2.5, 5.0), "look_at": (0, 0.8, 0), "fov_y": 55.0,
                        "exposure": 0.7}),
    "empty": ([], None),
}


@pytest.mark.parametrize("case", sorted(SPHERE_CASES))
def test_pt_render_aovs_matches_jax(case):
    scene, cam = SPHERE_CASES[case]
    ref = jmk.pt_render_aovs(96, 72, scene, cam)
    got = f3t.pt_render_aovs(96, 72, scene, cam, device="cpu")
    assert_outputs_match(ref, got)
    assert got["rgba"][..., :3].std() > 5.0
    np.testing.assert_array_equal(got["rgba"], f3t.pt_render_gpu(96, 72, scene, cam,
                                                                  device="cpu"))


def test_sphere_scene_parsing_and_refusals():
    ref = jmk.spheres_from_dicts(SPHERE_CASES["aniso_emissive"][0])
    got = tmk.spheres_from_dicts(SPHERE_CASES["aniso_emissive"][0])
    for k in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, k)), getattr(got, k).numpy(),
                                      err_msg=k)
    # a SphereBatch is taken as it is
    a = tmk.pt_render_aovs(32, 24, got, None, aovs=("depth",), device="cpu")
    b = tmk.pt_render_aovs(32, 24, SPHERE_CASES["aniso_emissive"][0], None, aovs=("depth",),
                           device="cpu")
    assert sorted(a) == ["depth", "rgba"]
    np.testing.assert_array_equal(a["depth"], b["depth"])
    for bad, msg in (([{"radius": 1.0}], "center"), ([(0, 0, 0)], "dicts")):
        for parse in (jmk.spheres_from_dicts, tmk.spheres_from_dicts):
            with pytest.raises(ValueError, match=msg):
                parse(bad)
    for fn in (jmk.pt_render_aovs, tmk.pt_render_aovs):
        with pytest.raises(ValueError, match="positive"):
            fn(4, 0, GOLDEN_SPHERES, None)


def test_mesh_tracer_scene_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    v, i = box_town(2)
    with pytest.raises(DeviceError, match="CUDA is not available"):
        tmr.MeshTracerScene(v, i)
