# The port's per-ray terrain path tracer (forge3d_tpu_torch.pt.terrain_ref)
# against forge3d_tpu.pt.terrain_ref: the frame step (K6's plain version)
# at frame 0 and at frame 1 after reuse, the center G-buffer (K5 + K8), and
# whole renders through both entries, on the CPU (device="cpu"), with and
# without a triangle mesh and typed lights.
#
# Tolerances:
# - Frame step and G-buffer floats: |d| <= 1e-5 * (1 + |ref|) on >= 99.9%
#   of elements, integer reservoir fields equal on >= 99.9%. The xorshift
#   streams are identical, so a difference can only come from a ray that
#   grazes a silhouette and flips on a last-ulp difference (XLA may contract
#   a*b+c into an FMA).
# - Whole renders: rgba within 1 u8 step on >= 99.5% of pixels, `frames`
#   equal, depth NaN on the same pixels; variance within 1e-4 relative.
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
import forge3d_tpu as f3d
from forge3d_tpu.lighting import Light as JLight
from forge3d_tpu.ops import restir as jrst
from forge3d_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from forge3d_tpu.ops.shading import EnvMap
from forge3d_tpu.ops.traversal import scene_from_pyramid as jax_scene_from_pyramid
from forge3d_tpu.pt import terrain_ref as jtr

import forge3d_tpu_torch as f3t
from forge3d_tpu_torch import convert
from forge3d_tpu_torch import errors as terr
from forge3d_tpu_torch.ops import restir as trst
from forge3d_tpu_torch.ops.shading import env_map
from forge3d_tpu_torch.pt import terrain_ref as ttr

torch.set_num_threads(1)

FRAC = 0.999
U8_FRAC = 0.995


def close_frac(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    ok = np.abs(got - ref) <= 1e-5 * (1.0 + np.abs(ref))
    return float((ok | (np.isnan(ref) & np.isnan(got))).mean())


def assert_reservoirs_close(ref, got: trst.Reservoirs):
    for name in jrst.Reservoirs._fields:
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name).numpy()
        if name in ("light_type", "light_index", "m"):
            assert (a.astype(np.int64) == b.astype(np.int64)).mean() >= FRAC, name
        else:
            assert close_frac(a, b) >= FRAC, name


@pytest.fixture(scope="module")
def small():
    """__graft_entry__._small_desc (128x64 over a 65^2 DEM) on both sides."""
    desc = graft._small_desc()
    pyr = jax_build_pyramid(desc.heights)
    scene, static = jax_scene_from_pyramid(pyr, spacing_xz=desc.spacing,
                                           exaggeration=desc.exaggeration)
    fields = {k: np.asarray(getattr(scene, k)) for k in scene._fields}
    tscene = convert.scene_from_numpy(fields, dict(static.__dict__))
    tdesc = ttr.TerrainRefDesc(**{k: getattr(desc, k) for k in desc.__dataclass_fields__})
    ctx = ttr.make_context(tdesc, tscene, env_map(None, desc.env_intensity))
    return desc, scene, static, ctx


def test_center_gbuffer(small):
    desc, scene, static, ctx = small
    ref = jax.jit(lambda s: jtr._center_gbuffer(desc, s, static))(scene)
    got = ttr.center_gbuffer(ctx)
    for k in ("albedo", "normal", "depth", "visibility"):
        assert got[k].shape == ref[k].shape
        assert close_frac(ref[k], got[k].numpy()) >= FRAC, k
    for a, b in zip(ref["gb_n"], got["gb_n"]):
        assert close_frac(a, b.numpy()) >= FRAC
    hit = np.isfinite(np.asarray(ref["depth"]))
    assert 0.3 < hit.mean() < 1.0


def test_frame_step_frames_0_and_1(small):
    desc, scene, static, ctx = small
    H, W = desc.height, desc.width
    env = EnvMap(rgb=None, intensity=jnp.float32(desc.env_intensity))
    step = jax.jit(jtr._make_frame_step(desc, static))
    reuse = jax.jit(jtr._make_reuse_step(desc))
    gb = jax.jit(lambda s: jtr._center_gbuffer(desc, s, static))(scene)
    tgb = ttr.center_gbuffer(ctx)

    acc, wf, res = jnp.zeros((H, W, 4)), jnp.zeros((H, W, 2)), jrst.Reservoirs.zeros(H * W)
    tacc, twf = torch.zeros(H, W, 4), torch.zeros(H, W, 2)
    tres = trst.Reservoirs.zeros(H * W)
    for frame in (0, 1):
        acc, wf, curr, res_c = step(scene, env, None, acc, wf, res, jnp.uint32(frame))
        tacc, twf, merged = ttr.frame_step(ctx, tacc, twf, tres, frame)
        assert close_frac(acc, tacc.numpy()) >= FRAC
        assert close_frac(wf, twf.numpy()) >= FRAC
        # the port's frame step returns the temporal merge of the clamped
        # history with this frame's candidates
        assert_reservoirs_close(jrst.temporal_merge(res_c, curr), merged)
        res = reuse(res_c, curr, gb["gb_n"], jnp.uint32(frame))
        tres = trst.spatial_reuse(merged, *tgb["gb_n"], W, H, frame, ctx.seed_hi)
        assert_reservoirs_close(res, tres)
    assert (np.asarray(acc)[..., 3] == 2.0).all()
    assert int(tres.m.sum()) > 0  # frame 1 shaded through reused samples


SCENE_N = 49
CAM = {"origin": (24, 20, 70), "look_at": (24, 0, 24), "fov_y": 42.0, "exposure": 1.0}
RENDERS = {
    "4_frames": dict(spp=2, max_frames=4, min_frames=2, variance_threshold=1e9),
    "window_reset": dict(spp=1, max_frames=40, min_frames=33, variance_threshold=1e9),
}


def small_dem(n=SCENE_N):
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    return (5.0 * np.sin(x * 0.2) * np.cos(y * 0.17)).astype(np.float32)


def assert_renders_match(a, b):
    assert set(a) == set(b)
    assert a["frames"] == b["frames"]
    du = np.abs(a["rgba"].astype(np.int32) - b["rgba"].astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= U8_FRAC
    assert b["rgba"].dtype == np.uint8 and (b["rgba"][..., 3] == 255).all()
    np.testing.assert_array_equal(np.isnan(a["depth"]), np.isnan(b["depth"]))
    assert abs(a["variance"] - b["variance"]) <= 1e-4 * abs(a["variance"])
    for k in ("minmax_pyramid_bytes", "gpu_resource_bytes", "converged"):
        assert a[k] == b[k], k
    assert close_frac(a["hdr"], b["hdr"]) >= U8_FRAC


@pytest.mark.parametrize("case", sorted(RENDERS))
def test_public_entry_matches(case):
    kw = RENDERS[case]
    dem = small_dem()
    a = f3d.hybrid_render_terrain_reference(dem, 64, 48, CAM, **kw)
    b = f3t.hybrid_render_terrain_reference(dem, 64, 48, CAM, device="cpu", **kw)
    assert_renders_match(a, b)


@pytest.mark.parametrize("case", sorted(RENDERS))
def test_restir_off_matches(case):
    kw = dict(RENDERS[case])
    common = dict(heights=small_dem(), width=64, height=48, cam_origin=CAM["origin"],
                  cam_look_at=CAM["look_at"], fov_y_deg=CAM["fov_y"], restir=False, **kw)
    a = jtr.render_terrain_reference(jtr.TerrainRefDesc(**common))
    b = ttr.render_terrain_reference(ttr.TerrainRefDesc(**common), device="cpu")
    assert_renders_match(a, b)


def test_env_map_low_sun_no_shadows():
    em = np.zeros((8, 16, 3), np.float32)
    em[..., 2] = 4.0
    em[:4, :, 0] = 1.0
    common = dict(heights=small_dem(), width=48, height=36, cam_origin=CAM["origin"],
                  cam_look_at=CAM["look_at"], fov_y_deg=42.0, env_map=em, env_intensity=1.0,
                  shadows_enabled=False, sun_elevation_deg=8.0, spp=1, max_frames=2,
                  min_frames=2, variance_threshold=1e9)
    assert_renders_match(jtr.render_terrain_reference(jtr.TerrainRefDesc(**common)),
                         ttr.render_terrain_reference(ttr.TerrainRefDesc(**common),
                                                      device="cpu"))


def test_mxu_is_an_alias_and_deterministic():
    kw = dict(spp=1, max_frames=2, min_frames=2, variance_threshold=1e9, device="cpu")
    a = f3t.hybrid_render_terrain_reference(small_dem(), 32, 24, CAM, traversal="dda", **kw)
    b = f3t.hybrid_render_terrain_reference(small_dem(), 32, 24, CAM, traversal="mxu", **kw)
    c = f3t.hybrid_render_terrain_reference(small_dem(), 32, 24, CAM, **kw)
    np.testing.assert_array_equal(a["rgba"], b["rgba"])
    np.testing.assert_array_equal(a["hdr"], c["hdr"])


def _both(**kw):
    kw.setdefault("spp", 1)
    dem = kw.pop("dem", small_dem())
    out = []
    for fn, extra in ((f3d.hybrid_render_terrain_reference, {}),
                      (f3t.hybrid_render_terrain_reference, {"device": "cpu"})):
        try:
            fn(dem, 32, 24, CAM, **kw, **extra)
            out.append(None)
        except Exception as e:  # noqa: BLE001 -- the test compares the types
            out.append(e)
    return out


@pytest.mark.parametrize("kw,exc", [
    (dict(dem=np.full((8, 8), np.nan, np.float32)), f3d.UploadError),
    (dict(dem=np.zeros((1, 8), np.float32)), f3d.UploadError),
    (dict(spacing=(0.0, 1.0)), f3d.RenderError),
    (dict(variance_threshold=-1.0), f3d.RenderError),
    (dict(sun_color=(1.0, -0.5, 0.5)), ValueError),
    (dict(traversal="bogus"), ValueError),
])
def test_error_paths_raise_the_same_types(kw, exc):
    # the port raises its own copy of the JAX package's class: the same name
    # and the same chain of base names
    ref, got = _both(**kw)
    assert isinstance(ref, exc), ref
    assert [c.__name__ for c in type(got).__mro__] == [c.__name__ for c in type(ref).__mro__], \
        (ref, got)
    assert type(got).__module__ in ("builtins", "forge3d_tpu_torch.errors"), got


def test_nonconvergence_raises_with_frames():
    # the JAX package raises ConvergenceError with frames == 4 for this call
    # (tests/test_terrain_ref.py::test_nonconvergence_raises)
    with pytest.raises(terr.ConvergenceError) as ei:
        f3t.hybrid_render_terrain_reference(small_dem(), 64, 48, CAM, spp=2, max_frames=4,
                                            min_frames=2, variance_threshold=1e-12,
                                            device="cpu")
    assert ei.value.frames == 4
    assert 1e-12 < ei.value.variance < float("inf")


def test_unported_features_raise_not_implemented():
    # Meshes and typed lights, once refused here, are ported: each of the
    # three calls that raised now renders and matches the JAX package.
    dem = small_dem()
    quad_v = np.array([[10, 8, 20], [38, 8, 20], [38, 22, 20]], np.float32)
    quad_i = np.array([[0, 1, 2]], np.uint32)
    kw = dict(spp=1, max_frames=2, min_frames=2, variance_threshold=1e9)
    mesh = dict(mesh_vertices=quad_v, mesh_indices=quad_i, **kw)
    # with a mesh, traversal="sweep" falls back to the per-ray engine
    a = f3d.hybrid_render_terrain_reference(dem, 32, 24, CAM, traversal="sweep", **mesh)
    b = f3t.hybrid_render_terrain_reference(dem, 32, 24, CAM, traversal="sweep", device="cpu",
                                            **mesh)
    assert_renders_match(a, b)
    b = f3t.hybrid_render_terrain_reference(dem, 32, 24, CAM, device="cpu", **mesh)
    assert_renders_match(a, b)
    common = dict(heights=dem, width=32, height=24, cam_origin=CAM["origin"],
                  cam_look_at=CAM["look_at"], fov_y_deg=42.0,
                  lights=(JLight(type="point", position=(24.0, 12.0, 30.0), intensity=80.0),),
                  **kw)
    assert_renders_match(jtr.render_terrain_reference(jtr.TerrainRefDesc(**common)),
                         ttr.render_terrain_reference(ttr.TerrainRefDesc(**common),
                                                      device="cpu"))


# ---------------------------------------------------------------------------
# Meshes and typed lights (K9 and K10 inside K6 and K8). The port builds the
# BVH itself (build_sah_bvh is bit-equal to JAX's, tests/test_torch_bvh.py)
# and its alias table from the same light rows. Tolerances as above: the
# frame step's floats within 1e-5 * (1 + |ref|) on >= 99.9% (sin/cos in the
# light sample may differ by an ulp), whole renders within 1 u8 step on
# >= 99.5% of pixels.
# ---------------------------------------------------------------------------

QUAD_V = np.array([[10, 8, 20], [38, 8, 20], [38, 22, 20], [10, 22, 20]], np.float32)
QUAD_I = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)


def six_lights(cls):
    """One light of each type (lighting.LIGHT_TYPES) over the scene."""
    types = ("directional", "point", "spot", "rect", "disk", "sphere")
    return tuple(cls(type=t, position=(20.0 + 8 * (i % 3), 14.0, 16.0 + 10 * (i // 3)),
                     direction=(0.2, -1.0, -0.3), intensity=60.0, radius=1.5,
                     extent=(2.0, 1.0), color=(1.0, 0.9 - 0.1 * i, 0.7))
                 for i, t in enumerate(types))


def test_frame_step_with_mesh_and_lights(small):
    desc, scene, static, _ = small
    H, W = desc.height, desc.width
    import dataclasses

    from forge3d_tpu.lighting import LightBuffer as JLB
    from forge3d_tpu.ops.lightsample import alias_table_build as jalias
    from forge3d_tpu.ops.lightsample import light_power_weights as jweights
    from forge3d_tpu.pt.mesh_render import MeshTracerScene as JMTS

    lights = six_lights(JLight)
    jdesc = dataclasses.replace(desc, mesh=(QUAD_V, QUAD_I), lights=lights)
    jm = JMTS(QUAD_V, QUAD_I)
    mesh_arg = (jm.scene, jm.face_normals)
    tdesc = ttr.TerrainRefDesc(**{k: getattr(jdesc, k) for k in jdesc.__dataclass_fields__})
    ctx = ttr.make_context(tdesc, small[3].scene, env_map(None, desc.env_intensity))
    # the port's BVH and alias table are the JAX package's
    for k in ("bounds_min", "first", "miss_link", "tri_e2"):
        np.testing.assert_array_equal(np.asarray(getattr(jm.scene, k)),
                                      getattr(ctx.mesh.scene, k).numpy())
    jbuf = JLB.from_lights(list(lights))
    np.testing.assert_array_equal(np.asarray(jalias(jweights(jbuf)).alias),
                                  ctx.lights[1].alias.numpy())

    env = EnvMap(rgb=None, intensity=jnp.float32(desc.env_intensity))
    step = jax.jit(jtr._make_frame_step(jdesc, static, mesh_nodes=jm.n_nodes))
    reuse = jax.jit(jtr._make_reuse_step(jdesc))
    gb = jax.jit(lambda s, m: jtr._center_gbuffer(jdesc, s, static, m, jm.n_nodes))(
        scene, mesh_arg)
    tgb = ttr.center_gbuffer(ctx)
    for k in ("albedo", "normal", "depth"):
        assert close_frac(gb[k], tgb[k].numpy()) >= FRAC, k
    on_mesh = np.all(np.asarray(gb["albedo"]) == np.float32([0.7, 0.7, 0.8]), -1)
    assert 0.02 < on_mesh.mean() < 0.9

    acc, wf, res = jnp.zeros((H, W, 4)), jnp.zeros((H, W, 2)), jrst.Reservoirs.zeros(H * W)
    tacc, twf = torch.zeros(H, W, 4), torch.zeros(H, W, 2)
    tres = trst.Reservoirs.zeros(H * W)
    for frame in (0, 1):
        acc, wf, curr, res_c = step(scene, env, mesh_arg, acc, wf, res, jnp.uint32(frame))
        tacc, twf, merged = ttr.frame_step(ctx, tacc, twf, tres, frame)
        assert close_frac(acc, tacc.numpy()) >= FRAC
        assert close_frac(wf, twf.numpy()) >= FRAC
        assert_reservoirs_close(jrst.temporal_merge(res_c, curr), merged)
        res = reuse(res_c, curr, gb["gb_n"], jnp.uint32(frame))
        tres = trst.spatial_reuse(merged, *tgb["gb_n"], W, H, frame, ctx.seed_hi)
        assert_reservoirs_close(res, tres)


def flat_light_scene(lights, **kw):
    """tests/test_lightsample.py's flat scene (64x48 over a flat 33^2 DEM,
    sun and sky off), cut to a few frames."""
    return dict(heights=np.zeros((33, 33), np.float32), albedo=(1.0, 1.0, 1.0),
                cam_origin=(16.0, 12.0, 30.0), cam_look_at=(16.0, 0.0, 16.0), fov_y_deg=40.0,
                width=64, height=48, sun_intensity=0.0, env_intensity=1e-7, spp=2,
                min_frames=4, max_frames=4, variance_threshold=1e9, restir=False,
                lights=lights, **kw)


@pytest.mark.parametrize("case", ["point", "rect", "quad_mesh_six_lights"])
def test_light_and_mesh_renders_match(case):
    if case == "point":
        common = flat_light_scene((JLight(type="point", position=(16.0, 6.0, 16.0),
                                          intensity=20.0),))
    elif case == "rect":
        common = flat_light_scene((JLight(type="rect", position=(16.0, 5.0, 16.0),
                                          intensity=4.0, extent=(2.0, 3.0)),))
    else:  # tests/test_terrain_ref.py's quad over the terrain, with six lights
        common = dict(heights=small_dem(), width=64, height=48, cam_origin=CAM["origin"],
                      cam_look_at=CAM["look_at"], fov_y_deg=42.0, spp=2, max_frames=4,
                      min_frames=2, variance_threshold=1e9, mesh=(QUAD_V, QUAD_I),
                      lights=six_lights(JLight))
    a = jtr.render_terrain_reference(jtr.TerrainRefDesc(**common))
    b = ttr.render_terrain_reference(ttr.TerrainRefDesc(**common), device="cpu")
    assert_renders_match(a, b)
    for k in ("albedo", "normal"):
        assert close_frac(a[k], b[k]) >= U8_FRAC, k
    assert a["gpu_resource_bytes"] == b["gpu_resource_bytes"]
    assert float(np.nanmax(b["hdr"])) > 0.05   # the lights light the scene


def test_mixed_scene_mesh_and_terrain():
    """tests/test_terrain_ref.py's quad scene inside the port: the quad
    shortens depth and carries the mesh albedo through the AOVs."""
    dem = small_dem()
    kw = dict(spp=2, max_frames=8, min_frames=2, variance_threshold=1e30, device="cpu")
    base = f3t.hybrid_render_terrain_reference(dem, 96, 72, CAM, **kw)
    mixed = f3t.hybrid_render_terrain_reference(dem, 96, 72, CAM, mesh_vertices=QUAD_V,
                                                mesh_indices=QUAD_I, **kw)
    ref = f3d.hybrid_render_terrain_reference(dem, 96, 72, CAM, mesh_vertices=QUAD_V,
                                              mesh_indices=QUAD_I,
                                              **{k: v for k, v in kw.items() if k != "device"})
    assert_renders_match(ref, mixed)
    d0, d1 = base["depth"], mixed["depth"]
    closer = np.isfinite(d1) & (~np.isfinite(d0) | (d1 < d0 - 1.0))
    assert closer.mean() > 0.01
    assert np.allclose(mixed["albedo"][closer], [0.7, 0.7, 0.8], atol=2e-2)
    assert mixed["gpu_resource_bytes"] > base["gpu_resource_bytes"]
