# The port's clipmap camera mode (forge3d_tpu_torch/terrain/screen.py:
# render_clipmap_scene, the plain version of S9 on the CPU, over the host
# G-buffer of terrain/clipmap_mesh.py) against the JAX package's, with the
# arguments of tests/test_screen_engine.py's engine-vs-oracle clipmap case
# (MapScene's rainier sun, POM at the recipe settings) at 128x80.
#
# Gates: the host copy's mesh, vertex heights and G-buffer arrays equal to
# JAX's; whole renders rgba within one u8 step on >= 99.5% of pixels (the
# CPU showed them byte-equal). Both renders of this file share one DEM,
# sun, span and environment, so each package builds its IBL pyramid and
# shadow map once.
import numpy as np
import pytest
import torch

from forge3d_tpu import mapscene_screen as jmss
from forge3d_tpu.terrain import clipmap_mesh as jcm
from forge3d_tpu.terrain import screen as J

from forge3d_tpu_torch.errors import DeviceError
from forge3d_tpu_torch.terrain import clipmap_mesh as tcm
from forge3d_tpu_torch.terrain import screen as T

torch.set_num_threads(1)

FRAC = 0.995


def sine_dem():
    xg = np.linspace(-1.0, 1.0, 32, dtype=np.float32)
    xx, yy = np.meshgrid(xg, xg)
    return (0.35 * np.sin(xx * np.pi * 2.0) + 0.22 * np.cos(yy * np.pi * 3.0)).astype(np.float32)


DEM = sine_dem()
AZ, EL = jmss.sun_angles_from_direction((0.64, 0.42, -0.64))
KW = dict(size_px=(128, 80), camera_mode="clipmap:4:32:32:10:0.3", terrain_span=1.0, z_scale=1.2,
          light_azimuth_deg=AZ, light_elevation_deg=EL, sun_intensity=1.15,
          sun_color=(1.0, 0.95, 0.90), ibl_intensity=0.3, cam_radius=1.44, cam_phi_deg=135.0,
          cam_theta_deg=45.0, fov_y_deg=55.0, albedo_mode="mix", colormap_strength=0.5,
          hdr_rgb=jmss.minimal_hdr_rgb(), domain=(float(DEM.min()), float(DEM.max())),
          pom=dict(enabled=True, height_scale=0.04, min_steps=12, max_steps=40, refine_steps=4,
                   occlusion=True))
LUT = J.build_lut_from_stops(jmss.TERRAIN_STOPS)


@pytest.mark.parametrize("mode", ["clipmap", "clipmap:4:32:32:10:0.3"])
def test_clipmap_mesh_and_gbuffer_equal(mode):
    cfg = tcm.ClipmapConfig.from_camera_mode(mode)
    assert cfg == tcm.ClipmapConfig(**vars(jcm.ClipmapConfig.from_camera_mode(mode)))
    ref = jcm.build_clipmap_mesh(jcm.ClipmapConfig.from_camera_mode(mode), extent=1.0)
    got = tcm.build_clipmap_mesh(cfg, extent=1.0)
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype
        np.testing.assert_array_equal(r, g)
    np.testing.assert_array_equal(
        tcm.clipmap_vertex_heights(DEM, got[1], got[2], cfg.ring_resolution, "nearest"),
        jcm.clipmap_vertex_heights(DEM, ref[1], ref[2], cfg.ring_resolution, "nearest"))
    gkw = dict(size_px=(64, 40), camera_mode=mode, terrain_span=1.0, z_scale=1.2,
               domain=KW["domain"], cam_radius=1.44, cam_phi_deg=135.0, cam_theta_deg=45.0,
               fov_y_deg=55.0, clip=(0.1, 6000.0))
    ref = jcm.rasterize_clipmap_gbuffer(DEM, **gkw)
    got = tcm.rasterize_clipmap_gbuffer(DEM, **gkw)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    assert 0.2 < got["valid"].mean() < 1.0      # terrain and background in frame


@pytest.mark.parametrize("extra", [dict(encode="srgb"), dict(generation="family")],
                         ids=["srgb_recipe", "gamma_family"])
def test_render_clipmap_scene_matches_jax(extra):
    a = J.render_clipmap_scene(DEM, LUT, **KW, **extra, unknown_option=3)
    b = T.render_clipmap_scene(DEM, LUT, device="cpu", **KW, **extra, unknown_option=3)
    assert b.shape == a.shape == (80, 128, 4) and b.dtype == np.uint8
    du = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= FRAC
    assert a[..., :3].std() > 5.0
    assert ((b[..., :3] == T.CLIP_BACKGROUND).all(-1)).mean() > 0.05   # the background


def test_render_clipmap_scene_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        T.render_clipmap_scene(DEM, LUT, **KW)
