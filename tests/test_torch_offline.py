# The port's offline accumulation session and render_offline
# (forge3d_tpu_torch.terrain: kernel R1 step's plain version on the CPU)
# and its a-trous denoiser (kernel E3's plain version) against the JAX
# package, over the 65^2 DEM at 96x64 of test_torch_terrain_renderer.py.
#
# Gates: the accumulator's resolved HDR and the AOVs within
# 1e-5 * (1 + |ref|) on >= 99.5% of elements; rgba within one u8 step on
# >= 99.5% of pixels; tile metrics (means of 1,024 luminances, summed in
# another order by XLA) within 1e-5 * (1 + |ref|), and the converged-tile
# ratio equal wherever no tile's delta lies within that tolerance of the
# threshold; the denoiser's output within 1e-5 * (1 + |ref|) everywhere.
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from forge3d_tpu.ops.denoise import atrous_denoise as j_atrous
from forge3d_tpu.terrain.offline import OfflineQualitySettings as JSettings
from forge3d_tpu.terrain.offline import render_offline as j_render_offline
from forge3d_tpu.terrain.params import make_terrain_params
from forge3d_tpu.terrain.renderer import IBL as JIBL
from forge3d_tpu.terrain.renderer import TerrainRenderer as JRenderer

from forge3d_tpu_torch.convert import terrain_params_from_dict
from forge3d_tpu_torch.errors import DeviceError
from forge3d_tpu_torch.frame import HdrFrame
from forge3d_tpu_torch.ops import denoise as dn
from forge3d_tpu_torch.terrain import offline as toff
from forge3d_tpu_torch.terrain import renderer as rr

torch.set_num_threads(1)

TOL = 1e-5


def dem65() -> np.ndarray:
    y, x = np.mgrid[0:65, 0:65].astype(np.float32)
    return (6.0 * np.sin(x * 0.15) * np.cos(y * 0.12) + 3.0 * np.sin(x * 0.4 + y * 0.3)
            ).astype(np.float32)


def params(**kw):
    p = make_terrain_params(size_px=(96, 64), cam_radius=75.0, cam_theta_deg=30.0, **kw)
    return p, terrain_params_from_dict(p.to_dict())


def within(ref, got, tol=TOL):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return (np.abs(got - ref) <= tol * (1.0 + np.abs(ref))) | (np.isnan(ref) & np.isnan(got))


def u8_close(a, b) -> float:
    return float((np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1) <= 1).mean())


@pytest.fixture(scope="module")
def renderers():
    return JRenderer(), rr.TerrainRenderer(device="cpu")


def test_session_api_matches_jax(renderers):
    jr, tr = renderers
    env = np.random.default_rng(5).uniform(0.0, 1.5, (8, 16, 3)).astype(np.float32)
    pj, pt = params(shadows=dict(softness=2.0, samples=2), water=dict(enabled=True, level=0.0),
                    ibl=dict(enabled=True), tonemap=dict(mode="filmic"))
    for r, ibl, p in ((jr, JIBL(env, 0.5), pj), (tr, rr.IBL(env, 0.5), pt)):
        r.begin_offline_accumulation(env_maps=ibl, params=p, heightmap=dem65())
    try:
        for r in (jr, tr):
            first = r.read_accumulation_metrics(5e-3)
            assert first["total_samples"] == 0 and first["mean_delta"] == float("inf")
        for batch in (3, 5):
            mj = jr.accumulate_batch(batch)
            mt = tr.accumulate_batch(batch)
            assert mj["total_samples"] == mt["total_samples"]
            for k in ("mean_delta", "p95_delta", "max_tile_delta"):
                assert within(mj[k], mt[k], 1e-4), k
            tiles_j = np.asarray(jr._offline["tiles"])
            tiles_t = tr._offline["tiles"]
            assert tiles_t.shape == (2, 3) and within(tiles_j, tiles_t).all()
        assert mt["total_samples"] == 8
        thr = 5e-3
        if not np.isclose(np.abs(tiles_j - tiles_t), thr, rtol=0, atol=1e-4).any():
            assert jr.read_accumulation_metrics(thr)["converged_tile_ratio"] == \
                tr.read_accumulation_metrics(thr)["converged_tile_ratio"]
        hj, aj = jr.resolve_offline_hdr()
        ht, at = tr.resolve_offline_hdr()
        assert isinstance(ht, HdrFrame) and ht.metadata == hj.metadata == {"samples": 8}
        assert within(hj.rgb, ht.rgb).mean() >= 0.995
        assert sorted(at.names()) == sorted(aj.names())
        for k in aj.names():
            assert at[k].dtype == np.float32 and within(aj[k], at[k]).mean() >= 0.995, k
        fj, ft = jr.tonemap_offline_hdr(hj), tr.tonemap_offline_hdr(ht)
        assert u8_close(fj.rgba, ft.rgba) >= 0.995
        assert u8_close(hj.tonemapped("aces", 1.2).rgba,
                        ht.tonemapped("aces", 1.2, device="cpu").rgba) >= 0.995
    finally:
        jr.end_offline_accumulation()
        tr.end_offline_accumulation()
    assert not tr.offline_session_active()


@pytest.mark.parametrize("denoiser", ["off", "atrous"])
def test_render_offline_matches_jax(renderers, denoiser):
    jr, tr = renderers
    pj, pt = params(sampling=dict(aa_seed=3), height_ao=dict(enabled=True, samples=2),
                    output_srgb_eotf=True)
    kw = dict(max_samples=8, min_samples=4, batch_size=4, denoiser=denoiser,
              denoise_iterations=3)
    seen = []
    out_j = j_render_offline(jr, params=pj, heightmap=dem65(),
                             settings=JSettings(enabled=True, **kw))
    out_t = toff.render_offline(tr, params=pt, heightmap=dem65(),
                                settings=toff.OfflineQualitySettings(enabled=True, **kw),
                                progress_callback=seen.append, certificate={})
    assert out_t.metadata["samples"] == out_j.metadata["samples"] == 8
    assert out_t.metadata["batches"] == out_j.metadata["batches"] == 2
    assert out_t.metadata["denoiser"] == denoiser and len(seen) == 2
    assert seen[-1].samples_so_far == 8 and out_t.metadata["certificate_payload_sha256"]
    assert within(out_j.hdr_frame.rgb, out_t.hdr_frame.rgb).mean() >= 0.995
    for k in out_j.aov_frame.names():
        assert within(out_j.aov_frame[k], out_t.aov_frame[k]).mean() >= 0.995, k
    assert u8_close(out_j.frame.rgba, out_t.frame.rgba) >= 0.995
    assert not tr.offline_session_active()
    with pytest.raises(ValueError, match="unknown denoiser"):
        toff.render_offline(tr, params=pt, heightmap=dem65(),
                            settings=toff.OfflineQualitySettings(enabled=True, denoiser="x"))


GUIDES = ["none", "albedo", "normal", "depth", "all"]


@pytest.mark.parametrize("guides", GUIDES)
def test_atrous_plain_matches_jax(guides):
    rng = np.random.default_rng(9)
    H, W = 37, 53
    color = rng.gamma(2.0, 0.4, (H, W, 3)).astype(np.float32)
    depth = rng.uniform(10.0, 80.0, (H, W)).astype(np.float32)
    depth[:3, :7] = np.nan
    depth[5, 5] = np.inf
    planes = {"albedo": rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
              "normal": rng.standard_normal((H, W, 3)).astype(np.float32),
              "depth": depth}
    kw = planes if guides == "all" else ({} if guides == "none" else {guides: planes[guides]})
    ref = np.asarray(j_atrous(color, iterations=5, **kw))
    got = dn.atrous_denoise(color, iterations=5, device="cpu", **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert within(ref, got.numpy()).all()
    assert within(ref, dn.atrous_denoise_plain(color, iterations=5, **kw).numpy()).all()
    assert np.abs(ref - color).max() > 1e-3
    svgf = dn.svgf_denoise(torch.as_tensor(color), kw, iterations=5)
    np.testing.assert_array_equal(svgf.numpy(), got.numpy())


def test_atrous_rejects_bad_color_and_oidn_fails_closed():
    with pytest.raises(ValueError, match=r"color must be \(H, W, 3\)"):
        dn.atrous_denoise(np.zeros((4, 4), np.float32), device="cpu")
    with pytest.raises(NotImplementedError, match="OIDN"):
        dn.oidn_denoise(np.zeros((4, 4, 3), np.float32))
    out = dn.atrous_denoise(np.ones((6, 5, 3), np.float32), iterations=0, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.ones((6, 5, 3), np.float32))


def test_numpy_input_defaults_to_cuda():
    """Numpy input is denoised and tonemapped on the card unless the caller
    asks for the CPU; without CUDA that raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    color = np.ones((6, 5, 3), np.float32)
    with pytest.raises(DeviceError, match="CUDA is not available"):
        dn.atrous_denoise(color)
    with pytest.raises(DeviceError, match="CUDA is not available"):
        dn.svgf_denoise(color, {"depth": np.ones((6, 5), np.float32)})
    with pytest.raises(DeviceError, match="CUDA is not available"):
        HdrFrame(rgb=color).tonemapped()
    with pytest.raises(DeviceError, match="unsupported device"):
        dn.atrous_denoise(torch.as_tensor(color), device="meta")


@pytest.mark.parametrize("unported", ["screen_camera", "vt_store"])
def test_offline_session_ignores_screen_camera_and_vt(renderers, unported):
    """The offline session renders the perspective shade whatever
    camera_mode or material_set ask, as the JAX package's does, where the
    one-shot renders refuse both. Gates as in test_session_api_matches_jax."""
    jr, tr = renderers
    kw = {"camera_mode": "screen"} if unported == "screen_camera" else {}
    mats = SimpleNamespace(vt_store={"pages": 1}) if unported == "vt_store" else None
    pj, pt = params(sampling=dict(aa_seed=7), **kw)
    outs = []
    for r, p in ((jr, pj), (tr, pt)):
        r.begin_offline_accumulation(material_set=mats, params=p, heightmap=dem65())
        try:
            r.accumulate_batch(2)
            hdr, aov = r.resolve_offline_hdr()
            outs.append((hdr, aov, r.tonemap_offline_hdr(hdr)))
        finally:
            r.end_offline_accumulation()
    (hj, aj, fj), (ht, at, ft) = outs
    assert within(hj.rgb, ht.rgb).mean() >= 0.995
    for k in aj.names():
        assert within(aj[k], at[k]).mean() >= 0.995, k
    assert u8_close(fj.rgba, ft.rgba) >= 0.995
