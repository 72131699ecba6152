# The port's Hosek-Wilkie sky (forge3d_tpu_torch.sky: the host cooking and
# kernel E5's plain version), its environment bake, the tonemap operators
# and the colormap sample against the JAX package, on the CPU.
#
# Gates: the cooked coefficients bit-equal (the same float64 host numpy,
# rounded once); radiance, bakes, tonemaps and LUT samples within
# 1e-5 * (1 + |ref|) on every element (float32 in the same operation order;
# exp/acos/pow may differ by an ulp).
import numpy as np
import pytest
import torch

from forge3d_tpu import colormaps as jcm
from forge3d_tpu import sky as jsky
from forge3d_tpu.ops import tonemap as jtm

from forge3d_tpu_torch import colormaps as tcm
from forge3d_tpu_torch import sky as tsky
from forge3d_tpu_torch.errors import DeviceError
from forge3d_tpu_torch.ops import tonemap as ttm

torch.set_num_threads(1)

SUNS = [(315.0, 45.0, 3.0, 0.3), (120.0, 8.0, 1.0, 0.0), (10.0, 70.0, 10.0, 1.0),
        (200.0, -5.0, 6.4, 0.55), (90.0, 30.0, 2.5, 0.1)]


def within(ref, got, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return (np.abs(got - ref) <= tol * (1.0 + np.abs(ref))) | (np.isnan(ref) & np.isnan(got))


@pytest.mark.parametrize("sun", SUNS, ids=[f"sun{i}" for i in range(len(SUNS))])
def test_hosek_cooking_bit_equal(sun):
    az, el, turb, alb = sun
    ref = jsky.make_hosek_sky(az, el, turbidity=turb, ground_albedo=alb, exposure=0.8)
    got = tsky.make_hosek_sky(az, el, turbidity=turb, ground_albedo=alb, exposure=0.8)
    for a, b in ((ref.sun_dir, got.sun_dir), (ref.configs, got.configs),
                 (ref.radiances, got.radiances), (ref.exposure, got.exposure)):
        a = np.asarray(a)
        assert a.dtype == np.asarray(b).dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("sun", SUNS, ids=[f"sun{i}" for i in range(len(SUNS))])
def test_hosek_radiance_plain_matches_jax(sun):
    az, el, turb, alb = sun
    rng = np.random.default_rng(int(az))
    d = rng.standard_normal((3, 4096)).astype(np.float32)
    d[1, :512] = -np.abs(d[1, :512])   # below the horizon
    ref = jsky.hosek_radiance(jsky.make_hosek_sky(az, el, turbidity=turb, ground_albedo=alb),
                              *d)
    got = tsky.hosek_radiance(tsky.make_hosek_sky(az, el, turbidity=turb, ground_albedo=alb),
                              *(torch.as_tensor(c) for c in d))
    for a, b in zip(ref, got):
        assert within(np.asarray(a), b.numpy()).all()


@pytest.mark.parametrize("size", [(128, 64), (37, 19)])
def test_hosek_environment_bake_matches_jax(size):
    w, h = size
    ref = jsky.hosek_environment_map(250.0, 33.0, turbidity=4.0, ground_albedo=0.25,
                                     exposure=1.5, width=w, height=h)
    got = tsky.hosek_environment_map(250.0, 33.0, turbidity=4.0, ground_albedo=0.25,
                                     exposure=1.5, width=w, height=h, device="cpu")
    assert got.shape == ref.shape == (h, w, 3) and got.dtype == np.float32
    assert within(ref, got).all()
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            tsky.hosek_environment_map(250.0, 33.0)   # device="cuda" by default


TONEMAP_INPUT = np.concatenate([
    np.random.default_rng(2).gamma(1.5, 0.8, (4000, 3)),
    np.array([[0.0, 1e-8, 0.003], [0.004, 0.0031308, 1.0], [64.0, 1e4, 0.5]]),
]).astype(np.float32)


@pytest.mark.parametrize("mode", ["reinhard", "reinhard_extended", "filmic", "aces"])
@pytest.mark.parametrize("exposure", [1.0, 0.37])
def test_tonemap_operators_match_jax(mode, exposure):
    ref = np.asarray(jtm.apply(mode, TONEMAP_INPUT, exposure=np.float32(exposure)))
    got = ttm.apply(mode, torch.as_tensor(TONEMAP_INPUT), exposure=exposure).numpy()
    assert within(ref, got).all()


def test_reinhard_extended_white_point_and_srgb_match_jax():
    x = torch.as_tensor(TONEMAP_INPUT)
    ref = np.asarray(jtm.reinhard_extended(TONEMAP_INPUT, 1.3, 2.5))
    assert within(ref, ttm.reinhard_extended(x, 1.3, 2.5).numpy()).all()
    ldr = np.clip(TONEMAP_INPUT / 4.0, 0, 1.2).astype(np.float32)
    assert within(np.asarray(jtm.srgb_eotf_inv(ldr)),
                  ttm.srgb_eotf_inv(torch.as_tensor(ldr)).numpy()).all()
    assert within(np.asarray(jtm.srgb_eotf(ldr)), ttm.srgb_eotf(torch.as_tensor(ldr)).numpy()).all()
    with pytest.raises(ValueError, match="unknown tonemap operator"):
        ttm.apply("hable", x)


@pytest.mark.parametrize("name", ["terrain", "viridis", "magma"])
def test_sample_lut_matches_jax(name):
    t = np.concatenate([np.linspace(-0.2, 1.2, 1001),
                        np.random.default_rng(4).uniform(0, 1, 3000)]).astype(np.float32)
    ref = jcm.sample_lut_jnp(jcm.get_lut(name), t)
    got = tcm.sample_lut(torch.as_tensor(tcm.get_lut(name)), torch.as_tensor(t))
    for a, b in zip(ref, got):
        assert within(np.asarray(a), b.numpy()).all()
    np.testing.assert_array_equal(jcm.apply(name, t * 300.0), tcm.apply(name, t * 300.0))
