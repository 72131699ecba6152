# The port's skies (forge3d_tpu_torch.sky: the Preetham and Hosek-Wilkie
# host cooking and the plain versions of kernels E5 Preetham and E5), their
# environment bakes, the sun's ephemeris, the tonemap operators and the
# colormap sample against the JAX package, on the CPU.
#
# Gates: the cooked coefficients bit-equal (the same float64 host numpy,
# rounded once); the sun's position equal; radiance, bakes, tonemaps and
# LUT samples within 1e-5 * (1 + |ref|) on every element (float32 in the
# same operation order; XLA's exp/acos/pow on the CPU may differ from the C
# library's by an ulp).
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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


# ---------------------------------------------------------------------------
# Preetham (E5 Preetham)

PREETHAM_SUNS = [(135.0, 35.0, 3.0), (20.0, 5.0, 7.5), (300.0, 80.0, 2.0), (90.0, -3.0, 3.0),
                 (200.0, 60.0, 12.0)]


@pytest.mark.parametrize("sun", PREETHAM_SUNS, ids=[f"sun{i}" for i in range(5)])
def test_make_sky_fields_bit_equal(sun):
    az, el, turb = sun
    ref = jsky.make_sky(az, el, turbidity=turb, exposure=0.07)
    got = tsky.make_sky(az, el, turbidity=turb, exposure=0.07)
    assert got._fields == ref._fields
    for a, b in zip(ref, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sun", PREETHAM_SUNS, ids=[f"sun{i}" for i in range(5)])
def test_sky_radiance_matches_jax(sun):
    """a 64x48 grid of directions, a third of them below the horizon"""
    az, el, turb = sun
    rng = np.random.default_rng(int(az) + 7)
    d = rng.standard_normal((3, 48, 64)).astype(np.float32)
    d[1, :16] = -np.abs(d[1, :16])
    ref = jsky.sky_radiance(jsky.make_sky(az, el, turbidity=turb), *(jnp.asarray(c) for c in d))
    got = tsky.sky_radiance(tsky.make_sky(az, el, turbidity=turb), *d, device="cpu")
    for a, b in zip(ref, got):
        assert b.shape == (48, 64) and b.dtype == torch.float32
        assert within(np.asarray(a), b.numpy()).all()
        assert (b.numpy() >= 0).all()


def test_sky_model():
    """tests/test_misc_modules.py:173, on the port"""
    sky = tsky.make_sky(135, 35, turbidity=3.0)
    r, g, b = (float(c) for c in tsky.sky_radiance(sky, 0.0, 1.0, 0.0, device="cpu"))
    assert b > r                                   # clear-sky zenith is blue
    rs, gs, bs = (float(c) for c in tsky.sky_radiance(sky, *sky.sun_dir, device="cpu"))
    assert rs + gs + bs > r + g + b                # circumsolar brighter than zenith
    env = tsky.sky_environment_map(sky, 64, 32, device="cpu")
    assert env.shape == (32, 64, 3) and np.isfinite(env).all() and env.min() >= 0


@pytest.mark.parametrize("size", [(64, 32), (37, 19)])
def test_sky_environment_map_matches_jax(size):
    w, h = size
    ref = jsky.sky_environment_map(jsky.make_sky(250.0, 33.0, turbidity=4.0), w, h)
    got = tsky.sky_environment_map(tsky.make_sky(250.0, 33.0, turbidity=4.0), w, h,
                                   device="cpu")
    assert got.shape == ref.shape == (h, w, 3) and got.dtype == np.float32
    assert within(ref, got).all()
    # Preetham's bake is not Hosek's direction convention
    assert not np.allclose(tsky.preetham_directions(w, h), tsky.bake_directions(w, h))
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            tsky.sky_environment_map(tsky.make_sky(250.0, 33.0))   # device="cuda" by default


def test_sun_position_at_equal():
    """tests/test_misc_modules.py:191, and a day of hours at Rainier"""
    from forge3d_tpu.astro import julian_date

    az, alt = tsky.sun_position_at(julian_date(2026, 6, 21, 20), 47.6, -122.3)
    assert alt == pytest.approx(65.8, abs=1.0) and 150 < az < 210
    assert tsky.sun_position_at(julian_date(2026, 6, 21, 9), 47.6, -122.3)[1] < 0
    for h in range(0, 24):
        jd = 2460855.5 + h / 24.0
        assert tsky.sun_position_at(jd, 46.85, -121.76) == jsky.sun_position_at(jd, 46.85,
                                                                                 -121.76)


def test_preetham_signatures_match_jax_but_device():
    for name in ("make_sky", "sky_radiance", "sun_position_at", "sky_environment_map"):
        ref = inspect.signature(getattr(jsky, name)).parameters
        got = {k: v for k, v in inspect.signature(getattr(tsky, name)).parameters.items()
               if k != "device"}
        assert list(got) == list(ref), name
        assert [(p.kind, p.default) for p in got.values()] == [
            (p.kind, p.default) for p in ref.values()], name
