# The port's primitives (forge3d_tpu_torch.ops.rng / shading / tonemap /
# pyramid) against the JAX package on the same inputs, made from a seed with
# numpy. The JAX side runs on the CPU as its own tests run it.
#
# Tolerances:
# - RNG words and uniforms, tent offsets, float16 rounds and u8 bytes: bit
#   exact (integer math, and float32 ops that round once on both sides).
# - Shading floats: |d| <= 1e-5 * (1 + |ref|). cos/sin/atan2/acos are not
#   correctly rounded, and XLA may contract a*b+c into an FMA, so the two
#   sides can differ by a few ulps.
# - Env-map lookups with a map: a last-ulp difference in atan2/acos can move
#   a direction across a texel border, so at most 0.1% of directions may
#   pick a neighbouring texel; all others meet the shading tolerance.
# - Pyramid: equal array for array.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from forge3d_tpu.ops import rng as jrng
from forge3d_tpu.ops import shading as jsh
from forge3d_tpu.ops import tonemap as jtm
from forge3d_tpu.ops.pyramid import build_pyramid as jax_build_pyramid

from forge3d_tpu_torch.errors import UploadError
from forge3d_tpu_torch.ops import rng as trng
from forge3d_tpu_torch.ops import shading as tsh
from forge3d_tpu_torch.ops import tonemap as ttm
from forge3d_tpu_torch.ops.pyramid import build_pyramid

torch.set_num_threads(1)

M32 = 0xFFFFFFFF
SHADE_TOL = 1e-5


def assert_shading_close(ref, got, frac=1.0):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    ok = np.abs(got - ref) <= SHADE_TOL * (1.0 + np.abs(ref))
    assert ok.mean() >= frac, f"{(~ok).sum()} of {ok.size} outside tolerance"


def _inv_xorshift32(y: np.ndarray) -> np.ndarray:
    """Inverse of one xorshift32 step (undo <<5, >>17, <<13 in turn)."""
    y = y.astype(np.uint64)
    x = y.copy()
    for _ in range(7):
        x = y ^ ((x << np.uint64(5)) & np.uint64(M32))
    x = x ^ (x >> np.uint64(17))
    y2 = x.copy()
    for _ in range(3):
        x = y2 ^ ((x << np.uint64(13)) & np.uint64(M32))
    return x.astype(np.uint32)


def _states(n=100_000, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    # states whose next word is >= 0xFFFFFF80, where u rounds to 1.0
    top = np.arange(0xFFFFFF00, 0x100000000, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([s, _inv_xorshift32(top), np.array([1, M32], np.uint32)])


class TestRng:
    def test_xorshift32_bit_exact(self):
        s = _states()
        jx, ju = jrng.xorshift32(jnp.asarray(s))
        tx, tu = trng.xorshift32(torch.as_tensor(s.astype(np.int64)))
        np.testing.assert_array_equal(np.asarray(jx).astype(np.int64), tx.numpy())
        np.testing.assert_array_equal(np.asarray(ju).view(np.uint32), tu.numpy().view(np.uint32))
        # the inverse is right, so words near 2**32 really were drawn
        assert (tu.numpy() == 1.0).sum() >= 128

    def test_chained_steps_bit_exact(self):
        s = _states(20_000, seed=1)
        js, ts = jnp.asarray(s), torch.as_tensor(s.astype(np.int64))
        for _ in range(9):
            js, ju = jrng.xorshift32(js)
            ts, tu = trng.xorshift32(ts)
            np.testing.assert_array_equal(np.asarray(ju).view(np.uint32),
                                          tu.numpy().view(np.uint32))
        np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())

    @pytest.mark.parametrize("seed,frame", [(7, 0), (123456789, 5), (0xFFFFFFFF, 92837)])
    def test_seed_state_bit_exact(self, seed, frame):
        rng = np.random.default_rng(seed % 1000)
        x = rng.integers(0, 4096, 5000).astype(np.uint32)
        y = rng.integers(0, 4096, 5000).astype(np.uint32)
        lo = jrng.derive_seed_lo(seed)
        assert trng.derive_seed_lo(seed) == lo
        js = jrng.seed_state(seed & M32, lo, jnp.asarray(x), jnp.asarray(y), frame)
        ts = trng.seed_state(seed & M32, lo, torch.as_tensor(x.astype(np.int64)),
                             torch.as_tensor(y.astype(np.int64)), frame)
        np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())

    def test_tent_offset_bit_exact(self):
        _, u = trng.xorshift32(torch.as_tensor(_states().astype(np.int64)))
        u = torch.cat([u, torch.tensor([0.0, 0.5, 1.0, np.nextafter(0.5, 0, dtype=np.float32)])])
        ref = np.asarray(jrng.tent_offset(jnp.asarray(u.numpy())))
        np.testing.assert_array_equal(ref.view(np.uint32), trng.tent_offset(u).numpy().view(np.uint32))


class TestShading:
    def _normals(self, n, seed):
        rng = np.random.default_rng(seed)
        v = rng.standard_normal((n, 3)).astype(np.float32)
        v[: n // 8, 2] = 0.0  # the basis switch at nz = 0
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        u = rng.random((n, 2)).astype(np.float32)
        return v.astype(np.float32), u

    def test_cosine_dir(self):
        v, u = self._normals(20_000, 3)
        ref = jsh.cosine_dir(*(jnp.asarray(v[:, i]) for i in range(3)),
                             jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]))
        got = tsh.cosine_dir(*(torch.as_tensor(v[:, i].copy()) for i in range(3)),
                             torch.as_tensor(u[:, 0].copy()), torch.as_tensor(u[:, 1].copy()))
        for r, g in zip(ref, got):
            assert_shading_close(r, g.numpy())

    def test_luminance(self):
        c = np.random.default_rng(4).uniform(0, 8, (3, 10_000)).astype(np.float32)
        ref = jsh.luminance(*(jnp.asarray(x) for x in c))
        assert_shading_close(ref, tsh.luminance(*(torch.as_tensor(x) for x in c)).numpy())

    def test_env_radiance_constant(self):
        v, _ = self._normals(4096, 5)
        ref = jsh.env_radiance(jsh.EnvMap(None, jnp.float32(0.35)),
                               *(jnp.asarray(v[:, i]) for i in range(3)))
        got = tsh.env_radiance(tsh.env_map(None, 0.35),
                               *(torch.as_tensor(v[:, i].copy()) for i in range(3)))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(r), g.numpy())

    def test_env_radiance_map(self):
        rng = np.random.default_rng(6)
        em = rng.uniform(0, 4, (16, 32, 3)).astype(np.float32)
        v, _ = self._normals(20_000, 7)
        v = v * rng.uniform(0.5, 3.0, (len(v), 1)).astype(np.float32)  # unnormalized in
        ref = jsh.env_radiance(jsh.EnvMap(jnp.asarray(em), jnp.float32(1.3)),
                               *(jnp.asarray(v[:, i]) for i in range(3)))
        got = tsh.env_radiance(tsh.env_map(em, 1.3),
                               *(torch.as_tensor(v[:, i].copy()) for i in range(3)))
        for r, g in zip(ref, got):
            assert_shading_close(r, g.numpy(), frac=0.999)

    @pytest.mark.parametrize("az,el", [(315.0, 45.0), (0.0, 90.0), (123.4, 8.0), (-30.0, 1e-3)])
    def test_sun_direction(self, az, el):
        ref = jsh.sun_direction(az, el)
        got = tsh.sun_direction(az, el)
        assert_shading_close([float(r) for r in ref], got)


class TestTonemap:
    def _hdr(self):
        rng = np.random.default_rng(8)
        x = np.concatenate([rng.exponential(1.0, 50_000), [0.0, 1e-8, 0.5, 65504.0, 1e6]])
        return x.astype(np.float32)

    def test_reinhard(self):
        x = self._hdr()
        for exposure in (1.0, 0.37):
            assert_shading_close(jtm.reinhard(jnp.asarray(x), exposure),
                                 ttm.reinhard(torch.as_tensor(x), exposure).numpy())

    def test_f16_round_and_u8_bit_exact(self):
        x = np.concatenate([self._hdr() / 4.0, np.linspace(-0.1, 1.1, 4097, dtype=np.float32)])
        ref = np.asarray(jtm.f16_round(jnp.asarray(x)))
        got = ttm.f16_round(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(ref.view(np.uint32), got.view(np.uint32))
        ref_u8 = np.asarray(jtm.to_u8(jnp.asarray(ref))).astype(np.uint8)
        got_u8 = ttm.to_u8(torch.as_tensor(got)).numpy().astype(np.uint8)
        np.testing.assert_array_equal(ref_u8, got_u8)


class TestPyramid:
    @pytest.mark.parametrize("shape", [(33, 33), (17, 23), (50, 19), (2, 2), (65, 40)])
    def test_equal_to_jax_package(self, shape):
        rng = np.random.default_rng(shape[0] * 100 + shape[1])
        dem = rng.standard_normal(shape).astype(np.float32) * 5.0
        ref, got = jax_build_pyramid(dem), build_pyramid(dem)
        for name in ("heights", "mm_min", "mm_max", "level_offset", "level_w", "level_h"):
            a, b = getattr(ref, name), getattr(got, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for name in ("cell_w", "cell_h", "mip_count", "h_min", "h_max", "nbytes"):
            assert getattr(ref, name) == getattr(got, name)

    def test_rejects_bad_input(self):
        with pytest.raises(UploadError):
            build_pyramid(np.zeros((1, 5), np.float32))
        bad = np.zeros((4, 4), np.float32)
        bad[1, 1] = np.nan
        with pytest.raises(UploadError):
            build_pyramid(bad)
