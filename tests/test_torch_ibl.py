# The port's IBL bake E1 (forge3d_tpu_torch/ops/ibl.py, the plain version on
# the CPU) against the JAX package's forge3d_tpu/ops/ibl.py: bake_ibl at
# the "low" tier on a seeded 64x32 HDR equirect, every map.
#
# Gates: the BRDF LUT (numpy on the host in both) bit-equal; the cube, the
# specular mips and the irradiance map within 1e-5 * (1 + |ref|) on every
# texel: the gather and the sums are bit-equal, which the test shows by
# handing the port XLA's atan2 and acos, and only those two transcendental
# calls move a texel. The tiers' ValueError is JAX's.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forge3d_tpu.ops import ibl as J

from forge3d_tpu_torch.errors import DeviceError
from forge3d_tpu_torch.ops import ibl as P

torch.set_num_threads(1)

ENV = np.random.default_rng(23).uniform(0.0, 4.0, (32, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_low():
    return J.bake_ibl(ENV, quality="low")


def maps(m):
    return {"cubemap": m.cubemap, "brdf": m.brdf, "irradiance": m.irradiance,
            **{f"mip{i}": x for i, x in enumerate(m.specular_mips)}}


def test_bake_low_matches_jax(jax_low):
    ref, got = maps(jax_low), maps(P.bake_ibl(ENV, quality="low", device="cpu"))
    assert ref.keys() == got.keys()
    for k in ref:
        a = np.asarray(ref[k], np.float64)
        b = got[k].numpy()
        assert b.dtype == np.float32 and a.shape == b.shape, k
        assert (np.abs(b - a) <= 1e-5 * (1.0 + np.abs(a))).all(), k
    assert np.array_equal(np.asarray(ref["brdf"]), got["brdf"].numpy())


def test_bake_is_bit_equal_given_xla_transcendentals(jax_low, monkeypatch):
    monkeypatch.setattr(torch, "atan2", lambda a, b: torch.as_tensor(
        np.array(jnp.arctan2(a.numpy(), b.numpy()))))
    monkeypatch.setattr(torch, "acos", lambda a: torch.as_tensor(
        np.array(jnp.arccos(a.numpy()))))
    ref, got = maps(jax_low), maps(P.bake_ibl(ENV, quality="low", device="cpu"))
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), got[k].numpy()), k


def test_sample_equirect_wraps_u_and_clamps_v():
    rng = np.random.default_rng(5)
    d = rng.standard_normal((500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4] = [[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1e-9, 0.2, -1.0]]
    ref = np.asarray(J.sample_equirect(jnp.asarray(ENV), jnp.asarray(d)), np.float64)
    got = P.sample_equirect(torch.as_tensor(ENV), torch.as_tensor(d)).numpy()
    assert (np.abs(got - ref) <= 1e-5 * (1.0 + np.abs(ref))).all()


def test_unknown_tier_and_default_device():
    with pytest.raises(ValueError, match="unknown IBL quality"):
        J.bake_ibl(ENV, quality="ultra")
    with pytest.raises(ValueError, match="unknown IBL quality"):
        P.bake_ibl(ENV, quality="ultra", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        P.bake_ibl(ENV, quality="low")
