# The port's path-guiding cache (forge3d_tpu_torch.guiding: the plain
# versions of kernel E7) against the JAX package's forge3d_tpu/guiding.py,
# on the CPU.
#
# Gates:
# - octa_encode, octa_decode, record's histogram and stats() bit-equal:
#   JAX's CPU scatter-add applies the records in record order, and the port
#   sums each bin in that order ([1e8, 1, 1, -1e8] into one bin of 0 gives
#   0 only so);
# - sample's dy and pdf bit-equal (the sampled bin: the row total and the
#   CDF follow XLA's CPU sum and cumsum orders, and one ulp of the CDF would
#   flip a bin) at octa_res 8, 16 and 24; dx and dz, rotated by cos and sin of
#   the jitter, within 1e-5 * (1 + |ref|) (XLA's cos and sin are not the C
#   library's; the CPU shows 8e-8);
# - a zero direction lands in bin 0 in both (0/0 is NaN, which XLA converts
#   to int32 0; torch's own conversion of NaN is undefined).
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forge3d_tpu import guiding as J

from forge3d_tpu_torch import guiding as P
from forge3d_tpu_torch.errors import DeviceError

torch.set_num_threads(1)


def records(n, seed):
    rng = np.random.default_rng(seed)
    px = rng.uniform(-20.0, 110.0, n).astype(np.float32)    # some outside the AABB
    pz = rng.uniform(-5.0, 90.0, n).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    lum = (rng.uniform(0.0, 1.0, n) * rng.choice([1e-3, 1.0, 1e3, 1e5], n)).astype(np.float32)
    return px, pz, d, lum


def caches(res, cells=6):
    return (J.GuidingCache.create((-5.0, 3.0), (100.0, 80.0), cells=cells, octa_res=res),
            P.GuidingCache.create((-5.0, 3.0), (100.0, 80.0), cells=cells, octa_res=res,
                                  device="cpu"))


@pytest.mark.parametrize("res", [4, 8, 12, 16])
def test_octa_encode_decode_bit_equal(res):
    _, _, d, _ = records(20_000, res)
    ref = np.asarray(J.octa_encode(*(jnp.asarray(c) for c in d), res))
    got = P.octa_encode(*d, res, device="cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)
    bins = np.arange(res * res, dtype=np.int32)
    assert np.array_equal(P.octa_decode(bins, res, device="cpu").numpy(),
                          np.asarray(J.octa_decode(jnp.asarray(bins), res)))


def test_octa_roundtrip():
    """tests/test_misc_modules.py:14, on the port"""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(200, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bins = P.octa_encode(d[:, 0], d[:, 1], d[:, 2], 16, device="cpu")
    back = P.octa_decode(bins, 16, device="cpu").numpy()
    assert (back * d).sum(1).min() > 0.97


def test_zero_direction_lands_in_bin_zero():
    z = np.zeros(3, np.float32)
    ref = np.asarray(J.octa_encode(jnp.asarray(z), jnp.asarray(z), jnp.asarray(z), 8))
    got = P.octa_encode(z, z, z, 8, device="cpu").numpy()
    assert got.tolist() == ref.tolist() == [0, 0, 0]
    jc, pc = caches(8)
    jc = jc.record(z, z, z, z, z, np.ones(3, np.float32))
    pc = pc.record(z, z, z, z, z, np.ones(3, np.float32))
    assert np.array_equal(pc.hist.numpy(), np.asarray(jc.hist))


@pytest.mark.parametrize("res", [8, 16])
def test_record_bit_equal_and_pure(res):
    jc, pc = caches(res)
    px, pz, d, lum = records(30_000, 17)
    hist0 = pc.hist.clone()
    jc2 = jc.record(px, pz, *d, lum)
    pc2 = pc.record(px, pz, *d, lum)
    assert np.array_equal(pc2.hist.numpy(), np.asarray(jc2.hist))
    assert torch.equal(pc.hist, hist0)                 # pure update
    assert pc2.stats() == jc2.stats()
    # a second batch on top of the first
    px, pz, d, lum = records(5_000, 18)
    assert np.array_equal(pc2.record(px, pz, *d, lum).hist.numpy(),
                          np.asarray(jc2.record(px, pz, *d, lum).hist))


def test_record_sums_in_record_order():
    one = np.zeros(4, np.float32)
    up = np.ones(4, np.float32)
    lum = np.array([1e8, 1.0, 1.0, -1e8], np.float32)
    jc = J.GuidingCache.create((0, 0), (1, 1), cells=1, octa_res=2)
    pc = P.GuidingCache.create((0, 0), (1, 1), cells=1, octa_res=2, device="cpu")
    ref = np.asarray(jc.record(one, one, one, up, one, lum).hist)
    got = pc.record(one, one, one, up, one, lum).hist.numpy()
    assert np.array_equal(got, ref)
    assert got[0, 3] == 0.0      # up is bin 3: ((1e-3 + 1e8) + 1) + 1 - 1e8 in float32


@pytest.mark.parametrize("res", [8, 16, 24])     # 24: 36 blocks of 16 bins in the CDF
def test_sample_matches_jax(res):
    jc, pc = caches(res)
    px, pz, d, lum = records(30_000, 21)
    jc = jc.record(px, pz, *d, lum)
    pc = pc.record(px, pz, *d, lum)
    rng = np.random.default_rng(22)
    u1 = rng.uniform(0.0, 1.0, 20_000).astype(np.float32)
    u2 = rng.uniform(0.0, 1.0, 20_000).astype(np.float32)
    qx, qz = px[:20_000], pz[:20_000]
    ref = [np.asarray(v) for v in jc.sample(qx, qz, u1, u2)]
    got = [v.numpy() for v in pc.sample(qx, qz, u1, u2)]
    assert np.array_equal(got[1], ref[1])          # dy: the bin's own
    assert np.array_equal(got[3], ref[3])          # pdf
    for i in (0, 2):
        assert (np.abs(got[i] - ref[i]) <= 1e-5 * (1.0 + np.abs(ref[i]))).all()
    assert (ref[3] > 0).all()


def test_guiding_learns_direction():
    """tests/test_misc_modules.py:29, on the port"""
    cache = P.GuidingCache.create((0, 0), (100, 100), cells=4, octa_res=8, device="cpu")
    n = 500
    cache = cache.record(np.full(n, 10.0), np.full(n, 10.0), np.zeros(n), np.ones(n),
                         np.zeros(n), np.full(n, 5.0))
    dx, dy, dz, pdf = cache.sample(np.full(64, 10.0), np.full(64, 10.0),
                                   np.linspace(0.01, 0.99, 64), np.full(64, 0.5))
    assert float((dy > 0.5).double().mean()) > 0.8
    assert float(pdf.min()) > 0
    assert cache.stats()["total_energy"] > 2000


def test_xla_orders_match_jnp():
    """the row total and CDF orders the sample depends on, at several widths"""
    rng = np.random.default_rng(4)
    for B in (4, 16, 33, 64, 144, 256, 576, 1024, 4096):
        x = (rng.uniform(0.0, 1.0, (50, B)) * rng.choice([1e-3, 1.0, 1e3, 1e5], (50, B))
             ).astype(np.float32)
        assert np.array_equal(P.xla_sum(torch.as_tensor(x)).numpy(),
                              np.asarray(jnp.sum(jnp.asarray(x), -1))), B
        assert np.array_equal(P.xla_cumsum(torch.as_tensor(x)).numpy(),
                              np.asarray(jnp.cumsum(jnp.asarray(x), -1))), B


def test_signatures_match_jax_but_device():
    for ref_fn, got_fn in ((J.octa_encode, P.octa_encode), (J.octa_decode, P.octa_decode),
                           (J.GuidingCache.create, P.GuidingCache.create),
                           (J.GuidingCache.record, P.GuidingCache.record),
                           (J.GuidingCache.sample, P.GuidingCache.sample),
                           (J.GuidingCache.stats, P.GuidingCache.stats)):
        ref = inspect.signature(ref_fn).parameters
        got = {k: v for k, v in inspect.signature(got_fn).parameters.items() if k != "device"}
        assert list(got) == list(ref)
        assert [(p.kind, p.default) for p in got.values()] == [
            (p.kind, p.default) for p in ref.values()]
    assert P.GuidingCache._fields == J.GuidingCache._fields


def test_create_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        P.GuidingCache.create((0, 0), (1, 1))
    with pytest.raises(DeviceError, match="CUDA is not available"):
        P.octa_encode(np.ones(2), np.ones(2), np.ones(2), 8)
