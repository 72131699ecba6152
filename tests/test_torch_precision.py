# The port's double-float arithmetic (forge3d_tpu_torch.precision: the
# error-free transformations and the plain versions of kernel E9) against
# the JAX package's forge3d_tpu/precision.py, on the CPU.
#
# Gate: bits. JAX runs the DD ops eagerly, one correctly rounded float32
# operation at a time (XLA's CPU sqrt and division are IEEE), and the port
# does the same operations in the same order, so every (hi, lo) pair, every
# self-test report and every harness dict equals JAX's exactly.
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forge3d_tpu import precision as J

from forge3d_tpu_torch import precision as P
from forge3d_tpu_torch.errors import DeviceError

torch.set_num_threads(1)

OPS = ("add", "mul", "div", "sqrt")


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def pairs(n, seed):
    """a and b over twelve decades of magnitude, signs mixed"""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1e3, 1e3, n) * 10.0 ** rng.integers(-6, 6, n)
    b = rng.uniform(-1e3, 1e3, n) * 10.0 ** rng.integers(-6, 6, n)
    return a, b


def run_both(op, a64, b64=None):
    ja, pa = J.dd_from_f64(a64), P.dd_from_f64(a64, device="cpu")
    if op == "sqrt":
        return J.dd_sqrt(ja), P.dd_sqrt(pa)
    jb, pb = J.dd_from_f64(b64), P.dd_from_f64(b64, device="cpu")
    return getattr(J, f"dd_{op}")(ja, jb), getattr(P, f"dd_{op}")(pa, pb)


@pytest.mark.parametrize("op", OPS)
def test_dd_ops_bit_equal_at_100k(op):
    a64, b64 = pairs(100_000, 7)
    if op == "sqrt":
        a64 = np.abs(a64)
        a64[:1000] = -a64[:1000]          # negative hi: (0, 0) in both
    ref, got = run_both(op, a64, b64)
    assert got.hi.dtype == got.lo.dtype == torch.float32
    assert np.array_equal(bits(ref.hi), bits(got.hi.numpy()))
    assert np.array_equal(bits(ref.lo), bits(got.lo.numpy()))


def test_dd_from_f64_and_to_f64_equal():
    a64, _ = pairs(10_000, 3)
    ref, got = J.dd_from_f64(a64), P.dd_from_f64(a64, device="cpu")
    assert np.array_equal(bits(ref.hi), bits(got.hi.numpy()))
    assert np.array_equal(bits(ref.lo), bits(got.lo.numpy()))
    assert np.array_equal(J.dd_to_f64(ref), P.dd_to_f64(got))


def test_error_free_transformations_bit_equal():
    rng = np.random.default_rng(11)
    a = (rng.normal(size=20_000) * 10.0 ** rng.integers(-8, 8, 20_000)).astype(np.float32)
    b = (rng.normal(size=20_000) * 10.0 ** rng.integers(-8, 8, 20_000)).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for jf, pf in ((J.two_sum, P.two_sum), (J.two_prod, P.two_prod)):
        for r, g in zip(jf(jnp.asarray(a), jnp.asarray(b)), pf(ta, tb)):
            assert np.array_equal(bits(r), bits(g.numpy()))
    for r, g in zip(J._split(jnp.asarray(a)), P._split(ta)):
        assert np.array_equal(bits(r), bits(g.numpy()))


def test_dd_exactness_small():
    """tests/test_assurance.py:150: f64 values unrepresentable in f32
    survive a DD round-trip add"""
    a = P.dd_from_f64([1.0 + 2.0 ** -30], device="cpu")
    b = P.dd_from_f64([2.0 ** -31], device="cpu")
    s = P.dd_to_f64(P.dd_add(a, b))
    assert s[0] == 1.0 + 2.0 ** -30 + 2.0 ** -31
    ref = J.dd_to_f64(J.dd_add(J.dd_from_f64([1.0 + 2.0 ** -30]), J.dd_from_f64([2.0 ** -31])))
    assert np.array_equal(s, ref)


def test_dd_sqrt_of_zero_and_negative_hi():
    a64 = np.array([0.0, -0.0, -4.0, -1e-30, 4.0, 2.0])
    ref, got = run_both("sqrt", a64)
    assert np.array_equal(bits(ref.hi), bits(got.hi.numpy()))
    assert np.array_equal(bits(ref.lo), bits(got.lo.numpy()))
    assert got.hi.numpy()[:4].tolist() == [0.0] * 4 and got.lo.numpy()[:4].tolist() == [0.0] * 4
    assert float(got.hi[4]) == 2.0 and float(got.lo[4]) == 0.0


def test_dd_selftest_reports_equal():
    """tests/test_assurance.py:138: the u^2 bounds hold, and the report
    equals JAX's key for key"""
    ref = J.dd_selftest(n=200_000, seed=1)
    got = P.dd_selftest(n=200_000, seed=1, device="cpu")
    assert got == ref
    assert got["ok"], got
    for op in OPS:
        assert got[op]["max_err_u2"] <= got[op]["bound_u2"], (op, got[op])


@pytest.mark.parametrize("op", OPS)
def test_dd_harness_equal(op):
    a, b = pairs(64, 5)
    if op == "sqrt":
        a, b = np.abs(a), None
    assert P.dd_harness(op, a, b, device="cpu") == J.dd_harness(op, a, b)


def test_dd_harness_unknown_op():
    with pytest.raises(ValueError, match="unknown dd op"):
        P.dd_harness("pow", [1.0], [2.0], device="cpu")


@pytest.mark.parametrize("kw", [{}, dict(anchor=6.4e6, extent=50.0, n=4096, seed=9)])
def test_dd_jitter_demo_equal(kw):
    got = P.dd_jitter_demo(**kw, device="cpu")
    assert got == J.dd_jitter_demo(**kw)
    assert got["dd_max_err"] < got["f32_max_err"]


def test_signatures_match_jax_but_device():
    for name in ("dd_from_f64", "dd_to_f64", "dd_add", "dd_mul", "dd_div", "dd_sqrt",
                 "two_sum", "two_prod", "dd_selftest", "dd_harness", "dd_jitter_demo"):
        ref = inspect.signature(getattr(J, name)).parameters
        got = {k: v for k, v in inspect.signature(getattr(P, name)).parameters.items()
               if k != "device"}
        assert list(got) == list(ref), name
        assert [p.default for p in got.values()] == [p.default for p in ref.values()], name


def test_dd_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        P.dd_from_f64([1.0])
    with pytest.raises(DeviceError, match="CUDA is not available"):
        P.dd_selftest(n=16)
    with pytest.raises(DeviceError, match="CUDA is not available"):
        P.dd_harness("add", [1.0], [2.0])
