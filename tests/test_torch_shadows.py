# The port's CSM shadow state (forge3d_tpu_torch.shadows: a host copy of
# the state and its functions, and the Peter-panning probe over K5's plain
# version) against the JAX package's forge3d_tpu/shadows.py, on the CPU, and
# the top-level names the slice adds (sky, guiding, precision, shadows, the
# dd_* names and the eight CSM names).
#
# Gates: every state function's result and error equal; the probe's dict
# equal at the same DEM, seed and sample count (K5's hit masks agree on
# every probe here).
import importlib.util
import inspect

import numpy as np
import pytest
import torch

import forge3d_tpu as f3d
from forge3d_tpu import shadows as J

import forge3d_tpu_torch as f3t
from forge3d_tpu_torch import shadows as P
from forge3d_tpu_torch.errors import DeviceError

torch.set_num_threads(1)

CSM_NAMES = ("configure_csm", "set_csm_enabled", "set_csm_light_direction",
             "set_csm_pcf_kernel", "set_csm_bias_params", "set_csm_debug_mode",
             "get_csm_cascade_info", "validate_csm_peter_panning")


def sync_state():
    """Start the port's state from the JAX module's: the comparisons below
    read keys that they do not set, and another test file in the same
    process may have left the JAX module's state changed."""
    P._STATE.clear()
    P._STATE.update(J.csm_state())


@pytest.fixture(autouse=True)
def restore_state():
    """Both modules keep process-wide state: start them equal, and leave
    them as found."""
    saved = (J.csm_state(), P.csm_state())
    sync_state()
    yield
    J._STATE.clear()
    J._STATE.update(saved[0])
    P._STATE.clear()
    P._STATE.update(saved[1])


def both(name, *args, **kw):
    return getattr(J, name)(*args, **kw), getattr(P, name)(*args, **kw)


def compare_configure_sequence():
    """tests/test_misc_modules.py:243's calls on both modules: every result
    and the state after them equal."""
    ref, got = both("configure_csm", cascade_count=4, near=0.5, far=500.0, debug_mode=2,
                    unknown_key=1)
    assert got == ref
    for name, args in (("set_csm_light_direction", (-1.0, -2.0, -0.5)),
                       ("set_csm_pcf_kernel", (5,)), ("set_csm_bias_params", (1e-3, 2e-3)),
                       ("set_csm_debug_mode", (3,)), ("set_csm_enabled", (False,))):
        assert both(name, *args) == (None, None)
    assert P.csm_state() == J.csm_state()
    ref, got = both("get_csm_cascade_info")
    assert got == ref
    assert got["count"] == 4 and got["splits"] == sorted(got["splits"])
    assert got["splits"][-1] == pytest.approx(500.0, rel=1e-6)
    assert np.isclose(np.linalg.norm(got["light_direction"]), 1.0)


def compare_state_functions():
    """tests/test_torch_host_copies.py:test_csm_state_functions_equal's calls
    on both modules."""
    for mod in (J, P):
        mod.configure_csm(cascade_count=3, near=1.0, far=800.0, lam=0.5, pcf_kernel=7)
        mod.set_csm_light_direction(0.3, -1.0, 0.2)
        mod.set_csm_bias_params(2e-3, 4e-3)
    assert P.csm_state() == J.csm_state()
    assert P.get_csm_cascade_info() == J.get_csm_cascade_info()


def fresh_instance(mod):
    """A second instance of `mod`'s file, loaded apart from the one that
    the other tests (and other files in the process) change."""
    spec = importlib.util.spec_from_file_location(f"{mod.__package__}._fresh_shadows",
                                                  mod.__file__)
    out = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(out)
    return out


def test_csm_default_state_equal():
    """The state each module starts with, before any call: every key, those
    that no comparison sets (lambda, bias, slope_bias, enabled, the light,
    pcf_kernel) included, and the cascades it gives."""
    j, p = fresh_instance(J), fresh_instance(P)
    assert j._STATE and p._STATE == j._STATE
    assert p.csm_state() == j.csm_state()
    assert p.get_csm_cascade_info() == j.get_csm_cascade_info()


def test_csm_state_and_cascades_equal():
    """tests/test_misc_modules.py:243, on both"""
    compare_configure_sequence()


def test_csm_state_equal_after_misc_modules_state():
    """The order that once failed: tests/test_misc_modules.py:243-264 leaves
    the JAX module configured (cascades 4 over 0.5-500, the light
    (-1, -2, -0.5) normalised, pcf_kernel 5, biases 1e-3 and 2e-3, enabled)
    when it runs earlier in the same process. Put the JAX module into that
    state and the port into its defaults' light and PCF kernel, start the
    port from the JAX module's state as the fixture does, then run both
    comparisons."""
    P.set_csm_light_direction(-0.5, -0.8, -0.3)
    P.set_csm_pcf_kernel(3)
    J.configure_csm(cascade_count=4, near=0.5, far=500.0)
    J.set_csm_light_direction(-1.0, -2.0, -0.5)
    J.set_csm_pcf_kernel(5)
    J.set_csm_bias_params(1e-3, 2e-3)
    J.set_csm_enabled(True)
    assert J.csm_state()["pcf_kernel"] == 5 and J.csm_state() != P.csm_state()
    sync_state()
    compare_configure_sequence()
    sync_state()
    compare_state_functions()


@pytest.mark.parametrize("args", [(0.1, 1000.0, 4, 0.7), (1.0, 50.0, 1, 0.0),
                                  (0.5, 2e4, 8, 1.0)])
def test_cascade_splits_equal(args):
    assert P.cascade_splits(*args) == J.cascade_splits(*args)


@pytest.mark.parametrize("call", [
    ("set_csm_pcf_kernel", (4,)), ("set_csm_light_direction", (0.0, 0.0, 0.0)),
    ("set_csm_bias_params", (-1.0, 0.0)), ("set_csm_bias_params", (0.0, -1.0)),
    ("cascade_splits", (10.0, 1.0, 4)), ("cascade_splits", (1.0, 10.0, 0)),
    ("configure_csm", (0,)), ("configure_csm", (9,))], ids=lambda c: str(c))
def test_state_errors_equal(call):
    name, args = call
    with pytest.raises(ValueError) as ref:
        getattr(J, name)(*args)
    with pytest.raises(ValueError) as got:
        getattr(P, name)(*args)
    assert str(got.value) == str(ref.value)


def dem65():
    y, x = np.mgrid[0:65, 0:65].astype(np.float32)
    return (5.0 * np.sin(x * 0.3) * np.cos(y * 0.3) + 2.0 * np.sin(x * 0.05)).astype(np.float32)


@pytest.mark.parametrize("case", [
    dict(bias=1e-3, light=(-0.5, -0.8, -0.3), kw=dict(samples=128)),
    dict(bias=0.0, light=(-0.5, -0.3, -0.2), kw=dict(spacing=(1.5, 1.0), samples=300, seed=3)),
    dict(bias=0.5, light=(0.2, -0.4, 0.6), kw=dict(spacing=(2.0, 0.5), samples=200, seed=9)),
], ids=["defaults", "zero_bias", "large_bias"])
def test_peter_panning_probe_equal(case):
    for m in (J, P):
        m.set_csm_bias_params(case["bias"], 2e-3)
        m.set_csm_light_direction(*case["light"])
    ref = J.validate_csm_peter_panning(dem65(), **case["kw"])
    got = P.validate_csm_peter_panning(dem65(), **case["kw"], device="cpu")
    assert got == ref
    assert 0.0 <= got["occluded_fraction"] <= 1.0


def test_peter_panning_probe_small_dem():
    """tests/test_misc_modules.py:265, on the port"""
    y, x = np.mgrid[0:33, 0:33].astype(np.float32)
    dem = 5.0 * np.sin(x * 0.3) * np.cos(y * 0.3)
    P.set_csm_bias_params(1e-3, 2e-3)
    rep = P.validate_csm_peter_panning(dem, samples=64, device="cpu")
    assert 0.0 <= rep["occluded_fraction"] <= 1.0
    assert not rep["peter_panning_detected"] or rep["occluded_fraction"] < 0.01


def test_signatures_match_jax_but_device():
    for name in CSM_NAMES + ("cascade_splits", "csm_state"):
        ref = inspect.signature(getattr(J, name)).parameters
        got = {k: v for k, v in inspect.signature(getattr(P, name)).parameters.items()
               if k != "device"}
        assert list(got) == list(ref), name
        assert [(p.kind, p.default) for p in got.values()] == [
            (p.kind, p.default) for p in ref.values()], name


def test_top_level_names_resolve_as_jax():
    for name in ("sky", "guiding", "precision", "shadows"):
        assert getattr(f3t, name).__name__ == f"forge3d_tpu_torch.{name}"
        assert getattr(f3d, name).__name__ == f"forge3d_tpu.{name}"
    for name in CSM_NAMES:
        assert getattr(f3t, name) is getattr(P, name)
        assert getattr(f3d, name).__module__ == "forge3d_tpu.shadows"
    for name in ("dd_selftest", "dd_harness", "dd_jitter_demo"):
        assert getattr(f3t, name) is getattr(f3t.precision, name)
        assert getattr(f3d, name).__module__ == "forge3d_tpu.precision"
    with pytest.raises(AttributeError):
        f3t.not_a_name


def test_probe_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        P.validate_csm_peter_panning(dem65(), samples=8)
