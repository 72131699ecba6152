# The port's own copies of the JAX package's host modules
# (forge3d_tpu_torch.errors, .camera, .mem, .assurance) against the
# originals in forge3d_tpu, on the CPU: the exception classes' names and
# chains of base names, the camera basis bit for bit, the memory ledger's
# budget refusals and records, and a render certificate's canonical JSON,
# digest and Ed25519 signature byte for byte.
import inspect

import numpy as np
import pytest

from forge3d_tpu import _version as jver
from forge3d_tpu import camera as jcam
from forge3d_tpu import errors as jerr
from forge3d_tpu import mem as jmem
from forge3d_tpu.assurance import certificate as jcert

from forge3d_tpu_torch import _version as tver
from forge3d_tpu_torch import camera as tcam
from forge3d_tpu_torch import errors as terr
from forge3d_tpu_torch import mem as tmem
from forge3d_tpu_torch.assurance import certificate as tcert


def _classes(mod):
    return {n: c for n, c in vars(mod).items()
            if inspect.isclass(c) and issubclass(c, BaseException) and c.__module__ == mod.__name__}


def test_exception_hierarchy_names_and_bases():
    ref, got = _classes(jerr), _classes(terr)
    assert sorted(ref) == sorted(got) and len(ref) == 9
    for name, cls in ref.items():
        assert [c.__name__ for c in got[name].__mro__] == [c.__name__ for c in cls.__mro__], name
    e = terr.ConvergenceError("no", frames=7, variance=0.5)
    assert (e.frames, e.variance, str(e)) == (7, 0.5, "no")
    e = terr.MemoryBudgetExceeded("big", requested_bytes=10, budget_bytes=4)
    assert (e.requested_bytes, e.budget_bytes) == (10, 4)


CAMERAS = [((0, 1, 5), (0, 0, 0), (0, 1, 0)),
           ((512.0, 260.0, 1400.0), (512.0, 0.0, 512.0), (0, 1, 0)),
           ((1.2, 1.0, 2.2), (0, 0, 0), (0, 1, 0)),
           ((16.0, 40.0, 16.0), (16.0, 0.0, 16.001), (0, 1, 0)),
           ((-3.0, 2.0, -7.5), (4.0, -1.0, 2.0), (0.1, 1.0, -0.2))]


@pytest.mark.parametrize("cam", CAMERAS, ids=[f"cam{i}" for i in range(len(CAMERAS))])
def test_camera_basis_bit_equal(cam):
    ref = jcam.camera_basis(*cam)
    got = tcam.camera_basis(*cam)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_camera_basis_refuses_a_degenerate_view():
    for mod in (jcam, tcam):
        with pytest.raises(ValueError, match="zero vector"):
            mod.camera_basis((1, 2, 3), (1, 2, 3), (0, 1, 0))


def test_memory_tracker_budget_errors():
    assert tmem.MEMORY_BUDGET_CAP == jmem.MEMORY_BUDGET_CAP
    msgs = []
    for mod, err in ((jmem, jerr), (tmem, terr)):
        t = mod.MemoryTracker(budget_bytes=1000)
        a = t.track("a", 600)
        with pytest.raises(err.MemoryBudgetExceeded) as ei:
            t.track("b", 500)
        msgs.append((str(ei.value), ei.value.requested_bytes, ei.value.budget_bytes))
        t.free(a)
        t.track("b", 500)               # fits once "a" is freed
        t.set_policy("off")
        t.track("c", 10 ** 6)
        with pytest.raises(ValueError, match="policy must be one of"):
            t.set_policy("strict")
        with pytest.raises(ValueError, match=">= 0"):
            t.track("neg", -1)
        t.set_budget(10)
        assert (t.get_policy(), t.budget_bytes) == ("off", 10)
    assert msgs[0] == msgs[1]
    # warn records a degradation instead of raising
    t = tmem.MemoryTracker(budget_bytes=8)
    t.set_policy("warn")
    n = len(tmem._DEGRADATIONS)
    t.track("x", 16)
    assert len(tmem._DEGRADATIONS) == n + 1
    assert tmem._DEGRADATIONS[-1]["category"] == "memory_budget"
    m = t.metrics()
    assert (m["tracked_bytes"], m["peak_tracked_bytes"], m["within_budget"]) == (16, 16, False)
    assert isinstance(tmem.global_tracker(), tmem.MemoryTracker)


RENDER = {"frames": 12, "variance": 3.25e-4, "rgba": np.zeros((24, 32, 4), np.uint8)}


def test_certificate_bytes_equal():
    assert tver.__version__ == jver.__version__
    body = {"b": [1, 2.5, "x"], "a": {"z": None, "y": True}}
    assert tcert.canonical_json(body) == jcert.canonical_json(body)
    ref, got = {}, {}
    jcert.emit_certificate(ref, "terrain-pt", RENDER)
    tcert.emit_certificate(got, "terrain-pt", RENDER)
    assert jcert.canonical_json(ref) == tcert.canonical_json(got)
    assert tcert.certificate_public_key_hex() == jcert.certificate_public_key_hex()
    assert tcert.verify_render_certificate(got) and jcert.verify_render_certificate(got)
    forged = dict(got, label="other")
    assert not tcert.verify_render_certificate(forged)
    seed = bytes(range(32))
    assert (tcert.sign_render_certificate_digest(got["digest"], seed)
            == jcert.sign_render_certificate_digest(got["digest"], seed))


def test_certificate_capture_passes():
    reports = []
    for mod in (jcert, tcert):
        cap = mod.begin_render_capture("capture")
        assert mod.current_capture() is cap
        cap.record_pass("frame", 1.5, index=0)
        cap.meta["w"] = 32
        out = {}
        mod.emit_certificate(out, "ignored", RENDER)
        cap.finish()
        assert mod.current_capture() is None
        reports.append(out)
    assert reports[0]["passes"] == [{"name": "frame", "ms": 1.5, "index": 0}]
    assert jcert.canonical_json(reports[0]) == tcert.canonical_json(reports[1])
