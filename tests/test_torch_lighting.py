# The port's lighting (forge3d_tpu_torch.lighting: r2_sequence and
# eval_lights, the plain version of kernel E6) against the JAX package's
# forge3d_tpu/lighting.py, on the CPU.
#
# Gates: r2_sequence bit-equal (the same float64 numpy); eval_lights within
# 1e-5 * (1 + |ref|) on every element. JAX runs it eagerly and the port
# repeats its float32 operations in order, but XLA's CPU rsqrt is not the
# correctly rounded 1 / sqrt (it differs on ~30% of float32 inputs) and its
# cos and sin are not the C library's; on these inputs the largest
# difference is 8.7e-7 (1 + |ref|), and 88% of the six-light elements are
# bit-equal (asserted below at >= 80%).
import inspect

import numpy as np
import pytest
import torch

from forge3d_tpu import lighting as J

from forge3d_tpu_torch import lighting as P
from forge3d_tpu_torch.errors import DeviceError

torch.set_num_threads(1)

LIGHTS = {
    "directional": dict(type="directional", direction=(0.3, -1.0, 0.2), intensity=2.0,
                        color=(1.0, 0.9, 0.8)),
    "point": dict(type="point", position=(1.0, 5.0, 2.0), intensity=25.0),
    "spot": dict(type="spot", position=(3.0, 5.0, 0.0), direction=(0.1, -1.0, 0.0),
                 intensity=25.0, inner_cone_deg=25, outer_cone_deg=40),
    "rect": dict(type="rect", position=(0.0, 4.0, 0.0), extent=(2.0, 1.5), intensity=16.0),
    "disk": dict(type="disk", position=(3.0, 6.0, -2.0), radius=1.5, intensity=9.0),
    "sphere": dict(type="sphere", position=(-3.0, 3.0, 2.0), radius=2.0, intensity=12.0),
}


def points(shape=(48, 64), seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-8.0, 8.0, shape + (3,)).astype(np.float32)
    p[..., 1] = rng.uniform(-1.0, 1.0, shape)
    n = rng.normal(size=shape + (3,)).astype(np.float32)
    n[..., 1] = np.abs(n[..., 1]) + 0.5
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return p, n


def both(specs, p, n, u=None):
    jb = J.LightBuffer.from_lights([J.Light(**s) for s in specs])
    pb = P.LightBuffer.from_lights([P.Light(**s) for s in specs], device="cpu")
    ref = np.asarray(J.eval_lights(jb, p, n, u=u))
    got = P.eval_lights(pb, p, n, u=u, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    return ref, got.numpy()


def assert_close(ref, got):
    assert got.shape == ref.shape
    assert (np.abs(got - ref) <= 1e-5 * (1.0 + np.abs(ref))).all()


@pytest.mark.parametrize("jitter", [False, True], ids=["plain", "r2"])
@pytest.mark.parametrize("kind", list(LIGHTS))
def test_each_light_type_matches_jax(kind, jitter):
    p, n = points()
    u = P.r2_sequence(p.shape[0] * p.shape[1]).reshape(p.shape[:-1] + (2,)) if jitter else None
    ref, got = both([LIGHTS[kind]], p, n, u)
    assert_close(ref, got)
    assert (ref > 0).mean() > 0.1       # the light reaches part of the points


@pytest.mark.parametrize("jitter", [False, True], ids=["plain", "r2"])
def test_six_lights_match_jax(jitter):
    p, n = points((64, 80), seed=3)
    u = P.r2_sequence(64 * 80, frame=2).reshape(64, 80, 2) if jitter else None
    ref, got = both(list(LIGHTS.values()), p, n, u)
    assert_close(ref, got)
    assert (got == ref).mean() >= 0.8


def test_r2_sequence_bit_equal():
    """tests/test_lighting_ibl.py:46"""
    for n, frame in ((512, 0), (512, 1), (1000, 7), (3, 0)):
        got = P.r2_sequence(n, frame=frame)
        assert got.dtype == np.float32 and np.array_equal(got, J.r2_sequence(n, frame=frame))
    s = P.r2_sequence(512)
    assert s.min() >= 0 and s.max() < 1 and np.abs(s.mean(0) - 0.5).max() < 0.05


def test_eval_lights_directional_point_spot():
    """tests/test_lighting_ibl.py:59, on the port"""
    lights = P.LightBuffer.from_lights([
        P.Light(type="directional", direction=(0, -1, 0), intensity=2.0),
        P.Light(type="point", position=(0, 5, 0), intensity=25.0),
        P.Light(type="spot", position=(10, 5, 0), direction=(0, -1, 0),
                intensity=25.0, inner_cone_deg=15, outer_cone_deg=25)], device="cpu")
    p = np.array([[0.0, 0.0, 0.0], [10.0, 0.0, 0.0], [50.0, 0.0, 0.0]], np.float32)
    n = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (3, 1))
    out = P.eval_lights(lights, p, n, device="cpu").numpy()
    assert out[0, 0] == pytest.approx(3.0, rel=1e-4)
    assert out[1, 0] > out[2, 0]
    assert out[2, 0] == pytest.approx(2.0, abs=0.1)


def test_eval_lights_area_jitter():
    """tests/test_lighting_ibl.py:79, on the port"""
    lights = P.LightBuffer.from_lights([P.Light(type="rect", position=(0, 4, 0),
                                                extent=(2, 2), intensity=16.0)], device="cpu")
    p = np.zeros((64, 3), np.float32)
    n = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (64, 1))
    out = P.eval_lights(lights, p, n, u=P.r2_sequence(64), device="cpu").numpy()
    center = P.eval_lights(lights, p[:1], n[:1], device="cpu").numpy()
    assert out.std() > 0
    assert out.mean() == pytest.approx(float(center.mean()), rel=0.25)


def test_tensor_inputs_stay_on_their_device_and_numpy_defaults_to_cuda():
    lights = P.LightBuffer.from_lights([P.Light(**LIGHTS["point"])], device="cpu")
    p, n = points((4, 5))
    out = P.eval_lights(lights, torch.as_tensor(p), torch.as_tensor(n))
    assert out.device.type == "cpu" and out.shape == (4, 5, 3)
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError, match="CUDA is not available"):
            P.eval_lights(lights, p, n)


def test_signatures_match_jax_but_device():
    for name in ("r2_sequence", "eval_lights"):
        ref = inspect.signature(getattr(J, name)).parameters
        got = {k: v for k, v in inspect.signature(getattr(P, name)).parameters.items()
               if k != "device"}
        assert list(got) == list(ref), name
        assert [(p.kind, p.default) for p in got.values()] == [
            (p.kind, p.default) for p in ref.values()], name
