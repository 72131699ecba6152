# The port's ReSTIR passes (forge3d_tpu_torch.ops.restir: m_clamp,
# temporal_merge, and K7's plain version spatial_reuse, which the wrapper
# runs on CPU tensors) against forge3d_tpu.ops.restir on random reservoirs
# made from a seed with numpy.
#
# Tolerances: integer fields (light_type, light_index, m) bit exact; the
# port holds them in int32 where JAX holds u32, and their values stay far
# below 2**31. Float fields within 1e-5 relative, |d| <= 1e-5 * |ref|: both
# sides run the same float32 operations, and XLA may contract a*b+c into an
# FMA, which moves a result by an ulp. The RIS choices draw from the same
# xorshift stream, so a choice flips only if an ulp moves a comparison; the
# integer check would catch that.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from forge3d_tpu.ops import restir as jr

from forge3d_tpu_torch import convert
from forge3d_tpu_torch.ops import restir as tr

torch.set_num_threads(1)

INT_FIELDS = ("light_type", "light_index", "m")


def random_reservoirs(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[rng.random(n) < 0.05] = 0.0
    m = rng.integers(0, 1400, n).astype(np.uint32)
    m[rng.random(n) < 0.1] = 0
    w_sum = rng.exponential(1.0, n).astype(np.float32)
    tp = rng.exponential(0.5, n).astype(np.float32)
    tp[rng.random(n) < 0.1] = 0.0
    weight = (w_sum / (np.maximum(m, 1) * np.maximum(tp, 1e-3))).astype(np.float32)
    weight[rng.random(n) < 0.1] = 0.0
    return dict(
        dir_x=d[:, 0].copy(), dir_y=d[:, 1].copy(), dir_z=d[:, 2].copy(),
        intensity=rng.uniform(0, 3, n).astype(np.float32),
        light_type=(rng.random(n) < 0.85).astype(np.uint32),
        light_index=rng.integers(0, 4, n).astype(np.uint32),
        w_sum=w_sum, m=m, weight=weight, target_pdf=tp,
    )


def to_jax(fields):
    return jr.Reservoirs(**{k: jnp.asarray(v) for k, v in fields.items()})


def assert_reservoirs_match(ref: jr.Reservoirs, got: tr.Reservoirs):
    for name in jr.Reservoirs._fields:
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name).numpy()
        if name in INT_FIELDS:
            np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=name)
        else:
            assert b.dtype == np.float32
            assert np.all(np.abs(b.astype(np.float64) - a) <= 1e-5 * np.abs(a)), name


def test_m_clamp():
    f = random_reservoirs(20_000, 1)
    assert (f["m"] > tr.M_CAP).any()
    assert_reservoirs_match(jr.m_clamp(to_jax(f)),
                            tr.m_clamp(convert.reservoirs_from_numpy(f)))


@pytest.mark.parametrize("seed", [2, 3])
def test_temporal_merge(seed):
    prev = random_reservoirs(20_000, seed)
    curr = random_reservoirs(20_000, seed + 100)
    curr["m"] = np.minimum(curr["m"], 4)
    assert_reservoirs_match(
        jr.temporal_merge(to_jax(prev), to_jax(curr)),
        tr.temporal_merge(convert.reservoirs_from_numpy(prev),
                          convert.reservoirs_from_numpy(curr)))


@pytest.mark.parametrize("width,height,frame,seed_hi", [
    (24, 16, 0, 7), (37, 21, 5, 123456789), (64, 48, 33, 0xFFFFFFFF)])
def test_spatial_reuse(width, height, frame, seed_hi):
    n = width * height
    f = random_reservoirs(n, frame + 10)
    f["m"] = np.minimum(f["m"], 600)
    rng = np.random.default_rng(frame)
    g = rng.standard_normal((3, n)).astype(np.float32)
    g /= np.linalg.norm(g, axis=0, keepdims=True)
    ref = jr.spatial_reuse(to_jax(f), *(jnp.asarray(c) for c in g), width, height,
                           jnp.uint32(frame), seed_hi)
    got = tr.spatial_reuse(convert.reservoirs_from_numpy(f), *(torch.as_tensor(c) for c in g),
                           width, height, frame, seed_hi)
    assert_reservoirs_match(ref, got)
    # the reuse really mixed neighbours in
    assert (got.m.numpy() > f["m"]).mean() > 0.5


def test_spatial_reuse_does_not_modify_input():
    f = random_reservoirs(24 * 16, 4)
    res = convert.reservoirs_from_numpy(f)
    before = [x.clone() for x in res.fields()]
    g = torch.zeros(3, 24 * 16)
    g[1] = 1.0
    tr.spatial_reuse(res, g[0], g[1], g[2], 24, 16, 3, 7)
    for a, b in zip(before, res.fields()):
        assert torch.equal(a, b)


def test_reservoir_round_trip_and_dispatch():
    f = random_reservoirs(100, 5)
    res = convert.reservoirs_from_numpy(f)
    for k, v in f.items():
        back = getattr(res, k).numpy()
        np.testing.assert_array_equal(back, v.astype(back.dtype))
    for a, b in zip(res.fields(), res.to("cpu").fields()):
        assert torch.equal(a, b)
    z = tr.Reservoirs.zeros(10)
    assert all(int(x.abs().sum()) == 0 for x in z.fields())
    assert z.m.dtype == torch.int32 and z.w_sum.dtype == torch.float32
    before = tr.spatial_reuse.launches
    meta = tr.Reservoirs.empty(16, "meta")
    g = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tr.spatial_reuse(meta, g, g, g, 4, 4, 0, 7)
    assert tr.spatial_reuse.launches == before
