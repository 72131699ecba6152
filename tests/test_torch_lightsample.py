# The port's typed lights and light sampling (forge3d_tpu_torch.lighting,
# forge3d_tpu_torch.ops.lightsample) against forge3d_tpu.lighting and
# forge3d_tpu.ops.lightsample on the CPU: the light rows, the power weights
# and the host-built alias table bit for bit, the alias draw's indices
# exactly, and one NEE sample per lane (K10's plain version) for each light
# type.
#
# Tolerance of the NEE sample: |d| <= 1e-5 * (1 + |ref|) on every element
# (the disk and sphere offsets go through sin and cos, whose float32 results
# may differ by an ulp between XLA and PyTorch).
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from forge3d_tpu import lighting as jlt  # noqa: E402
from forge3d_tpu.ops import lightsample as jls  # noqa: E402

from forge3d_tpu_torch import convert  # noqa: E402
from forge3d_tpu_torch import lighting as tlt  # noqa: E402
from forge3d_tpu_torch.ops import lightsample as tls  # noqa: E402

TOL = 1e-5


def six(cls):
    """One light of each type, with distinct colours, sizes and cones."""
    return [cls(type=t, position=(4.0 * i - 10.0, 6.0 + i, 3.0 - 2.0 * i),
                direction=(0.3 - 0.1 * i, -1.0, 0.2), intensity=2.0 + 3.0 * i,
                color=(1.0, 0.8 - 0.1 * i, 0.5 + 0.05 * i), radius=0.5 + 0.25 * i,
                extent=(1.0 + 0.5 * i, 0.75), inner_cone_deg=15.0, outer_cone_deg=40.0)
            for i, t in enumerate(tlt.LIGHT_TYPES)]


def test_light_types_and_buffer_equal():
    assert tlt.LIGHT_TYPES == jlt.LIGHT_TYPES and tlt._TYPE_ID == jlt._TYPE_ID
    ref = jlt.LightBuffer.from_lights(six(jlt.Light))
    got = tlt.LightBuffer.from_lights(six(tlt.Light), device="cpu")
    assert got.count == ref.count == 6
    for k in tlt.LightBuffer.__dataclass_fields__:
        a = np.asarray(getattr(ref, k))
        b = getattr(got, k).numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    back = convert.light_buffer_from_numpy({k: np.asarray(getattr(ref, k)) for k in ref._fields})
    for k in tlt.LightBuffer.__dataclass_fields__:
        assert torch.equal(getattr(back, k), getattr(got, k)), k


@pytest.mark.parametrize("kw", [dict(type="laser"), dict(intensity=-1.0),
                                dict(type="spot", inner_cone_deg=50.0, outer_cone_deg=40.0),
                                dict(type="spot", inner_cone_deg=0.0)],
                         ids=["type", "intensity", "cones", "inner"])
def test_light_validation(kw):
    msgs = []
    for cls in (jlt.Light, tlt.Light):
        with pytest.raises(ValueError) as ei:
            cls(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="empty"):
        tlt.LightBuffer.from_lights([], device="cpu")


WEIGHTS = {
    "random": lambda: np.random.default_rng(1).random(37),
    "skewed": lambda: np.random.default_rng(2).pareto(1.2, 64),
    "zeros": lambda: np.zeros(5),
    "one_hot": lambda: np.eye(9)[4],
    "single": lambda: np.array([3.0]),
    "six_lights": lambda: jls.light_power_weights(jlt.LightBuffer.from_lights(six(jlt.Light))),
}


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_alias_table_equal(name):
    w = WEIGHTS[name]()
    ref = jls.alias_table_build(w)
    got = tls.alias_table_build(w, device="cpu")
    for k in ("prob", "alias", "pdf"):
        a = np.asarray(getattr(ref, k))
        assert a.dtype == getattr(got, k).numpy().dtype, k
        np.testing.assert_array_equal(a, getattr(got, k).numpy(), err_msg=k)
    back = convert.alias_table_from_numpy({k: np.asarray(getattr(ref, k)) for k in ref._fields})
    assert all(torch.equal(getattr(back, k), getattr(got, k)) for k in ("prob", "alias", "pdf"))
    # the draw: the same indices and pdfs, edges of [0, 1) included
    u = np.concatenate([np.random.default_rng(3).random(20000, dtype=np.float32),
                        np.float32([0.0, 1e-8, 0.5, 1.0 - 2 ** -24])])
    ri, rp = jls.alias_sample(ref, jnp.asarray(u))
    gi, gp = tls.alias_sample(got, torch.as_tensor(u))
    np.testing.assert_array_equal(np.asarray(ri), gi.numpy())
    np.testing.assert_array_equal(np.asarray(rp), gp.numpy())


def test_light_power_weights_and_refusals():
    ref = jls.light_power_weights(jlt.LightBuffer.from_lights(six(jlt.Light)))
    got = tls.light_power_weights(tlt.LightBuffer.from_lights(six(tlt.Light), device="cpu"))
    assert ref.dtype == got.dtype
    np.testing.assert_array_equal(ref, got)
    for w, msg in (([], "at least one"), ([1.0, -1.0], "non-negative"),
                   ([1.0, np.inf], "finite")):
        for build in (jls.alias_table_build, tls.alias_table_build):
            with pytest.raises(ValueError, match=msg):
                build(w)


def lanes(n, seed):
    """Shading points under and around the lights, upward-leaning unit
    normals, and three uniforms per lane (numpy, float32)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform([-14.0, -3.0, -12.0], [14.0, 3.0, 6.0], (n, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm[:, 1] = np.abs(nrm[:, 1]) + 0.3
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    u = rng.random((n, 3), dtype=np.float32)
    return [np.ascontiguousarray(a[:, k]) for a in (p, nrm, u) for k in range(3)]


@pytest.mark.parametrize("which", list(tlt.LIGHT_TYPES) + ["all_six"])
def test_sample_light_nee_matches_jax(which):
    picked = [l for l in range(6) if which in ("all_six", tlt.LIGHT_TYPES[l])]
    jl = [six(jlt.Light)[l] for l in picked]
    tl = [six(tlt.Light)[l] for l in picked]
    jbuf = jlt.LightBuffer.from_lights(jl)
    jtab = jls.alias_table_build(jls.light_power_weights(jbuf))
    tbuf = tlt.LightBuffer.from_lights(tl, device="cpu")
    ttab = tls.alias_table_build(tls.light_power_weights(tbuf), device="cpu")
    x = lanes(4096, seed=len(picked) + 7 * picked[0])
    ref = jls.sample_light_nee(jbuf, jtab, *(jnp.asarray(a) for a in x))
    got = tls.sample_light_nee(tbuf, ttab, *(torch.as_tensor(a) for a in x))  # CPU: plain
    names = ("dx", "dy", "dz", "dist", "wr", "wg", "wb")
    for name, a, b in zip(names, ref, got):
        a = np.asarray(a, np.float64)
        b = b.numpy().astype(np.float64)
        assert np.all(np.abs(a - b) <= TOL * (1.0 + np.abs(a))), \
            (name, float(np.abs(a - b).max()))
    assert float(np.asarray(ref[4]).max()) > 0.0   # some lanes are lit
    if which == "directional":
        assert np.all(got[3].numpy() == np.float32(1e30))


def test_packed_light_table():
    """K10's packed table (pack_lights) holds JAX's light rows and alias
    table bit for bit, a light's 20 words; light_table forms it once per
    light set and keeps it with the alias table."""
    jbuf = jlt.LightBuffer.from_lights(six(jlt.Light))
    jtab = jls.alias_table_build(jls.light_power_weights(jbuf))
    tbuf = tlt.LightBuffer.from_lights(six(tlt.Light), device="cpu")
    ttab = tls.alias_table_build(tls.light_power_weights(tbuf), device="cpu")
    j = {k: np.asarray(getattr(jbuf, k)) for k in jbuf._fields}
    prob, alias, pdf = (np.asarray(getattr(jtab, k)) for k in ("prob", "alias", "pdf"))
    col = lambda a: np.asarray(a).reshape(6, -1)  # noqa: E731
    want = np.concatenate([col(prob), col(alias.view(np.float32)), col(pdf), col(pdf[alias]),
                           j["position"], col(j["type_id"].view(np.float32)), j["direction"],
                           col(j["radius"]), j["color"], np.zeros((6, 1), np.float32),
                           j["extent"], j["cones"]], 1)
    packs = tls.light_table.packs
    rec = tls.light_table(tbuf, ttab)
    assert rec.shape == (6, tls.LIGHT_WORDS) == want.shape
    np.testing.assert_array_equal(rec.numpy().view(np.int32), want.view(np.int32))
    assert tls.light_table(tbuf, ttab) is rec and tls.light_table.packs == packs + 1
    other = tlt.LightBuffer.from_lights(six(tlt.Light)[::-1], device="cpu")
    assert tls.light_table(other, ttab) is not rec and tls.light_table.packs == packs + 2
    with pytest.raises(ValueError, match="alias table of 6"):
        tls.pack_lights(tlt.LightBuffer.from_lights(six(tlt.Light)[:2], device="cpu"), ttab)


def test_light_tables_default_to_cuda():
    """LightBuffer.from_lights and alias_table_build called as the JAX
    package's put their tables on the card: without CUDA they raise
    DeviceError, after their arguments are checked."""
    from forge3d_tpu_torch.errors import DeviceError

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        tlt.LightBuffer.from_lights(six(tlt.Light))
    with pytest.raises(DeviceError, match="CUDA is not available"):
        tls.alias_table_build([1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="empty"):
        tlt.LightBuffer.from_lights([])
    with pytest.raises(ValueError, match="at least one weight"):
        tls.alias_table_build([])
