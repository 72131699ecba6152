# The port's K5 plain version (forge3d_tpu_torch.ops.traversal.trace_plain,
# which `trace` runs on CPU tensors) and normal_at against the JAX package's
# trace / normal_at on random rays over a 65^2 DEM, plus a brute-force
# oracle check.
#
# Tolerances:
# - Hit masks equal on >= 99.9% of rays, and |dt|/t <= 1e-4 where both hit:
#   a last-ulp difference (XLA may contract a*b+c into an FMA) can flip a
#   ray that grazes a silhouette.
# - Hit cells equal wherever both hit.
# - Normals: |d| <= 1e-5 * (1 + |ref|) at the same hit points and cells.
# - Against the brute-force float64 oracle: the JAX package's own gate
#   (tests/test_traversal.py): < 2% disagreement on grazing tangencies,
#   relative t error < 1e-3.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from forge3d_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from forge3d_tpu.ops.traversal import normal_at as jax_normal_at
from forge3d_tpu.ops.traversal import scene_from_pyramid as jax_scene_from_pyramid
from forge3d_tpu.ops.traversal import trace as jax_trace
from forge3d_tpu.ops.traversal import trace_bruteforce_numpy

from forge3d_tpu_torch import convert
from forge3d_tpu_torch.ops import traversal as tv
from forge3d_tpu_torch.ops.pyramid import build_pyramid

torch.set_num_threads(1)

HIT_AGREE = 0.999
T_REL = 1e-4


def dem65(seed=0):
    n = 65
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    return (6.0 * np.sin(x * 0.15) * np.cos(y * 0.12)
            + 0.4 * rng.standard_normal((n, n))).astype(np.float32)


def random_rays(dem, spacing, n, seed, origin_xz=(0.0, 0.0)):
    """Downward rays from above and oblique rays from outside the domain,
    plus near-horizontal and upward rays."""
    rng = np.random.default_rng(seed)
    h, w = dem.shape
    ox, oz = origin_xz
    ext_x, ext_z = (w - 1) * spacing[0], (h - 1) * spacing[1]
    hmax = float(dem.max())
    origins = np.stack([ox + rng.uniform(-0.3 * ext_x, 1.3 * ext_x, n),
                        hmax + rng.uniform(0.5, 2.0 * max(1.0, hmax), n),
                        oz + rng.uniform(-0.3 * ext_z, 1.3 * ext_z, n)], axis=1)
    targets = np.stack([ox + rng.uniform(0, ext_x, n),
                        rng.uniform(float(dem.min()) - 1.0, hmax + 2.0, n),
                        oz + rng.uniform(0, ext_z, n)], axis=1)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origins.astype(np.float32), d.astype(np.float32)


def jax_scene(dem, origin_xz=(0.0, 0.0), spacing=(1.0, 1.0), exag=1.0):
    return jax_scene_from_pyramid(jax_build_pyramid(dem), origin_xz, spacing, exag)


def to_port(scene, static):
    fields = {k: np.asarray(getattr(scene, k)) for k in scene._fields}
    return convert.scene_from_numpy(fields, dict(static.__dict__))


def cols(a, lib):
    return tuple(lib(np.ascontiguousarray(a[:, i])) for i in range(3))


@pytest.mark.parametrize("spacing,exag,origin_xz", [
    ((1.0, 1.0), 1.0, (0.0, 0.0)),
    ((2.5, 0.75), 3.0, (-10.0, 5.0)),
])
def test_trace_matches_jax(spacing, exag, origin_xz):
    dem = dem65()
    scene, static = jax_scene(dem, origin_xz, spacing, exag)
    ro, rd = random_rays(dem * exag, spacing, 6000, seed=11, origin_xz=origin_xz)
    ref = jax_trace(scene, static, cols(ro, jnp.asarray), cols(rd, jnp.asarray))
    got = tv.trace(to_port(scene, static), cols(ro, torch.as_tensor), cols(rd, torch.as_tensor))
    rh, gh = np.asarray(ref.hit), got.hit.numpy()
    assert 0.2 < rh.mean() < 0.95  # the rays exercise both outcomes
    assert (rh == gh).mean() >= HIT_AGREE
    both = rh & gh
    rt, gt = np.asarray(ref.t), got.t.numpy()
    assert np.max(np.abs(gt[both] - rt[both]) / np.abs(rt[both])) <= T_REL
    np.testing.assert_array_equal(np.asarray(ref.cell_x)[both], got.cell_x.numpy()[both])
    np.testing.assert_array_equal(np.asarray(ref.cell_z)[both], got.cell_z.numpy()[both])
    # misses report tmax and cell 0, as in JAX
    miss = ~gh
    assert (gt[miss] == np.float32(1e30)).all() and (got.cell_x.numpy()[miss] == 0).all()


def test_trace_tmin_tmax_and_shapes():
    dem = dem65(1)
    scene, static = jax_scene(dem)
    ro, rd = random_rays(dem, (1.0, 1.0), 2048, seed=3)
    ro2, rd2 = ro.reshape(32, 64, 3), rd.reshape(32, 64, 3)
    for tmin, tmax in ((0.5, 40.0), (1e-3, 1e30)):
        ref = jax_trace(scene, static, tuple(jnp.asarray(ro2[..., i]) for i in range(3)),
                        tuple(jnp.asarray(rd2[..., i]) for i in range(3)), tmin, tmax)
        got = tv.trace(to_port(scene, static),
                       tuple(torch.as_tensor(ro2[..., i].copy()) for i in range(3)),
                       tuple(torch.as_tensor(rd2[..., i].copy()) for i in range(3)), tmin, tmax)
        assert got.hit.shape == (32, 64) and got.t.dtype == torch.float32
        assert (np.asarray(ref.hit) == got.hit.numpy()).mean() >= HIT_AGREE
        both = np.asarray(ref.hit) & got.hit.numpy()
        rt, gt = np.asarray(ref.t)[both], got.t.numpy()[both]
        assert np.max(np.abs(gt - rt) / np.abs(rt)) <= T_REL


def test_normal_at_matches_jax():
    dem = dem65(2)
    scene, static = jax_scene(dem, (3.0, -2.0), (1.5, 0.8), 2.0)
    ro, rd = random_rays(dem * 2.0, (1.5, 0.8), 4000, seed=5, origin_xz=(3.0, -2.0))
    ref = jax_trace(scene, static, cols(ro, jnp.asarray), cols(rd, jnp.asarray))
    hit = np.asarray(ref.hit)
    t = np.asarray(ref.t)[hit]
    p = ro[hit] + t[:, None] * rd[hit]
    cx, cz = np.asarray(ref.cell_x)[hit], np.asarray(ref.cell_z)[hit]
    rn = jax_normal_at(scene, static, cols(p, jnp.asarray), jnp.asarray(cx), jnp.asarray(cz))
    gn = tv.normal_at(to_port(scene, static), cols(p, torch.as_tensor),
                      torch.as_tensor(cx), torch.as_tensor(cz))
    for r, g in zip(rn, gn):
        r, g = np.asarray(r, np.float64), g.numpy().astype(np.float64)
        assert np.all(np.abs(g - r) <= 1e-5 * (1 + np.abs(r)))


def test_port_scene_equals_jax_scene():
    dem = np.random.default_rng(4).standard_normal((37, 50)).astype(np.float32)
    scene, static = jax_scene(dem, (1.0, 2.0), (0.5, 2.0), 1.7)
    port = tv.scene_from_pyramid(build_pyramid(dem), (1.0, 2.0), (0.5, 2.0), 1.7, device="cpu")
    for name in ("h_pair", "mm_pack", "level_offset", "level_w"):
        ref = np.asarray(getattr(scene, name))
        got = getattr(port, name).numpy()
        assert ref.dtype == got.dtype
        np.testing.assert_array_equal(ref, got)
    assert port.origin_xz == tuple(np.asarray(scene.origin_xz).tolist())
    assert port.spacing_xz == tuple(np.asarray(scene.spacing_xz).tolist())
    assert port.exaggeration == float(np.asarray(scene.exaggeration))
    for name in ("dem_w", "dem_h", "cell_w", "cell_h", "mip_count", "max_iters"):
        assert getattr(port, name) == getattr(static, name)
    moved = port.to("cpu")
    assert moved.device.type == "cpu" and torch.equal(moved.mm_pack, port.mm_pack)


def test_trace_matches_bruteforce():
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:17, 0:23].astype(np.float32)
    dem = (4.0 * np.sin(x * 0.4) * np.cos(y * 0.3)
           + 0.5 * rng.standard_normal((17, 23))).astype(np.float32)
    scene = tv.scene_from_pyramid(build_pyramid(dem), device="cpu")
    ro, rd = random_rays(dem, (1.0, 1.0), 160, seed=11)
    got = tv.trace(scene, cols(ro, torch.as_tensor), cols(rd, torch.as_tensor))
    bf_hit, bf_t = trace_bruteforce_numpy(dem, (0.0, 0.0), (1.0, 1.0), 1.0, ro, rd)
    hit = got.hit.numpy()
    assert (hit != bf_hit).mean() < 0.02
    both = hit & bf_hit
    err = np.abs(got.t.numpy()[both] - bf_t[both]) / np.maximum(1.0, np.abs(bf_t[both]))
    assert both.sum() > 20 and err.max() < 1e-3


def test_trace_dispatch_is_by_device():
    dem = dem65(3)
    scene = tv.scene_from_pyramid(build_pyramid(dem), device="cpu")
    ro, rd = random_rays(dem, (1.0, 1.0), 64, seed=1)
    before = tv.trace.launches
    tv.trace(scene, cols(ro, torch.as_tensor), cols(rd, torch.as_tensor))
    assert tv.trace.launches == before  # CPU tensors: the plain version
    # anything but CPU goes to the kernel, which takes CUDA tensors only
    meta = tuple(torch.empty(64, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="CUDA"):
        tv.trace(scene, meta, meta)
    assert tv.trace.launches == before


def test_scene_from_pyramid_defaults_to_cuda():
    """scene_from_pyramid called as the JAX package's puts the scene on the
    card: without CUDA it raises DeviceError."""
    from forge3d_tpu_torch.errors import DeviceError

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        tv.scene_from_pyramid(build_pyramid(dem65(3)))
