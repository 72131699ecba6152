# The port's post-processing suite E2 (forge3d_tpu_torch/ops/post.py, the
# plain versions on the CPU) against the JAX package's functions in
# forge3d_tpu/ops/post.py, on seeded 48x64 inputs made with numpy.
#
# Gates: the JAX functions run eagerly, one rounded float32 operation at a
# time, and the plain versions do the same operations in the same order,
# so every output is held bit for bit, except where a transcendental call
# decides: jnp.exp in the blur taps (sigma 6 and 15 here, so the bloom and
# the chains with it) and jnp.power in the rect light's specular lobe. Those
# are held to |d| <= 1e-5 * (1 + |ref|) on every element, and shown to be
# bit-equal once the port is handed JAX's own taps or power. halton_jitter
# is bit-equal.
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forge3d_tpu.ops import post as J

from forge3d_tpu_torch.errors import DeviceError
from forge3d_tpu_torch.ops import post as P

torch.set_num_threads(1)

H, W = 48, 64
RNG = np.random.default_rng(17)
COLOR = RNG.uniform(0.0, 2.0, (H, W, 3)).astype(np.float32)
HISTORY = RNG.uniform(0.0, 2.0, (H, W, 3)).astype(np.float32)
DEPTH = RNG.uniform(1.0, 50.0, (H, W)).astype(np.float32)
_n = RNG.standard_normal((H, W, 3)).astype(np.float32)
NORMAL = (_n / np.linalg.norm(_n, axis=-1, keepdims=True)).astype(np.float32)
POINTS = RNG.uniform(-20.0, 20.0, (H, W, 3)).astype(np.float32)
_v = RNG.standard_normal((H, W, 3)).astype(np.float32)
VIEW = (_v / np.linalg.norm(_v, axis=-1, keepdims=True)).astype(np.float32)


def exact(ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape and ref.dtype == got.dtype
    assert np.array_equal(ref, got)


def close(ref, got, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = got.numpy().astype(np.float64)
    assert ref.shape == got.shape
    assert (np.abs(got - ref) <= tol * (1.0 + np.abs(ref))).all()


@pytest.mark.parametrize("sigma,radius", [(2.0, None), (1.0, 2), (1.5, None), (4.5, None),
                                          (6.0, None), (15.0, None)])
def test_gauss_taps_and_blur(sigma, radius, monkeypatch):
    r = radius if radius is not None else max(1, int(np.ceil(3 * sigma)))
    ref_taps = np.asarray(J._gauss_kernel(sigma, r))
    close(ref_taps, P._gauss_kernel(sigma, r))
    ref = J.gaussian_blur(COLOR, sigma, radius)
    close(ref, P.gaussian_blur(COLOR, sigma, radius, device="cpu"))
    # with JAX's own taps the blur is bit-equal: only jnp.exp and the order
    # of jnp.sum can move a tap
    monkeypatch.setattr(P, "_gauss_kernel", lambda s, rr: torch.as_tensor(
        np.array(J._gauss_kernel(s, rr))))
    exact(ref, P.gaussian_blur(COLOR, sigma, radius, device="cpu"))


def test_blur_of_a_2d_and_a_4_channel_image():
    exact(J.gaussian_blur(DEPTH, 2.0), P.gaussian_blur(DEPTH, 2.0, device="cpu"))
    img = RNG.uniform(0, 1, (H, W, 4)).astype(np.float32)
    exact(J.gaussian_blur(img, 1.0, radius=3), P.gaussian_blur(img, 1.0, radius=3, device="cpu"))


def test_bloom():
    close(J.bloom(COLOR, threshold=0.8, intensity=0.5),
          P.bloom(COLOR, threshold=0.8, intensity=0.5, device="cpu"))
    # sigmas whose taps jnp.exp and torch.exp agree on: bit-equal
    exact(J.bloom(COLOR, threshold=1.2, intensity=0.7, sigma=0.6),
          P.bloom(COLOR, threshold=1.2, intensity=0.7, sigma=0.6, device="cpu"))


@pytest.mark.parametrize("near_blur", [True, False])
def test_depth_of_field(near_blur):
    kw = dict(focus_distance=20.0, focus_range=5.0, max_coc=6.0, near_blur=near_blur)
    exact(J.depth_of_field(COLOR, DEPTH, **kw), P.depth_of_field(COLOR, DEPTH, device="cpu", **kw))


def test_halton_jitter():
    for n in (1, 8, 13):
        exact(J.halton_jitter(n), P.halton_jitter(n, device="cpu"))


@pytest.mark.parametrize("clamp", [True, False])
def test_taa_resolve_wraps_at_the_border(clamp):
    got = P.taa_resolve(COLOR, HISTORY, blend=0.15, clamp_neighborhood=clamp, device="cpu")
    exact(J.taa_resolve(COLOR, HISTORY, blend=0.15, clamp_neighborhood=clamp), got)
    if clamp:   # the corner's neighbourhood holds the opposite corner (jnp.roll)
        lo = min(COLOR[y, x, 0] for y in (-1, 0, 1) for x in (-1, 0, 1))
        hi = max(COLOR[y, x, 0] for y in (-1, 0, 1) for x in (-1, 0, 1))
        h = min(max(HISTORY[0, 0, 0], lo), hi)
        assert float(got[0, 0, 0]) == float(np.float32(0.15) * COLOR[0, 0, 0]
                                            + np.float32(0.85) * h)


@pytest.mark.parametrize("normal", ["3d", "2d"])
def test_ssao(normal):
    nrm = NORMAL if normal == "3d" else NORMAL[..., 2]
    for kw in (dict(), dict(radius=16.0, intensity=0.8, bias=0.025, n_samples=12)):
        exact(J.ssao(DEPTH, nrm, **kw), P.ssao(DEPTH, nrm, device="cpu", **kw))


@pytest.mark.parametrize("normal", ["3d", "2d"])
def test_ssr_wraps_at_the_top(normal):
    nrm = NORMAL if normal == "3d" else NORMAL[..., 1]
    ref = J.ssr(COLOR, DEPTH, nrm, intensity=0.5)
    got = P.ssr(COLOR, DEPTH, nrm, intensity=0.5, device="cpu")
    exact(ref, got)
    # the top rows march through the bottom of the image: a depth there
    # decides their reflection
    dep = DEPTH.copy()
    dep[:6] = 100.0
    dep[-4:] = 1.0
    exact(J.ssr(COLOR, dep, nrm, stride=3, max_steps=7, edge_fade=0.05),
          P.ssr(COLOR, dep, nrm, stride=3, max_steps=7, edge_fade=0.05, device="cpu"))


def test_vignette_and_sharpen():
    for kw in (dict(), dict(strength=0.6, radius=0.5)):
        exact(J.vignette(COLOR, **kw), P.vignette(COLOR, device="cpu", **kw))
    for amount in (0.3, 1.5):
        exact(J.sharpen(COLOR, amount=amount), P.sharpen(COLOR, amount=amount, device="cpu"))


LIGHT = dict(light_center=(1.0, 15.0, 2.0), light_right=(1.0, 0.0, 0.0),
             light_up=(0.0, 0.0, 1.0), half_extent=(4.0, 3.0), color=(1.0, 0.9, 0.8),
             intensity=4.0)


@pytest.mark.parametrize("roughness", [0.3, 0.7, 0.01])
def test_rect_area_light(roughness, monkeypatch):
    ref = J.rect_area_light(POINTS, NORMAL, VIEW, roughness=roughness, **LIGHT)
    close(ref, P.rect_area_light(POINTS, NORMAL, VIEW, roughness=roughness, device="cpu",
                                 **LIGHT))
    # with XLA's power the rest is bit-equal (the norms fused as XLA fuses them)
    monkeypatch.setattr(torch, "pow", lambda a, b: torch.as_tensor(
        np.array(jnp.power(jnp.asarray(a.numpy()), jnp.float32(b)))))
    exact(ref, P.rect_area_light(POINTS, NORMAL, VIEW, roughness=roughness, device="cpu",
                                 **LIGHT))


def test_rect_area_light_sum_is_the_scene_sum():
    second = dict(light_center=(-6.0, 9.0, -3.0), light_right=(0.6, 0.0, 0.8),
                  light_up=(0.0, 1.0, 0.0), half_extent=(2, 5), intensity=2.5)
    ref = jnp.zeros_like(jnp.asarray(POINTS))
    for kw in (LIGHT, second):
        ref = ref + J.rect_area_light(POINTS, NORMAL, VIEW, **kw)
    close(ref, P.rect_area_light_sum(POINTS, NORMAL, VIEW, [LIGHT, second], device="cpu"))
    assert not P.rect_area_light_sum(POINTS, NORMAL, VIEW, [], device="cpu").any()


CHAINS = list(itertools.product([False, True], repeat=4))


@pytest.mark.parametrize("bloom,dof,vig,sharp", CHAINS)
def test_post_chain(bloom, dof, vig, sharp):
    kw = dict(bloom_enabled=bloom, bloom_threshold=0.9, bloom_intensity=0.4, dof_enabled=dof,
              dof_focus=18.0, dof_range=6.0, dof_max_coc=4.0, vignette_enabled=vig,
              vignette_strength=0.5, sharpen_amount=0.25 if sharp else 0.0)
    ref = J.apply_post_chain(COLOR, DEPTH, J.PostConfig(**kw))
    got = P.apply_post_chain(COLOR, DEPTH, P.PostConfig(**kw), device="cpu")
    if bloom:   # sigma 6 and 15: jnp.exp's taps
        close(ref, got)
    else:
        exact(ref, got)


def test_chain_without_depth_skips_dof():
    cfg = dict(dof_enabled=True, vignette_enabled=True)
    exact(J.apply_post_chain(COLOR, None, J.PostConfig(**cfg)),
          P.apply_post_chain(COLOR, None, P.PostConfig(**cfg), device="cpu"))


def test_numpy_input_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        P.vignette(COLOR)
    with pytest.raises(DeviceError, match="CUDA is not available"):
        P.halton_jitter(4)
    # a tensor stays where it is
    assert P.vignette(torch.as_tensor(COLOR)).device.type == "cpu"
