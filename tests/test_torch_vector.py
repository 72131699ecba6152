# Kernel E4's plain versions (forge3d_tpu_torch/vector/coverage.py) against
# forge3d_tpu/vector/coverage.py on the CPU, on seeded inputs: strokes (also
# with no segment and a dashed polyline through _dash_segments), discs, and a
# polygon with a hole under both fill rules, including a ring whose vertices
# and horizontal edges lie on pixel centres; and the port's VectorScene.render
# (also with opacities 2.0 and -0.5 over a base holding -0.0 and NaN, bit for
# bit) and the four flat vector_render_* functions against the JAX package's.
#
# Gates: coverage and rgb/alpha |d| <= 1e-5 * (1 + |ref|) on every element,
# pick maps equal, u8 overlays within one step on every byte and equal on
# >= 99.9% (the CPU shows every element bit-equal: the plain versions round
# XLA's fused multiply-adds once, as XLA does).
import numpy as np
import pytest
import torch

from forge3d_tpu import vector as jv
from forge3d_tpu.vector import coverage as jc

from forge3d_tpu_torch import vector as tv
from forge3d_tpu_torch.vector import coverage as tc

torch.set_num_threads(1)

W, H = 96, 64
TOL = 1e-5


def assert_close(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    assert np.all(np.abs(got - ref) <= TOL * (1.0 + np.abs(ref))), np.abs(got - ref).max()


def ellipse(cx, cy, rx, ry, n=24, reverse=False):
    t = np.linspace(0.0, 2.0 * np.pi, n + 1)[:-1]
    if reverse:
        t = -t
    return np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], 1)


def polyline(seed=0, n=30):
    rng = np.random.default_rng(seed)
    return np.stack([np.linspace(3, 92, n), 32 + np.cumsum(rng.normal(0, 3, n))], 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("width", [1.0, 3.0, 6.5])
def test_stroke_coverage_matches_jax(seed, width):
    segs = np.random.default_rng(seed).uniform(-10, 100, (9 + 7 * seed, 4)).astype(np.float32)
    ref = np.asarray(jc.stroke_coverage(W, H, segs, width))
    got = tc.stroke_coverage_plain(W, H, torch.as_tensor(segs), width)
    assert_close(ref, got)
    assert 0.0 < ref.mean() < 1.0


def test_stroke_coverage_without_segments():
    ref = np.asarray(jc.stroke_coverage(W, H, np.zeros((0, 4), np.float32), 3.0))
    got = tc.stroke_coverage(W, H, np.zeros((0, 4)), 3.0, device="cpu")
    assert_close(ref, got)
    assert float(got.abs().max()) == 0.0


@pytest.mark.parametrize("dash", [[6.0, 3.0], [12.0, 7.0, 2.0, 7.0], [4.0, 0.0], [0.0, 5.0]])
def test_dashed_polyline_matches_jax(dash):
    pl = polyline(3).astype(np.float32)
    ref_segs = jv._dash_segments(pl, dash)
    got_segs = tv._dash_segments(pl, dash)
    np.testing.assert_array_equal(ref_segs, got_segs)
    ref = np.asarray(jc.stroke_coverage(W, H, ref_segs, 2.5))
    got = tc.stroke_coverage(W, H, got_segs, 2.5, device="cpu")
    assert_close(ref, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_disc_coverage_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-5, 100, (40, 2))
    rad = rng.uniform(0.3, 7.0, 40)
    ref = np.asarray(jc.disc_coverage(W, H, ctr, rad))
    got = tc.disc_coverage(W, H, ctr, rad, device="cpu")
    assert_close(ref, got)
    # a scalar radius, as VectorScene's points layers pass it
    ref = np.asarray(jc.disc_coverage(W, H, ctr, np.full(40, 2.5)))
    assert_close(ref, tc.disc_coverage(W, H, ctr, 2.5, device="cpu"))


ON_CENTRES = np.array([[10.5, 8.5], [60.5, 8.5], [60.5, 40.5], [30.5, 20.5], [10.5, 40.5]])


@pytest.mark.parametrize("rule", ["nonzero", "evenodd"])
@pytest.mark.parametrize("case", ["hole", "same_winding", "on_centres"])
def test_polygon_coverage_matches_jax(rule, case):
    rings = {
        "hole": [ellipse(48, 32, 35, 25), ellipse(48, 32, 12, 9, reverse=True)],
        "same_winding": [ellipse(48, 32, 35, 25), ellipse(48, 32, 12, 9)],
        "on_centres": [ON_CENTRES],
    }[case]
    ref = np.asarray(jc.polygon_coverage(W, H, rings, rule))
    got = tc.polygon_coverage(W, H, rings, rule, device="cpu")
    assert_close(ref, got)
    if case == "same_winding":
        # the inner ring winds twice: filled under nonzero, a hole under evenodd
        assert float(got[32, 48]) == (1.0 if rule == "nonzero" else 0.0)
    elif case == "hole":
        assert float(got[32, 48]) == 0.0 and float(got[32, 20]) == 1.0


def test_pixel_centres_on_edges_wind_as_jax():
    """The ring's vertices and its horizontal edges lie on rows of pixel
    centres: the half-open test counts an upward edge for y1 <= py < y2 and
    none for a horizontal one, so row 8 (py = 8.5, the top edge) is inside
    and row 40 (py = 40.5, the bottom vertices) outside; pinned here."""
    edges = torch.as_tensor(tc.ring_edges([ON_CENTRES]))
    px, py = tc._pixel_grid(W, H, "cpu")
    x1, y1, x2, y2 = [edges[:, k, None, None] for k in range(4)]
    up = (y1 <= py) & (y2 > py)
    dn = (y2 <= py) & (y1 > py)
    dy = y2 - y1
    xint = x1 + (py - y1) / torch.where(dy.abs() > 1e-12, dy, torch.ones_like(dy)) * (x2 - x1)
    winding = ((up & (px < xint)).int() - (dn & (px < xint)).int()).sum(0)
    assert winding[8, 11:60].unique().tolist() == [1]    # the top edge's row
    assert winding[40].abs().max() == 0                   # the bottom vertices' row
    assert winding[30, 15].item() == 1 and winding[30, 40].item() == 0
    cov = tc.polygon_coverage(W, H, [ON_CENTRES], device="cpu")
    ref = np.asarray(jc.polygon_coverage(W, H, [ON_CENTRES]))
    # on the top edge: inside, distance ~0, so coverage just over one half
    assert np.array_equal(cov[8, 11:60].numpy(), ref[8, 11:60])
    assert 0.5 < float(cov[8, 30]) < 0.5001
    # the bottom-left vertex's pixel: outside, distance 0, coverage one half
    assert float(cov[40, 10]) == float(ref[40, 10]) == 0.5


def test_polygon_ring_too_short_refused():
    with pytest.raises(ValueError, match=">= 3 vertices"):
        tc.polygon_coverage(W, H, [[[0, 0], [1, 1]]], device="cpu")
    with pytest.raises(ValueError, match="unknown fill rule"):
        tc.polygon_coverage(W, H, [ON_CENTRES], "winding", device="cpu")


def scenes():
    """The same layers in both packages' VectorScene."""
    rng = np.random.default_rng(9)
    out = []
    for mod in (jv, tv):
        vs = mod.VectorScene()
        vs.add_lines(polyline(1), width=3.0, color=(0.9, 0.2, 0.1), opacity=0.9)
        vs.add_lines(polyline(2), width=2.0, dash_array=[6, 3])
        vs.add_polygons([ellipse(48, 32, 30, 20), ellipse(48, 32, 10, 7, reverse=True)],
                        opacity=0.6)
        vs.add_points(np.random.default_rng(9).uniform(0, 96, (25, 2)), size=5.0, opacity=0.8)
        vs.add_lines(np.array([[5.0, 5.0], [5.0, 5.0]]))   # a zero-length segment
        out.append(vs)
    del rng
    return out


@pytest.mark.parametrize("base", [False, True])
def test_vector_scene_render_matches_jax(base):
    js, ts = scenes()
    b = np.random.default_rng(3).uniform(0, 1, (H, W, 3)).astype(np.float32) if base else None
    ref = js.render(W, H, b)
    keep = None if b is None else b.copy()
    got = ts.render(W, H, b, device="cpu")
    if base:
        np.testing.assert_array_equal(b, keep)      # the caller's base is not written
    assert got[0].dtype == np.float32 and got[1].dtype == np.float32 and got[2].dtype == np.int32
    assert_close(ref[0], got[0])
    assert_close(ref[1], got[1])
    np.testing.assert_array_equal(ref[2], got[2])
    assert set(np.unique(got[2]).tolist()) == {0, 1, 2, 3, 4, 5}
    assert ts.pick_at(got[2], 48, 32) == js.pick_at(ref[2], 48, 32)
    ts.clear_vectors()
    assert ts.layers == [] and ts.add_points([[1, 1]]) == 1


def test_vector_scene_special_values_match_jax():
    """Opacities 2.0 and -0.5, a zero-length segment and a point far outside
    the frame, over a base holding -0.0 and NaN: every layer's composite is
    applied at every pixel, coverage 0 included, so the port's render (all
    layers through vector_layers, whose kernel keeps every layer's composite
    too) equals JAX's element for element, -0.0 apart from +0.0 and NaN
    where NaN."""
    out = []
    for mod in (jv, tv):
        vs = mod.VectorScene()
        vs.add_lines(polyline(4), width=5.0, opacity=2.0)
        vs.add_points([[40.0, 30.0], [500.0, -400.0]], size=9.0, opacity=-0.5)
        vs.add_polygons([ellipse(30, 20, 14, 10)], opacity=-0.5)
        vs.add_lines(np.array([[7.0, 7.0], [7.0, 7.0]]), opacity=2.0)
        out.append(vs)
    base = np.random.default_rng(8).uniform(0, 1, (H, W, 3)).astype(np.float32)
    base[::3, ::2, 0] = -0.0
    base[1::5, 1::3, 1] = np.nan
    ref = out[0].render(W, H, base)
    got = out[1].render(W, H, base, device="cpu")
    for a, b in zip(ref, got):
        a, b = np.asarray(a), np.asarray(b)
        nan = np.isnan(a) if a.dtype == np.float32 else np.zeros(a.shape, bool)
        np.testing.assert_array_equal(nan, np.isnan(b) if b.dtype == np.float32 else nan)
        np.testing.assert_array_equal(a[~nan].view(np.int32), b[~nan].view(np.int32))
    # a composite at coverage 0 is not the identity: -0.0 + (+0.0) is +0.0
    zeros = got[0][::3, ::2, 0][got[0][::3, ::2, 0] == 0]
    assert np.signbit(base[::3, ::2, 0]).all() and zeros.size and not np.signbit(zeros).any()


def test_render_overlay_rgba_matches_jax():
    js, ts = scenes()
    assert_close(jv.render_overlay_rgba(js, W, H), tv.render_overlay_rgba(ts, W, H, device="cpu"))


PAYLOAD = dict(
    points_xy=[[10.0, 10.0], [40.0, 30.0], [80.0, 50.0]],
    point_rgba=[(1.0, 0.0, 0.0, 1.0), (0.0, 1.0, 0.0, 0.5)],
    point_size=[6.0, 9.0],
    polylines=[[[2, 60], [50, 5], [94, 40]], [[0, 0], [95, 63]]],
    polyline_rgba=[(0.2, 0.3, 0.9, 0.8)],
    stroke_width=[3.0],
)


@pytest.mark.parametrize("name", ["vector_render_oit", "vector_render_oit_edl",
                                  "vector_render_pick_map", "vector_render_oit_and_pick"])
def test_flat_functions_match_jax(name):
    ref = getattr(jv, name)(W, H, **PAYLOAD)
    got = getattr(tv, name)(W, H, device="cpu", **PAYLOAD)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == np.uint8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            assert float((a == b).mean()) >= 0.999
        else:
            np.testing.assert_array_equal(a, b)


def test_vector_layer_counts_no_launch_on_the_cpu():
    before = tc.vector_layer.launches
    js, ts = scenes()
    ts.render(W, H, device="cpu")
    assert tc.vector_layer.launches == before
