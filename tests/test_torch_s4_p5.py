# S4's depth raster on edge cases and P5's staged, culled instance walk, on
# the kernels' CPU twin (the bodies of csrc/screen.cuh and csrc/pt.cuh
# built with g++ and driven in the kernels' order,
# tests/test_torch_kernels.py:HOST_LAUNCHERS) against the plain versions;
# with the `cuda` marker the wrapper cases run on the card
# (`python -m pytest --noconftest tests/test_torch_s4_p5.py -m cuda`).
#
# Gates: S4's map bit for bit (torch.equal) to raster_depth_plain; P5's
# hits bit for bit to trace_tlas_plain, and its cull never rejecting an
# instance whose root box the walk enters (csrc/pt.cuh:tlas_root_accepts).
import ctypes

import numpy as np
import pytest
import torch

from forge3d_tpu_torch import _kernels
from forge3d_tpu_torch.ops import bvh, tlas as tl
from forge3d_tpu_torch.terrain import screen as scr
from test_torch_kernels import _BOX_F, _BOX_V, host_lib, kernels  # noqa: F401

torch.set_num_threads(1)

_P = ctypes.c_void_p


def tri(ax, ay, bx, by, cx, cy, z=(0.3, 0.5, 0.7)):
    return [[ax, ay, z[0]], [bx, by, z[1]], [cx, cy, z[2]]]


def seeded(rng, n, lo, hi, size=(1.0, 9.0), zr=(0.05, 0.95)):
    """n random triangles with a corner in [lo, hi)^2 and sides up to size."""
    p = rng.uniform(lo, hi, (n, 1, 2)) + rng.uniform(-1, 1, (n, 3, 2)) * rng.uniform(*size, (n, 1, 1))
    return np.concatenate([p, rng.uniform(*zr, (n, 3, 1))], -1).tolist()


def s4_case(name):
    """(tris (T, 3, 3), keep (T,), res, wbb, hbb) of each S4 case; res 70 is
    not a multiple of the tile, 64 is."""
    rng = np.random.default_rng(sum(map(ord, name)))
    keep = None
    res, wbb, hbb = 70, 9, 12
    if name == "off_each_edge":
        t = [tri(-6, 10, 4, 12, -3, 20), tri(66, 30, 76, 33, 72, 41), tri(20, -7, 28, 3, 25, -2),
             tri(40, 64, 48, 77, 43, 75), tri(-5, -5, 3, -4, -2, 4), tri(66, 66, 75, 68, 69, 74)]
        t += seeded(rng, 120, -8, 78)
    elif name == "far_off":   # past 2^22 a box's pixels round
        t = [tri(-1e5, 10, -1e5 + 4, 12, -1e5 + 1, 19), tri(1e6, 30, 1e6 + 5, 31, 1e6 + 2, 40),
             tri(20, -3e5, 27, -3e5 + 2, 23, -3e5 + 8), tri(40, 7e5, 46, 7e5 + 1, 42, 7e5 + 9),
             tri(-2e6, -2e6, -2e6 + 8, -2e6 + 1, -2e6 + 3, -2e6 + 9),
             tri(-9e6, 20, -9e6 + 8, 22, -9e6 + 3, 30), tri(30, 5e7, 36, 5e7 + 16, 33, 5e7 + 40),
             tri(4194300, 50, 4194310, 52, 4194304, 60), tri(8e6, 8e6, 8e6 + 16, 8e6, 8e6, 8e6 + 8)]
        t += seeded(rng, 40, 0, 70)
    elif name == "cut_by_box":
        res, wbb, hbb = 64, 5, 7
        t = seeded(rng, 80, 0, 64, size=(8.0, 30.0))
    elif name == "wide_boxes":
        res, wbb, hbb = 70, 40, 3
        t = [tri(2, 5, 60, 6, 30, 8), tri(-10, 40, 75, 41, 20, 43)] + seeded(rng, 60, 0, 70,
                                                                             size=(10.0, 40.0))
    elif name == "across_four_tiles":
        res = 64
        t = [tri(26, 25, 39, 28, 30, 39), tri(31.2, 31.4, 32.7, 31.5, 32.1, 32.6)]
        t += seeded(rng, 60, 0, 64)
    elif name == "degenerate_and_culled":
        t = seeded(rng, 80, 0, 70)
        t += [tri(5, 5, 5, 5, 5, 5), tri(3, 3, 9, 3, 15, 3), tri(10, 10, 10 + 1e-7, 10, 10, 10 + 1e-6)]
        keep = np.ones(len(t), bool)
        keep[::3] = False
    elif name == "depth_clamps":
        t = seeded(rng, 80, 0, 70, zr=(-0.5, 1.6))
        t += [tri(2, 2, 20, 3, 6, 18, (-0.0, -0.0, -0.0)), tri(30, 30, 50, 31, 36, 48, (1.5, 2.0, 1.2)),
              tri(40, 2, 60, 3, 45, 20, (-3.0, -2.0, -1.0))]
    elif name == "one_pixel_boxes":
        wbb = hbb = 1
        t = seeded(rng, 80, -2, 72)
    elif name == "none_live":
        wbb = hbb = 1
        t = seeded(rng, 30, 0, 70)
        keep = np.zeros(len(t), bool)
    t = np.asarray(t, np.float32)
    if keep is None:
        keep = np.ones(len(t), bool)
    return t, keep, res, wbb, hbb


S4_CASES = ["off_each_edge", "far_off", "cut_by_box", "wide_boxes", "across_four_tiles",
            "degenerate_and_culled", "depth_clamps", "one_pixel_boxes", "none_live"]


@pytest.mark.parametrize("case", S4_CASES)
def test_s4_equal_plain(kernels, case):  # noqa: F811
    """Every texel of the kernel's map equals the plain version's, bit for
    bit: triangles off each edge of the map and far off it (past 2^22 the
    pixels round), boxes cut by wbb x hbb, wide and tall boxes, a triangle
    across four tiles of 32, a side that is not a multiple of 32,
    degenerate and culled triangles, depths clamped at 0 and 1, boxes of a
    pixel and no live triangle."""
    tris, keep, res, wbb, hbb = s4_case(case)
    t, k = torch.as_tensor(tris, device=kernels), torch.as_tensor(keep, device=kernels)
    before = scr.raster_depth.launches
    got = scr._raster_depth_kernel(t, k, res, wbb, hbb)
    assert scr.raster_depth.launches == before + 1
    assert torch.equal(got, scr.raster_depth_plain(t, k, res, wbb, hbb))
    written = float((got < 1.0).double().mean())
    assert (written == 0.0) == (case == "none_live")
    if case == "depth_clamps":
        assert bool((got == 0.0).any()) and not bool(torch.signbit(got).any())


# P5: instances of a unit box (12 triangles) and a triangle soup
def rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]])


def place(x, y, z, sc=(1.0, 1.0, 1.0), a=0.0):
    m = np.diag([*sc, 1.0])
    m[:3, 3] = (x, y, z)
    return m @ rot_y(a)


def p5_tlas(name, device):
    rng = np.random.default_rng(7)
    soup = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    blases = [(_BOX_V, _BOX_F), (soup, np.arange(60, dtype=np.uint32).reshape(20, 3))]
    if name == "unit_box":
        insts = [tl.Instance(0, np.eye(4))]
    elif name == "mirrored_scaled":
        insts = [tl.Instance(0, place(-30, 0, 0, (-8.0, 12.0, 30.0), 0.4)),
                 tl.Instance(1, place(20, 5, -10, (25.0, -9.0, 14.0), -1.1)),
                 tl.Instance(0, place(5, -20, 20, (30.0, 30.0, -8.0), 2.0))]
    elif name == "twins":
        insts = [tl.Instance(0, place(1, 0, 0, (3, 3, 3))), tl.Instance(0, place(1, 0, 0, (3, 3, 3))),
                 tl.Instance(1, place(-4, 1, 0, (2, 2, 2)))]
    elif name == "past_one_chunk":
        insts = [tl.Instance(int(i % 2), place(*rng.uniform(-40, 40, 3), rng.uniform(0.5, 4, 3),
                                                rng.uniform(0, 6.3)))
                 for i in range(3 * tl.tlas_attrs()["chunk"] // 2 + 5)]
    return tl.build_tlas(blases, insts, device=device)


def grazing_rays(eps=(0.0, 1e-7, -1e-7, 1e-2, -1e-2)):
    """Rays along each face of the unit box, at it and a float step in or
    out, from outside and inside, with direction components 0 and +-1e-13,
    over tmin/tmax clips that end inside the box."""
    ro, rd = [], []
    for axis in range(3):
        for face in (0.0, 1.0):
            for e in eps:
                for d in (0.0, 1e-13, -1e-13):
                    o = np.array([0.5, 0.5, 0.5])
                    o[axis] = face + e
                    u = (axis + 1) % 3
                    o[u] = -2.0
                    v = np.zeros(3)
                    v[u] = 1.0
                    v[(axis + 2) % 3] = d
                    v[axis] = d
                    ro.append(o)
                    rd.append(v)
    ro.append([0.5, 0.5, 0.5])      # from inside, each way
    rd.append([0.0, 0.0, 1.0])
    ro.append([0.25, 0.75, 0.5])
    rd.append([-1.0, 0.0, 0.0])
    return np.asarray(ro, np.float32), np.asarray(rd, np.float32)


def random_rays(n, seed, spread=50.0):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-spread, spread, (n, 3))
    rd = rng.uniform(-spread / 2, spread / 2, (n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[::7, 1] = 0.0
    rd[3::11, 0] = 1e-13
    return ro.astype(np.float32), rd.astype(np.float32)


P5_CASES = {"unit_box": ("grazing", 1e-4, 1e30), "unit_box_clipped": ("grazing", 1.8, 2.6),
            "mirrored_scaled": ("random", 1e-3, 1e30), "twins": ("random", 1e-3, 1e30),
            "past_one_chunk": ("random", 1e-3, 1e30), "past_one_chunk_clipped": ("random", 5.0, 30.0)}


def p5_inputs(case, device):
    kind, tmin, tmax = P5_CASES[case]
    tlas = p5_tlas(case.replace("_clipped", ""), device)
    if kind == "grazing":
        ro, rd = grazing_rays()
    else:
        ro, rd = random_rays(1500, 3, 12.0 if case == "twins" else 50.0)
    ro = tuple(torch.as_tensor(ro[:, k].copy(), device=device) for k in range(3))
    rd = tuple(torch.as_tensor(rd[:, k].copy(), device=device) for k in range(3))
    return tlas, ro, rd, tmin, tmax


def cull_counts(lib, tlas, ro, rd, tmin, tmax):
    """(pairs the cull rejects where the root test accepts, pairs it rejects)
    on the twin."""
    lib.f3d_test_tlas_cull.argtypes = [ctypes.POINTER(_kernels.TlasArgs)] + [_P] * 6 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_float, _P]
    lib.f3d_test_tlas_cull.restype = None
    out = (ctypes.c_longlong * 2)()
    args = _kernels.TlasArgs(tlas.table.data_ptr(), len(tlas.instances))
    lib.f3d_test_tlas_cull(ctypes.byref(args), *(c.data_ptr() for c in (*ro, *rd)),
                           ro[0].numel(), float(np.float32(tmin)), float(np.float32(tmax)), out)
    return out[0], out[1]


@pytest.mark.parametrize("case", list(P5_CASES))
def test_p5_culled_walk_equals_plain(kernels, request, case):  # noqa: F811
    """The staged, culled walk's hits equal trace_tlas_plain's bit for bit,
    and the cull rejects no instance whose root box the walk enters (on the
    twin)."""
    tlas, ro, rd, tmin, tmax = p5_inputs(case, kernels)
    before = tl.trace_tlas.launches
    hk = tl._trace_tlas_kernel(tlas, ro, rd, tmin, tmax)
    assert tl.trace_tlas.launches == before + 1
    hp = tl.trace_tlas_plain(tlas, ro, rd, tmin, tmax)
    assert all(torch.equal(a, b) for a, b in zip(hk, hp))
    assert bool(hp.hit.any()) and bool((~hp.hit).any())
    if case == "twins":   # the lower index wins a tie
        assert not bool((hp.instance == 1).any()) and bool((hp.instance == 0).any())
    if kernels.type == "cpu":
        misses, culled = cull_counts(request.getfixturevalue("host_lib"), tlas, ro, rd, tmin, tmax)
        assert misses == 0 and culled > 0


@pytest.mark.parametrize("name", ["F3D_MESH_INV_MIN", "F3D_MESH_INV_CLAMP"])
def test_p5_margin_takes_the_built_mesh_inv_limits(kernels, name):  # noqa: F811
    """cull_margin reads mesh_inv's limits from their one home in
    csrc/mesh.cuh; the library reports the values it was built with, and
    the plain walk's reciprocal (JAX's) switches to the clamp at the same
    component."""
    key = {"F3D_MESH_INV_MIN": "inv_min", "F3D_MESH_INV_CLAMP": "inv_clamp"}[name]
    assert tl.tlas_attrs()[key] == _kernels.csrc_constant(name)
    inv_min = _kernels.csrc_constant("F3D_MESH_INV_MIN")
    clamp = _kernels.csrc_constant("F3D_MESH_INV_CLAMP")
    at = torch.tensor([inv_min, -inv_min, 0.0], dtype=torch.float32)
    above = torch.nextafter(at[:2], torch.tensor([1.0, -1.0]))
    assert bvh._inv(at).tolist() == [clamp, -clamp, clamp]
    assert torch.equal(bvh._inv(above), 1.0 / above)


def test_p5_cull_margin_bounds_the_float32_transform():
    """cull_margin's box holds the root's corners through the float64
    transform, its margin grows with |ro|, and an instance the argument
    cannot hold for (a singular transform, a root whose miss link is not
    the end) is never culled."""
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    t = place(3, -2, 5, (8.0, -30.0, 12.0), 0.7)
    xf = np.concatenate([np.linalg.inv(t)[:3, :3].reshape(-1), np.linalg.inv(t)[:3, 3]]).astype(
        np.float32)
    wlo, whi, g0, g1, dir_min, org_max = tl.cull_margin(t, xf, lo, hi)
    corners = np.array([[x, y, z, 1.0] for x in (0, 1) for y in (0, 1) for z in (0, 1)]) @ t.T
    assert (corners[:, :3] >= wlo).all() and (corners[:, :3] <= whi).all()
    assert 0 < g0 < 1e-2 and 0 < g1 < 1e-4 and (dir_min, org_max) == (tl.DIR_MIN, tl.ORG_MAX)
    flat = xf.copy()
    flat[0:3] = 0.0     # a singular world-to-object matrix
    assert tl.cull_margin(t, flat, lo, hi)[4] == np.inf
    assert tl.cull_margin(t, xf, hi, lo)[4] == np.inf
    other = place(3, -2, 5, (8.0, -30.0, 13.0), 0.7)   # a float32 row that is not its inverse
    assert tl.cull_margin(other, xf, lo, hi)[2] > 1.0
