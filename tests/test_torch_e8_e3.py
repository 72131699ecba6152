# E8 step's fused stages and Jacobi bricks, and E3's lattice tiles, on the
# kernels' CPU twin (the bodies of csrc/smoke.cuh and csrc/post.cuh built
# with g++ and driven in the kernels' order, tests/test_torch_kernels.py:
# HOST_LAUNCHERS) against the parent design's per-voxel and per-pixel
# bodies built beside them (a sweep a launch, the forced velocity stored,
# every tap read from memory), and through the wrappers against the plain
# versions; with the `cuda` marker the wrapper cases run on the card
# (`python -m pytest --noconftest tests/test_torch_e8_e3.py -m cuda`).
#
# Gates: E8 bit for bit (torch.equal) everywhere, the step's launches
# O.step_launches(jacobi, levels); E3 bit for bit to the parent's pixels on
# the twin (NaN where NaN), and every element within close_frac's tolerance
# of the plain version through the wrapper (close_frac == 1.0).
import ctypes

import numpy as np
import pytest
import torch

from forge3d_tpu_torch import _kernels
from forge3d_tpu_torch.ops import denoise as dn
from forge3d_tpu_torch.ops import smoke as O
from forge3d_tpu_torch.smoke import SmokeStepSettings
from test_torch_kernels import close_frac, host_lib, kernels  # noqa: F401

torch.set_num_threads(1)

_P = ctypes.c_void_p
GRIDS = ("density", "velocity", "temperature", "soot", "emission")


def state(shape, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)  # noqa: E731
    return {"density": t(rng.uniform(0.0, 1.0, shape)),
            "velocity": t(rng.normal(0.0, 1.5, (3, *shape))),
            "temperature": t(rng.uniform(0.0, 2.0, shape)),
            "soot": t(rng.uniform(0.0, 0.5, shape)), "emission": t(rng.uniform(0.0, 1.0, shape))}


def consts(jacobi):
    return O.step_consts(SmokeStepSettings(dt=0.4, buoyancy=1.3, ambient_temperature=0.1,
                                           wind=(0.2, 0.0, -0.3), jacobi_iters=jacobi))


def parent_fns(lib):
    lib.f3d_test_parent_forces_advect.argtypes = [_P] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float] * 7 + [ctypes.c_int]
    lib.f3d_test_parent_divergence.argtypes = [_P, _P] + [ctypes.c_int] * 3
    lib.f3d_test_parent_jacobi.argtypes = [_P] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float]
    lib.f3d_test_parent_atrous.argtypes = [ctypes.POINTER(_kernels.AtrousArgs), _P, _P,
                                           ctypes.c_int]
    for name in ("forces_advect", "divergence", "jacobi", "atrous"):
        getattr(lib, f"f3d_test_parent_{name}").restype = None
    return lib


def ptr(t):
    return None if t is None else t.data_ptr()


def parent_sweeps(lib, p, div, k, sweeps):
    """`sweeps` of the parent's sweep a launch from p (None: zeros)."""
    nz, ny, nx = div.shape
    for _ in range(sweeps):
        out = torch.empty_like(div)
        lib.f3d_test_parent_jacobi(ptr(p), ptr(div), ptr(out), nx, ny, nz, k.sixth)
        p = out
    return p


def brick_sweeps(lib, p, div, k, levels):
    nz, ny, nx = div.shape
    out = torch.full_like(div, float("nan"))
    assert lib.f3d_smoke_jacobi(ptr(p), ptr(div), ptr(out), nx, ny, nz, k.sixth, levels,
                                None) == 0
    return out


# (nz, ny, nx): the test domain; 2x2x2; x and z narrower than a CTA's staged
# box; sides that do not divide into bricks; three bricks or more on every
# axis, so that some bricks have a halo on all six faces and each face has
# bricks at the domain's edge
BRICK_SHAPES = {"20x24x28": (20, 24, 28), "2x2x2": (2, 2, 2), "smaller": (5, 61, 7),
                "ragged": (29, 53, 61), "six_faces": (66, 63, 97)}


def brick_size():
    """(k, staged x, y, z) of the Jacobi bricks."""
    return (O.jacobi_attrs()["levels"],) + O.jacobi_attrs()["brick"]


@pytest.fixture
def host(host_lib, monkeypatch):  # noqa: F811
    """The twin as the wrappers' library, on CPU tensors."""
    monkeypatch.setattr(_kernels, "lib", lambda: host_lib)
    monkeypatch.setattr(_kernels, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    return parent_fns(host_lib)


def test_brick_shapes_exercise_every_face(host):
    k, sx, sy, sz = brick_size()
    assert k >= 2
    nz, ny, nx = BRICK_SHAPES["six_faces"]   # a brick between two others on each axis
    assert all(n > 2 * (s - k) for n, s in ((nx, sx), (ny, sy), (nz, sz)))
    nz, ny, nx = BRICK_SHAPES["smaller"]
    assert nx < sx and nz < sz and ny > sy
    nz, ny, nx = BRICK_SHAPES["ragged"]
    assert all(n > s and (n - 2 * (s - k)) % (s - 2 * k) for n, s in ((nx, sx), (ny, sy), (nz, sz)))


@pytest.mark.parametrize("levels", ["1", "2", "k"])
@pytest.mark.parametrize("shape", list(BRICK_SHAPES))
def test_jacobi_bricks_are_the_parent_sweeps(host, shape, levels):
    """`levels` levels of the bricks in one launch equal that many of the
    parent's sweeps, bit for bit, from a seeded pressure and from zeros."""
    n = brick_size()[0] if levels == "k" else int(levels)
    g = state(BRICK_SHAPES[shape], 3)
    div = g["density"] - 0.5
    k = consts(20)
    p = g["temperature"]
    assert torch.equal(brick_sweeps(host, p, div, k, n), parent_sweeps(host, p, div, k, n))
    assert torch.equal(brick_sweeps(host, None, div, k, n), parent_sweeps(host, None, div, k, n))


def test_jacobi_bricks_refuse_levels_past_k(host):
    div = torch.zeros((4, 4, 4))
    k = consts(20)
    for bad in (0, brick_size()[0] + 1):
        assert host.f3d_smoke_jacobi(None, ptr(div), ptr(div.clone()), 4, 4, 4, k.sixth, bad,
                                     None) != 0


def test_jacobi_edge_is_its_own_neighbour_at_each_level(host):
    """A spike on the domain's corner and one a level inside a brick's
    halo: the replicated edge is re-read at every level, as the sweeps do
    (a staged copy of level 0 there would give other bits from level 2)."""
    shape = BRICK_SHAPES["six_faces"]
    k_max = brick_size()[0]
    div = torch.zeros(shape)
    p = torch.zeros(shape)
    p[0, 0, 0] = 1.0
    p[-1, -1, -1] = -3.0
    bx = brick_size()[1]
    p[5, 7, bx - 1] = 2.0       # just inside the first brick, in its neighbour's halo
    k = consts(20)
    assert torch.equal(brick_sweeps(host, p, div, k, k_max),
                       parent_sweeps(host, p, div, k, k_max))


@pytest.mark.parametrize("jacobi", [0, 1, 6, 20])
@pytest.mark.parametrize("shape", ["20x24x28", "2x2x2", "smaller", "ragged"])
def test_fused_advection_and_divergence_are_the_parent_stages(host, shape, jacobi):
    """The forces formed where the self-advection reads them equal the
    parent's stored forces then advection; the divergence with the first
    sweep equals the parent's divergence then its sweep from zeros."""
    nz, ny, nx = BRICK_SHAPES[shape]
    g = state((nz, ny, nx), 9)
    k = consts(jacobi)
    forms = k.forms[0] | k.forms[1] << 2 | k.forms[2] << 4
    ref, vf = torch.empty_like(g["velocity"]), torch.empty_like(g["velocity"])
    host.f3d_test_parent_forces_advect(ptr(g["velocity"]), ptr(g["temperature"]),
                                       ptr(vf), ptr(ref), nx, ny, nz, k.dt,
                                       k.dtb, k.amb, *k.wind, k.kdamp, forms)
    va = O._advect_velocity_kernel(g["velocity"], g["temperature"], k)
    assert torch.equal(va, ref)
    div_ref = torch.empty_like(g["density"])
    host.f3d_test_parent_divergence(ptr(va), ptr(div_ref), nx, ny, nz)
    div, p1 = O._divergence_kernel(va, k)
    assert torch.equal(div, div_ref)
    assert torch.equal(p1, parent_sweeps(host, None, div_ref, k, 1))


# the step: jacobi 0, 1, 2, 3, 20, k and k + 1 on the test domain and on the
# brick shapes, through the launches the card runs (host twin and card)
def step_cases():
    cases = [("20x24x28", j) for j in (0, 1, 2, 3, 20, "k", "k+1")]
    return cases + [(s, j) for s in ("2x2x2", "smaller", "ragged", "six_faces") for j in (2, 9)]


@pytest.mark.parametrize("shape,jacobi", step_cases())
def test_step_launches_equal_the_plain_step(kernels, shape, jacobi):  # noqa: F811
    k_max = O.jacobi_attrs()["levels"]
    jacobi = {"k": k_max, "k+1": k_max + 1}.get(jacobi, jacobi)
    g = state(BRICK_SHAPES[shape], 13, kernels)
    k = consts(jacobi)
    args = [g[n] for n in GRIDS]
    counters = (O.smoke_advect_velocity, O.smoke_divergence, O.smoke_jacobi,
                O.smoke_project_advect)
    before = sum(c.launches for c in counters)
    out = O._step_kernel(*args, k)
    assert sum(c.launches for c in counters) - before == O.step_launches(jacobi, k_max)
    ref = O.smoke_step_plain(*[a.cpu() for a in args], k)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(out, ref))


@pytest.mark.parametrize("jacobi", [0, 1, 3])
def test_stage_wrappers_compose_the_plain_step(kernels, jacobi):  # noqa: F811
    """The public stage wrappers, chained a sweep a call, give
    smoke_step_plain's grids bit for bit (their plain versions on CPU
    tensors, their kernels on the card)."""
    g = state(BRICK_SHAPES["20x24x28"], 17, kernels)
    k = consts(jacobi)
    va = O.smoke_advect_velocity(g["velocity"], g["temperature"], k)
    p = div = None
    if jacobi:
        div = O.smoke_divergence(va)
        for _ in range(jacobi if jacobi > 1 else 0):
            p = O.smoke_jacobi(p, div, k)
    out = O.smoke_project_advect(va, p, g["density"], g["temperature"], g["soot"],
                                 g["emission"], k, div if jacobi == 1 else None)
    ref = O.smoke_step_plain(*[g[n].cpu() for n in GRIDS], k)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(out, ref))


def test_step_launch_counts():
    assert [O.step_launches(j, 4) for j in (0, 1, 2, 5, 6, 20)] == [2, 3, 4, 4, 5, 8]
    assert O.step_launches(20, 1) == 22


# ---------------------------------------------------------------------------
# E3

KS = tuple(dn._sigma_k(s) for s in (0.3, 0.3, 0.6, 0.8))


def atrous_planes(H, W, seed, special=False):
    rng = np.random.default_rng(seed)
    c = rng.gamma(2.0, 0.3, (H, W, 3)).astype(np.float32)
    alb = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    nrm = rng.standard_normal((H, W, 3)).astype(np.float32)
    dep = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    if special:   # NaN, +inf and -0.0 in the colour and in each guide
        for a in (c, alb, nrm):
            a[H // 2, W // 3, 0] = np.nan
            a[H - 1, W - 1, 1] = np.inf
            a[0, 0] = -0.0
            a[H // 3, W - 2] = -0.0
        dep[1 % H, 2 % W] = np.nan
        dep[H - 1, 0] = np.inf
        dep[0, W - 1] = -0.0
    return [torch.as_tensor(a) for a in (c, alb, nrm, dep)]


GUIDES = {"none": (False, False, False), "depth_only": (False, False, True),
          "all": (True, True, True)}


def atrous_args(planes, guides):
    c, alb, nrm, dep = planes
    use = GUIDES[guides]
    return _kernels.AtrousArgs(*(p.data_ptr() if u else None
                                 for p, u in zip((alb, nrm, dep), use)),
                               c.shape[1], c.shape[0], *KS)


def same_bits(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32),
                                                            b[~nan].view(torch.int32))


# (H, W): smaller than 4 s + 1 at every spacing past 1 (5x3) or past 8
# (33x17), a tile's width and height exactly (32x16) and past it (52x40)
ATROUS_SIZES = {"5x3": (3, 5), "33x17": (17, 33), "32x16": (16, 32), "52x40": (40, 52)}


@pytest.mark.parametrize("guides", list(GUIDES))
@pytest.mark.parametrize("step", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("size", list(ATROUS_SIZES))
def test_atrous_tiles_are_the_parent_pixels(host, size, step, guides):
    H, W = ATROUS_SIZES[size]
    planes = atrous_planes(H, W, step, special=size != "32x16")
    a = atrous_args(planes, guides)
    got = torch.full_like(planes[0], 7.0)
    assert host.f3d_atrous_pass(a, ptr(planes[0]), ptr(got), step, None) == 0
    ref = torch.full_like(planes[0], 7.0)
    host.f3d_test_parent_atrous(a, ptr(planes[0]), ptr(ref), step)
    assert same_bits(got, ref)


def test_atrous_tiles_report_their_shape(host):
    at = dn.atrous_attrs()
    tx, ty = at["tile"]
    assert tx >= 1 and ty >= 1
    assert at["shared_bytes"] > 4 * (10 * (tx + 4) * (ty + 4) + 12 * tx * ty)


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("guides", list(GUIDES))
@pytest.mark.parametrize("size", ["5x3", "33x17", "52x40"])
def test_atrous_passes_equal_the_plain_version(kernels, size, guides, special):  # noqa: F811
    H, W = ATROUS_SIZES[size]
    c, alb, nrm, dep = (p.to(kernels) for p in atrous_planes(H, W, 21, special))
    use = GUIDES[guides]
    g = [p if u else None for p, u in zip((alb, nrm, dep), use)]
    before = dn.atrous_denoise.launches
    got = dn._atrous_kernel(c, *g, 5, *KS)
    assert dn.atrous_denoise.launches == before + 5
    ref = dn._atrous_plain(c.cpu(), *(None if p is None else p.cpu() for p in g), 5, *KS)
    assert close_frac(ref, got.cpu()) == 1.0
