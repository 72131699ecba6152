# The port's smoke path (forge3d_tpu_torch/smoke.py over ops/smoke.py, the
# plain versions on the CPU) against the JAX package's forge3d_tpu/smoke.py,
# each case started from the same seeded numpy state.
#
# Gates:
# - `trilinear_plain` bit-equal to eager `_trilinear` (LERP_EAGER) and to
#   `jax.jit(_trilinear)` (LERP_FUSED) on domains of at most 33 voxels an
#   axis;
# - three steps bit-equal to JAX's jitted step on all seven grids, with and
#   without Jacobi sweeps, wind, buoyancy and an ambient temperature;
# - `add_emitter` within 1e-6 * (1 + |ref|) (torch.exp against XLA's exp; the
#   CPU shows 1.2e-7);
# - `render_rgba` every pixel within one u8 step and >= 99.9% of pixels
#   bit-equal (the CPU shows every pixel equal; XLA's rsqrt and exp are not
#   libm's, so the gate leaves them an ulp);
# - `sample_density`, the reports (the total density, a float32 sum in JAX,
#   within 1e-5 relative) and the UploadError / ValueError paths JAX's.
#
# The reference fault: on a 40x36x40 domain JAX's `_trilinear` reads past
# its array at the far z face (float32(n - 1.000001) == n - 1 for n >= 34)
# and returns NaN; the port clamps the +1 neighbour, is finite there, and is
# bit-equal to JAX wherever JAX is finite.
import jax
import numpy as np
import pytest
import torch

from forge3d_tpu import smoke as J

from forge3d_tpu_torch import convert
from forge3d_tpu_torch import smoke as P
from forge3d_tpu_torch.errors import DeviceError, UploadError
from forge3d_tpu_torch.ops import smoke as O

torch.set_num_threads(1)

GRIDS = ("density", "velocity", "temperature", "soot", "emission")


def seeded_state(shape, seed):
    rng = np.random.default_rng(seed)
    return {"density": rng.uniform(0.0, 1.0, shape).astype(np.float32),
            "velocity": rng.normal(0.0, 2.0, (3, *shape)).astype(np.float32),
            "temperature": rng.uniform(0.0, 2.0, shape).astype(np.float32),
            "soot": rng.uniform(0.0, 0.5, shape).astype(np.float32),
            "emission": rng.uniform(0.0, 1.0, shape).astype(np.float32)}


def jax_domain(state, voxel_size=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0)):
    nz, ny, nx = state["density"].shape
    d = J.SmokeDomain(nx, ny, nz, voxel_size, origin)
    d.set_density(state["density"])
    d.set_velocity(state["velocity"])
    d.set_temperature(state["temperature"])
    d.set_soot(state["soot"])
    d.set_emission(state["emission"])
    return d


def jax_state(d):
    return {"density": d.to_density_numpy(), "velocity": d.to_velocity_numpy(),
            "temperature": d.to_temperature_numpy(), "soot": d.to_soot_numpy(),
            "emission": d.to_emission_numpy()}


def port_domain(d):
    """The JAX domain's state carried into the port, mid-simulation."""
    return convert.smoke_domain_from_numpy(jax_state(d), d.voxel_size, d.origin, d.time,
                                           d.steps, device="cpu")


def assert_grids_equal(jd, td):
    for name, ref in jax_state(jd).items():
        got = getattr(td, f"to_{name}_numpy")()
        assert got.dtype == np.float32 and got.shape == ref.shape, name
        assert np.array_equal(got, ref), (name, int((got != ref).sum()))


def rand_points(rng, n, dims, lo=-2.0, hi=2.0):
    return [rng.uniform(lo, d + hi, n).astype(np.float32) for d in dims]


@pytest.mark.parametrize("form", ["eager", "fused"])
def test_trilinear_matches_jax(form):
    rng = np.random.default_rng(3)
    grid = rng.normal(0.0, 1.0, (20, 24, 28)).astype(np.float32)
    pts = rand_points(rng, 50_000, (28, 24, 20))
    fn = J._trilinear if form == "eager" else jax.jit(J._trilinear)
    ref = np.asarray(fn(grid, *pts))
    got = O.trilinear_plain(torch.as_tensor(grid), *map(torch.as_tensor, pts),
                            O.LERP_EAGER if form == "eager" else O.LERP_FUSED).numpy()
    assert np.isfinite(ref).all() and np.array_equal(got, ref)


STEP_CASES = {
    "jacobi0": ((20, 24, 28), dict(dt=0.37, buoyancy=1.3, ambient_temperature=0.2,
                                   wind=(0.3, -0.1, 0.7), jacobi_iters=0)),
    "jacobi20": ((20, 24, 28), dict(dt=0.37, buoyancy=1.3, ambient_temperature=0.2,
                                    wind=(0.3, -0.1, 0.7), jacobi_iters=20)),
    "wildfire_33": ((12, 16, 33), dict(dt=0.6, buoyancy=1.2, dissipation=0.02,
                                       wind=(0.5, 0.0, -0.25), velocity_damping=0.05)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_steps_match_jax_bit_for_bit(case):
    shape, kw = STEP_CASES[case]
    jd = jax_domain(seeded_state(shape, 11), voxel_size=(2.0, 1.5, 3.0))
    td = port_domain(jd)
    for _ in range(3):
        jd.step(J.SmokeStepSettings(**kw))
        td.step(P.SmokeStepSettings(**kw))
        assert_grids_equal(jd, td)
    assert (td.time, td.steps) == (jd.time, jd.steps)


def test_step_with_emitters_carried_mid_simulation():
    """Two JAX steps, then both sides from JAX's state: a step with an
    emitter list; the emitter inside the step moves the grids by exp's ulp,
    so the grids after it are held to add_emitter's gate."""
    jd = jax_domain(seeded_state((16, 20, 24), 5), origin=(-3.0, 0.0, 2.0))
    s = dict(dt=0.5, buoyancy=1.1, jacobi_iters=8)
    for _ in range(2):
        jd.step(J.SmokeStepSettings(**s))
    td = port_domain(jd)
    e = dict(center=(8.0, 4.0, 12.0), radius=4.0, density_rate=2.0, temperature_rate=3.0)
    jd.step(J.SmokeStepSettings(**s), emitters=[J.SmokeEmitter(**e)])
    td.step(P.SmokeStepSettings(**s), emitters=[P.SmokeEmitter(**e)])
    for name, ref in jax_state(jd).items():
        got = getattr(td, f"to_{name}_numpy")()
        assert (np.abs(got - ref) <= 1e-5 * (1.0 + np.abs(ref))).all(), name
    assert (td.time, td.steps) == (jd.time, jd.steps) == (1.5, 3)


@pytest.mark.parametrize("window", ["open", "closed"])
def test_add_emitter_matches_jax(window):
    jd = jax_domain(seeded_state((20, 24, 28), 2), voxel_size=(2.0, 1.5, 3.0),
                    origin=(-4.0, 1.0, 2.0))
    td = port_domain(jd)
    e = dict(center=(20.0, 10.0, 30.0), radius=9.0, density_rate=4.0, temperature_rate=3.0,
             velocity=(0.2, 1.0, -0.3), start_time=0.0 if window == "open" else 1.0)
    jd.add_emitter(J.SmokeEmitter(**e), 0.6)
    td.add_emitter(P.SmokeEmitter(**e), 0.6)
    for name, ref in jax_state(jd).items():
        got = getattr(td, f"to_{name}_numpy")()
        assert (np.abs(got - ref) <= 1e-6 * (1.0 + np.abs(ref))).all(), name
        if window == "closed":
            assert np.array_equal(got, ref), name


def stepped_pair():
    jd = jax_domain(seeded_state((20, 24, 28), 7), voxel_size=(2.0, 1.5, 3.0),
                    origin=(-5.0, 1.0, 2.0))
    td = port_domain(jd)
    e = dict(center=(20.0, 8.0, 30.0), radius=10.0, density_rate=4.0, temperature_rate=3.0)
    for d, mod in ((jd, J), (td, P)):
        d.add_emitter(mod.SmokeEmitter(**e), 0.6)
        d.step(mod.SmokeStepSettings(dt=0.6, buoyancy=1.2))
    return jd, td


def cube_pair():
    rng = np.random.default_rng(19)
    nz, ny, nx = 24, 12, 32
    z, y, x = np.mgrid[0:nz, 0:ny, 0:nx].astype(np.float32)
    dens = 0.05 * rng.uniform(0.0, 1.0, (nz, ny, nx))
    for _ in range(3):
        c = rng.uniform(0.0, 1.0, 3) * (nz, ny, nx)
        sg = rng.uniform(2.0, 5.0)
        dens += np.exp(-((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2) / (2 * sg * sg))
    vel = rng.normal(0.0, 0.5, (3, nz, ny, nx)).astype(np.float32)
    kw = dict(voxel_size=(4.0, 4.0, 4.0), origin=(10.0, 0.0, -20.0))
    jd = J.AtmosphericSmokeCube(dens, vel, **kw).to_domain()
    td = P.AtmosphericSmokeCube(dens, vel, **kw).to_domain(device="cpu")
    assert_grids_equal(jd, td)
    return jd, td


RENDER_CASES = {
    "stepped_64x48_32steps": (stepped_pair, 64, 48, dict(step_count=32), {}),
    "stepped_96x64_defaults": (stepped_pair, 96, 64, {}, {}),
    "cube_64x48_32steps": (cube_pair, 64, 48, dict(step_count=32, sun_steps=4),
                           dict(cam_origin=(64.0, 90.0, 150.0), cam_look_at=(60.0, 10.0, 20.0))),
    "cube_96x64_defaults": (cube_pair, 96, 64, {}, {}),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_rgba_matches_jax(case):
    make, W, H, settings, cam = RENDER_CASES[case]
    jd, td = make()
    ref = jd.render_rgba(W, H, J.SmokeRenderSettings(**settings), **cam)
    got = td.render_rgba(W, H, P.SmokeRenderSettings(**settings), **cam)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (H, W, 4)
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16)).max(-1)
    assert d.max() <= 1 and (d == 0).mean() >= 0.999
    assert 0.05 < (ref[..., 3] > 0).mean()   # the smoke covers part of the frame


def test_sample_density_and_reports_match_jax():
    jd, td = stepped_pair()
    rng = np.random.default_rng(13)
    ext = (28 * 2.0, 24 * 1.5, 20 * 3.0)
    pts = [tuple(rng.uniform(-10.0, e + 10.0) + o for e, o in zip(ext, (-5.0, 1.0, 2.0)))
           for _ in range(64)] + [(-5.0, 1.0, 2.0), (51.0, 37.0, 62.0)]
    for p in pts:
        assert td.sample_density(p) == jd.sample_density(p), p
    assert td.memory_report() == jd.memory_report()
    a, b = jd.physics_report(), td.physics_report()
    assert a.keys() == b.keys()
    for k in ("time", "steps", "max_density", "max_speed", "max_temperature"):
        assert a[k] == b[k], k
    assert abs(a["total_density"] - b["total_density"]) <= 1e-5 * abs(a["total_density"])
    assert J.native_smoke_available() and P.native_smoke_available()


ERRORS = {
    "tiny_domain": (lambda m, dev: m.SmokeDomain(1, 4, 4, **dev), UploadError),
    "density_2d": (lambda m, dev: m.SmokeDomain.from_density(np.zeros((4, 4)), **dev),
                   UploadError),
    "density_shape": (lambda m, dev: m.SmokeDomain(4, 4, 4, **dev).set_density(
        np.zeros((4, 4, 5))), UploadError),
    "velocity_shape": (lambda m, dev: m.SmokeDomain(4, 4, 4, **dev).set_velocity(
        np.zeros((2, 4, 4, 4))), UploadError),
    "soot_shape": (lambda m, dev: m.SmokeDomain(4, 4, 4, **dev).set_soot(np.zeros((4, 4))),
                   UploadError),
    "cube_2d": (lambda m, dev: m.AtmosphericSmokeCube(np.zeros((4, 4))), UploadError),
    "cube_velocity": (lambda m, dev: m.AtmosphericSmokeCube(np.zeros((4, 4, 4)),
                                                            np.zeros((3, 4, 4))), UploadError),
    "emitter_radius": (lambda m, dev: m.SmokeEmitter(radius=0.0), ValueError),
    "emitter_window": (lambda m, dev: m.SmokeEmitter(start_time=2.0, end_time=1.0),
                       ValueError),
    "step_dt": (lambda m, dev: m.SmokeStepSettings(dt=0.0), ValueError),
    "step_jacobi": (lambda m, dev: m.SmokeStepSettings(jacobi_iters=-1), ValueError),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_jax(case):
    call, _ = ERRORS[case]
    with pytest.raises(Exception) as ref:
        call(J, {})
    with pytest.raises(Exception) as got:
        call(P, {"device": "cpu"})
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)
    assert isinstance(got.value, ERRORS[case][1])


def test_domain_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    for call in (lambda: P.SmokeDomain(4, 4, 4),
                 lambda: P.domain_from_density(np.zeros((4, 4, 4))),
                 lambda: P.AtmosphericSmokeCube(np.zeros((4, 4, 4))).to_domain()):
        with pytest.raises(DeviceError, match="CUDA is not available"):
            call()


# --- the reference's fault past 33 voxels an axis, pinned -------------------

FAULT_SHAPE = (40, 36, 40)   # (nz, ny, nx)


def test_far_face_reads_nan_in_jax_and_clamp_in_the_port():
    nz, ny, nx = FAULT_SHAPE
    grid = np.random.default_rng(23).uniform(0.5, 2.0, FAULT_SHAPE).astype(np.float32)
    assert np.float32(nz - 1.000001) == nz - 1   # the clip bound rounds to n - 1
    # points on and beyond the far z face, y on the lattice, x on it or halfway
    k = np.arange(nx - 1, dtype=np.float32)
    x = np.concatenate([k, k + 0.5]).astype(np.float32)
    xs, ys, zs = (a.ravel() for a in np.meshgrid(
        x, np.arange(ny, dtype=np.float32), np.float32([nz - 1, nz - 0.5, nz + 3.0])))
    ref = np.asarray(J._trilinear(grid, xs, ys, zs))
    got = O.trilinear_plain(torch.as_tensor(grid), *map(torch.as_tensor, (xs, ys, zs))).numpy()
    assert np.isnan(ref).all() and np.isfinite(got).all()
    # the clamped float64 lerp, rounded once: exact at these points
    x0 = np.floor(xs).astype(int)
    fx = xs.astype(np.float64) - x0
    g = grid.astype(np.float64)
    lerp = (g[nz - 1, ys.astype(int), x0] * (1 - fx)
            + g[nz - 1, ys.astype(int), np.minimum(x0 + 1, nx - 1)] * fx)
    assert np.array_equal(got, lerp.astype(np.float32))


@pytest.mark.parametrize("form", ["eager", "fused"])
def test_port_equals_jax_wherever_jax_is_finite(form):
    nz, ny, nx = FAULT_SHAPE
    rng = np.random.default_rng(29)
    grid = rng.normal(0.0, 1.0, FAULT_SHAPE).astype(np.float32)
    pts = rand_points(rng, 40_000, (nx, ny, nz), lo=-1.0, hi=1.0)
    fn = J._trilinear if form == "eager" else jax.jit(J._trilinear)
    ref = np.asarray(fn(grid, *pts))
    got = O.trilinear_plain(torch.as_tensor(grid), *map(torch.as_tensor, pts),
                            O.LERP_EAGER if form == "eager" else O.LERP_FUSED).numpy()
    fin = np.isfinite(ref)
    assert 0 < (~fin).sum() and fin.mean() > 0.9 and np.isfinite(got).all()
    assert np.array_equal(got[fin], ref[fin])


def test_one_step_leaves_jax_nan_and_the_port_finite():
    rng = np.random.default_rng(31)
    state = seeded_state(FAULT_SHAPE, 31)
    state["velocity"] = rng.normal(0.0, 0.5, (3, *FAULT_SHAPE)).astype(np.float32)
    jd = jax_domain(state)
    td = port_domain(jd)
    jd.step(J.SmokeStepSettings(jacobi_iters=0))
    td.step(P.SmokeStepSettings(jacobi_iters=0))
    n_nan = 0
    for name, ref in jax_state(jd).items():
        got = getattr(td, f"to_{name}_numpy")()
        fin = np.isfinite(ref)
        n_nan += int((~fin).sum())
        assert np.isfinite(got).all(), name
        assert np.array_equal(got[fin], ref[fin]), name
    assert n_nan > 0
