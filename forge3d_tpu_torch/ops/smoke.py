# forge3d_tpu_torch/ops/smoke.py
# The smoke path's device functions (kernels E8 step and E8 march of
# forge3d_tpu/smoke.py): the trilinear sample, the fluid step in its five
# stages, and the volume march. Each wrapper launches its CUDA kernel
# (csrc/smoke.cu over csrc/smoke.cuh) for CUDA tensors and runs its plain
# PyTorch version, beside it here, for CPU tensors; nothing falls back from
# one to the other. Each wrapper counts its launches.
#
# The plain versions repeat the JAX package's float32 arithmetic: the step
# is one jitted program in JAX, and the multiply-adds XLA fuses there (found
# by search against JAX's CPU code) are fused here with `fma32`; see
# csrc/smoke.cuh for the list. `_trilinear`'s fault past n = 33 voxels an
# axis (its +1 neighbour leaves the grid, and JAX reads NaN) is not carried
# over: the +1 neighbour clamps to n - 1.

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from .shading import fdiv, fma32, sqrt32
from .traversal import f32

__all__ = ["trilinear_plain", "StepConsts", "step_consts", "smoke_forces",
           "smoke_advect_velocity", "smoke_divergence", "smoke_jacobi",
           "smoke_project_advect", "smoke_step", "smoke_step_plain", "MarchSetup",
           "march_setup", "smoke_march", "smoke_march_plain"]

_F32 = torch.float32

# lerp forms (csrc/smoke.cuh F3D_LERP_*)
LERP_EAGER, LERP_FUSED, LERP_SWAPPED = 0, 1, 2


def _lerp(a, b, t, form):
    u = 1.0 - t
    if form == LERP_FUSED:
        return fma32(a, u, b * t)
    if form == LERP_SWAPPED:
        return fma32(b, t, a * u)
    return a * u + b * t


def trilinear_plain(grid: torch.Tensor, px, py, pz, form: int = LERP_EAGER) -> torch.Tensor:
    """`_trilinear`: sample grid (nz, ny, nx) at fractional voxel coordinates
    (broadcast together), clamped to [0, float32(n - 1.000001)] on each
    axis, each +1 neighbour clamped to n - 1. LERP_EAGER rounds every
    operation (JAX's op-by-op `_trilinear`), LERP_FUSED and LERP_SWAPPED
    fuse each lerp as XLA's jitted code does."""
    nz, ny, nx = grid.shape
    px, py, pz = torch.broadcast_tensors(px, py, pz)
    x = torch.clamp(px, 0.0, f32(nx - 1.000001))
    y = torch.clamp(py, 0.0, f32(ny - 1.000001))
    z = torch.clamp(pz, 0.0, f32(nz - 1.000001))
    x0, y0, z0 = (torch.floor(c).to(torch.int64) for c in (x, y, z))
    fx, fy, fz = x - x0.to(_F32), y - y0.to(_F32), z - z0.to(_F32)
    x1 = torch.clamp(x0 + 1, max=nx - 1)
    y1 = torch.clamp(y0 + 1, max=ny - 1)
    z1 = torch.clamp(z0 + 1, max=nz - 1)
    flat = grid.reshape(-1)

    def at(zi, yi, xi):
        return flat[(zi * ny + yi) * nx + xi]

    c00 = _lerp(at(z0, y0, x0), at(z0, y0, x1), fx, form)
    c01 = _lerp(at(z0, y1, x0), at(z0, y1, x1), fx, form)
    c10 = _lerp(at(z1, y0, x0), at(z1, y0, x1), fx, form)
    c11 = _lerp(at(z1, y1, x0), at(z1, y1, x1), fx, form)
    return _lerp(_lerp(c00, c01, fy, form), _lerp(c10, c11, fy, form), fz, form)


def _axes(shape, device):
    nz, ny, nx = shape
    return (torch.arange(nx, dtype=_F32, device=device)[None, None, :],
            torch.arange(ny, dtype=_F32, device=device)[None, :, None],
            torch.arange(nz, dtype=_F32, device=device)[:, None, None])


# ---------------------------------------------------------------------------
# E8 step


@dataclass(frozen=True)
class StepConsts:
    """A step's float32 constants as the jitted JAX step forms them:
    dt b folded in float32, the wind's dt w from float64, the Jacobi's
    reciprocal of 6, and the lerp forms of the stored self-advected velocity
    (y and z swapped when no Jacobi sweep runs)."""

    dt: float
    dtb: float
    amb: float
    wind: Tuple[float, float, float]
    kdamp: float
    keep: float
    keep2: float
    sixth: float
    jacobi: int
    forms: Tuple[int, int, int]


def step_consts(s) -> StepConsts:
    """StepConsts of a SmokeStepSettings."""
    jacobi = int(s.jacobi_iters)
    keep = 1.0 - s.dissipation
    return StepConsts(
        dt=f32(s.dt), dtb=float(np.float32(s.dt) * np.float32(s.buoyancy)),
        amb=f32(s.ambient_temperature), wind=tuple(f32(s.dt * w) for w in s.wind),
        kdamp=f32(1.0 - s.velocity_damping), keep=f32(keep), keep2=f32(keep * keep),
        sixth=float(np.float32(1.0) / np.float32(6.0)), jacobi=jacobi,
        forms=(LERP_FUSED,) * 3 if jacobi > 0 else (LERP_FUSED, LERP_SWAPPED, LERP_SWAPPED))


def _dims(grid):
    nz, ny, nx = grid.shape
    return int(nx), int(ny), int(nz)


def _forces_plain(vel, temp, k: StepConsts):
    w0, w1, w2 = k.wind
    return torch.stack([(vel[0] + w0) * k.kdamp,
                        (fma32(temp - k.amb, k.dtb, vel[1]) + w1) * k.kdamp,
                        (vel[2] + w2) * k.kdamp])


def _forces_kernel(vel, temp, k: StepConsts):
    _kernels.require_cuda("E8 forces", vel, temp)
    vf = torch.empty_like(vel)
    err = _kernels.lib().f3d_smoke_forces(
        _kernels.ptr(vel), _kernels.ptr(temp), _kernels.ptr(vf), temp.numel(), k.dtb, k.amb,
        *k.wind, k.kdamp, _kernels.stream_ptr(vel.device))
    _kernels.check(err, "E8 forces")
    smoke_forces.launches += 1
    return vf


def smoke_forces(vel, temp, k: StepConsts) -> torch.Tensor:
    """The step's forces (smoke.py:223-227): buoyancy, wind, damping."""
    if vel.device.type == "cpu":
        return _forces_plain(vel, temp, k)
    return _forces_kernel(vel, temp, k)


smoke_forces.launches = 0


def _advect_velocity_plain(vf, k: StepConsts):
    xs, ys, zs = _axes(vf.shape[1:], vf.device)
    bx, by, bz = fma32(-k.dt, vf[0], xs), fma32(-k.dt, vf[1], ys), fma32(-k.dt, vf[2], zs)
    return torch.stack([trilinear_plain(vf[c], bx, by, bz, k.forms[c]) for c in range(3)])


def _advect_velocity_kernel(vf, k: StepConsts):
    _kernels.require_cuda("E8 advect_velocity", vf)
    nx, ny, nz = _dims(vf[0])
    va = torch.empty_like(vf)
    forms = k.forms[0] | k.forms[1] << 2 | k.forms[2] << 4
    err = _kernels.lib().f3d_smoke_advect_velocity(
        _kernels.ptr(vf), _kernels.ptr(va), nx, ny, nz, k.dt, forms,
        _kernels.stream_ptr(vf.device))
    _kernels.check(err, "E8 advect_velocity")
    smoke_advect_velocity.launches += 1
    return va


def smoke_advect_velocity(vf, k: StepConsts) -> torch.Tensor:
    """The forced velocity's self-advection (smoke.py:230)."""
    if vf.device.type == "cpu":
        return _advect_velocity_plain(vf, k)
    return _advect_velocity_kernel(vf, k)


smoke_advect_velocity.launches = 0


def _neighbours(p):
    """lap_nb (smoke.py:233-240): xm, xp, ym, yp, zm, zp, edges replicated."""
    return (torch.cat([p[:, :, :1], p[:, :, :-1]], 2), torch.cat([p[:, :, 1:], p[:, :, -1:]], 2),
            torch.cat([p[:, :1], p[:, :-1]], 1), torch.cat([p[:, 1:], p[:, -1:]], 1),
            torch.cat([p[:1], p[:-1]], 0), torch.cat([p[1:], p[-1:]], 0))


def _divergence_plain(va):
    xm, xp, _, _, _, _ = _neighbours(va[0])
    _, _, ym, yp, _, _ = _neighbours(va[1])
    _, _, _, _, zm, zp = _neighbours(va[2])
    return 0.5 * ((xp - xm) + (yp - ym) + (zp - zm))


def _divergence_kernel(va):
    _kernels.require_cuda("E8 divergence", va)
    nx, ny, nz = _dims(va[0])
    div = torch.empty_like(va[0])
    err = _kernels.lib().f3d_smoke_divergence(_kernels.ptr(va), _kernels.ptr(div), nx, ny, nz,
                                              _kernels.stream_ptr(va.device))
    _kernels.check(err, "E8 divergence")
    smoke_divergence.launches += 1
    return div


def smoke_divergence(va) -> torch.Tensor:
    """div_of (smoke.py:242-246) of the advected velocity."""
    if va.device.type == "cpu":
        return _divergence_plain(va)
    return _divergence_kernel(va)


smoke_divergence.launches = 0


def _jacobi_plain(p, div, k: StepConsts):
    if p is None:
        p = torch.zeros_like(div)
    xm, xp, ym, yp, zm, zp = _neighbours(p)
    return (xm + xp + ym + yp + zm + zp - div) * k.sixth


def _jacobi_kernel(p, div, k: StepConsts, out=None):
    _kernels.require_cuda("E8 jacobi", div, *(() if p is None else (p,)))
    nx, ny, nz = _dims(div)
    out = torch.empty_like(div) if out is None else out
    err = _kernels.lib().f3d_smoke_jacobi(
        None if p is None else p.data_ptr(), _kernels.ptr(div), _kernels.ptr(out), nx, ny, nz,
        k.sixth, _kernels.stream_ptr(div.device))
    _kernels.check(err, "E8 jacobi")
    smoke_jacobi.launches += 1
    return out


def smoke_jacobi(p: Optional[torch.Tensor], div, k: StepConsts, out=None) -> torch.Tensor:
    """One Jacobi sweep of the pressure solve (smoke.py:251-253); p None is
    the first sweep from zeros. A CUDA sweep writes into `out` when given
    (the step ping-pongs two buffers)."""
    if div.device.type == "cpu":
        return _jacobi_plain(p, div, k)
    return _jacobi_kernel(p, div, k, out)


smoke_jacobi.launches = 0


def _project_advect_plain(va, p, density, temperature, soot, emission, k: StepConsts,
                          div=None):
    if p is not None:
        xm, xp, ym, yp, zm, zp = _neighbours(p)
        vel = torch.stack([va[0] + -0.5 * (xp - xm), va[1] + -0.5 * (yp - ym),
                           va[2] + -0.5 * (zp - zm)])
    elif div is not None:
        # one sweep, unrolled into the projection: p = (0 - div) / 6 formed
        # in place, one product of each difference left unrounded
        xm, xp, ym, yp, zm, zp = (0.0 - a for a in _neighbours(div))
        s = k.sixth
        vel = torch.stack([va[0] + -0.5 * fma32(-xm, s, xp * s),
                           va[1] + -0.5 * fma32(-ym, s, yp * s),
                           va[2] + -0.5 * fma32(zp, s, -(zm * s))])
    else:
        vel = va
    xs, ys, zs = _axes(density.shape, density.device)
    b = (fma32(-k.dt, vel[0], xs), fma32(-k.dt, vel[1], ys), fma32(-k.dt, vel[2], zs))
    return (trilinear_plain(density, *b, LERP_FUSED) * k.keep, vel,
            trilinear_plain(temperature, *b, LERP_FUSED) * k.keep,
            trilinear_plain(soot, *b, LERP_FUSED) * k.keep,
            trilinear_plain(emission, *b, LERP_FUSED) * k.keep2)


def _project_advect_kernel(va, p, density, temperature, soot, emission, k: StepConsts,
                           div=None):
    _kernels.require_cuda("E8 project_advect", va, density, temperature, soot, emission,
                          *(t for t in (p, div) if t is not None))
    nx, ny, nz = _dims(density)
    vel = torch.empty_like(va)
    outs = [torch.empty_like(density) for _ in range(4)]
    err = _kernels.lib().f3d_smoke_project_advect(
        _kernels.ptr(va), None if p is None else p.data_ptr(),
        None if div is None else div.data_ptr(), _kernels.ptr(density),
        _kernels.ptr(temperature), _kernels.ptr(soot), _kernels.ptr(emission),
        _kernels.ptr(vel), *map(_kernels.ptr, outs), nx, ny, nz, k.dt, k.keep, k.keep2,
        k.sixth, _kernels.stream_ptr(va.device))
    _kernels.check(err, "E8 project_advect")
    smoke_project_advect.launches += 1
    return outs[0], vel, outs[1], outs[2], outs[3]


def smoke_project_advect(va, p, density, temperature, soot, emission, k: StepConsts,
                         div=None):
    """The pressure projection (smoke.py:256-259) and the advection of the
    four scalars with dissipation (262-266): (density, velocity, temperature,
    soot, emission). p is the pressure after two or more sweeps; with one
    sweep pass p None and the divergence as `div`: the sweep runs here, in
    the form XLA gives the unrolled loop; with neither the velocity stays as
    advected."""
    if va.device.type == "cpu":
        return _project_advect_plain(va, p, density, temperature, soot, emission, k, div)
    return _project_advect_kernel(va, p, density, temperature, soot, emission, k, div)


smoke_project_advect.launches = 0


def smoke_step_plain(density, velocity, temperature, soot, emission, k: StepConsts):
    """One fluid step by the plain versions (any device)."""
    va = _advect_velocity_plain(_forces_plain(velocity, temperature, k), k)
    p = div = None
    if k.jacobi:
        div = _divergence_plain(va)
        for _ in range(k.jacobi if k.jacobi > 1 else 0):
            p = _jacobi_plain(p, div, k)
    return _project_advect_plain(va, p, density, temperature, soot, emission, k,
                                 div if k.jacobi == 1 else None)


def smoke_step(density, velocity, temperature, soot, emission, k: StepConsts):
    """One fluid step (`_build_step`'s program): the forces, the
    self-advection, the divergence, `jacobi_iters` sweeps and the fused
    projection and scalar advection. CPU tensors run the plain versions;
    CUDA tensors launch 4 + jacobi_iters kernels (3 with no sweep, 4 with
    one: a single sweep runs inside the projection, as XLA unrolls it)."""
    va = smoke_advect_velocity(smoke_forces(velocity, temperature, k), k)
    p = div = None
    if k.jacobi:
        div = smoke_divergence(va)
        bufs = (torch.empty_like(div), torch.empty_like(div)) if div.is_cuda else (None, None)
        for i in range(k.jacobi if k.jacobi > 1 else 0):
            p = smoke_jacobi(p, div, k, out=bufs[i % 2])
    return smoke_project_advect(va, p, density, temperature, soot, emission, k,
                                div if k.jacobi == 1 else None)


# ---------------------------------------------------------------------------
# E8 march


@dataclass(frozen=True)
class MarchSetup:
    """A render's host constants, float32 as `render_rgba` forms them, and
    the sun march's offsets float32(sun ds i), (sun_steps, 3)."""

    args: dict
    sun_off: np.ndarray

    def ctypes_args(self) -> _kernels.SmokeMarchArgs:
        a = _kernels.SmokeMarchArgs()
        for name, v in self.args.items():
            if isinstance(v, tuple):
                getattr(a, name)[:] = v
            else:
                setattr(a, name, v)
        return a


def march_setup(shape, voxel_size, origin, width: int, height: int, settings, cam_origin,
                cam_look_at, fov_y_deg: float) -> MarchSetup:
    """The constants of one march (smoke.py:337-401): the camera basis, the
    box, to_vox's reciprocals, and the folded extinction constants."""
    from ..camera import camera_basis

    s = settings
    nz, ny, nx = shape
    ext = (nx * voxel_size[0], ny * voxel_size[1], nz * voxel_size[2])
    right, up, fwd = camera_basis(cam_origin, cam_look_at, (0, 1, 0))
    half_h = math.tan(math.radians(fov_y_deg) * 0.5)
    half_w = (width / height) * half_h
    sun = np.asarray(s.sun_dir, np.float64)
    sun = sun / np.linalg.norm(sun)
    ds = max(ext) / s.sun_steps * 0.5
    sigma_t = s.absorption + s.scattering
    sun_off = np.asarray([[sun[c] * ds * i for c in range(3)]
                          for i in range(1, int(s.sun_steps) + 1)], np.float32).reshape(-1, 3)
    vec = lambda v: tuple(f32(c) for c in v)  # noqa: E731
    args = dict(
        nx=nx, ny=ny, nz=nz, width=int(width), height=int(height), steps=int(s.step_count),
        sun_steps=int(s.sun_steps), half_w=f32(half_w), half_h=f32(half_h),
        steps_f=f32(int(s.step_count)), right=vec(right), up=vec(up), fwd=vec(fwd),
        cam_o=vec(cam_origin), lo=vec(origin), hi=vec(origin[i] + ext[i] for i in range(3)),
        org=vec(origin), rcp=tuple(float(np.float32(1.0) / np.float32(v)) for v in voxel_size),
        sigma_t=f32(sigma_t), sun_k=float(np.float32(-sigma_t) * np.float32(ds)),
        scat_k=float(np.float32(s.scattering) * (np.float32(1.0) / np.maximum(
            np.float32(sigma_t), np.float32(1e-6)))),
        alb=vec(s.smoke_albedo), sun_c=vec(s.sun_color), emis_c=vec(s.emission_color),
        bg=vec(s.background))
    return MarchSetup(args, sun_off)


def _u8(v):
    return (torch.clamp(v, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def smoke_march_plain(density, emission, soot, m: MarchSetup) -> torch.Tensor:
    """The march of `render_rgba` by plain PyTorch (any device): (H, W, 4)
    u8 rgba, alpha = 1 - transmittance."""
    a = m.args
    dev = density.device
    H, W = a["height"], a["width"]
    xsp = torch.arange(W, dtype=_F32, device=dev)[None, :].expand(H, W)
    ysp = torch.arange(H, dtype=_F32, device=dev)[:, None].expand(H, W)
    cx = (fdiv(2.0 * (xsp + 0.5), float(W)) - 1.0) * a["half_w"]
    cy = (1.0 - fdiv(2.0 * (ysp + 0.5), float(H))) * a["half_h"]
    d = [cx * a["right"][c] + cy * a["up"][c] + a["fwd"][c] for c in range(3)]
    inv = fdiv(1.0, sqrt32(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]))
    d = [x * inv for x in d]
    t0, t1 = [], []
    for c in range(3):
        big = torch.abs(d[c]) > f32(1e-9)
        invd = torch.where(big, fdiv(1.0, torch.where(big, d[c], 1.0)),
                           torch.where(d[c] >= 0, 1e9, -1e9).to(_F32))
        ta = float(np.float32(a["lo"][c]) - np.float32(a["cam_o"][c])) * invd
        tb = float(np.float32(a["hi"][c]) - np.float32(a["cam_o"][c])) * invd
        t0.append(torch.minimum(ta, tb))
        t1.append(torch.maximum(ta, tb))
    t_in = torch.maximum(torch.maximum(t0[0], t0[1]), torch.clamp(t0[2], min=0.0))
    t_out = torch.minimum(torch.minimum(t1[0], t1[1]), t1[2])
    has = t_in < t_out
    dtm = fdiv(t_out - t_in, a["steps_f"])
    off = m.sun_off.tolist()

    def to_vox(w):
        return [fma32(w[c] - a["org"][c], a["rcp"][c], -0.5) for c in range(3)]

    tr = torch.ones_like(cx)
    r, g, b = torch.zeros_like(cx), torch.zeros_like(cx), torch.zeros_like(cx)
    for i in range(a["steps"]):
        t = fma32(i + 0.5, dtm, t_in)
        w = [fma32(t, d[c], a["cam_o"][c]) for c in range(3)]
        p = to_vox(w)
        dens = trilinear_plain(density, *p, LERP_FUSED)
        emis = trilinear_plain(emission, *p, LERP_FUSED)
        so = trilinear_plain(soot, *p, LERP_FUSED)
        att = torch.exp(-torch.where(has, (a["sigma_t"] * dens) * dtm, 0.0))
        acc = torch.zeros_like(cx)
        for o in off:
            acc = acc + trilinear_plain(density, *to_vox([w[c] + o[c] for c in range(3)]),
                                        LERP_FUSED)
        lsun = torch.exp(acc * a["sun_k"])
        sf = torch.clamp(fdiv(so, dens + f32(1e-4)), 0.0, 1.0)
        oat = (1.0 - att) * tr
        scat = (oat * lsun) * a["scat_k"]
        glow = oat * emis
        sn, s5 = 1.0 - sf, f32(0.05) * sf
        r, g, b = (fma32(glow, a["emis_c"][c],
                         fma32(scat * fma32(a["alb"][c], sn, s5), a["sun_c"][c], acc_c))
                   for c, acc_c in enumerate((r, g, b)))
        tr = tr * att
    lin = [acc_c + tr * a["bg"][c] for c, acc_c in enumerate((r, g, b))]
    return torch.stack([_u8(fdiv(v, 1.0 + v)) for v in lin] + [_u8(1.0 - tr)], -1)


def _march_kernel(density, emission, soot, m: MarchSetup) -> torch.Tensor:
    _kernels.require_cuda("E8 march", density, emission, soot)
    dev = density.device
    off = torch.as_tensor(m.sun_off, device=dev).contiguous()
    rgba = torch.empty((m.args["height"], m.args["width"], 4), dtype=torch.uint8, device=dev)
    args = m.ctypes_args()
    err = _kernels.lib().f3d_smoke_march(
        ctypes.byref(args), _kernels.ptr(density), _kernels.ptr(emission), _kernels.ptr(soot),
        _kernels.ptr(off), _kernels.ptr(rgba), _kernels.stream_ptr(dev))
    _kernels.check(err, "E8 march")
    smoke_march.launches += 1
    return rgba


def smoke_march(density, emission, soot, m: MarchSetup) -> torch.Tensor:
    """The volume march of `render_rgba`: (H, W, 4) u8 on the grids' device.
    CPU grids run the plain version, CUDA grids launch kernel E8 march."""
    if density.device.type == "cpu":
        return smoke_march_plain(density, emission, soot, m)
    return _march_kernel(density, emission, soot, m)


smoke_march.launches = 0
