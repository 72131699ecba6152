# forge3d_tpu_torch/smoke.py
# Smoke and volumetrics of forge3d_tpu/smoke.py on PyTorch: voxel smoke
# domains, the fluid step (forces, semi-Lagrangian advection, a Jacobi
# pressure projection), spherical emitters, and the volume march, with the
# JAX package's names, arguments and output types.
#
# A domain's grids live on its device, "cuda" by default: there `step` runs
# kernel E8 step (csrc/smoke.cu: forces, self-advection, divergence, one
# launch a Jacobi sweep, the projection fused with the scalar advection) and
# `render_rgba` kernel E8 march (one thread a pixel). device="cpu" runs the
# plain PyTorch versions in ops/smoke.py. The emitter is elementwise PyTorch
# glue on the domain's device, in the order of JAX's eager ops; a step and
# an emitter replace the grids with new tensors, as JAX's do.
#
# Axes: grids are (nz, ny, nx), x fastest, y up (buoyancy along +y); the
# velocity is (3, nz, ny, nx). `_trilinear`'s +1 neighbour, which leaves
# the grid in the JAX package for an axis of 34 voxels or more, clamps to
# n - 1 here (ops/smoke.py).

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .errors import UploadError
from .ops import smoke as ops
from .ops.shading import fdiv
from .ops.traversal import f32
from .pt.terrain_ref import resolve_device

__all__ = ["SmokeEmitter", "SmokeStepSettings", "SmokeRenderSettings", "SmokeDomain",
           "domain_from_density", "AtmosphericSmokeCube", "native_smoke_available"]

_F32 = torch.float32


@dataclass
class SmokeEmitter:
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius: float = 1.0
    density_rate: float = 1.0
    temperature_rate: float = 1.0
    fuel_rate: float = 0.0
    soot_rate: float = 0.2
    humidity_rate: float = 0.0
    emission_rate: float = 1.0
    velocity: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    start_time: float = 0.0
    end_time: float = float(np.finfo(np.float32).max)

    def __post_init__(self):
        if self.radius <= 0.0:
            raise ValueError("radius must be > 0")
        if self.end_time < self.start_time:
            raise ValueError("end_time must be >= start_time")


@dataclass
class SmokeStepSettings:
    dt: float = 1.0 / 30.0
    buoyancy: float = 1.0
    ambient_temperature: float = 0.0
    dissipation: float = 0.02
    velocity_damping: float = 0.02
    wind: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    jacobi_iters: int = 20
    vorticity: float = 0.0

    def __post_init__(self):
        if self.dt <= 0:
            raise ValueError("dt must be > 0")
        if self.jacobi_iters < 0:
            raise ValueError("jacobi_iters must be >= 0")


@dataclass
class SmokeRenderSettings:
    absorption: float = 1.2
    scattering: float = 0.8
    step_count: int = 64
    sun_steps: int = 8
    sun_dir: Tuple[float, float, float] = (0.4, 0.8, 0.3)
    sun_color: Tuple[float, float, float] = (1.0, 0.96, 0.9)
    smoke_albedo: Tuple[float, float, float] = (0.85, 0.85, 0.88)
    emission_color: Tuple[float, float, float] = (1.0, 0.45, 0.1)
    background: Tuple[float, float, float] = (0.25, 0.35, 0.55)


class SmokeDomain:
    """Voxel smoke domain of shape (nz, ny, nx); y is up."""

    def __init__(self, nx: int, ny: int, nz: int,
                 voxel_size=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0), *, device="cuda"):
        if min(nx, ny, nz) < 2:
            raise UploadError("smoke domain needs at least 2 voxels per axis")
        self.device = resolve_device(device)
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.origin = tuple(float(v) for v in origin)
        shape = (self.nz, self.ny, self.nx)
        zeros = lambda *s: torch.zeros(s, dtype=_F32, device=self.device)  # noqa: E731
        self.density = zeros(*shape)
        self.velocity = zeros(3, *shape)  # (vx, vy, vz)
        self.temperature = zeros(*shape)
        self.soot = zeros(*shape)
        self.emission = zeros(*shape)
        self.time = 0.0
        self.steps = 0

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_density(density: np.ndarray, voxel_size=(1.0, 1.0, 1.0),
                     origin=(0.0, 0.0, 0.0), *, device="cuda") -> "SmokeDomain":
        d = np.asarray(density, np.float32)
        if d.ndim != 3:
            raise UploadError("density must be 3D (nz, ny, nx)")
        nz, ny, nx = d.shape
        dom = SmokeDomain(nx, ny, nz, voxel_size, origin, device=device)
        dom.density = dom._upload(d)
        return dom

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, dtype=_F32, device=self.device)

    def set_density(self, density: np.ndarray) -> None:
        d = np.asarray(density, np.float32)
        if d.shape != (self.nz, self.ny, self.nx):
            raise UploadError(f"density shape {d.shape} != domain {(self.nz, self.ny, self.nx)}")
        self.density = self._upload(d)

    def set_velocity(self, velocity: np.ndarray) -> None:
        v = np.asarray(velocity, np.float32)
        if v.shape != (3, self.nz, self.ny, self.nx):
            raise UploadError("velocity must be (3, nz, ny, nx)")
        self.velocity = self._upload(v)

    def set_temperature(self, t: np.ndarray) -> None:
        self.temperature = self._check(t)

    def set_soot(self, s: np.ndarray) -> None:
        self.soot = self._check(s)

    def set_emission(self, e: np.ndarray) -> None:
        self.emission = self._check(e)

    def _check(self, a):
        a = np.asarray(a, np.float32)
        if a.shape != (self.nz, self.ny, self.nx):
            raise UploadError("grid shape mismatch")
        return self._upload(a)

    # -- emitters ----------------------------------------------------------
    def add_emitter(self, emitter: SmokeEmitter, dt: float) -> None:
        """Inject from a spherical emitter for dt seconds (smooth falloff)."""
        if not (emitter.start_time <= self.time <= emitter.end_time):
            return
        xs, ys, zs = ops._axes((self.nz, self.ny, self.nx), self.device)
        vx, vy, vz = self.voxel_size
        wx = f32(self.origin[0]) + (xs + 0.5) * f32(vx)
        wy = f32(self.origin[1]) + (ys + 0.5) * f32(vy)
        wz = f32(self.origin[2]) + (zs + 0.5) * f32(vz)
        c = [f32(v) for v in emitter.center]
        d2 = (wx - c[0]) ** 2 + (wy - c[1]) ** 2 + (wz - c[2]) ** 2
        w = torch.exp(fdiv(-d2, 2.0 * (emitter.radius * 0.5) ** 2))
        w = torch.where(d2 <= f32(emitter.radius ** 2 * 4.0), w, 0.0)
        dt32 = f32(dt)
        self.density = self.density + w * f32(emitter.density_rate) * dt32
        self.temperature = self.temperature + w * f32(emitter.temperature_rate) * dt32
        self.soot = self.soot + w * f32(emitter.soot_rate) * dt32
        self.emission = self.emission + w * f32(emitter.emission_rate) * dt32
        self.velocity = torch.stack([self.velocity[i] + w * f32(vr) * dt32
                                     for i, vr in enumerate(emitter.velocity)])

    # -- simulation --------------------------------------------------------
    def step(self, settings: Optional[SmokeStepSettings] = None,
             emitters=()) -> None:
        s = settings or SmokeStepSettings()
        for e in emitters:
            self.add_emitter(e, s.dt)
        (self.density, self.velocity, self.temperature, self.soot,
         self.emission) = ops.smoke_step(self.density, self.velocity, self.temperature,
                                         self.soot, self.emission, ops.step_consts(s))
        self.time += s.dt
        self.steps += 1

    # -- queries -----------------------------------------------------------
    def sample_density(self, position) -> float:
        """Density at a world position: `_trilinear` op by op (JAX runs it
        eagerly), on the host, of the 2x2x2 block around the position."""
        p, lo, idx = [], [], []
        for i, n in enumerate((self.nx, self.ny, self.nz)):
            c = np.float32((position[i] - self.origin[i]) / self.voxel_size[i] - 0.5)
            c = min(max(c, np.float32(0.0)), np.float32(n - 1.000001))
            lo.append(int(np.floor(c)))
            p.append(torch.tensor(c - np.float32(lo[-1]), dtype=_F32))
            idx.append(torch.tensor([lo[-1], min(lo[-1] + 1, n - 1)], device=self.device))
        g = self.density[idx[2][:, None, None], idx[1][None, :, None],
                         idx[0][None, None, :]].cpu()
        fx, fy, fz = p
        lerp = lambda a, b, t: ops._lerp(a, b, t, ops.LERP_EAGER)  # noqa: E731
        c0 = lerp(lerp(g[0, 0, 0], g[0, 0, 1], fx), lerp(g[0, 1, 0], g[0, 1, 1], fx), fy)
        c1 = lerp(lerp(g[1, 0, 0], g[1, 0, 1], fx), lerp(g[1, 1, 0], g[1, 1, 1], fx), fy)
        return float(lerp(c0, c1, fz))

    def to_density_numpy(self) -> np.ndarray:
        return self.density.cpu().numpy()

    def to_velocity_numpy(self) -> np.ndarray:
        return self.velocity.cpu().numpy()

    def to_temperature_numpy(self) -> np.ndarray:
        return self.temperature.cpu().numpy()

    def to_soot_numpy(self) -> np.ndarray:
        return self.soot.cpu().numpy()

    def to_emission_numpy(self) -> np.ndarray:
        return self.emission.cpu().numpy()

    def memory_report(self) -> dict:
        vox = self.nx * self.ny * self.nz
        return {
            "voxels": vox,
            "grids": 7,
            "bytes": vox * 4 * 7,
            "shape": (self.nz, self.ny, self.nx),
        }

    def physics_report(self) -> dict:
        """Sums in float64 of the float32 grids (JAX's float32 sum has its
        own rounding order); maxima exact."""
        return {
            "time": self.time,
            "steps": self.steps,
            "total_density": float(self.density.double().sum()),
            "max_density": float(self.density.max()),
            "max_speed": float(self.velocity.abs().max()),
            "max_temperature": float(self.temperature.max()),
        }

    # -- rendering ---------------------------------------------------------
    def render_rgba(self, width: int, height: int,
                    settings: Optional[SmokeRenderSettings] = None,
                    cam_origin=None, cam_look_at=None,
                    fov_y_deg: float = 45.0) -> np.ndarray:
        """Volumetric raymarch of the domain -> (H, W, 4) uint8, alpha the
        accumulated opacity (1 - transmittance)."""
        s = settings or SmokeRenderSettings()
        ext = (self.nx * self.voxel_size[0], self.ny * self.voxel_size[1],
               self.nz * self.voxel_size[2])
        center = tuple(self.origin[i] + ext[i] * 0.5 for i in range(3))
        if cam_origin is None:
            cam_origin = (center[0], center[1] + ext[1] * 0.2,
                          center[2] + max(ext) * 1.8)
        if cam_look_at is None:
            cam_look_at = center
        m = ops.march_setup((self.nz, self.ny, self.nx), self.voxel_size, self.origin,
                            width, height, s, cam_origin, cam_look_at, fov_y_deg)
        return ops.smoke_march(self.density, self.emission, self.soot, m).cpu().numpy()


def domain_from_density(density, voxel_size=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0), *,
                        device="cuda"):
    return SmokeDomain.from_density(density, voxel_size, origin, device=device)


@dataclass
class AtmosphericSmokeCube:
    """Geospatial smoke cube (e.g. HRRR-derived) ready for a domain
    (reference: smoke.py:36-60)."""

    density: np.ndarray
    velocity: Optional[np.ndarray] = None
    voxel_size: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    vertical_levels: tuple = ()
    times: tuple = ()
    crs: Optional[str] = None
    source: Optional[str] = None

    def __post_init__(self):
        self.density = np.ascontiguousarray(self.density, np.float32)
        if self.density.ndim != 3:
            raise UploadError("density must be 3D")
        if self.velocity is not None:
            v = np.ascontiguousarray(self.velocity, np.float32)
            if v.shape != (3, *self.density.shape):
                raise UploadError("velocity must be (3, nz, ny, nx)")
            self.velocity = v

    def to_domain(self, *, device="cuda") -> SmokeDomain:
        dom = domain_from_density(self.density, self.voxel_size, self.origin, device=device)
        if self.velocity is not None:
            dom.set_velocity(self.velocity)
        return dom


def native_smoke_available() -> bool:
    """Always True: the port's smoke path is its own (CUDA kernels on the
    card, their plain versions on the CPU)."""
    return True
