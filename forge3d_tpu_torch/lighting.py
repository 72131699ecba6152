# forge3d_tpu_torch/lighting.py
# Typed lights (forge3d_tpu/lighting.py): the six light types, the `Light`
# record with its validation, the struct-of-arrays `LightBuffer` that the
# per-ray estimator's light sampling (ops/lightsample.py, kernel K10) reads,
# the R2 jitter sequence, and `eval_lights`, the diffuse irradiance of a
# light list at surface points (kernel E6, csrc/leaf.cuh:eval_lights_point,
# launched by csrc/leaf.cu:eval_lights_kernel; plain version
# `eval_lights_plain`). Values are rounded to float32 where the JAX package
# rounds them.
#
# eval_lights runs eagerly in JAX, one rounded float32 operation at a time,
# and the plain version and the kernel do the same operations in the same
# order. XLA's rsqrt on the CPU is not 1 / sqrtf, and its cos and sin are
# not the C library's, so against JAX the irradiance holds to
# 1e-5 (1 + |ref|).

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from . import _kernels
from .ops.shading import fdiv, rsqrt, sqrt32

__all__ = ["Light", "LightBuffer", "r2_sequence", "eval_lights", "eval_lights_plain",
           "LIGHT_TYPES"]

LIGHT_TYPES = ("directional", "point", "spot", "rect", "disk", "sphere")
_TYPE_ID = {t: i for i, t in enumerate(LIGHT_TYPES)}


@dataclass
class Light:
    """One typed light (reference: PyLight)."""

    type: str = "directional"
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    direction: Tuple[float, float, float] = (0.0, -1.0, 0.0)
    position: Tuple[float, float, float] = (0.0, 10.0, 0.0)
    radius: float = 1.0                 # disk/sphere radius, rect half-size
    extent: Tuple[float, float] = (1.0, 1.0)   # rect half extents
    inner_cone_deg: float = 20.0
    outer_cone_deg: float = 30.0

    def __post_init__(self):
        if self.type not in LIGHT_TYPES:
            raise ValueError(f"unknown light type {self.type!r}; "
                             f"one of {LIGHT_TYPES}")
        if self.intensity < 0:
            raise ValueError("intensity must be >= 0")
        if self.type == "spot" and not (
                0 < self.inner_cone_deg <= self.outer_cone_deg <= 90):
            raise ValueError("require 0 < inner <= outer <= 90 degrees")


@dataclass(frozen=True)
class LightBuffer:
    """Struct-of-arrays light set on one device; each field has L rows."""

    type_id: torch.Tensor    # (L,) i32
    color: torch.Tensor      # (L, 3) premultiplied by intensity
    direction: torch.Tensor  # (L, 3) normalized
    position: torch.Tensor   # (L, 3)
    radius: torch.Tensor     # (L,)
    extent: torch.Tensor     # (L, 2)
    cones: torch.Tensor      # (L, 2) cos(inner), cos(outer)

    @staticmethod
    def from_lights(lights: List[Light], device="cuda") -> "LightBuffer":
        """The lights' rows on `device`, the card unless device="cpu"."""
        from .pt.terrain_ref import resolve_device

        if not lights:
            raise ValueError("empty light list")
        device = resolve_device(device)
        d = np.asarray([l.direction for l in lights], np.float32)
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)

        def f32(rows):
            return torch.as_tensor(np.asarray(rows, np.float64).astype(np.float32),
                                   device=device)

        return LightBuffer(
            type_id=torch.as_tensor(np.asarray([_TYPE_ID[l.type] for l in lights], np.int32),
                                    device=device),
            color=f32([np.asarray(l.color) * l.intensity for l in lights]),
            direction=torch.as_tensor(d, device=device),
            position=f32([l.position for l in lights]),
            radius=f32([l.radius for l in lights]),
            extent=f32([l.extent for l in lights]),
            cones=f32([(math.cos(math.radians(l.inner_cone_deg)),
                        math.cos(math.radians(l.outer_cone_deg))) for l in lights]),
        )

    @property
    def count(self) -> int:
        return int(self.type_id.shape[0])

    def to(self, device) -> "LightBuffer":
        return LightBuffer(*(getattr(self, f).to(device) for f in self.__dataclass_fields__))

    def leaf_rows(self) -> np.ndarray:
        """The lights as E6 reads them (csrc/leaf.cuh, F3D_LIGHT_FLOATS): one
        float32 row of 16 per light, type id, colour, direction, position,
        radius, extent, cos inner, cos outer, 0."""
        def f(t):
            return t.detach().cpu().numpy().astype(np.float32).reshape(self.count, -1)

        return np.ascontiguousarray(np.concatenate(
            [f(self.type_id), f(self.color), f(self.direction), f(self.position),
             f(self.radius), f(self.extent), f(self.cones),
             np.zeros((self.count, 1), np.float32)], axis=1))


def r2_sequence(n: int, *, frame: int = 0) -> np.ndarray:
    """(n, 2) R2 low-discrepancy sequence (the reference's light-buffer
    jitter source; generalized golden ratio)."""
    g = 1.32471795724474602596  # plastic constant
    a1, a2 = 1.0 / g, 1.0 / (g * g)
    i = np.arange(frame * n, (frame + 1) * n, dtype=np.float64) + 1
    return np.stack([(0.5 + a1 * i) % 1.0, (0.5 + a2 * i) % 1.0],
                    axis=1).astype(np.float32)


def _dot3(a, b):
    """jnp.sum(a * b, -1) of eager JAX over (..., 3) and three floats or
    tensors: (m0 + m1) + m2."""
    return (a[..., 0] * b[0] + a[..., 1] * b[1]) + a[..., 2] * b[2]


def eval_lights_plain(rows: np.ndarray, p, n, u=None):
    """Plain PyTorch version of E6: the lights' rows (LightBuffer.leaf_rows)
    at float32 points and normals (..., 3), with the optional (..., 2)
    jitter u for area lights; (..., 3)."""
    out = torch.zeros(p.shape[:-1] + (3,), dtype=torch.float32, device=p.device)
    f = np.float32
    for row in rows:
        t = int(row[0])
        col = torch.as_tensor(row[1:4], device=p.device)
        dirn = [float(v) for v in row[4:7]]
        if t == _TYPE_ID["directional"]:
            ndl = torch.clamp(_dot3(n, [-v for v in dirn]), min=0.0)
            out = out + col * ndl[..., None]
            continue
        lx, ly, lz = (float(v) for v in row[7:10])
        r = float(row[10])
        if u is not None and t in (_TYPE_ID["rect"], _TYPE_ID["disk"], _TYPE_ID["sphere"]):
            if t == _TYPE_ID["rect"]:
                lx = lx + (u[..., 0] * 2.0 - 1.0) * float(row[11])
                lz = lz + (u[..., 1] * 2.0 - 1.0) * float(row[12])
            else:
                ang = (u[..., 0] * 2.0) * float(f(math.pi))
                rr = sqrt32(u[..., 1]) * r
                lx = lx + rr * torch.cos(ang)
                lz = lz + rr * torch.sin(ang)
            ly = ly + torch.zeros_like(u[..., 0])
        to_l = [lx - p[..., 0], ly - p[..., 1], lz - p[..., 2]]
        dist2 = torch.clamp((to_l[0] * to_l[0] + to_l[1] * to_l[1]) + to_l[2] * to_l[2],
                            min=float(f(1e-6)))
        rs = rsqrt(dist2)
        ld = [c * rs for c in to_l]
        ndl = torch.clamp(_dot3(n, ld), min=0.0)
        atten = fdiv(1.0, dist2)
        if t == _TYPE_ID["spot"]:
            cd = ((-ld[0]) * dirn[0] + (-ld[1]) * dirn[1]) + (-ld[2]) * dirn[2]
            den = float(max(f(row[13]) - f(row[14]), f(1e-6)))
            spot = torch.clamp(fdiv(cd - float(row[14]), den), 0.0, 1.0)
            atten = atten * spot * spot
        elif t == _TYPE_ID["sphere"]:
            atten = atten * torch.clamp(1.0 + fdiv(float(f(r) * f(r)), dist2), max=4.0)
        out = out + col * (ndl * atten)[..., None]
    return out


def _eval_lights_kernel(rows, p, n, u=None):
    """E6 over CUDA tensors; `rows` is LightBuffer.leaf_rows(), as numpy
    or already as a float32 tensor on the card."""
    ts =[p.contiguous(), n.contiguous()] + ([] if u is None else [u.contiguous()])
    _kernels.require_cuda("E6 eval_lights", *ts)
    lights = torch.as_tensor(rows, device=p.device)
    count = p.numel() // 3
    out = torch.empty(p.shape[:-1] + (3,), dtype=torch.float32, device=p.device)
    err = _kernels.lib().f3d_eval_lights(
        _kernels.ptr(lights), rows.shape[0], _kernels.ptr(ts[0]), _kernels.ptr(ts[1]),
        None if u is None else _kernels.ptr(ts[2]), count, _kernels.ptr(out),
        _kernels.stream_ptr(p.device))
    _kernels.check(err, "E6 eval_lights")
    eval_lights.launches += 1
    return out


def eval_lights(lights: LightBuffer, p, n, *, u=None, device=None):
    """Diffuse irradiance from every light at surface points.

    p, n: (..., 3) position/normal arrays. u: optional (..., 2) jitter for
    area lights (R2 samples). Returns (..., 3) RGB irradiance (no
    occlusion — shadow queries are the renderer's job). Tensors stay on
    their device; numpy input goes to `device` (the card unless
    device="cpu"). CPU tensors run the plain version; CUDA tensors launch
    kernel E6, one thread a point.
    """
    from .pt.terrain_ref import device_for

    dev = device_for(p, device)
    p = torch.as_tensor(p, dtype=torch.float32, device=dev)
    n = torch.as_tensor(n, dtype=torch.float32, device=dev)
    p, n = torch.broadcast_tensors(p, n)
    if u is not None:
        u = torch.as_tensor(u, dtype=torch.float32, device=dev).expand(p.shape[:-1] + (2,))
    rows = lights.leaf_rows()
    if dev.type == "cpu":
        return eval_lights_plain(rows, p, n, u)
    return _eval_lights_kernel(rows, p, n, u)


eval_lights.launches = 0
