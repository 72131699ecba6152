# forge3d_tpu_torch/ops/lightsample.py
# Multi-light next-event estimation (forge3d_tpu/ops/lightsample.py):
# power-weighted alias-table light selection (Vose, built on the host) and
# typed light sampling, one sample per lane.
#
# `sample_light_nee` is the wrapper of kernel K10's standalone launcher
# (csrc/kernels.cu:sample_light_kernel over csrc/lights.cuh:sample_light):
# on CUDA tensors it launches the kernel, on CPU tensors it runs
# `sample_light_nee_plain`. On the render's path the same device function
# runs inside the frame kernel K6, once per sample. Both read the light set
# from one packed table (pack_lights: a light's fields and its alias
# column, 80 bytes), formed once per light set by light_table and kept
# with the alias table.

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from .. import _kernels
from ..lighting import _TYPE_ID, LightBuffer
from .shading import fdiv, sqrt32

_F32 = torch.float32


@dataclass(frozen=True)
class AliasTable:
    prob: torch.Tensor   # (L,) acceptance probability of the home column
    alias: torch.Tensor  # (L,) i32 alias index
    pdf: torch.Tensor    # (L,) selection pdf of each light
    # the kernels' packed table of this alias table with its light set, made
    # once by light_table: {"lights": LightBuffer, "table": (L, 20) tensor,
    # "args": LightArgs}
    kernel: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def count(self) -> int:
        return int(self.prob.shape[0])

    @property
    def u_hi(self) -> float:
        """float32(n - 1e-6), the clamp of u * n (a Python double rounded
        once, as JAX rounds it)."""
        return float(np.float32(self.count - 1e-6))

    def to(self, device) -> "AliasTable":
        return AliasTable(self.prob.to(device), self.alias.to(device), self.pdf.to(device))


def alias_table_build(weights, device="cuda") -> AliasTable:
    """Vose's alias method over non-negative weights (host, deterministic),
    its table on `device`, the card unless device="cpu"."""
    from ..pt.terrain_ref import resolve_device

    w = np.asarray(weights, np.float64).ravel()
    if w.size == 0:
        raise ValueError("alias table needs at least one weight")
    if (w < 0).any() or not np.isfinite(w).all():
        raise ValueError("weights must be finite and non-negative")
    device = resolve_device(device)
    total = w.sum()
    if total <= 0:
        w = np.ones_like(w)
        total = w.sum()
    n = w.size
    pdf = w / total
    scaled = pdf * n
    prob = np.zeros(n)
    alias = np.arange(n)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    scaled = scaled.copy()
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    return AliasTable(prob=torch.as_tensor(prob.astype(np.float32), device=device),
                      alias=torch.as_tensor(alias.astype(np.int32), device=device),
                      pdf=torch.as_tensor(pdf.astype(np.float32), device=device))


def light_power_weights(lights: LightBuffer) -> np.ndarray:
    """Importance weights ~ emitted power: luminance x intensity x emitter
    area/solid factor (float64 on the host over the float32 light rows)."""
    col = lights.color.cpu().numpy()
    lum = 0.2126 * col[:, 0] + 0.7152 * col[:, 1] + 0.0722 * col[:, 2]
    t = lights.type_id.cpu().numpy()
    r = lights.radius.cpu().numpy()
    ex = lights.extent.cpu().numpy()
    area = np.ones_like(lum)
    area = np.where(t == _TYPE_ID["rect"], 4.0 * ex[:, 0] * ex[:, 1], area)
    area = np.where(t == _TYPE_ID["disk"], np.pi * r * r, area)
    area = np.where(t == _TYPE_ID["sphere"], 4.0 * np.pi * r * r, area)
    return np.maximum(lum * area, 1e-9)


def alias_sample(table: AliasTable, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """Light indices drawn from uniform u in [0, 1): (index, selection pdf)."""
    x = torch.clamp(u * table.count, 0.0, table.u_hi)
    col = x.to(torch.int32)
    frac = x - col.to(_F32)
    cl = col.to(torch.int64)
    take_home = frac < table.prob[cl]
    idx = torch.where(take_home, col, table.alias[cl])
    return idx, table.pdf[idx.to(torch.int64)]


_TWO_PI = 6.2831853     # lightsample.py's literal, rounded to float32 on use
_AREA_SPHERE = 4.0 * math.pi   # a double product, as in `4.0 * jnp.pi * rad`


def sample_light_nee_plain(lights: LightBuffer, table: AliasTable,
                           px, py, pz, nx, ny, nz, u_pick, u1, u2):
    """Plain PyTorch version of K10: one NEE light sample per lane.

    Returns (dx, dy, dz, dist, wr, wg, wb): unit shadow-ray direction, ray
    length (1e30 for directional), and the unoccluded radiance estimate
    premultiplied by cos(theta) and divided by all pdfs."""
    idx, p_pick = alias_sample(table, u_pick)
    i = idx.to(torch.int64)
    t_id = lights.type_id[i]
    col = lights.color[i]
    ldir = lights.direction[i]
    lpos = lights.position[i]
    rad = lights.radius[i]
    ext = lights.extent[i]
    cones = lights.cones[i]

    is_dir = t_id == _TYPE_ID["directional"]
    is_spot = t_id == _TYPE_ID["spot"]
    is_rect = t_id == _TYPE_ID["rect"]
    is_disk = t_id == _TYPE_ID["disk"]
    is_sphere = t_id == _TYPE_ID["sphere"]

    rx = (u1 * 2.0 - 1.0) * ext[..., 0]
    rz = (u2 * 2.0 - 1.0) * ext[..., 1]
    dr = sqrt32(u1) * rad
    dphi = _TWO_PI * u2
    sz = u1 * 2.0 - 1.0
    sphi = _TWO_PI * u2
    sr = sqrt32(torch.clamp(1.0 - sz * sz, min=0.0))
    off_x = torch.where(is_rect, rx,
                        torch.where(is_disk, dr * torch.cos(dphi),
                                    torch.where(is_sphere, rad * sr * torch.cos(sphi), 0.0)))
    off_y = torch.where(is_sphere, rad * sz, 0.0)
    off_z = torch.where(is_rect, rz,
                        torch.where(is_disk, dr * torch.sin(dphi),
                                    torch.where(is_sphere, rad * sr * torch.sin(sphi), 0.0)))
    lx = lpos[..., 0] + off_x
    ly = lpos[..., 1] + off_y
    lz = lpos[..., 2] + off_z

    vx = lx - px
    vy = ly - py
    vz = lz - pz
    d2 = vx * vx + vy * vy + vz * vz
    dist = sqrt32(torch.clamp(d2, min=1e-12))
    inv = fdiv(1.0, dist)
    dx = torch.where(is_dir, -ldir[..., 0], vx * inv)
    dy = torch.where(is_dir, -ldir[..., 1], vy * inv)
    dz = torch.where(is_dir, -ldir[..., 2], vz * inv)
    dist = torch.where(is_dir, 1e30, dist)

    ndl = torch.clamp(nx * dx + ny * dy + nz * dz, min=0.0)

    inv_d2 = fdiv(1.0, torch.clamp(d2, min=1e-6))
    cos_l = dy.abs()
    area_rect = 4.0 * ext[..., 0] * ext[..., 1]
    area_disk = math.pi * rad * rad
    rpos = rad > 0
    rsafe = torch.clamp(rad, min=1e-9)
    snx = torch.where(rpos, off_x / rsafe, 0.0)
    sny = torch.where(rpos, off_y / rsafe, 0.0)
    snz = torch.where(rpos, off_z / rsafe, 0.0)
    cos_s = torch.clamp(-(snx * dx + sny * dy + snz * dz), min=0.0)
    area_sphere = _AREA_SPHERE * rad * rad

    geom = torch.where(is_dir, 1.0, inv_d2)
    geom = torch.where(is_rect, area_rect * cos_l * inv_d2, geom)
    geom = torch.where(is_disk, area_disk * cos_l * inv_d2, geom)
    geom = torch.where(is_sphere, area_sphere * cos_s * inv_d2, geom)

    cd = -(dx * ldir[..., 0] + dy * ldir[..., 1] + dz * ldir[..., 2])
    spot_f = torch.clamp((cd - cones[..., 1])
                         / torch.clamp(cones[..., 0] - cones[..., 1], min=1e-6), 0.0, 1.0)
    geom = torch.where(is_spot, geom * spot_f * spot_f, geom)

    scale = ndl * geom / torch.clamp(p_pick, min=1e-12)
    return dx, dy, dz, dist, col[..., 0] * scale, col[..., 1] * scale, col[..., 2] * scale


#: the floats of a light's record in the packed table (csrc/lights.cuh)
LIGHT_WORDS = int(_kernels.csrc_constant("F3D_LIGHT_WORDS"))


def _bits_f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous().view(_F32)


def pack_lights(lights: LightBuffer, table: AliasTable) -> torch.Tensor:
    """The light set as the kernels read it (csrc/lights.cuh): an (L, 20)
    float32 table on the lights' device, a light's record 80 bytes, five
    16-byte words: word 0 the alias column i (prob, alias's bits, pdf[i],
    pdf[alias[i]]), then position and the type's bits, direction and
    radius, colour and 0, extent and the cones' cosines. Every field is
    stored bit for bit."""
    n = table.count
    if lights.count != n:
        raise ValueError(f"{lights.count} lights and an alias table of {n}")
    alias = table.alias.to(torch.int64)
    zero = torch.zeros((n, 1), dtype=_F32, device=lights.type_id.device)
    cols = [table.prob[:, None], _bits_f32(table.alias)[:, None], table.pdf[:, None],
            table.pdf[alias][:, None],
            lights.position, _bits_f32(lights.type_id)[:, None],
            lights.direction, lights.radius[:, None],
            lights.color, zero,
            lights.extent, lights.cones]
    return torch.cat([c.to(lights.type_id.device, _F32) for c in cols], 1).contiguous()


def light_table(lights: LightBuffer, table: AliasTable) -> torch.Tensor:
    """The packed table of this light set (pack_lights), formed on its
    first use and kept with the alias table, so that neither a render's
    frames nor a sample_light_nee call packs it again. Counts the packings
    in `light_table.packs`."""
    k = table.kernel
    if k.get("lights") is not lights:
        k.clear()
        k["table"] = pack_lights(lights, table)
        k["lights"] = lights
        light_table.packs += 1
    return k["table"]


light_table.packs = 0


def light_args(lights: LightBuffer, table: AliasTable) -> _kernels.LightArgs:
    """The kernels' view of a light set: its packed table (light_table),
    the light count and u's clamp, made once with the table."""
    packed = light_table(lights, table)
    args = table.kernel.get("args")
    if args is None:
        _kernels.require_cuda("lights", packed)
        args = table.kernel["args"] = _kernels.LightArgs(_kernels.ptr(packed), table.count,
                                                         table.u_hi)
    return args


def _sample_light_kernel(lights: LightBuffer, table: AliasTable, *lanes):
    if any(c.shape != lanes[0].shape for c in lanes):
        lanes = torch.broadcast_tensors(*lanes)
    comps = [c if c.dtype == _F32 and c.is_contiguous() else c.to(_F32).contiguous()
             for c in lanes]
    args = light_args(lights, table)
    _kernels.require_cuda("sample_light_nee", *comps)
    dev = comps[0].device
    n = comps[0].numel()
    out = torch.empty((7,) + tuple(comps[0].shape), dtype=_F32, device=dev)   # one allocation
    base = out.data_ptr()
    err = _kernels.lib().f3d_sample_light_nee(
        args, n, *(c.data_ptr() for c in comps), *(base + 4 * n * k for k in range(7)),
        _kernels.stream_ptr(dev))
    _kernels.check(err, "K10 sample_light_nee")
    sample_light_nee.launches += 1
    return tuple(out.unbind(0))


def sample_light_nee(lights: LightBuffer, table: AliasTable,
                     px, py, pz, nx, ny, nz, u_pick, u1, u2):
    """One NEE light sample per lane (kernel K10). CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    if px.device.type == "cpu":
        return sample_light_nee_plain(lights, table, px, py, pz, nx, ny, nz, u_pick, u1, u2)
    return _sample_light_kernel(lights, table, px, py, pz, nx, ny, nz, u_pick, u1, u2)


sample_light_nee.launches = 0
