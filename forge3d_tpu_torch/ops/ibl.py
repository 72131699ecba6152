# forge3d_tpu_torch/ops/ibl.py
# Image-based lighting bake of forge3d_tpu/ops/ibl.py (kernel E1):
# equirect -> cubemap, the GGX-prefiltered specular chain, the split-sum
# BRDF LUT and the cosine-convolved irradiance map, with the quality tiers
# of `bake_ibl`.
#
# The direction tables (the cube faces' texel directions, the per-texel GGX
# reflection directions with their n.l weights, the cosine-lobe
# directions) are formed on the host in float64 as the JAX package forms
# them, then narrowed to float32. Each stage gathers the map bilinearly
# along each texel's directions and sums them: kernel E1 (csrc/ibl.cu over
# csrc/ibl.cuh) for CUDA tensors, one launch for all the stages of a call
# (a bake's seven), over the tables packed texel-major once a tier and kept
# on the card (`_jobs`), in launches of at most BAKE_JOBS stages; the plain
# PyTorch version for CPU tensors; nothing falls back from one to the other. `brdf_lut` is numpy on the host, as in
# the JAX package.

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..pt.terrain_ref import device_for
from .shading import fdiv

__all__ = ["equirect_to_cubemap", "prefilter_environment", "brdf_lut",
           "irradiance_map", "sample_equirect", "IblMaps", "bake_ibl"]

_F32 = torch.float32

# a stage's modes (csrc/ibl.cuh F3D_IBL_*): ONE the one sample; WEIGHTED the
# sum of sample * w over max(sum of w, 1e-6); MEAN the sum of the samples
# over S; the sums from zero in sample order
ONE, WEIGHTED, MEAN = 0, 1, 2

_FACE_AXES = [
    # (forward, up, right) per cube face +X -X +Y -Y +Z -Z
    ((1, 0, 0), (0, 1, 0), (0, 0, -1)),
    ((-1, 0, 0), (0, 1, 0), (0, 0, 1)),
    ((0, 1, 0), (0, 0, -1), (1, 0, 0)),
    ((0, -1, 0), (0, 0, 1), (1, 0, 0)),
    ((0, 0, 1), (0, 1, 0), (1, 0, 0)),
    ((0, 0, -1), (0, 1, 0), (-1, 0, 0)),
]


def _face_dirs(face: int, size: int) -> np.ndarray:
    f, u, r = (np.asarray(a, np.float64) for a in _FACE_AXES[face])
    t = (np.arange(size) + 0.5) / size * 2 - 1
    vy, vx = np.meshgrid(-t, t, indexing="ij")
    d = f[None, None] + vx[..., None] * r[None, None] + vy[..., None] * u[None, None]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d.astype(np.float32)


def _env_tensor(env, device) -> torch.Tensor:
    if isinstance(env, torch.Tensor):
        return env.to(device=device, dtype=_F32).contiguous()
    return torch.as_tensor(np.ascontiguousarray(np.asarray(env, np.float32)), device=device)


def sample_equirect(env: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bilinear equirect lookup for unit directions d (..., 3): u wraps by
    `mod`, v clamps (plain PyTorch; float32)."""
    H, W = env.shape[:2]
    u = (fdiv(torch.atan2(d[..., 0], d[..., 2]), 2 * math.pi) + 0.5) * W - 0.5
    v = fdiv(torch.acos(torch.clamp(d[..., 1], -1, 1)), math.pi) * H - 0.5
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.clamp(torch.floor(v).to(torch.int64), 0, H - 2)
    fu = (u - u0.to(_F32))[..., None]
    fv = torch.clamp(v - v0.to(_F32), 0, 1)[..., None]
    u0m = torch.remainder(u0, W)
    u1m = torch.remainder(u0 + 1, W)
    a = env[v0, u0m] * (1 - fu) + env[v0, u1m] * fu
    b = env[v0 + 1, u0m] * (1 - fu) + env[v0 + 1, u1m] * fu
    return a * (1 - fv) + b * fv


def _accum_plain(env, dirs, weights, mode):
    S = dirs.shape[0]
    if mode == ONE:
        return sample_equirect(env, dirs[0])
    acc = torch.zeros(dirs.shape[1:], dtype=_F32, device=env.device)
    if mode == WEIGHTED:
        wsum = torch.zeros((*dirs.shape[1:-1], 1), dtype=_F32, device=env.device)
        for s in range(S):
            w = weights[s][..., None]
            acc = acc + sample_equirect(env, dirs[s]) * w
            wsum = wsum + w
        return acc / torch.clamp(wsum, min=1e-6)
    for s in range(S):
        acc = acc + sample_equirect(env, dirs[s])
    return fdiv(acc, float(S))


#: the lanes that share a texel in a stage of more than one sample (a power
#: of two up to 32); a one-sample stage takes one lane a texel
GROUP_LANES = 16
#: the stages one launch's job table holds (csrc/ibl.cuh kIblBakeJobs)
BAKE_JOBS = 8


class _Job(NamedTuple):
    """One stage of an E1 launch: its records (T, S, 4), texel-major, the
    output's shape (..., 3) and the mode."""

    tab: torch.Tensor
    shape: Tuple[int, ...]
    mode: int


def _records(dirs: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """The records (T, S, 4) {dx, dy, dz, w} of a table dirs (S, ..., 3)
    with weights (S, ...) (w 0 without): the table transposed, texel-major,
    so that a texel's lanes read consecutive 16-byte records."""
    S = dirs.shape[0]
    d = dirs.reshape(S, -1, 3)
    w = torch.zeros_like(d[..., 0]) if weights is None else weights.reshape(S, -1)
    return torch.cat([d, w[..., None]], -1).transpose(0, 1).contiguous()


def _rgbx(env: torch.Tensor) -> torch.Tensor:
    """The RGBx copy (H, W, 4), x = 0, of an (H, W, 3) map."""
    return torch.nn.functional.pad(env, (0, 1))


def _launch(env: torch.Tensor, jobs) -> list:
    """E1 over `jobs` from the RGBx copy of `env`: one launch (one more for
    every BAKE_JOBS stages past the first BAKE_JOBS), the largest stage
    first, a texel of a stage of more than one sample on GROUP_LANES lanes;
    the outputs in the order of `jobs`. Each launch adds one to
    `_launch.launches`."""
    env4 = _rgbx(env)
    outs, words = [], []
    for job in jobs:
        out = torch.empty(job.shape, dtype=_F32, device=env.device)
        _kernels.require_cuda("E1 equirect_accum", env4, job.tab, out)
        n, count = int(job.tab.shape[0]), int(job.tab.shape[1])
        outs.append(out)
        words.append((n * count, [job.tab.data_ptr(), out.data_ptr(), n, count, job.mode,
                                  1 if count == 1 else GROUP_LANES]))
    words.sort(key=lambda j: -j[0])     # the largest work first; sort is stable
    for j0 in range(0, len(words), BAKE_JOBS):
        part = words[j0:j0 + BAKE_JOBS]
        arr = (ctypes.c_longlong * (6 * len(part)))(*(w for _, job in part for w in job))
        err = _kernels.lib().f3d_ibl_bake(_kernels.ptr(env4), int(env.shape[0]),
                                          int(env.shape[1]), arr, len(part),
                                          _kernels.stream_ptr(env.device))
        _kernels.check(err, "E1 equirect_accum")
        _launch.launches += 1
    return outs


_launch.launches = 0


def _accum_kernel(env, dirs, weights, mode):
    """One stage alone in one E1 launch, from device tables dirs (S, ...,
    3) and weights (S, ...) or None."""
    return _launch(env, [_Job(_records(dirs, weights), tuple(dirs.shape[1:]), mode)])[0]


def _tables(kind: str, *key) -> list:
    """The host tables of a set of stages, float32 formed in float64:
    [(dirs (S, ..., 3), weights (S, ...) or None, mode)]. "cube" (size),
    "prefilter" (base_size, mips, samples), "irradiance" (size, samples)."""
    if kind == "cube":
        return [(np.stack([_face_dirs(f, key[0]) for f in range(6)])[None], None, ONE)]
    if kind == "prefilter":
        return [(d, w, ONE if w is None else WEIGHTED) for d, w in prefilter_tables(*key)]
    return [(irradiance_tables(*key), None, MEAN)]


_JOBS: dict = {}


def _jobs(kind: str, key: tuple, device) -> List[_Job]:
    """E1's jobs of a set of stages on `device`: the records packed from the
    host tables once a (kind, sizes, samples, device) and kept, so that a
    second bake copies no table."""
    k = (kind, *key, str(device))
    if k not in _JOBS:
        _JOBS[k] = [_Job(_records(torch.as_tensor(d), None if w is None else torch.as_tensor(w))
                         .to(device), tuple(d.shape[1:]), mode)
                    for d, w, mode in _tables(kind, *key)]
    return _JOBS[k]


def _stages(env: torch.Tensor, sets) -> List[torch.Tensor]:
    """The maps of the sets of stages [(kind, key)] in order: on CUDA one E1
    launch of them all, on the CPU the plain version stage by stage."""
    if env.device.type == "cpu":
        return [_accum_plain(env, torch.as_tensor(d), None if w is None else torch.as_tensor(w),
                             mode)
                for kind, key in sets for d, w, mode in _tables(kind, *key)]
    return _launch(env, [j for kind, key in sets for j in _jobs(kind, key, env.device)])


def equirect_to_cubemap(env, size: int = 64, *, device=None) -> torch.Tensor:
    """(6, size, size, 3) cubemap from an equirect HDR map."""
    return _stages(_env_tensor(env, device_for(env, device)), [("cube", (size,))])[0]


def _hammersley(n: int) -> np.ndarray:
    out = np.empty((n, 2), np.float64)
    for i in range(n):
        bits = i
        bits = (bits << 16 | bits >> 16) & 0xFFFFFFFF
        bits = ((bits & 0x55555555) << 1 | (bits & 0xAAAAAAAA) >> 1)
        bits = ((bits & 0x33333333) << 2 | (bits & 0xCCCCCCCC) >> 2)
        bits = ((bits & 0x0F0F0F0F) << 4 | (bits & 0xF0F0F0F0) >> 4)
        bits = ((bits & 0x00FF00FF) << 8 | (bits & 0xFF00FF00) >> 8)
        out[i] = (i / n, (bits & 0xFFFFFFFF) * 2.3283064365386963e-10)
    return out


def _ggx_sample(xi, roughness):
    a = roughness * roughness
    phi = 2 * math.pi * xi[:, 0]
    cos_t = np.sqrt((1 - xi[:, 1]) / (1 + (a * a - 1) * xi[:, 1]))
    sin_t = np.sqrt(np.maximum(1 - cos_t * cos_t, 0))
    return np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], 1)


def _latlong_normals(h: int, w: int) -> np.ndarray:
    theta = (np.arange(h) + 0.5) / h * math.pi
    phi = (np.arange(w) + 0.5) / w * 2 * math.pi - math.pi
    PH, TH = np.meshgrid(phi, theta)
    return np.stack([np.sin(TH) * np.sin(PH), np.cos(TH), np.sin(TH) * np.cos(PH)], -1)


def _tangent_frame(n: np.ndarray):
    up = np.where(np.abs(n[..., 1:2]) < 0.99,
                  np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
    t = np.cross(up, n)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    return t, np.cross(n, t)


def prefilter_tables(base_size: int, mips: int, samples: int):
    """Per mip: (directions (S, h, w, 3), n.l weights (S, h, w) or None) in
    float32, formed in float64 as prefilter_environment forms them."""
    xi = _hammersley(samples)
    tables = []
    for m in range(mips):
        rough = m / max(mips - 1, 1)
        h = max(base_size >> m, 4)
        n = _latlong_normals(h, h * 2)
        if m == 0:
            tables.append((n.astype(np.float32)[None], None))
            continue
        t, b = _tangent_frame(n)
        hs = _ggx_sample(xi, rough)
        dirs = np.empty((samples, *n.shape), np.float32)
        wts = np.empty((samples, *n.shape[:2]), np.float32)
        for s in range(samples):
            hv = t * hs[s, 0] + b * hs[s, 1] + n * hs[s, 2]
            ndh = np.sum(n * hv, -1, keepdims=True)
            L = 2 * ndh * hv - n
            wts[s] = np.maximum(np.sum(n * L, -1), 0.0)
            dirs[s] = L
        tables.append((dirs, wts))
    return tables


def prefilter_environment(env, *, base_size: int = 32, mips: int = 5, samples: int = 64,
                          device=None) -> List[torch.Tensor]:
    """Roughness-prefiltered specular chain: mip m holds the GGX-convolved
    environment at roughness m / (mips - 1) as an equirect map of height
    max(base_size >> m, 4)."""
    return _stages(_env_tensor(env, device_for(env, device)),
                   [("prefilter", (base_size, mips, samples))])


def brdf_lut(size: int = 32, samples: int = 128, *, device=None) -> torch.Tensor:
    """Split-sum BRDF integration LUT: (size, size, 2) over (NdotV,
    roughness) -> (scale, bias) for F0, integrated on the host in
    float64."""
    from ..pt.terrain_ref import resolve_device

    nv = (np.arange(size) + 0.5) / size
    rough = (np.arange(size) + 0.5) / size
    NV, R = np.meshgrid(nv, rough, indexing="ij")
    V = np.stack([np.sqrt(1 - NV * NV), np.zeros_like(NV), NV], -1)
    xi = _hammersley(samples)
    A = np.zeros_like(NV)
    B = np.zeros_like(NV)
    for s in range(samples):
        a = R * R
        phi = 2 * math.pi * xi[s, 0]
        cos_t = np.sqrt((1 - xi[s, 1]) / (1 + (a * a - 1) * xi[s, 1]))
        sin_t = np.sqrt(np.maximum(1 - cos_t ** 2, 0))
        H = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], -1)
        vdh = np.sum(V * H, -1)
        L = 2 * vdh[..., None] * H - V
        ndl = L[..., 2]
        ok = ndl > 0
        ndh = np.maximum(H[..., 2], 0)
        vdh = np.maximum(vdh, 1e-6)
        k = (R * R) / 2
        g1l = np.maximum(ndl, 1e-6) / (np.maximum(ndl, 1e-6) * (1 - k) + k)
        g1v = np.maximum(NV, 1e-6) / (np.maximum(NV, 1e-6) * (1 - k) + k)
        G = g1l * g1v
        g_vis = np.where(ok, G * vdh / (ndh * np.maximum(NV, 1e-6) + 1e-9), 0)
        fc = (1 - vdh) ** 5
        A += np.where(ok, (1 - fc) * g_vis, 0.0)
        B += np.where(ok, fc * g_vis, 0.0)
    lut = (np.stack([A, B], -1) / samples).astype(np.float32)
    return torch.as_tensor(lut, device=resolve_device("cuda" if device is None else device))


def irradiance_tables(size: int, samples: int) -> np.ndarray:
    """(S, size, 2 size, 3) float32 cosine-lobe directions, formed in
    float64 as irradiance_map forms them."""
    n = _latlong_normals(size, size * 2)
    t, b = _tangent_frame(n)
    xi = _hammersley(samples)
    dirs = np.empty((samples, *n.shape), np.float32)
    for s in range(samples):
        r = math.sqrt(xi[s, 1])
        ang = 2 * math.pi * xi[s, 0]
        lx, ly = r * math.cos(ang), r * math.sin(ang)
        lz = math.sqrt(max(1 - xi[s, 1], 0.0))
        dirs[s] = t * lx + b * ly + n * lz
    return dirs


def irradiance_map(env, *, size: int = 16, samples: int = 256, device=None) -> torch.Tensor:
    """Cosine-convolved diffuse irradiance (equirect, size x 2 size)."""
    return _stages(_env_tensor(env, device_for(env, device)), [("irradiance", (size, samples))])[0]


class IblMaps(NamedTuple):
    cubemap: torch.Tensor
    specular_mips: Tuple[torch.Tensor, ...]
    brdf: torch.Tensor
    irradiance: torch.Tensor


def bake_ibl(env, *, quality: str = "medium", device=None) -> IblMaps:
    """Full IBL bake with quality tiers (the reference's tiered bake), on
    `device` ("cuda" unless "cpu" is passed; a tensor's own device)."""
    tiers = {"low": (16, 3, 16, 16, 64),
             "medium": (32, 4, 32, 16, 128),
             "high": (64, 5, 64, 32, 256)}
    try:
        cube, mips, smp, isz, bs = tiers[quality]
    except KeyError:
        raise ValueError(f"unknown IBL quality {quality!r}") from None
    e = _env_tensor(env, device_for(env, device))
    cubemap, *specular, irradiance = _stages(e, [("cube", (cube,)),
                                                 ("prefilter", (cube, mips, smp)),
                                                 ("irradiance", (isz, smp * 2))])
    return IblMaps(cubemap=cubemap, specular_mips=tuple(specular),
                   brdf=brdf_lut(isz, bs, device=e.device), irradiance=irradiance)
