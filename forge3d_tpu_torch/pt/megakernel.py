# forge3d_tpu_torch/pt/megakernel.py
# The deterministic sphere + ground path tracer with AOVs
# (forge3d_tpu/pt/megakernel.py): pixel-center primary rays, the nearest
# sphere, GGX iso/aniso shading for one directional sun with an
# env-gradient reflection term and emission, a glossy ground plane at y = 0
# with distance fog, a gradient sky, Reinhard, and 7 AOVs.
#
# `render_spheres` is the wrapper of kernel P1 (csrc/engines.cu:
# sphere_kernel over csrc/pbr.cuh:sphere_pixel): on CUDA it launches the
# kernel, on the CPU it runs `render_spheres_plain`. The shading helpers
# here (`shade_pbr`, `env_color`, `engine_rays`) are shared with the mesh
# engine P2 (pt/mesh_render.py).

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .. import _kernels
from ..camera import camera_basis
from ..ops.shading import fdiv, sqrt32
from .terrain_ref import resolve_device

_F32 = torch.float32
_PI = 3.141592653589793

AOV_NAMES = ("albedo", "normal", "depth", "direct", "indirect", "emission", "visibility")

_SUN_DIR = (0.4, 1.0, 0.2)           # normalized below
_SUN_RADIANCE = (2.5, 2.375, 2.25)   # (1.0, 0.95, 0.90) * 2.5
# float32(_SUN_DIR) / float32(|_SUN_DIR|): JAX divides the float32 array by
# the numpy norm in float32
SUN_L = tuple(float(c) for c in (np.asarray(_SUN_DIR, np.float32)
                                 / np.float32(np.linalg.norm(_SUN_DIR))))
SUN_LI = tuple(float(np.float32(c)) for c in _SUN_RADIANCE)


@dataclass(frozen=True)
class SphereBatch:
    """(N, ...) sphere rows (megakernel.py:SphereBatch's fields)."""

    center: torch.Tensor     # (N, 3)
    radius: torch.Tensor     # (N,)
    albedo: torch.Tensor     # (N, 3)
    metallic: torch.Tensor   # (N,)
    emissive: torch.Tensor   # (N, 3)
    roughness: torch.Tensor  # (N,)
    ior: torch.Tensor        # (N,)
    ax: torch.Tensor         # (N,)
    ay: torch.Tensor         # (N,)

    def to(self, device) -> "SphereBatch":
        return SphereBatch(*(getattr(self, f).to(device) for f in self.__dataclass_fields__))

    def kernel_args(self) -> _kernels.SphereArgs:
        fields = [getattr(self, f) for f in ("center", "radius", "albedo", "metallic",
                                             "emissive", "roughness", "ax", "ay")]
        _kernels.require_cuda("spheres", *fields)
        return _kernels.SphereArgs(*(_kernels.ptr(f) for f in fields),
                                   int(self.radius.shape[0]))


def spheres_from_dicts(scene, device="cpu") -> SphereBatch:
    """Parse the scene list-of-dicts contract (defaults: albedo .8,
    metallic 0, roughness .5, emissive 0, ior 1, ax/ay 0.2)."""
    items = list(scene) if scene else []
    n = max(len(items), 1)
    c = np.zeros((n, 3), np.float32)
    r = np.zeros((n,), np.float32)  # radius 0 => never hit (placeholder)
    alb = np.full((n, 3), 0.8, np.float32)
    met = np.zeros((n,), np.float32)
    emi = np.zeros((n, 3), np.float32)
    rough = np.full((n,), 0.5, np.float32)
    ior = np.ones((n,), np.float32)
    ax = np.full((n,), 0.2, np.float32)
    ay = np.full((n,), 0.2, np.float32)
    for i, d in enumerate(items):
        if not isinstance(d, dict):
            raise ValueError("scene items must be dicts")
        if "center" not in d or "radius" not in d:
            raise ValueError("sphere missing 'center'/'radius'")
        c[i] = d["center"]
        r[i] = d["radius"]
        alb[i] = d.get("albedo", (0.8, 0.8, 0.8))
        met[i] = d.get("metallic", 0.0)
        emi[i] = d.get("emissive", (0.0, 0.0, 0.0))
        rough[i] = d.get("roughness", 0.5)
        ior[i] = d.get("ior", 1.0)
        ax[i] = d.get("ax", 0.2)
        ay[i] = d.get("ay", 0.2)
    return SphereBatch(*(torch.as_tensor(v, device=device)
                         for v in (c, r, alb, met, emi, rough, ior, ax, ay)))


def _f32(x) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class EngineCamera:
    """The engines' pinhole camera, float32 values (the JAX cam_params)."""

    width: int
    height: int
    origin: Tuple[float, float, float]
    right: Tuple[float, float, float]
    up: Tuple[float, float, float]
    fwd: Tuple[float, float, float]
    aspect: float
    tan_half: float   # float32 tan(float32(0.5) * float32(fov_y))
    exposure: float

    @staticmethod
    def make(width: int, height: int, cam, origin, look_at) -> "EngineCamera":
        cam = cam or {}
        o = np.asarray(cam.get("origin", origin), np.float32)
        la = np.asarray(cam.get("look_at", look_at), np.float32)
        up = np.asarray(cam.get("up", (0.0, 1.0, 0.0)), np.float32)
        fov_y = np.float32(math.radians(float(cam.get("fov_y", 45.0))))
        right, upv, fwd = camera_basis(o, la, up)
        tan_half = float(torch.tan(torch.tensor(fov_y) * 0.5))
        t3 = lambda v: tuple(float(x) for x in v)  # noqa: E731
        return EngineCamera(int(width), int(height), t3(o), t3(right), t3(upv), t3(fwd),
                            _f32(width / height), tan_half,
                            _f32(float(cam.get("exposure", 1.0))))

    def kernel_args(self) -> _kernels.CamArgs:
        F3 = _kernels._F3
        return _kernels.CamArgs(self.width, self.height, F3(*self.origin), F3(*self.right),
                                F3(*self.up), F3(*self.fwd), self.aspect, self.tan_half,
                                self.exposure, F3(*SUN_L), F3(*SUN_LI))


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def engine_rays(cam: EngineCamera, device):
    """Unit pixel-center ray directions, three (H, W) tensors."""
    W, H = cam.width, cam.height
    xs = torch.arange(W, dtype=_F32, device=device).expand(H, W)
    ys = torch.arange(H, dtype=_F32, device=device)[:, None].expand(H, W)
    ndc_x = fdiv(2.0 * (xs + 0.5), float(W)) - 1.0
    ndc_y = 1.0 - fdiv(2.0 * (ys + 0.5), float(H))
    a = ndc_x * cam.aspect * cam.tan_half
    b = ndc_y * cam.tan_half
    d = [cam.fwd[k] + a * cam.right[k] + b * cam.up[k] for k in range(3)]
    n = sqrt32(dot3(d, d))
    return tuple(c / n for c in d)


def env_color(dir_y):
    """Gradient sky: up = blue, horizon = white, below = dark ground tint."""
    t = torch.clamp(0.5 * (dir_y + 1.0), 0.0, 1.0)
    s0, s1 = (0.9, 0.95, 1.0), (0.2, 0.4, 0.8)
    return tuple((1.0 - t) * 0.08 + t * ((1.0 - t) * s0[c] + t * s1[c]) for c in range(3))


def _pow5(x):
    return torch.pow(x, 5.0)


def _smith_g1(ndx, alpha):
    k = (alpha + 1.0) * (alpha + 1.0) / 8.0
    return ndx / (ndx * (1.0 - k) + k)


def _smith_g_aniso(v, t, b, n, ax, ay):
    vx = dot3(v, t)
    vy = dot3(v, b)
    vz = torch.clamp(dot3(v, n), min=1e-6)
    av = sqrt32(vx * vx * ax * ax + vy * vy * ay * ay) / vz
    return fdiv(2.0, 1.0 + sqrt32(1.0 + av * av))


def shade_pbr(v, n, m_albedo, m_metallic, m_roughness, m_emissive, m_ax, m_ay):
    """GGX direct + env-reflection indirect + emissive for view v and normal
    n (3-tuples of tensors); material values are tensors or floats that
    broadcast. Returns (color, albedo, direct, indirect), each a 3-tuple."""
    like = n[0]
    as_t = lambda x: x if isinstance(x, torch.Tensor) else torch.full_like(like, x)  # noqa: E731
    albedo = [torch.clamp(as_t(a), min=0.0) for a in m_albedo]
    metallic = torch.clamp(as_t(m_metallic), 0.0, 1.0)
    rough = torch.clamp(as_t(m_roughness), 0.0, 1.0)
    ax = torch.clamp(as_t(m_ax), min=0.002)
    ay = torch.clamp(as_t(m_ay), min=0.002)

    l, li = SUN_L, SUN_LI
    h = [l[c] + v[c] for c in range(3)]
    hn = sqrt32(dot3(h, h))
    h = [c / hn for c in h]
    ndl = torch.clamp(dot3(n, l), min=0.0)
    nv = dot3(n, v)
    ndv = torch.clamp(nv, min=0.0)
    ndh = torch.clamp(dot3(n, h), min=0.0)
    vdh = torch.clamp(dot3(v, h), min=0.0)

    a_iso = torch.clamp(rough * rough, min=0.02)
    a2 = a_iso * a_iso
    q = ndh * ndh * (a2 - 1.0) + 1.0
    d_iso = a2 / torch.clamp(_PI * (q * q), min=1e-6)
    g_iso = _smith_g1(ndl, a_iso) * _smith_g1(ndv, a_iso)

    sign = torch.where(n[2] < 0.0, -1.0, 1.0).to(_F32)
    a = fdiv(-1.0, sign + n[2])
    b0 = n[0] * n[1] * a
    t = (1.0 + sign * (n[0] * n[0]) * a, sign * b0, -sign * n[0])
    bv = (b0, sign + (n[1] * n[1]) * a, -n[1])
    hx, hy = dot3(h, t), dot3(h, bv)
    hz = torch.clamp(dot3(h, n), min=0.0)
    x2 = hx * hx / torch.clamp(ax * ax, min=1e-8)
    y2 = hy * hy / torch.clamp(ay * ay, min=1e-8)
    denom = x2 + y2 + hz * hz
    d_an = fdiv(1.0, torch.clamp(_PI * ax * ay * denom * denom, min=1e-6))
    lv = tuple(torch.full_like(like, c) for c in l)
    g_an = _smith_g_aniso(lv, t, bv, n, ax, ay) * _smith_g_aniso(v, t, bv, n, ax, ay)

    iso = (ax - ay).abs() < 1e-4
    D = torch.where(iso, d_iso, d_an)
    G = torch.where(iso, g_iso, g_an)

    p_v = _pow5(1.0 - torch.clamp(vdh, 0.0, 1.0))
    p_n = _pow5(1.0 - ndv)
    sdg = D * G / torch.clamp(4.0 * ndl * ndv, min=1e-6)
    env = env_color(2.0 * nv * n[1] - v[1])
    color, direct, indirect = [], [], []
    for c in range(3):
        f0 = 0.04 * (1.0 - metallic) + albedo[c] * metallic
        F = f0 + (1.0 - f0) * p_v
        kd = (1.0 - F) * (1.0 - metallic)
        diffuse = fdiv(kd * albedo[c], _PI)
        dc = (diffuse + sdg * F) * li[c] * ndl
        f_ibl = f0 + (torch.maximum(1.0 - rough, f0) - f0) * p_n
        ic = env[c] * (f_ibl * 0.5 + 0.5 * kd * albedo[c])
        color.append(dc + ic + torch.clamp(as_t(m_emissive[c]), min=0.0))
        direct.append(dc)
        indirect.append(ic)
    return tuple(color), tuple(albedo), tuple(direct), tuple(indirect)


def _planes(color, albedo, normal, depth, direct, indirect, vis, exposure):
    """The engines' output planes: Reinhard LDR (H, W, 3) and the AOVs."""
    e = [c * max(exposure, _f32(1e-4)) for c in color]
    st = lambda x: torch.stack(list(x), dim=-1)  # noqa: E731
    return {"ldr": st(c / (c + 1.0) for c in e), "albedo": st(albedo), "normal": st(normal),
            "depth": depth, "direct": st(direct), "indirect": st(indirect), "vis": vis}


def render_spheres_plain(cam: EngineCamera, spheres: SphereBatch) -> dict:
    """Plain PyTorch version of P1: the planes of `_planes`."""
    dev = spheres.center.device
    rd = engine_rays(cam, dev)
    o = cam.origin
    best_t = torch.full_like(rd[0], 1e30)
    best = torch.zeros(rd[0].shape, dtype=torch.int64, device=dev)
    for j in range(int(spheres.radius.shape[0])):
        oc = [o[k] - spheres.center[j, k] for k in range(3)]
        r = spheres.radius[j]
        b = dot3(rd, oc)
        cc = dot3(oc, oc) - r * r
        disc = b * b - cc
        sd = sqrt32(torch.clamp(disc, min=0.0))
        t0, t1 = -b - sd, -b + sd
        t = torch.where(t0 > 1e-4, t0, t1)
        t = torch.where((disc >= 0.0) & (t > 1e-4) & (r > 0.0), t, 1e30)
        upd = t < best_t
        best_t = torch.where(upd, t, best_t)
        best = torch.where(upd, j, best)
    hit_s = best_t < 1e30
    g = lambda a: a[best]  # noqa: E731
    ctr = g(spheres.center)
    n = [(o[k] + best_t * rd[k]) - ctr[..., k] for k in range(3)]
    nn = torch.clamp(sqrt32(dot3(n, n)), min=1e-12)
    n = [c / nn for c in n]
    v = tuple(-c for c in rd)
    alb, emi = g(spheres.albedo), g(spheres.emissive)
    cs, als, ds, ins = shade_pbr(v, n, alb.unbind(-1), g(spheres.metallic),
                                 g(spheres.roughness), emi.unbind(-1), g(spheres.ax),
                                 g(spheres.ay))

    one, zero = torch.ones_like(rd[0]), torch.zeros_like(rd[0])
    ng = (zero, one, zero)
    tg = fdiv(-o[1], torch.where(rd[1] >= -1e-5, -1.0, rd[1]))
    hit_g = (rd[1] < -1e-5) & (tg > 0.0)
    cg, alg, dg, ing = shade_pbr(v, ng, (0.6, 0.6, 0.6), 0.0, 0.2, (0.0, 0.0, 0.0), 0.2, 0.2)
    dv = [(o[k] + tg * rd[k]) - o[k] for k in range(3)]
    fog = torch.clamp(fdiv(sqrt32(dot3(dv, dv)), 50.0), 0.0, 1.0)
    horizon = (0.2, 0.4, 0.8)   # env_color of (0, 1, 0)
    cg = tuple((1.0 - fog) * cg[k] + fog * horizon[k] for k in range(3))
    env = env_color(rd[1])

    hg = ~hit_s & hit_g
    pick = lambda s, gr, e: tuple(torch.where(hit_s, a, torch.where(hg, b, c))  # noqa: E731
                                  for a, b, c in zip(s, gr, e))
    z3 = (zero, zero, zero)
    nrm = [torch.where(hit_s, n[k], ng[k]) for k in range(3)]
    nm = torch.clamp(sqrt32(dot3(nrm, nrm)), min=1e-12)
    return _planes(pick(cs, cg, env), pick(als, alg, z3), tuple(c / nm for c in nrm),
                   torch.where(hit_s, best_t, torch.where(hit_g, tg, 1.0)),
                   pick(ds, dg, z3), pick(ins, ing, env),
                   torch.where(hit_s | hit_g, 1.0, 0.0), cam.exposure)


def _empty_planes(cam: EngineCamera, device) -> dict:
    H, W = cam.height, cam.width
    p3 = lambda: torch.empty((H, W, 3), dtype=_F32, device=device)  # noqa: E731
    p1 = lambda: torch.empty((H, W), dtype=_F32, device=device)  # noqa: E731
    return {"ldr": p3(), "albedo": p3(), "normal": p3(), "depth": p1(), "direct": p3(),
            "indirect": p3(), "vis": p1()}


def aov_args(planes: dict) -> _kernels.AovArgs:
    return _kernels.AovArgs(*(_kernels.ptr(planes[k]) for k in
                              ("ldr", "albedo", "normal", "depth", "direct", "indirect", "vis")))


def _render_spheres_kernel(cam: EngineCamera, spheres: SphereBatch) -> dict:
    dev = spheres.center.device
    planes = _empty_planes(cam, dev)
    err = _kernels.lib().f3d_render_spheres(cam.kernel_args(), spheres.kernel_args(),
                                            aov_args(planes), _kernels.stream_ptr(dev))
    _kernels.check(err, "P1 render_spheres")
    render_spheres.launches += 1
    return planes


def render_spheres(cam: EngineCamera, spheres: SphereBatch) -> dict:
    """One image of the sphere engine (kernel P1). CPU spheres run the
    plain version; CUDA spheres launch the kernel."""
    if spheres.center.device.type == "cpu":
        return render_spheres_plain(cam, spheres)
    return _render_spheres_kernel(cam, spheres)


render_spheres.launches = 0


def to_u8(ldr: np.ndarray) -> np.ndarray:
    """RGBA16F round trip of (ldr, 1), then the u8 readback quantisation."""
    rgba = np.concatenate([ldr, np.ones_like(ldr[..., :1])], axis=-1)
    rgba16 = np.asarray(rgba, np.float32).astype(np.float16).astype(np.float32)
    return (np.clip(rgba16, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def pt_render_aovs(width, height, scene, cam, seed=1, frames=1, aovs=AOV_NAMES, *,
                   device="cuda"):
    """Megakernel render returning rgba + requested AOV planes (numpy).
    `device` is "cuda" (kernel P1) or "cpu" (the plain version)."""
    width = int(width)
    height = int(height)
    if width <= 0 or height <= 0:
        raise ValueError("width/height must be positive")
    dev = resolve_device(device)
    spheres = scene.to(dev) if isinstance(scene, SphereBatch) else spheres_from_dicts(scene, dev)
    ecam = EngineCamera.make(width, height, cam, (0.0, 1.2, 3.0), (0.0, 1.0, 0.0))
    out = {k: v.cpu().numpy() for k, v in render_spheres(ecam, spheres).items()}
    out["visibility"] = out.pop("vis")
    out["emission"] = np.zeros_like(out["albedo"])
    result = {"rgba": to_u8(out["ldr"])}
    for name in aovs:
        if name == "rgba":
            continue
        plane = np.asarray(out[name], np.float32)
        if name in ("albedo", "normal", "direct", "indirect", "emission"):
            plane = plane.astype(np.float16).astype(np.float32)
        result[name] = plane
    return result


def pt_render_gpu(width, height, scene, cam, seed=1, frames=1, *, device="cuda"):
    """Deterministic megakernel render -> (H, W, 4) uint8. `seed`/`frames`
    are accepted for signature parity (pixel-center rays)."""
    return pt_render_aovs(width, height, scene, cam, seed=seed, frames=frames,
                          device=device)["rgba"]
