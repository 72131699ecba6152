# forge3d_tpu_torch/ops/post.py
# The post-processing suite of forge3d_tpu/ops/post.py (kernel E2): bloom,
# depth of field, TAA, SSAO, SSR, vignette, sharpen and the rect-area light,
# with the JAX package's names, arguments and float32 (H, W, 3) images.
#
# Each stage has a plain PyTorch version and a CUDA kernel in csrc/post.cu
# over csrc/post.cuh: the separable blur (`blur_axis`, two launches a blur,
# counted by instantiation: `blur_instance`),
# the pointwise stages around the blurs (`post_point`: bloom's brightpass
# and composite, the depth-of-field mix, the vignette, the unsharp
# composite), `ssr`, `taa_resolve`, `ssao` and the rect lights
# (`rect_area_light_sum`, every light of a list in one launch). A wrapper
# runs the plain version for CPU tensors and launches the kernel for CUDA
# tensors; nothing falls back from one to the other. Each wrapper counts its
# kernel launches in `.launches`.
#
# The JAX functions run eagerly, one rounded jnp operation at a time: the
# plain versions do the same float32 operations in the same order (divisions
# through `fdiv`, square roots through `sqrt32`), so they equal JAX bit for
# bit apart from jnp.exp in the blur taps and the power in the rect light's
# specular lobe. jnp.linalg.norm is jitted: XLA fuses its squares into the
# sum, which the rect light's plain version and kernel do with fma; an eager
# jnp.sum over three elements is (x0 + x1) + x2. The blur taps are formed
# once on the host (float32, summed in order) and shared by both versions.
# Numpy input goes to `device` ("cuda" by default, which raises DeviceError
# without CUDA); a tensor stays on its own device.

from __future__ import annotations

import math
from collections import Counter
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from ..pt.terrain_ref import device_for
from .shading import fdiv, fma32, sqrt32

__all__ = ["gaussian_blur", "bloom", "depth_of_field", "taa_resolve",
           "ssao", "ssr", "vignette", "sharpen", "halton_jitter",
           "rect_area_light", "rect_area_light_sum", "PostConfig", "apply_post_chain"]

_F32 = torch.float32

# post_point's modes (csrc/post.cuh F3D_PP_*)
PP_BRIGHT, PP_BLOOM, PP_DOF, PP_VIGNETTE, PP_SHARPEN = range(5)


def _f(x) -> float:
    """A Python float holding the float32 rounding of x."""
    return float(np.float32(x))


def _t(x, device) -> torch.Tensor:
    """x as a contiguous float32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=_F32).contiguous()
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x, np.float32)), device=device)


def _gauss_kernel(sigma: float, radius: int) -> torch.Tensor:
    """post.py:_gauss_kernel on the host: exp(-0.5 (x / sigma)^2) over
    x = -r..r, normalised by its float32 sum taken in order. A CPU tensor."""
    x = torch.arange(-radius, radius + 1, dtype=_F32)
    q = fdiv(x, sigma)
    k = torch.exp(-0.5 * (q * q))
    total = torch.zeros((), dtype=_F32)
    for v in k:
        total = total + v
    return fdiv(k, total)


# ---------------------------------------------------------------------------
# The separable blur
# ---------------------------------------------------------------------------


def _blur_axis_plain(x: torch.Tensor, taps, radius: int, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    idx = torch.clamp(torch.arange(n + 2 * radius, device=x.device) - radius, 0, n - 1)
    xp = x.index_select(axis, idx)
    out = torch.zeros_like(x)
    for i in range(2 * radius + 1):
        out = out + taps[i] * xp.narrow(axis, i, n)
    return out


#: the widest radius whose window E2 blur stages in shared memory (at 120
#: its (128 + 2r) * 32 staged floats and 2r + 1 taps, csrc/post.cuh:
#: blur_shared_bytes, take 48,068 B of the 48 KB a CTA has without opting
#: in); wider ones read device memory
BLUR_SHARED_RADIUS = 120


def blur_instance(radius: int) -> str:
    """The instantiation E2 blur launches for `radius`: where its window is
    read from (csrc/post.cu:blur_kernel<true> stages it, <false> reads
    device memory)."""
    return "shared window" if 0 <= radius <= BLUR_SHARED_RADIUS else "device window"


def _blur_axis_kernel(x: torch.Tensor, taps: torch.Tensor, radius: int, axis: int):
    _kernels.require_cuda("gaussian_blur", x, taps)
    shape = x.shape
    outer = int(np.prod(shape[:axis], dtype=np.int64))
    inner = int(np.prod(shape[axis + 1:], dtype=np.int64))
    out = torch.empty_like(x)
    instance = blur_instance(int(radius))
    err = _kernels.lib().f3d_blur_axis(_kernels.ptr(x), _kernels.ptr(out), _kernels.ptr(taps),
                                       int(radius), outer, int(shape[axis]), inner,
                                       int(instance == "shared window"),
                                       _kernels.stream_ptr(x.device))
    _kernels.check(err, "E2 blur_axis")
    blur_axis.launches += 1
    blur_axis.instances[instance] += 1
    return out


def blur_axis(x: torch.Tensor, taps: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """One pass of gaussian_blur's conv1d along `axis` (0 or 1) of a
    contiguous float32 tensor, edge-clamped, with the host's 2r + 1 taps
    (a CPU tensor). CPU tensors run the plain version; CUDA tensors launch
    kernel E2 blur."""
    if x.device.type == "cpu":
        return _blur_axis_plain(x, [float(v) for v in taps], radius, axis)
    return _blur_axis_kernel(x, taps.to(x.device), radius, axis)


blur_axis.launches = 0
blur_axis.instances = Counter()   # launches by blur_instance


def gaussian_blur(img, sigma: float = 2.0, radius: Optional[int] = None, *, device=None):
    """Separable gaussian blur, edge-clamped: axis 0, then axis 1."""
    if radius is None:
        radius = max(1, int(math.ceil(3 * sigma)))
    k = _gauss_kernel(float(sigma), int(radius))
    x = _t(img, device_for(img, device))
    return blur_axis(blur_axis(x, k, int(radius), 0), k, int(radius), 1)


# ---------------------------------------------------------------------------
# Pointwise stages
# ---------------------------------------------------------------------------


def _point_plain(mode, a, b, c, d, p):
    if mode == PP_BRIGHT:
        lum = 0.2126 * a[..., 0] + 0.7152 * a[..., 1] + 0.0722 * a[..., 2]
        knee = torch.clamp(fdiv(lum - p[0], p[1]), min=0.0)
        return a * fdiv(knee, torch.clamp(lum, min=1e-4))[..., None]
    if mode == PP_BLOOM:
        return a + p[0] * (0.65 * b + 0.35 * c)
    if mode == PP_DOF:
        coc = fdiv((b - p[0]).abs(), p[1])
        if not p[4]:
            coc = torch.where(b < p[0], 0.0, coc)
        coc = torch.clamp(coc, 0.0, 1.0) * p[2]
        t = fdiv(coc, p[3])[..., None]
        sharp = torch.clamp(t * 2.0, 0.0, 1.0)
        blur = torch.clamp(t * 2.0 - 1.0, 0.0, 1.0)
        return (a * (1 - sharp) + c * sharp) * (1 - blur) + d * blur
    if mode == PP_VIGNETTE:
        H, W = a.shape[:2]
        yy = (fdiv(torch.arange(H, dtype=_F32, device=a.device), float(H - 1)) - 0.5) * 2
        xx = (fdiv(torch.arange(W, dtype=_F32, device=a.device), float(W - 1)) - 0.5) * 2
        r = fdiv(sqrt32(yy[:, None] * yy[:, None] + xx[None, :] * xx[None, :]), p[3])
        fall = torch.clamp(fdiv(r - p[1], p[2]), 0.0, 1.0)
        return a * (1 - p[0] * fall * fall)[..., None]
    return torch.clamp(a + p[0] * (a - b), min=0.0)   # PP_SHARPEN


def _point_kernel(mode, a, b, c, d, p):
    planes = [t for t in (a, b, c, d) if t is not None]
    _kernels.require_cuda("post_point", *planes)
    H, W = a.shape[:2]
    C = int(np.prod(a.shape[2:], dtype=np.int64))
    out = torch.empty_like(a)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _kernels.lib().f3d_post_point(mode, H, W, C, ptr(a), ptr(b), ptr(c), ptr(d),
                                        out.data_ptr(), *(list(p) + [0.0] * (6 - len(p))),
                                        _kernels.stream_ptr(a.device))
    _kernels.check(err, "E2 post_point")
    post_point.launches += 1
    return out


def post_point(mode: int, a, b=None, c=None, d=None, params: Sequence[float] = ()):
    """One pointwise stage of the chain (csrc/post.cuh:post_point_pixel) on
    contiguous float32 (H, W, C) planes (DoF's depth (H, W)); `params` are
    float32 values. CPU tensors run the plain version, CUDA tensors launch
    kernel E2 point."""
    p = [float(v) for v in params]
    if a.device.type == "cpu":
        return _point_plain(mode, a, b, c, d, p)
    return _point_kernel(mode, a, b, c, d, p)


post_point.launches = 0


def bloom(color, *, threshold: float = 1.0, intensity: float = 0.5, sigma: float = 6.0,
          device=None):
    """Brightpass -> blur at sigma and 2.5 sigma -> additive composite."""
    c = _t(color, device_for(color, device))
    bright = post_point(PP_BRIGHT, c, params=(_f(threshold), _f(max(threshold, 1e-4))))
    b1 = gaussian_blur(bright, sigma)
    b2 = gaussian_blur(bright, sigma * 2.5)
    return post_point(PP_BLOOM, c, b1, b2, params=(_f(intensity),))


def depth_of_field(color, depth, *, focus_distance: float, focus_range: float = 2.0,
                   max_coc: float = 8.0, near_blur: bool = True, device=None):
    """Gather DOF: circle of confusion from depth, a blend of the sharp
    image and two blurs."""
    dev = device_for(color, device)
    c = _t(color, dev)
    dep = _t(depth, dev)
    b_small = gaussian_blur(c, max(max_coc * 0.25, 0.5))
    b_large = gaussian_blur(c, max(max_coc * 0.75, 1.0))
    return post_point(PP_DOF, c, dep, b_small, b_large,
                      params=(_f(focus_distance), _f(max(focus_range, 1e-4)), _f(max_coc),
                              _f(max(max_coc, 1e-4)), 1.0 if near_blur else 0.0))


def vignette(color, *, strength: float = 0.35, radius: float = 0.85, device=None):
    c = _t(color, device_for(color, device))
    return post_point(PP_VIGNETTE, c, params=(_f(strength), _f(radius),
                                              _f(max(1 - radius, 1e-4)), _f(math.sqrt(2))))


def sharpen(color, *, amount: float = 0.3, device=None):
    """Unsharp mask (the reference's TAA sharpen companion)."""
    c = _t(color, device_for(color, device))
    blur = gaussian_blur(c, 1.0, radius=2)
    return post_point(PP_SHARPEN, c, blur, params=(_f(amount),))


def halton_jitter(n: int = 8, *, device="cuda") -> torch.Tensor:
    """(n, 2) Halton(2,3) subpixel jitter sequence in [-0.5, 0.5) (the
    reference's TAA jitter source), computed on the host."""
    from ..pt.terrain_ref import resolve_device

    def halton(i, b):
        f, r = 1.0, 0.0
        while i > 0:
            f /= b
            r += f * (i % b)
            i //= b
        return r

    pts = [(halton(i + 1, 2) - 0.5, halton(i + 1, 3) - 0.5) for i in range(n)]
    return torch.as_tensor(np.asarray(pts, np.float32).reshape(n, 2),
                           device=resolve_device(device))


# ---------------------------------------------------------------------------
# TAA, SSAO, SSR
# ---------------------------------------------------------------------------


def _taa_plain(cur, hist, blend, omb, clamp):
    if clamp:
        shifts = [torch.roll(cur, (dy, dx), (0, 1)) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        stack = torch.stack(shifts)
        hist = torch.clamp(hist, stack.amin(0), stack.amax(0))
    return blend * cur + omb * hist


def _taa_kernel(cur, hist, blend, omb, clamp):
    _kernels.require_cuda("taa_resolve", cur, hist)
    if hist.shape != cur.shape:
        raise ValueError(f"taa_resolve: history {tuple(hist.shape)} != current "
                         f"{tuple(cur.shape)}")
    H, W = cur.shape[:2]
    C = int(np.prod(cur.shape[2:], dtype=np.int64))
    out = torch.empty_like(cur)
    err = _kernels.lib().f3d_taa(_kernels.ptr(cur), _kernels.ptr(hist), _kernels.ptr(out), H, W,
                                 C, blend, omb, int(clamp), _kernels.stream_ptr(cur.device))
    _kernels.check(err, "E2 taa_resolve")
    taa_resolve.launches += 1
    return out


def taa_resolve(current, history, *, blend: float = 0.1, clamp_neighborhood: bool = True,
                device=None):
    """Temporal AA resolve: exponential history blend with a 3x3
    neighbourhood clamp (the neighbourhood wraps at the border, as
    jnp.roll does)."""
    dev = device_for(current, device)
    cur, hist = _t(current, dev), _t(history, dev)
    run = _taa_plain if dev.type == "cpu" else _taa_kernel
    return run(cur, hist, _f(blend), _f(1.0 - blend), bool(clamp_neighborhood))


taa_resolve.launches = 0


def ssao_offsets(radius: float, n_samples: int):
    """post.py:ssao's spiral taps (dy, dx), in sample order."""
    golden = 2.399963
    taps = []
    for i in range(n_samples):
        ang = i * golden
        r = radius * (i + 1) / n_samples
        dx = int(round(math.cos(ang) * r)) or 1
        dy = int(round(math.sin(ang) * r))
        taps.append((dy, dx))
    return taps


def _shift_clamp(a, dy, dx):
    """a[clamp(y + dy), clamp(x + dx)]."""
    H, W = a.shape
    rows = torch.clamp(torch.arange(H, device=a.device) + dy, 0, H - 1)
    cols = torch.clamp(torch.arange(W, device=a.device) + dx, 0, W - 1)
    return a[rows][:, cols]


def _facing(normal, axis):
    return normal[..., axis] if normal.ndim == 3 else normal


def _ssao_plain(depth, normal, taps, bias, rden, intensity):
    occl = torch.zeros_like(depth)
    for dy, dx in taps:
        delta = depth - _shift_clamp(depth, dy, dx) - bias
        w = torch.clamp(1.0 - fdiv(delta.abs(), rden), 0.0, 1.0)
        occl = occl + torch.where(delta > 0, w, 0.0)
    ao = 1.0 - fdiv(intensity * occl, float(len(taps)))
    facing = torch.clamp(_facing(normal, 2), 0.0, 1.0)
    return torch.clamp(ao * (0.75 + 0.25 * facing), 0.0, 1.0)


def _ssao_kernel(depth, normal, taps, bias, rden, intensity):
    _kernels.require_cuda("ssao", depth, normal)
    H, W = depth.shape
    offs = torch.as_tensor(np.asarray(taps, np.int32).reshape(-1), device=depth.device)
    out = torch.empty_like(depth)
    err = _kernels.lib().f3d_ssao(_kernels.ptr(depth), _kernels.ptr(normal),
                                  3 if normal.ndim == 3 else 1, _kernels.ptr(offs), len(taps),
                                  _kernels.ptr(out), H, W, bias, rden, intensity,
                                  _kernels.stream_ptr(depth.device))
    _kernels.check(err, "E2 ssao")
    ssao.launches += 1
    return out


def ssao(depth, normal, *, radius: float = 6.0, intensity: float = 1.0, bias: float = 0.02,
         n_samples: int = 8, device=None):
    """Screen-space AO from depth and normal buffers with fixed spiral taps
    (edge-clamped). Returns (H, W) in [0, 1] (1 = unoccluded)."""
    dev = device_for(depth, device)
    dep, nrm = _t(depth, dev), _t(normal, dev)
    run = _ssao_plain if dev.type == "cpu" else _ssao_kernel
    return run(dep, nrm, ssao_offsets(radius, n_samples), _f(bias),
               _f(radius * 0.25 + 1e-4), _f(intensity))


ssao.launches = 0


def _ssr_plain(color, depth, normal, stride, max_steps, intensity, fade_den):
    H, W = depth.shape
    up = torch.clamp(normal[..., 1], 0.0, 1.0) if normal.ndim == 3 else normal
    best = torch.zeros((H, W, 3), dtype=_F32, device=color.device)
    found = torch.zeros((H, W), dtype=torch.bool, device=color.device)
    for step in range(1, max_steps + 1):
        dy = step * stride
        cand_c = torch.roll(color, dy, 0)        # sample above (row - dy), wrapping
        cand_d = torch.roll(depth, dy, 0)
        hit = (~found) & (cand_d < depth)
        best = torch.where(hit[..., None], cand_c, best)
        found = found | hit
    fade_y = torch.clamp(fdiv(torch.arange(H, dtype=_F32, device=color.device), fade_den),
                         0.0, 1.0)[:, None]
    strength = intensity * up * found.to(_F32) * fade_y
    return color * (1 - strength[..., None]) + best * strength[..., None]


def _ssr_kernel(color, depth, normal, stride, max_steps, intensity, fade_den):
    _kernels.require_cuda("ssr", color, depth, normal)
    H, W = depth.shape
    out = torch.empty_like(color)
    err = _kernels.lib().f3d_ssr(_kernels.ptr(color), _kernels.ptr(depth), _kernels.ptr(normal),
                                 3 if normal.ndim == 3 else 1, _kernels.ptr(out), H, W,
                                 int(stride), int(max_steps), intensity, fade_den,
                                 _kernels.stream_ptr(color.device))
    _kernels.check(err, "E2 ssr")
    ssr.launches += 1
    return out


def ssr(color, depth, normal, *, stride: int = 2, max_steps: int = 24, intensity: float = 0.5,
        edge_fade: float = 0.1, device=None):
    """Screen-space reflections (vertical-mirror marching model): march up
    the depth buffer (rows wrap, as jnp.roll wraps them), first closer
    surface wins, fade at the top edge."""
    dev = device_for(color, device)
    c, dep, nrm = _t(color, dev), _t(depth, dev), _t(normal, dev)
    H = dep.shape[0]
    run = _ssr_plain if dev.type == "cpu" else _ssr_kernel
    return run(c, dep, nrm, int(stride), int(max_steps), _f(intensity), _f(H * edge_fade))


ssr.launches = 0


# ---------------------------------------------------------------------------
# Rect area lights
# ---------------------------------------------------------------------------


def rect_light_record(light_center, light_right, light_up, half_extent,
                      color=(1.0, 1.0, 1.0), intensity: float = 1.0,
                      roughness: float = 0.3) -> np.ndarray:
    """One light's 18 float32 values (csrc/post.cuh:RectLight), formed as
    rect_area_light forms them: the shininess 2 / max(r^2, 1e-3) - 2 and its
    normalisation (shin + 2) / (2 pi) in float32."""
    hx, hy = half_extent
    f32 = np.float32
    shin = f32(f32(2.0) / f32(max(roughness * roughness, 1e-3))) - f32(2.0)
    spec_k = f32(shin + f32(2.0)) / f32(2 * math.pi)
    vals = [*np.asarray(light_center, f32).reshape(3), *np.asarray(light_right, f32).reshape(3),
            *np.asarray(light_up, f32).reshape(3), f32(hx), f32(hy), f32(4.0 * hx * hy),
            shin, spec_k, *np.asarray(color, f32).reshape(3), f32(intensity)]
    return np.asarray(vals, f32)


def _rect_plain_one(p, n, v, rec):
    c, r_axis, u_axis = (torch.as_tensor(rec[k:k + 3], device=p.device) for k in (0, 3, 6))
    hx, hy, area, shin, spec_k = (float(x) for x in rec[9:14])
    color = torch.as_tensor(rec[14:17], device=p.device)
    intensity = float(rec[17])

    def dot(a, b):   # jnp.sum over the last axis: (m0 + m1) + m2
        m = a * b
        return (m[..., 0] + m[..., 1] + m[..., 2])[..., None]

    def norm(a):     # jnp.linalg.norm, jitted: the squares fused into the sum
        return sqrt32(fma32(a[..., 2], a[..., 2],
                            fma32(a[..., 1], a[..., 1], a[..., 0] * a[..., 0])))[..., None]

    to_c = c - p
    s = torch.clamp(dot(-to_c, r_axis), -hx, hx)
    t = torch.clamp(dot(-to_c, u_axis), -hy, hy)
    rep = c + s * r_axis + t * u_axis
    L = rep - p
    dist = norm(L)
    Ld = fdiv(L, torch.clamp(dist, min=1e-6))
    ndl = torch.clamp(dot(n, Ld), 0.0, 1.0)
    omega = fdiv(area, torch.clamp(dist * dist, min=1e-4))
    diffuse = fdiv(ndl * torch.clamp(omega, max=_f(math.pi)), _f(math.pi))
    h = Ld + v
    h = fdiv(h, torch.clamp(norm(h), min=1e-6))
    ndh = torch.clamp(dot(n, h), 0.0, 1.0)
    spec = spec_k * torch.pow(ndh, shin) * torch.clamp(omega, max=1.0) * ndl
    return (diffuse + spec) * color * intensity


def _rect_plain(p, n, v, records):
    add = torch.zeros_like(p)
    for rec in records:
        add = add + _rect_plain_one(p, n, v, rec)
    return add


def _rect_kernel(p, n, v, records):
    _kernels.require_cuda("rect_area_light", p, n, v)
    if not (p.shape == n.shape == v.shape) or p.shape[-1] != 3:
        raise ValueError("rect_area_light: p, n and v must be (..., 3) of one shape")
    table = torch.as_tensor(np.stack(records).astype(np.float32).reshape(-1), device=p.device)
    out = torch.empty_like(p)
    err = _kernels.lib().f3d_rect_lights(_kernels.ptr(p), _kernels.ptr(n), _kernels.ptr(v),
                                         p.numel() // 3, _kernels.ptr(table), len(records),
                                         _kernels.ptr(out), _kernels.stream_ptr(p.device))
    _kernels.check(err, "E2 rect_area_light")
    rect_area_light_sum.launches += 1
    return out


def rect_area_light_sum(p, n, v, lights: Sequence[dict], *, device=None):
    """The sum of rect_area_light over `lights` (dicts of its keyword
    arguments: light_center, light_right, light_up, half_extent, and
    optionally color, intensity, roughness), added in list order from zero
    as Scene adds them: one launch of kernel E2 rect on CUDA tensors."""
    dev = device_for(p, device)
    p, n, v = (_t(x, dev) for x in (p, n, v))
    records = [rect_light_record(**L) for L in lights]
    if not records:
        return torch.zeros_like(p)
    run = _rect_plain if dev.type == "cpu" else _rect_kernel
    return run(p, n, v, records)


rect_area_light_sum.launches = 0


def rect_area_light(p, n, v, *, light_center, light_right, light_up,
                    half_extent: Tuple[float, float], color=(1.0, 1.0, 1.0),
                    intensity: float = 1.0, roughness: float = 0.3, device=None):
    """Rect area light via the representative-point approximation (Karis):
    the closest point on the rectangle stands in for the LTC integral,
    energy normalised by a solid-angle estimate. Inputs are (..., 3)."""
    return rect_area_light_sum(p, n, v, [dict(
        light_center=light_center, light_right=light_right, light_up=light_up,
        half_extent=half_extent, color=color, intensity=intensity, roughness=roughness)],
        device=device)


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------


class PostConfig(NamedTuple):
    bloom_enabled: bool = False
    bloom_threshold: float = 1.0
    bloom_intensity: float = 0.5
    dof_enabled: bool = False
    dof_focus: float = 10.0
    dof_range: float = 4.0
    dof_max_coc: float = 6.0
    vignette_enabled: bool = False
    vignette_strength: float = 0.35
    sharpen_amount: float = 0.0


def apply_post_chain(color, depth=None, cfg: PostConfig = PostConfig(), *, device=None):
    """Fixed-order post chain: bloom -> dof -> vignette -> sharpen."""
    out = _t(color, device_for(color, device))
    if cfg.bloom_enabled:
        out = bloom(out, threshold=cfg.bloom_threshold, intensity=cfg.bloom_intensity)
    if cfg.dof_enabled and depth is not None:
        out = depth_of_field(out, depth, focus_distance=cfg.dof_focus,
                             focus_range=cfg.dof_range, max_coc=cfg.dof_max_coc,
                             device=out.device)
    if cfg.vignette_enabled:
        out = vignette(out, strength=cfg.vignette_strength)
    if cfg.sharpen_amount > 0:
        out = sharpen(out, amount=cfg.sharpen_amount)
    return out
