# forge3d_tpu_torch/ops/traversal.py
# Heightfield ray traversal over the min-max pyramid: the stackless
# front-to-back max-mip DDA with an exact ray/bilinear-patch solve at the
# leaves (forge3d_tpu/ops/traversal.py).
#
# `trace` is the wrapper of kernel K5 (csrc/common.cuh:trace_ray, launched
# by csrc/kernels.cu:trace_kernel): on CUDA tensors it launches the kernel,
# on CPU tensors it runs `trace_plain`. `trace_plain` steps all live rays
# in lock step like the JAX version, but drops rays from the batch as they
# finish; per-ray results do not depend on the batch, so this changes no
# value.

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import _kernels
from .pyramid import MinMaxPyramid
from .shading import fdiv, rsqrt, sqrt32

_F32 = torch.float32
_I32 = torch.int32

#: Fraction of a cell the probe point is nudged forward to land strictly
#: inside the next node after an advance.
_EPS_CELL = 2.0 ** -12


def f32(x) -> float:
    """A Python float holding the float32 rounding of x."""
    return float(np.float32(x))


@dataclass(frozen=True)
class TerrainScene:
    """Heightfield scene: the DEM pairs, the flattened pyramid and the grid
    geometry. Scalars hold float32 values."""

    h_pair: torch.Tensor        # (h*w, 2) f32: (h[i], h[i+1 in row])
    mm_pack: torch.Tensor       # (total, 2) f32: (min, max)
    level_offset: torch.Tensor  # (mips,) i32
    level_w: torch.Tensor       # (mips,) i32
    origin_xz: Tuple[float, float]
    spacing_xz: Tuple[float, float]
    exaggeration: float
    dem_w: int
    dem_h: int
    cell_w: int
    cell_h: int
    mip_count: int
    max_iters: int

    @property
    def device(self) -> torch.device:
        return self.h_pair.device

    def to(self, device) -> "TerrainScene":
        return dataclasses.replace(
            self,
            h_pair=self.h_pair.to(device),
            mm_pack=self.mm_pack.to(device),
            level_offset=self.level_offset.to(device),
            level_w=self.level_w.to(device),
        )

    def kernel_args(self) -> _kernels.SceneArgs:
        _kernels.require_cuda("scene", self.h_pair, self.mm_pack,
                              self.level_offset, self.level_w)
        return _kernels.SceneArgs(
            _kernels.ptr(self.h_pair), _kernels.ptr(self.mm_pack),
            _kernels.ptr(self.level_offset), _kernels.ptr(self.level_w),
            self.dem_w, self.cell_w, self.cell_h, self.mip_count, self.max_iters,
            self.origin_xz[0], self.origin_xz[1],
            self.spacing_xz[0], self.spacing_xz[1], self.exaggeration,
        )


def level_layout(cell_w: int, cell_h: int):
    """The pyramid's level table as K5 forms it in registers
    (csrc/common.cuh:LevelCursor): level 0 padded to 2^wlog x 2^hlog cells,
    level L 2^max(wlog - L, 0) texels wide and 2^max(hlog - L, 0) high, the
    levels flattened finest first. Returns (offsets, widths), one a level."""
    wlog, hlog = (max(int(c) - 1, 0).bit_length() for c in (cell_w, cell_h))
    offsets, widths, acc = [], [], 0
    for lv in range(max(wlog, hlog) + 1):
        offsets.append(acc)
        widths.append(1 << max(wlog - lv, 0))
        acc += widths[-1] << max(hlog - lv, 0)
    return offsets, widths


def check_level_layout(level_offset, level_w, cell_w: int, cell_h: int) -> None:
    """Raise unless a scene's level table is level_layout's."""
    got = (np.asarray(level_offset).tolist(), np.asarray(level_w).tolist())
    if got != level_layout(cell_w, cell_h):
        raise ValueError("the pyramid's level table is not build_pyramid's layout, which K5 "
                         "forms in registers")


def scene_from_pyramid(pyr: MinMaxPyramid, origin_xz=(0.0, 0.0),
                       spacing_xz=(1.0, 1.0), exaggeration: float = 1.0,
                       max_iters: int | None = None, device="cuda") -> TerrainScene:
    """The scene's tensors on `device`, the card unless device="cpu"."""
    from ..pt.terrain_ref import resolve_device

    device = resolve_device(device)
    h, w = pyr.heights.shape
    check_level_layout(pyr.level_offset, pyr.level_w, pyr.cell_w, pyr.cell_h)
    if max_iters is None:
        # A ray crossing the whole grid visits O(perimeter) leaf cells, each
        # costing an advance plus bounded level moves; 4x is generous slack.
        max_iters = 4 * (pyr.cell_w + pyr.cell_h) + 16 * pyr.mip_count + 64
    hf = pyr.heights.ravel()
    h_next = np.concatenate([hf[1:], hf[-1:]])
    return TerrainScene(
        h_pair=torch.as_tensor(np.stack([hf, h_next], axis=1).astype(np.float32), device=device),
        mm_pack=torch.as_tensor(np.stack([pyr.mm_min, pyr.mm_max], axis=1).astype(np.float32),
                                device=device),
        level_offset=torch.as_tensor(pyr.level_offset.astype(np.int32), device=device),
        level_w=torch.as_tensor(pyr.level_w.astype(np.int32), device=device),
        origin_xz=(f32(origin_xz[0]), f32(origin_xz[1])),
        spacing_xz=(f32(spacing_xz[0]), f32(spacing_xz[1])),
        exaggeration=f32(exaggeration),
        dem_w=int(w), dem_h=int(h), cell_w=int(pyr.cell_w), cell_h=int(pyr.cell_h),
        mip_count=int(pyr.mip_count), max_iters=int(max_iters),
    )


class HitResult(NamedTuple):
    hit: torch.Tensor     # bool
    t: torch.Tensor       # f32 (tmax where missed)
    cell_x: torch.Tensor  # i32 (leaf cell of the hit; 0 where missed)
    cell_z: torch.Tensor  # i32


def _safe_inv(d):
    """Sign-preserving reciprocal with |d| clamped away from zero."""
    ad = torch.clamp(d.abs(), min=1e-12)
    return torch.where(d < 0.0, fdiv(-1.0, ad), fdiv(1.0, ad))


def _slab_xz(rox, roz, inv_dx, inv_dz, x0, x1, z0, z1):
    tx0 = (x0 - rox) * inv_dx
    tx1 = (x1 - rox) * inv_dx
    tz0 = (z0 - roz) * inv_dz
    tz1 = (z1 - roz) * inv_dz
    t_enter = torch.maximum(torch.minimum(tx0, tx1), torch.minimum(tz0, tz1))
    t_exit = torch.minimum(torch.maximum(tx0, tx1), torch.maximum(tz0, tz1))
    return t_enter, t_exit


def _bilinear_h(h00, h10, h01, h11, u, v):
    return (h00 * (1 - u) + h10 * u) * (1 - v) + (h01 * (1 - u) + h11 * u) * v


def _cell_heights(scene: TerrainScene, cx, cz):
    """Exaggerated corner heights (h00, h10, h01, h11) of DEM cell (cx, cz)."""
    base = cz.to(torch.int64) * scene.dem_w + cx.to(torch.int64)
    ex = scene.exaggeration
    p0 = scene.h_pair[base]
    p1 = scene.h_pair[base + scene.dem_w]
    return p0[..., 0] * ex, p0[..., 1] * ex, p1[..., 0] * ex, p1[..., 1] * ex


def _leaf_intersect(scene, ro, rd, cx, cz, t0, t1, tmin, tmax):
    """Exact ray vs bilinear patch over [t0, t1]: the ray's height above
    the patch is quadratic in t (Citardauq root form, linear fallback)."""
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    h00, h10, h01, h11 = _cell_heights(scene, cx, cz)
    ox, oz = scene.origin_xz
    sx, sz = scene.spacing_xz
    cxf = cx.to(_F32)
    czf = cz.to(_F32)

    def dev(t):
        px = rox + t * rdx
        pz = roz + t * rdz
        u = torch.clamp(fdiv(px - ox, sx) - cxf, 0.0, 1.0)
        v = torch.clamp(fdiv(pz - oz, sz) - czf, 0.0, 1.0)
        return (roy + t * rdy) - _bilinear_h(h00, h10, h01, h11, u, v)

    tm = 0.5 * (t0 + t1)
    d0 = dev(t0)
    dm = dev(tm)
    d1 = dev(t1)

    c = d0
    a = 2.0 * d1 + 2.0 * d0 - 4.0 * dm
    b = d1 - d0 - a

    b_big = b.abs() > 1e-12
    s_lin = -c / torch.where(b_big, b, 1.0)
    lin_ok = b_big & (s_lin >= 0.0) & (s_lin <= 1.0)

    disc = b * b - 4.0 * a * c
    sq = sqrt32(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.where(b >= 0.0, sq, -sq))
    safe_a = torch.where(a.abs() < 1e-12, 1.0, a)
    r0 = q / safe_a
    q_small = q.abs() < 1e-30
    r1 = torch.where(q_small, 1e30, c / torch.where(q_small, 1.0, q))
    rlo = torch.minimum(r0, r1)
    rhi = torch.maximum(r0, r1)
    s_quad = torch.where(
        (rlo >= 0.0) & (rlo <= 1.0), rlo,
        torch.where((rhi >= 0.0) & (rhi <= 1.0), rhi, 1e30),
    )
    quad_ok = (disc >= 0.0) & (s_quad <= 1.0)

    is_lin = a.abs() < 1e-12
    s_hit = torch.where(is_lin, torch.where(lin_ok, s_lin, 1e30),
                        torch.where(quad_ok, s_quad, 1e30))
    t_hit = t0 + s_hit * (t1 - t0)
    ok = (s_hit <= 1.0) & (t_hit > tmin) & (t_hit < tmax)
    return ok, t_hit


def _as_rays(ro, rd):
    comps = torch.broadcast_tensors(*(torch.as_tensor(c).to(_F32) for c in (*ro, *rd)))
    return comps[0].shape, [c.reshape(-1) for c in comps]


def trace_plain(scene: TerrainScene, ro, rd, tmin=1e-3, tmax=1e30) -> HitResult:
    """Plain PyTorch version of K5. `ro`/`rd` are (x, y, z) component
    tensors of one shape (broadcast). Returns the nearest hit per ray."""
    shape, (rox, roy, roz, rdx, rdy, rdz) = _as_rays(ro, rd)
    dev = rox.device
    tmin, tmax = f32(tmin), f32(tmax)
    ox, oz = scene.origin_xz
    sx, sz = scene.spacing_xz
    cw, ch = scene.cell_w, scene.cell_h
    top = scene.mip_count - 1
    ex = scene.exaggeration

    inv_dx = _safe_inv(rdx)
    inv_dz = _safe_inv(rdz)
    x1 = f32(np.float32(ox) + np.float32(cw) * np.float32(sx))
    z1 = f32(np.float32(oz) + np.float32(ch) * np.float32(sz))
    dom_enter, dom_exit = _slab_xz(rox, roz, inv_dx, inv_dz, ox, x1, oz, z1)
    t0 = torch.clamp(dom_enter, min=tmin)
    t_exit = torch.clamp(dom_exit, max=tmax)
    lat = torch.maximum(fdiv(rdx.abs(), sx), fdiv(rdz.abs(), sz))
    eps_t = fdiv(_EPS_CELL, torch.clamp(lat, min=1e-8))

    n = rox.numel()
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hit_t = torch.full((n,), 1e30, dtype=_F32, device=dev)
    cell_x = torch.zeros(n, dtype=_I32, device=dev)
    cell_z = torch.zeros(n, dtype=_I32, device=dev)

    # live rays: their indices, per-ray constants as columns, and (t, level)
    idx = torch.nonzero(~(t0 > t_exit)).squeeze(1)
    cols = torch.stack([rox, roy, roz, rdx, rdy, rdz, inv_dx, inv_dz, t_exit, eps_t],
                       dim=1)[idx]
    t = t0[idx]
    level = torch.full((idx.numel(),), top, dtype=_I32, device=dev)
    lvl_off = scene.level_offset.to(torch.int64)
    lvl_w = scene.level_w.to(torch.int64)

    for _ in range(scene.max_iters):
        if idx.numel() == 0:
            break
        trace_plain.steps += idx.numel()
        (r_ox, r_oy, r_oz, r_dx, r_dy, r_dz, i_dx, i_dz, t_ex, eps) = cols.unbind(1)
        pt = t + eps
        px = r_ox + pt * r_dx
        pz = r_oz + pt * r_dz
        cx = torch.clamp(torch.floor(fdiv(px - ox, sx)), 0, cw - 1).to(_I32)
        cz = torch.clamp(torch.floor(fdiv(pz - oz, sz)), 0, ch - 1).to(_I32)
        nx = cx >> level
        nz = cz >> level
        bx0 = (nx << level).to(_F32)
        bx1 = torch.clamp((nx + 1) << level, max=cw).to(_F32)
        bz0 = (nz << level).to(_F32)
        bz1 = torch.clamp((nz + 1) << level, max=ch).to(_F32)
        nt0, nt1 = _slab_xz(r_ox, r_oz, i_dx, i_dz,
                            ox + bx0 * sx, ox + bx1 * sx, oz + bz0 * sz, oz + bz1 * sz)
        nt0 = torch.maximum(nt0, torch.clamp(t, min=tmin))
        nt1 = torch.minimum(nt1, t_ex)

        lv = level.to(torch.int64)
        flat = lvl_off[lv] + nz.to(torch.int64) * lvl_w[lv] + nx.to(torch.int64)
        mm = scene.mm_pack[flat]
        bmin = mm[:, 0] * ex
        bmax = mm[:, 1] * ex
        ya = r_oy + nt0 * r_dy
        yb = r_oy + nt1 * r_dy
        band = (nt0 <= nt1) & ~(torch.minimum(ya, yb) > bmax) & ~(torch.maximum(ya, yb) < bmin)

        is_leaf = level == 0
        got_hit = torch.zeros_like(band)
        leaf_sel = torch.nonzero(band & is_leaf).squeeze(1)
        if leaf_sel.numel():
            trace_plain.leaf_tests += leaf_sel.numel()
            ok, lt = _leaf_intersect(
                scene,
                (r_ox[leaf_sel], r_oy[leaf_sel], r_oz[leaf_sel]),
                (r_dx[leaf_sel], r_dy[leaf_sel], r_dz[leaf_sel]),
                cx[leaf_sel], cz[leaf_sel], nt0[leaf_sel], nt1[leaf_sel], tmin, tmax)
            got_hit[leaf_sel] = ok
            won = leaf_sel[ok]
            dst = idx[won]
            hit[dst] = True
            hit_t[dst] = lt[ok]
            cell_x[dst] = cx[won]
            cell_z[dst] = cz[won]

        descend = band & ~is_leaf
        advance = ~got_hit & ~descend
        level = torch.where(descend, level - 1,
                            torch.where(advance, torch.clamp(level + 1, max=top), level))
        t = torch.where(advance, torch.maximum(nt1, t + eps), t)
        keep = ~(got_hit | (advance & (t >= t_ex)))
        if not bool(keep.all()):
            idx, cols, t, level = idx[keep], cols[keep], t[keep], level[keep]

    t_out = torch.where(hit, hit_t, tmax)
    return HitResult(hit.reshape(shape), t_out.reshape(shape),
                     cell_x.reshape(shape), cell_z.reshape(shape))


# The work the data needed, summed over calls (rays x DDA steps taken, and
# leaf cells solved): read by chip_smoke.py for the kernels' bounds.
trace_plain.steps = 0
trace_plain.leaf_tests = 0


def ray_image_width(shape) -> int:
    """K5's layout for rays of `shape`: an image of at least one warp's 8x4
    tile, (rows, width), is traced in 8x4 warp tiles and gives its width;
    any other shape is a flat set, traced in order (0)."""
    return int(shape[1]) if len(shape) == 2 and shape[0] >= 4 and shape[1] >= 8 else 0


def _trace_kernel(scene: TerrainScene, ro, rd, tmin, tmax) -> HitResult:
    shape, comps = _as_rays(ro, rd)
    comps = [c.contiguous() for c in comps]
    _kernels.require_cuda("trace", *comps)
    dev = comps[0].device
    n = comps[0].numel()
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=_F32, device=dev)
    cell_x = torch.empty(n, dtype=_I32, device=dev)
    cell_z = torch.empty(n, dtype=_I32, device=dev)
    args = scene.kernel_args()
    err = _kernels.lib().f3d_trace(
        args, *(_kernels.ptr(c) for c in comps), n, ray_image_width(shape), f32(tmin), f32(tmax),
        _kernels.ptr(hit), _kernels.ptr(t), _kernels.ptr(cell_x), _kernels.ptr(cell_z),
        _kernels.stream_ptr(dev))
    _kernels.check(err, "K5 trace")
    trace.launches += 1
    return HitResult(hit.reshape(shape), t.reshape(shape),
                     cell_x.reshape(shape), cell_z.reshape(shape))


def trace(scene: TerrainScene, ro, rd, tmin=1e-3, tmax=1e30) -> HitResult:
    """Trace a batch of rays against the heightfield (kernel K5). Shadow
    queries use the same function: front-to-back order makes the first hit
    the nearest. CPU tensors run `trace_plain`; CUDA tensors launch the
    kernel, and anything else raises."""
    if rd[0].device.type == "cpu":
        return trace_plain(scene, ro, rd, tmin, tmax)
    return _trace_kernel(scene, ro, rd, tmin, tmax)


trace.launches = 0


def normal_at(scene: TerrainScene, p, cell_x, cell_z):
    """Geometric normal from the analytic bilinear gradient at world point p
    inside cell (cell_x, cell_z)."""
    px, _, pz = p
    h00, h10, h01, h11 = _cell_heights(scene, cell_x, cell_z)
    ox, oz = scene.origin_xz
    sx, sz = scene.spacing_xz
    u = torch.clamp(fdiv(px - ox, sx) - cell_x.to(_F32), 0.0, 1.0)
    v = torch.clamp(fdiv(pz - oz, sz) - cell_z.to(_F32), 0.0, 1.0)
    dh_du = (h10 - h00) * (1 - v) + (h11 - h01) * v
    dh_dv = (h01 - h00) * (1 - u) + (h11 - h10) * u
    nx = fdiv(-dh_du, sx)
    ny = torch.ones_like(nx)
    nz = fdiv(-dh_dv, sz)
    inv = rsqrt(nx * nx + ny * ny + nz * nz)
    return nx * inv, ny * inv, nz * inv
