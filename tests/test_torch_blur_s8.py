# E2 blur's staged, register-blocked tiles and S8's 2-D quad tiles with the
# PCSS taps through the texture unit, on the kernels' CPU twin (the bodies
# of csrc/post.cuh and csrc/screen.cuh built with g++ and driven in the
# kernels' order, tests/test_torch_kernels.py:HOST_LAUNCHERS) and, with the
# `cuda` marker, on the card (`python -m pytest tests/test_torch_blur_s8.py
# -m cuda`).
#
# Gates: the blur equal to its plain version on every element (torch.equal)
# at every radius, shape and instantiation; PCSS through the texture equal
# to PCSS through the pointer and to the plain version on every receiver;
# S8 in its tile order equal to its plain version on every plane (but the
# water cases' wave normals on the host, see test_screen_shade_tiles).
import ctypes

import numpy as np
import pytest
import torch

from forge3d_tpu_torch import _kernels
from forge3d_tpu_torch.ops import post as P
from forge3d_tpu_torch.terrain import screen as scr
from test_torch_kernels import (FRAC, SCREEN_CASES, close_frac, host_lib,  # noqa: F401
                                kernels, screen_inputs)

torch.set_num_threads(1)

# (name, shape): (H, W, 3), a 2-D plane, 4 and 2 channels, and a tensor
# whose axes are shorter than a tile and than 2r + 1 (its staged rows
# repeat the edge); the columns of each are not a multiple of the tile's 32
BLUR_SHAPES = {"rgb": (40, 52, 3), "plane": (23, 37), "rgba": (9, 70, 4), "pairs": (11, 45, 2),
               "short": (5, 6, 3)}
BLUR_RADII = (1, 2, 5, 14, 18, 45, P.BLUR_SHARED_RADIUS + 1)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", list(BLUR_SHAPES))
@pytest.mark.parametrize("radius", BLUR_RADII)
def test_blur_tiles(kernels, radius, shape, axis):
    rng = np.random.default_rng(radius * 10 + axis)
    x = torch.as_tensor(rng.uniform(-1, 2, BLUR_SHAPES[shape]).astype(np.float32),
                        device=kernels)
    taps = P._gauss_kernel(max(radius / 3.0, 0.5), radius)
    before = dict(P.blur_axis.instances)
    got = P._blur_axis_kernel(x, taps.to(kernels), radius, axis)
    instance = P.blur_instance(radius)
    assert instance == ("shared window" if radius <= P.BLUR_SHARED_RADIUS else "device window")
    assert P.blur_axis.instances[instance] == before.get(instance, 0) + 1
    ref = P._blur_axis_plain(x, [float(t) for t in taps], radius, axis)
    assert torch.equal(got, ref)


def test_blur_signed_zero_and_constant_rows(kernels):
    # an all -0.0 input sums to +0.0 from the zero start, as the plain version
    x = torch.full((6, 40, 3), -0.0, device=kernels)
    x[3] = 1.5
    taps = P._gauss_kernel(2.0, 6).to(kernels)
    for axis in (0, 1):
        got = P._blur_axis_kernel(x, taps, 6, axis)
        ref = P._blur_axis_plain(x, [float(t) for t in taps.cpu()], 6, axis)
        assert torch.equal(got, ref) and torch.equal(got.view(torch.int32), ref.view(torch.int32))


def pcss_points(depth, lvp, sp, nrm, ld, texture):
    """S5 on receivers sp, nrm ((n, 3) float32) through csrc/screen.cu:
    f3d_pcss_points: the map through the texture (S8's path) or the
    pointer (S9's)."""
    a = _kernels.ScreenArgs()
    a.shadow, a.shadow_res = depth.data_ptr(), depth.shape[0]
    tex = scr.ShadowTexture(depth)
    a.shadow_tex = tex.handle
    a.lvp = (_kernels._F * 12)(*np.asarray(lvp, np.float32)[:3].reshape(-1).tolist())
    a.pcss_ld = _kernels._F3(*ld)
    out = torch.empty(sp.shape[0], device=depth.device)
    err = _kernels.lib().f3d_pcss_points(a, _kernels.ptr(sp), _kernels.ptr(nrm), sp.shape[0],
                                         int(texture), _kernels.ptr(out),
                                         _kernels.stream_ptr(depth.device))
    _kernels.check(err, "S5 pcss_points")
    if depth.device.type == "cuda":
        torch.cuda.synchronize()
    tex.close()
    return out


def pcss_receivers(r, depth01):
    """Receivers at the map's four edges and corners (inside, on and just
    past [0, 1]), on texel corners (u = i / r: the footprints' fractions 0.5)
    and at texel centres (u = (i + 0.5) / r: a tap's footprint on a texel
    boundary, fraction 0), and a seeded spread; all at depth01."""
    rng = np.random.default_rng(5)
    edge = np.concatenate([np.arange(0, 4) / r, np.arange(0, 4) / (4 * r), [1e-7, 0.5 / r]])
    us = np.concatenate([edge, 1 - edge, [1.0 + 1e-7, -1e-7], np.arange(1, 40) / r,
                         (np.arange(1, 40) + 0.5) / r, rng.uniform(0, 1, 64)]).astype(np.float32)
    uu, vv = np.meshgrid(us, us[::7])
    pts = np.stack([uu.ravel(), vv.ravel(), np.full(uu.size, depth01, np.float32)], -1)
    return np.concatenate([pts, pts[:, [1, 0, 2]]]).astype(np.float32)


def test_pcss_texture_taps(kernels):
    r = 1024
    rng = np.random.default_rng(17)
    dm = rng.uniform(0.2, 1.0, (r, r)).astype(np.float32)
    dm[:, :3] = 0.25        # blockers along the left edge, lit beyond
    dm[-2:, :] = 0.3
    depth = torch.as_tensor(dm, device=kernels)
    # light space = map space: su = x, sv = y, depth01 = z
    lvp = np.array([[2, 0, 0, -1], [0, -2, 0, 1], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    pts = pcss_receivers(r, 0.9)
    nrm = rng.normal(size=pts.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    ld = tuple(float(v) for v in np.asarray([0.3, 0.8, 0.52], np.float32)
               / np.linalg.norm([0.3, 0.8, 0.52]).astype(np.float32))
    sp = torch.as_tensor(pts, device=kernels)
    nt = torch.as_tensor(nrm, device=kernels)
    via_tex = pcss_points(depth, lvp, sp, nt, ld, True)
    via_ptr = pcss_points(depth, lvp, sp, nt, ld, False)
    assert torch.equal(via_tex, via_ptr)
    ref = scr._pcss(depth.cpu(), lvp, [torch.as_tensor(pts[:, k]) for k in range(3)],
                    [torch.as_tensor(nrm[:, k]) for k in range(3)], ld)
    assert torch.equal(via_tex.cpu(), ref)
    # the cases reach the edges' clamps and both shadowed and lit receivers
    assert 0.0 < float((via_tex < 1.0).double().mean()) < 1.0


def test_shadow_texture_of_the_cache(monkeypatch):
    # the texture is made once for a cached map, over the cached tensor
    # itself (no copy), and dropped with the cache; a map outside the cache
    # gets its own
    made = []
    monkeypatch.setattr(scr, "ShadowTexture", lambda d: made.append(d) or object())
    scr.clear_caches()
    dem = np.random.default_rng(3).uniform(0, 1, (33, 33)).astype(np.float32)
    kw = dict(terrain_span=2.8, z_scale=1.45, sun_dir=(-0.5, -0.7, -0.5), resolution=64,
              grid_res=16, device="cpu")
    depth, _, _ = scr.build_shadow_map(dem, **kw)
    depth2, _, _ = scr.build_shadow_map(dem + 1.0, **kw)
    a, b = scr.shadow_texture(depth), scr.shadow_texture(depth)
    assert a is b and len(made) == 1 and made[0] is depth
    assert scr.shadow_texture(depth2) is not a and len(made) == 2 and made[1] is depth2
    other = torch.zeros((64, 64))
    assert scr.shadow_texture(other) is not a and len(made) == 3
    assert len(scr._SHADOW_TEX) == 2     # a map outside the cache is not the cache's
    scr.clear_caches()
    assert not scr._SHADOW_TEX


# every SCREEN_CASES entry at 64x48, and the defaults at sizes that are not,
# are and are below a multiple of the 16x16 tile
S8_TILE_CASES = {**{k: (64, 48, k) for k in SCREEN_CASES},
                 "70x38": (70, 38, "pom_hosek_sky"), "16x16": (16, 16, "defaults"),
                 "2x2": (2, 2, "defaults")}


@pytest.mark.parametrize("case", list(S8_TILE_CASES))
def test_screen_shade_tiles(kernels, monkeypatch, case):
    W, H, kw = S8_TILE_CASES[case]
    cfg, u = screen_inputs(kernels, monkeypatch, W=W, H=H, **SCREEN_CASES[kw])
    got = scr._shade_kernel(cfg, u)
    ref = scr.shade_plain(cfg, u)
    # bit for bit; the wave normal of the water cases takes sinf and cosf,
    # where the host's libm and PyTorch's may differ by an ulp (on the card
    # both sides share the card's, and chip_smoke.py holds every element)
    waves = kernels.type == "cpu" and "water" in kw
    for k in ("rgba", "albedo", "height") + (() if waves else ("normal",)):
        assert torch.equal(got[k], ref[k]), k
    if waves:
        assert close_frac(ref["normal"], got["normal"]) >= FRAC


def test_host_texture_handle_is_the_map(host_lib):
    # the CPU twin's texture object is the map's pointer (ShadowTex's host
    # fetches read it); its destroy frees nothing
    depth = torch.zeros((8, 8))
    tex = ctypes.c_ulonglong(0)
    assert host_lib.f3d_shadow_texture_create(_kernels.ptr(depth), 8, ctypes.byref(tex)) == 0
    assert tex.value == depth.data_ptr()
    assert host_lib.f3d_shadow_texture_destroy(tex.value) == 0
