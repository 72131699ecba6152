# The CUDA kernels' code against the plain PyTorch versions, on two
# backends:
# - "host": the per-thread bodies of the kernels (forge3d_tpu_torch/csrc/
#   common.cuh) compiled for the CPU with g++ and driven through the kernel
#   wrappers' launch code. This checks the CUDA sources' arithmetic, the
#   ctypes argument blocks and the wrappers without a GPU; it cannot show
#   that nvcc builds the kernels or that they run on the card. The host
#   launchers below loop over the threads in order, as the CUDA launchers in
#   kernels.cu run them in parallel.
# - "cuda": the kernels themselves, built with nvcc, on a GPU. These cases
#   carry the `cuda` marker and skip without a CUDA device; on the card run
#   `python -m pytest tests/test_torch_kernels.py -m cuda`.
#
# Tolerances, as in the other port tests: trace hit masks equal on >= 99.9%
# of rays with |dt|/t <= 1e-4; floats |d| <= 1e-5 * (1 + |ref|) and integer
# reservoir fields equal, each on >= 99.9% of elements; whole renders within
# 1 u8 step on >= 99.5% of pixels. Both sides round every float32 operation
# once (-ffp-contract=off / -fmad=false), so they differ only where the math
# library's cos/sin/atan2/acos differ from PyTorch's by an ulp.
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from forge3d_tpu_torch import _kernels
from forge3d_tpu_torch.ops import restir as rst
from forge3d_tpu_torch.ops import traversal as tv
from forge3d_tpu_torch.ops.shading import env_map
from forge3d_tpu_torch.pt import terrain_ref as tr

torch.set_num_threads(1)

FRAC = 0.999

HOST_LAUNCHERS = r"""
#include "common.cuh"
extern "C" {
int f3d_trace(const SceneArgs* s, const float* rox, const float* roy, const float* roz,
              const float* rdx, const float* rdy, const float* rdz, int n, float tmin,
              float tmax, unsigned char* hit, float* t, int* cell_x, int* cell_z, void*) {
    for (int i = 0; i < n; ++i) {
        Hit h = trace_ray(*s, rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i], tmin, tmax);
        hit[i] = (unsigned char)h.hit; t[i] = h.t; cell_x[i] = h.cell_x; cell_z[i] = h.cell_z;
    }
    return 0;
}
int f3d_frame_step(const SceneArgs* s, const FrameArgs* f, const float* accum_in,
                   const float* welford_in, const ResArgs* res_in, float* accum_out,
                   float* welford_out, const ResArgs* res_out, void*) {
    for (int i = 0; i < f->width * f->height; ++i)
        frame_pixel(*s, *f, i, accum_in, welford_in, *res_in, accum_out, welford_out, *res_out);
    return 0;
}
int f3d_spatial_reuse(const ResArgs* res_in, const ResArgs* res_out, const float* gb_nx,
                      const float* gb_ny, const float* gb_nz, int width, int height,
                      unsigned int frame_index, unsigned int seed_hi, int k_neighbors,
                      int radius, void*) {
    for (int i = 0; i < width * height; ++i)
        store_res(*res_out, i, spatial_pixel(*res_in, gb_nx, gb_ny, gb_nz, width, height,
                                             frame_index, seed_hi, k_neighbors, radius, i));
    return 0;
}
int f3d_center_gbuffer(const SceneArgs* s, int n, const float* cam_o, const float* alb,
                       const float* dx, const float* dz,
                       const unsigned char* hit, const float* t, const int* cell_x,
                       const int* cell_z, float* albedo_out, float* normal_out,
                       float* depth_out, float* vis_out, float* gb_nx, float* gb_ny,
                       float* gb_nz, void*) {
    for (int i = 0; i < n; ++i)
        gbuffer_pixel(*s, cam_o, alb, i, dx[i], dz[i], hit[i], t[i], cell_x[i],
                      cell_z[i], albedo_out, normal_out, depth_out, vis_out, gb_nx, gb_ny,
                      gb_nz);
    return 0;
}
const char* f3d_error_string(int) { return "host build"; }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel bodies needs it")
    d = tmp_path_factory.mktemp("kernels_host")
    src = d / "host_launchers.cpp"
    src.write_text(HOST_LAUNCHERS)
    out = d / "libhost_kernels.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(_kernels.CSRC), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _kernels._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.f3d_error_string.argtypes = [ctypes.c_int]
    lib.f3d_error_string.restype = ctypes.c_char_p
    return lib


@pytest.fixture(params=["host", pytest.param("cuda", marks=pytest.mark.cuda)])
def kernels(request, monkeypatch):
    """The device the kernel wrappers run on; for "host", their launches go
    to the host build."""
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernels run only on the card")
        return torch.device("cuda")
    host_lib = request.getfixturevalue("host_lib")
    monkeypatch.setattr(_kernels, "lib", lambda: host_lib)
    monkeypatch.setattr(_kernels, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    return torch.device("cpu")


def close_frac(ref, got):
    ref = ref.double()
    got = got.double()
    ok = (got - ref).abs() <= 1e-5 * (1.0 + ref.abs())
    return float((ok | (torch.isnan(ref) & torch.isnan(got))).double().mean())


def make_ctx(device, **kw):
    n = 65
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (6.0 * np.sin(x * 0.15) * np.cos(y * 0.12)).astype(np.float32)
    em = kw.pop("env", None)
    desc = tr.TerrainRefDesc(heights=dem, cam_origin=(32.0, 22.0, 90.0),
                             cam_look_at=(32.0, 0.0, 32.0), fov_y_deg=42.0, width=96,
                             height=48, env_map=em, **kw)
    scene = tv.scene_from_pyramid(tr.build_pyramid(dem), spacing_xz=desc.spacing,
                                  exaggeration=desc.exaggeration, device=device)
    return tr.make_context(desc, scene, env_map(em, desc.env_intensity, device))


def assert_reservoirs(ref, got):
    for name in rst.Reservoirs.__dataclass_fields__:
        a, b = getattr(ref, name), getattr(got, name)
        frac = float((a == b).double().mean()) if not a.is_floating_point() else close_frac(a, b)
        assert frac >= FRAC, name


def test_trace_and_gbuffer(kernels):
    ctx = make_ctx(kernels)
    o, d = tr._center_rays(ctx)
    rng = np.random.default_rng(0)
    ro = torch.as_tensor(rng.uniform([-10, 8, -10], [74, 30, 74], (4096, 3)).astype(np.float32),
                         device=kernels)
    rd = torch.as_tensor(rng.standard_normal((4096, 3)).astype(np.float32), device=kernels)
    rd[:, 1] = -rd[:, 1].abs() * 0.5
    rd = rd / rd.norm(dim=1, keepdim=True)
    ro_all = tuple(torch.cat([o[i].reshape(-1), ro[:, i]]) for i in range(3))
    rd_all = tuple(torch.cat([d[i].reshape(-1), rd[:, i]]) for i in range(3))
    before = tv.trace.launches
    hk = tv._trace_kernel(ctx.scene, ro_all, rd_all, 1e-3, 1e30)
    assert tv.trace.launches == before + 1
    hp = tv.trace_plain(ctx.scene, ro_all, rd_all)
    assert float((hp.hit == hk.hit).double().mean()) >= FRAC
    both = hp.hit & hk.hit
    assert float(((hk.t[both] - hp.t[both]).abs() / hp.t[both]).max()) <= 1e-4
    # the trace has no transcendental function: both sides run the same
    # float32 operations, so t is bit-equal on (nearly) every ray
    assert float((hk.t[both] == hp.t[both]).double().mean()) >= FRAC
    assert torch.equal(hp.cell_x[both], hk.cell_x[both])

    th = tv.trace_plain(ctx.scene, o, d)
    gp = tr.gbuffer_resolve_plain(ctx, d, th)
    gk = tr._gbuffer_resolve_kernel(ctx, d, th)
    for k in ("albedo", "normal", "depth", "visibility"):
        assert close_frac(gp[k], gk[k]) >= FRAC, k
    for a, b in zip(gp["gb_n"], gk["gb_n"]):
        assert close_frac(a, b) >= FRAC


@pytest.mark.parametrize("kw", [
    dict(spp=2),
    dict(spp=1, restir=False, shadows_enabled=False),
    dict(spp=1, env=np.random.default_rng(1).uniform(0, 2, (8, 16, 3)).astype(np.float32)),
], ids=["restir_spp2", "plain_nee_no_shadows", "env_map"])
def test_frame_and_spatial_reuse(kernels, kw):
    ctx = make_ctx(kernels, **kw)
    H, W = ctx.height, ctx.width
    gb = tr.center_gbuffer_plain(ctx)["gb_n"]
    acc = torch.zeros(H, W, 4, device=kernels)
    wf = torch.zeros(H, W, 2, device=kernels)
    res = rst.Reservoirs.zeros(H * W, kernels)
    for frame in (0, 1, 32):  # 32 restarts the Welford window
        pa, pw, pm = tr.frame_step_plain(ctx, acc, wf, res, frame)
        ka, kw_, km = tr._frame_step_kernel(ctx, acc, wf, res, frame)
        assert close_frac(pa, ka) >= FRAC and close_frac(pw, kw_) >= FRAC
        assert_reservoirs(pm, km)
        rp = rst.spatial_reuse_plain(km, *gb, W, H, frame, ctx.seed_hi)
        rk = rst._spatial_reuse_kernel(km, *gb, W, H, frame, ctx.seed_hi, 8, 3)
        assert_reservoirs(rp, rk)
        acc, wf, res = ka, kw_, rk
    assert int(res.m.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(spp=2, max_frames=4, min_frames=2),
    dict(spp=1, max_frames=35, min_frames=33, sun_elevation_deg=8.0,
         env_map=np.random.default_rng(2).uniform(0, 2, (8, 16, 3)).astype(np.float32)),
], ids=["4_frames", "window_reset_env_map"])
def test_render_on_card_matches_plain_render(kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    y, x = np.mgrid[0:49, 0:49].astype(np.float32)
    dem = (5.0 * np.sin(x * 0.2) * np.cos(y * 0.17)).astype(np.float32)
    cam = {"origin": (24, 20, 70), "look_at": (24, 0, 24), "fov_y": 42.0}
    counters = (tv.trace, tr.frame_step, rst.spatial_reuse, tr.center_gbuffer)
    before = [c.launches for c in counters]
    a = tr.hybrid_render_terrain_reference(dem, 64, 48, cam, variance_threshold=1e9,
                                           device="cpu", **kw)
    b = tr.hybrid_render_terrain_reference(dem, 64, 48, cam, variance_threshold=1e9,
                                           device="cuda", **kw)
    frames = kw["max_frames"]
    assert [c.launches - n for c, n in zip(counters, before)] == [1, frames, frames, 1]
    assert a["frames"] == b["frames"] == frames
    du = np.abs(a["rgba"].astype(np.int32) - b["rgba"].astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= 0.995
    np.testing.assert_array_equal(np.isnan(a["depth"]), np.isnan(b["depth"]))
