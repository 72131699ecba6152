// forge3d_tpu_torch/csrc/adjudication.cu
// The two lanes of the AEQUITAS adjudication pair, for sm_90a, with plain C
// launchers for ctypes (see _kernels.py). Each launcher enqueues on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
//
// P4 raster  adj_raster_kernel  replaces forge3d_tpu/pt/adjudication.py:_raster_frame (327)
// P4 pt      adj_pt_kernel      replaces forge3d_tpu/pt/adjudication.py:_pt_sample (382)
//                               under render_adjudication_builtin's spp loop (471)
//
// The raster thread walks a pixel's 1,152 quadrature directions with a
// nearest-hit, a BSDF and, for a blocked direction, the secondary closure
// (two shadow rays and three sphere terms) each; a path lane runs spp paths
// of up to 16 vertices with two shadow rays and six threefry draws a
// vertex. Both are arithmetic and divergence (paths die at different
// depths); they read nothing but their constants, the quadrature table and
// the key table, and write 4 bytes a pixel (12 more with the HDR plane).
//
// The raster runs in K6's tiles: a block 16x16 pixels, a warp 8x4, so a
// warp's lanes see nearby surface points, whose directions escape or hit
// the scene together more often than along a row of 32 (PERF.md §6). The
// block copies the quadrature table (13.8 KB) into shared memory once; each
// direction's three words are then one broadcast read for the warp.
//
// The path lanes run the hit loop (adjudication.cuh: adj_pt_lane): a lane
// a pixel, in K6's 8x4 warps, takes cheap steps (camera rays, nearest hits,
// the sky term, the ends of samples) until it holds a vertex, and the warp
// shades its held vertices together. A pixel's samples are summed and
// stored by its own lane, so no bit depends on the schedule. A persistent
// grid that handed the lanes further pixels from a queue (an atomic
// counter) measured slower on an H100 and was dropped (PERF.md §6).

#include <cuda_runtime.h>

#include "adjudication.cuh"
#include "common.cuh"

namespace {

constexpr int kTileThreads = 256;

// At least 3 resident blocks of 256 an SM: 80 registers, 32 B spilled on an
// H100, 7.39-7.56 ms at 512^2 in three turns against 8.41-8.58 without a
// bound (nvcc's 96 registers, 2 blocks); a minimum of 2 (104 registers) or
// 4 (64, 96 B spilled) was no faster than none (PERF.md §6).
constexpr int kRasterBlocks = 3;

__global__ void __launch_bounds__(kTileThreads, kRasterBlocks)
adj_raster_kernel(AdjArgs a, const float* __restrict__ quad, unsigned char* __restrict__ rgba,
                  float* __restrict__ hdr) {
    __shared__ float sq[3 * F3D_ADJ_QUAD];
    for (int k = threadIdx.x; k < 3 * a.n_quad; k += kTileThreads) sq[k] = quad[k];
    __syncthreads();
    const int tiles_x = (a.width + 15) / 16;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int x = (blockIdx.x % tiles_x) * 16 + (warp & 1) * 8 + (lane & 7);
    const int y = (blockIdx.x / tiles_x) * 16 + (warp >> 1) * 4 + (lane >> 3);
    if (x >= a.width || y >= a.height) return;
    adj_raster_pixel(a, sq, y * a.width + x, rgba, hdr);
}

// P4 pt's lanes: a lane a pixel, kPtThreads a block, at least kPtBlocks
// resident an SM: 70 registers, 7 blocks on an H100; a minimum of 6 or 8
// blocks, or none, was no faster (PERF.md §6)
constexpr int kPtThreads = 128;
constexpr int kPtBlocks = 4;

__global__ void __launch_bounds__(kPtThreads, kPtBlocks)
adj_pt_kernel(AdjArgs a, const uint32_t* __restrict__ keys, unsigned char* __restrict__ rgba,
              float* __restrict__ hdr) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= adj_pt_lanes(a.width, a.height)) return;
    const int p = adj_pt_pixel_of(a.width, a.height, k);
    if (p < 0) return;
    AdjNoQueue none;
    adj_pt_lane(a, keys, p, none, rgba, hdr);
}

inline int adj_pt_blocks(const AdjArgs& a) {
    return (adj_pt_lanes(a.width, a.height) + kPtThreads - 1) / kPtThreads;
}

}  // namespace

extern "C" {

int f3d_adj_raster(const AdjArgs* a, const float* quad, unsigned char* rgba, float* hdr,
                   void* stream) {
    if (a->n_quad < 0 || a->n_quad > F3D_ADJ_QUAD) return (int)cudaErrorInvalidValue;
    if (a->width > 0 && a->height > 0)
        adj_raster_kernel<<<((a->width + 15) / 16) * ((a->height + 15) / 16), kTileThreads, 0,
                            (cudaStream_t)stream>>>(*a, quad, rgba, hdr);
    return (int)cudaGetLastError();
}

// P4 raster's kernel: out = {registers a thread, local (spilled) bytes a
// thread, resident blocks of 256 an SM}
int f3d_adj_raster_attrs(int* out) {
    return f3d_kernel_attrs((const void*)adj_raster_kernel, kTileThreads, out);
}

int f3d_adj_pt(const AdjArgs* a, const uint32_t* keys, unsigned char* rgba, float* hdr,
               void* stream) {
    if (a->width > 0 && a->height > 0)
        adj_pt_kernel<<<adj_pt_blocks(*a), kPtThreads, 0, (cudaStream_t)stream>>>(*a, keys, rgba,
                                                                                  hdr);
    return (int)cudaGetLastError();
}

// P4 pt's kernel: out = {registers a thread, local (spilled) bytes a
// thread, resident blocks an SM, threads a block}
int f3d_adj_pt_attrs(int* out) {
    out[3] = kPtThreads;
    return f3d_kernel_attrs((const void*)adj_pt_kernel, kPtThreads, out);
}

}  // extern "C"
