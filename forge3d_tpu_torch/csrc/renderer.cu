// forge3d_tpu_torch/csrc/renderer.cu
// The CUDA kernels of the perspective TerrainRenderer (R1), for sm_90a,
// with plain C launchers for ctypes (see _kernels.py). Each launcher
// enqueues on the caller's stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError().
//
// R1 render  render_kernel,    replaces forge3d_tpu/terrain/renderer.py:
//            render_lane_kernel _build_program (1036) over _make_shade (653),
//                              jitted at 321
// R1 step    step_kernel +     replaces renderer.py:begin_offline_accumulation
//            tile_mean_kernel  .step (1150), jitted at 1169
//
// A pixel's work is terrain_shade.cuh's: each AA sample's primary ray and its
// sun, AO and reflection rays through the K5 DDA, the shading, the mean of
// the samples and the tonemap. What bounds it on the card is the latency of
// the DDA's dependent loads, as in K6: a pixel of the print configuration
// traces up to 56 rays (aa 4 x (1 primary + 4 sun + 8 AO + 1 reflection)),
// and rays that take different numbers of steps or branches (sky, water,
// terrain) diverge within a warp. So R1 render takes K6's 2D tiles (a warp
// 8x4 pixels) and, at aa 4, a lane per sample (a pixel's 56-ray chain cut
// into four chains of 14 nearly coinciding rays, in adjacent lanes), both
// held to 4 resident blocks of 256 threads an SM (64 registers; the DDA's
// waits hide behind more warps, which pays for the spilled bytes; PERF.md
// §6 PR 15 has the designs measured). The output is written once: the u8
// rgba beside the float planes, so the host reads back 4 bytes a pixel for a
// beauty render.
//
// The offline step adds one sample into the accumulator in place and
// writes the luminance of the running mean; a second small kernel, one CTA
// of 256 threads per 32x32 metric tile, reduces each tile's mean (edge
// tiles read the clamped last row and column, renderer.py:1147) in a fixed
// tree order, so the tile means are deterministic. The step takes R1
// render's tiles and bound (a sample is R1 render's shade_sample): on an
// H100, 0.600 ms at 1080p, from 0.735 in rows of 128 and 0.646 at 3
// blocks; a fused kernel, a CTA a metric tile with the luminance in shared
// memory and no second launch, took 0.745-0.78 (PERF.md §6): a CTA holds
// its SM until its slowest warp is done.

#include <cuda_runtime.h>

#include "terrain_shade.cuh"

namespace {

constexpr int kRenderThreads = 256;
constexpr int kRenderBlocks = 4;   // R1 render's bound: 4 blocks an SM, at most 64 registers
constexpr int kTileThreads = F3D_TILE_THREADS;

// R1 render, K6's mapping (r1_tile_pixel): a block 16x16 pixels, a warp
// 8x4, so that a warp's primary, sun and reflection rays leave neighbouring
// pixels nearly parallel, walk the same nodes and take nearly the same
// number of steps, and sky pixels share warps with sky pixels.
__global__ void __launch_bounds__(kRenderThreads, kRenderBlocks)
    render_kernel(SceneArgs s, TerrainArgs a, TerrainOut o) {
    int x, y;
    if (r1_tile_pixel(a, blockIdx.x, threadIdx.x, x, y)) render_pixel(s, a, o, y * a.width + x);
}

// R1 render at aa 4 (the print configuration's): a lane per AA sample,
// four adjacent lanes a pixel, a warp 4x2 pixels, a block 8x8. Lane k
// starts from the pixel's state advanced by k times a sample's draws
// (r1_sample_draws), which is where render_pixel's serial loop starts
// sample k, so a pixel's chain of rays is cut into four whose rays nearly
// coincide. The pixel's sums are taken in the serial order, ((0 + r0) +
// r1) + r2) + r3, from shuffles; lane 0 writes the outputs, with sample
// 0's AOVs and VT fallback count.
__global__ void __launch_bounds__(kRenderThreads, kRenderBlocks)
    render_lane_kernel(SceneArgs s, TerrainArgs a, TerrainOut o) {
    const int tiles_x = (a.width + 7) / 8;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int k = lane & 3, p = lane >> 2;
    const int x = (blockIdx.x % tiles_x) * 8 + (warp & 1) * 4 + (p & 3);
    const int y = (blockIdx.x / tiles_x) * 8 + (warp >> 1) * 2 + (p >> 2);
    const bool in = x < a.width && y < a.height;
    float r = 0.0f, g = 0.0f, b = 0.0f;
    ShadeAux aux;
    if (in) {
        uint32_t st = xorshift_skip(r1_seed(a, x, y), k * r1_sample_draws(a));
        r1_sample(s, a, x, y, st, r, g, b, aux);
    }
    float rs = 0.0f, gs = 0.0f, bs = 0.0f;
    for (int j = 0; j < 4; ++j) {
        const int src = (lane & ~3) + j;
        rs = rs + __shfl_sync(0xffffffffu, r, src);
        gs = gs + __shfl_sync(0xffffffffu, g, src);
        bs = bs + __shfl_sync(0xffffffffu, b, src);
    }
    if (!in || k != 0) return;
    if (aux.vt_miss && o.vt_fallback != nullptr) count_fallback(o.vt_fallback);
    r1_write(a, o, y * a.width + x, rs, gs, bs, aux);
}

// R1 step, K6's and R1 render's mapping (r1_tile_pixel): a block 16x16
// pixels, a warp 8x4, 4 blocks an SM. A pixel's sample is R1 render's
// shade_sample, so the warp's rays diverge as little there as here.
__global__ void __launch_bounds__(kRenderThreads, kRenderBlocks)
    step_kernel(SceneArgs s, TerrainArgs a, float* accum, uint32_t sample_idx, float* lum,
                TerrainOut o) {
    int x, y;
    if (r1_tile_pixel(a, blockIdx.x, threadIdx.x, x, y)) {
        const int i = y * a.width + x;
        lum[i] = step_pixel(s, a, accum, sample_idx, o, i);
    }
}

// One CTA per tile: thread j sums the tile's elements j, j + 256, j + 512,
// j + 768 (tile_partial), then a shared-memory tree; the mean is the sum /
// 1024.
__global__ void tile_mean_kernel(const float* __restrict__ lum, int width, int height,
                                 int tiles_w, float* __restrict__ tiles) {
    __shared__ float part[kTileThreads];
    const int ty = blockIdx.y, tx = blockIdx.x;
    part[threadIdx.x] = tile_partial(lum + (ty * width + tx) * F3D_TILE, width,
                                     imin(F3D_TILE, height - ty * F3D_TILE),
                                     imin(F3D_TILE, width - tx * F3D_TILE), threadIdx.x);
    __syncthreads();
    for (int w = kTileThreads / 2; w > 0; w >>= 1) {
        if ((int)threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) tiles[ty * tiles_w + tx] = part[0] / (float)(F3D_TILE * F3D_TILE);
}

}  // namespace

extern "C" {

int f3d_terrain_render(const SceneArgs* s, const TerrainArgs* a, const TerrainOut* o,
                       void* stream) {
    if (a->width <= 0 || a->height <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (a->aa == 4)
        render_lane_kernel<<<((a->width + 7) / 8) * ((a->height + 7) / 8), kRenderThreads, 0,
                             st>>>(*s, *a, *o);
    else
        render_kernel<<<((a->width + 15) / 16) * ((a->height + 15) / 16), kRenderThreads, 0,
                        st>>>(*s, *a, *o);
    return (int)cudaGetLastError();
}

// R1's kernels: R1 render for any aa but 4 (0) or for aa 4 (1), R1 step
// (2): out = {registers a thread, local (spilled) bytes a thread, resident
// blocks an SM}
int f3d_terrain_render_attrs(int which, int* out) {
    return f3d_kernel_attrs(which == 0   ? (const void*)render_kernel
                            : which == 1 ? (const void*)render_lane_kernel
                                         : (const void*)step_kernel,
                            kRenderThreads, out);
}

int f3d_terrain_step(const SceneArgs* s, const TerrainArgs* a, float* accum,
                     unsigned int sample_idx, float* lum, const TerrainOut* o, float* tiles,
                     void* stream) {
    if (a->width <= 0 || a->height <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    step_kernel<<<((a->width + 15) / 16) * ((a->height + 15) / 16), kRenderThreads, 0, st>>>(
        *s, *a, accum, sample_idx, lum, *o);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    dim3 grid((a->width + F3D_TILE - 1) / F3D_TILE, (a->height + F3D_TILE - 1) / F3D_TILE);
    tile_mean_kernel<<<grid, kTileThreads, 0, st>>>(lum, a->width, a->height, grid.x, tiles);
    return (int)cudaGetLastError();
}

}  // extern "C"
