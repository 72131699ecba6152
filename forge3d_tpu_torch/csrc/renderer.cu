// forge3d_tpu_torch/csrc/renderer.cu
// The CUDA kernels of the perspective TerrainRenderer (R1), for sm_90a,
// with plain C launchers for ctypes (see _kernels.py). Each launcher
// enqueues on the caller's stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError().
//
// R1 render  render_kernel     replaces forge3d_tpu/terrain/renderer.py:
//                              _build_program (1036) over _make_shade (653),
//                              jitted at 321
// R1 step    step_kernel +     replaces renderer.py:begin_offline_accumulation
//            tile_mean_kernel  .step (1150), jitted at 1169
//
// One thread per pixel runs the whole pixel (terrain_shade.cuh): the AA
// loop in registers, each sample's primary ray and its sun, AO and
// reflection rays through the K5 DDA, the shading, and the tonemap. What
// bounds them on the card is the latency of the DDA's dependent loads, as
// in K6: a pixel of the print configuration traces up to 56 rays (aa 4 x
// (1 primary + 4 sun + 8 AO + 1 reflection)), and pixels that take
// different branches (sky, water, terrain) diverge within a warp. The
// output is written once: the u8 rgba beside the float planes, so the host
// reads back 4 bytes a pixel for a beauty render.
//
// The offline step adds one sample into the accumulator in place and
// writes the luminance of the running mean; a second small kernel, one CTA
// of 256 threads per 32x32 metric tile, reduces each tile's mean (edge
// tiles read the clamped last row and column, renderer.py:1147) in a fixed
// tree order, so the tile means are deterministic.

#include <cuda_runtime.h>

#include "terrain_shade.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileThreads = F3D_TILE_THREADS;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

__global__ void render_kernel(SceneArgs s, TerrainArgs a, TerrainOut o) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.width * a.height) return;
    render_pixel(s, a, o, i);
}

__global__ void step_kernel(SceneArgs s, TerrainArgs a, float* accum, uint32_t sample_idx,
                            float* lum, TerrainOut o) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.width * a.height) return;
    step_pixel(s, a, accum, sample_idx, lum, o, i);
}

// One CTA per tile: each thread sums 4 of the tile's 1024 elements, then a
// shared-memory tree; the mean is the sum / 1024.
__global__ void tile_mean_kernel(const float* __restrict__ lum, int width, int height,
                                 int tiles_w, float* __restrict__ tiles) {
    __shared__ float part[kTileThreads];
    const int ty = blockIdx.y, tx = blockIdx.x;
    float acc = 0.0f;
    for (int k = threadIdx.x; k < F3D_TILE * F3D_TILE; k += kTileThreads)
        acc += tile_lum(lum, width, height, ty, tx, k);
    part[threadIdx.x] = acc;
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
    int n = a->width * a->height;
    if (n > 0) render_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*s, *a, *o);
    return (int)cudaGetLastError();
}

int f3d_terrain_step(const SceneArgs* s, const TerrainArgs* a, float* accum,
                     unsigned int sample_idx, float* lum, const TerrainOut* o, float* tiles,
                     void* stream) {
    int n = a->width * a->height;
    if (n <= 0) return 0;
    step_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*s, *a, accum, sample_idx,
                                                                      lum, *o);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    dim3 grid((a->width + F3D_TILE - 1) / F3D_TILE, (a->height + F3D_TILE - 1) / F3D_TILE);
    tile_mean_kernel<<<grid, kTileThreads, 0, (cudaStream_t)stream>>>(lum, a->width, a->height,
                                                                      grid.x, tiles);
    return (int)cudaGetLastError();
}

}  // extern "C"
