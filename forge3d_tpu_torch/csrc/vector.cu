// forge3d_tpu_torch/csrc/vector.cu
// The CUDA kernels of the vector overlays, for sm_90a, with plain C
// launchers for ctypes (see _kernels.py). Each launcher enqueues on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
//
// E4 vector_tiles_kernel (with its binning: vector_count_kernel,
//                   vector_scatter_kernel, vector_backdrop_kernel)
//                   replaces forge3d_tpu/vector/coverage.py:stroke_coverage
//                   (53), disc_coverage (73) and polygon_coverage (90), with
//                   VectorScene.render's composite (vector/__init__.py:140)
//                   fused in: every layer of a render in one pass
//
// JAX scans every primitive over whole (H, W) planes of running minima, a
// layer at a time; done so on the card (PR 7's design) every pixel tested
// every primitive and each layer read and wrote the frame's planes. Yet a
// primitive changes a pixel's coverage only within a short reach of it
// (vector.cuh states the cull and why it is exact), and a polygon's winding
// from far edges is a count per row. So the kernel bins first: one thread a
// primitive counts the 16x16 pixel tiles it can change into a count per
// (tile, layer) pair, and adds each polygon edge's winding to the rows of
// the tiles left of it (a difference at the tile next to it, summed from the
// right by vector_backdrop_kernel); the caller scans the counts into offsets
// (torch.cumsum) and sizes the list; the scatter writes each primitive into
// its tiles' lists. Then one CTA a tile, one thread a pixel, loads the
// tile's rgb, alpha and pick once, stages the table, offsets and backdrops
// of up to 64 layers at a time in shared memory, takes each layer in order
// (the primitives of its non-empty lists through shared memory, a broadcast
// to every thread; the backdrop of the thread's row; a layer that reaches
// no pixel of the tile gives the empty state's coverage, formed once a
// layer), composites in registers and writes once. Bytes are the frame's planes once and the
// lists; the arithmetic is the kept primitive-pixel pairs.

#include <cuda_runtime.h>

#include "vector.cuh"

namespace {

constexpr int kThreads = F3D_VEC_TILE * F3D_VEC_TILE;
constexpr int kLayerChunk = 64;
constexpr int kPrimThreads = 128;

inline int blocks_for(long long n, int threads) { return (int)((n + threads - 1) / threads); }

// The binning (vector.cuh: vec_count_prim, vec_scatter_prim,
// vec_backdrop_row): one thread a primitive, or a backdrop row.
__global__ void vector_count_kernel(const VecLayer* __restrict__ table, int n_layers,
                                    const float* __restrict__ prims, int n_prims, int width,
                                    int height, int* counts, int* backdrop) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n_prims) vec_count_prim(table, n_layers, prims, i, width, height, counts, backdrop);
}

__global__ void vector_scatter_kernel(const VecLayer* __restrict__ table, int n_layers,
                                      const float* __restrict__ prims, int n_prims, int width,
                                      int height, int* counts, const int* __restrict__ offs,
                                      float* __restrict__ entries) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n_prims)
        vec_scatter_prim(table, n_layers, prims, i, width, height, counts, offs, entries);
}

__global__ void vector_backdrop_kernel(int* backdrop, int rows, int tiles_x) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j < rows) vec_backdrop_row(backdrop, j, tiles_x);
}

// One CTA a 16x16 tile, one thread a pixel: every layer in order
// (vec_pixel_binned, with the reads staged in shared memory).
__global__ void __launch_bounds__(kThreads)
    vector_tiles_kernel(const VecLayer* __restrict__ table, int n_layers, int width, int height,
                        const int* __restrict__ offs, const float4* __restrict__ entries,
                        const int* __restrict__ backdrop, float* __restrict__ cov,
                        float* __restrict__ rgb, float* __restrict__ alpha,
                        int* __restrict__ pick) {
    __shared__ VecLayer lay[kLayerChunk];
    __shared__ float empty_s[kLayerChunk][2];   // cover_empty, outside and inside
    __shared__ int off_s[kLayerChunk + 1];
    __shared__ int bd_s[kLayerChunk][F3D_VEC_TILE];
    __shared__ float4 stage[kThreads];
    const int tiles_x = vec_tiles(width);
    const int tile = blockIdx.x;
    const int tid = threadIdx.x;
    const int row = tid / F3D_VEC_TILE;
    const int x0 = (tile % tiles_x) * F3D_VEC_TILE, y0 = (tile / tiles_x) * F3D_VEC_TILE;
    const int x = x0 + tid % F3D_VEC_TILE, y = y0 + row;
    const bool in = x < width && y < height;
    const int i = y * width + x;
    const float px = (float)x + 0.5f;
    const float py = (float)y + 0.5f;
    float c3[3] = {0.0f, 0.0f, 0.0f};
    float al = 0.0f;
    int pk = 0;
    if (in && rgb != nullptr) {
        for (int c = 0; c < 3; ++c) c3[c] = rgb[3 * i + c];
        al = alpha[i];
        pk = pick[i];
    }
    for (int L0 = 0; L0 < n_layers; L0 += kLayerChunk) {
        const int m = min(kLayerChunk, n_layers - L0);
        __syncthreads();
        for (int j = tid; j < m; j += kThreads) {
            const VecLayer l = table[L0 + j];
            lay[j] = l;
            empty_s[j][0] = cover_empty(l, 0);
            empty_s[j][1] = cover_empty(l, 1);
        }
        for (int j = tid; j <= m; j += kThreads) off_s[j] = offs[tile * n_layers + L0 + j];
        for (int j = tid; j < m * F3D_VEC_TILE; j += kThreads) {
            const int slot = table[L0 + j / F3D_VEC_TILE].bd_slot;
            const int yy = y0 + j % F3D_VEC_TILE;
            bd_s[j / F3D_VEC_TILE][j % F3D_VEC_TILE] =
                slot >= 0 && yy < height
                    ? backdrop[((long long)slot * height + yy) * tiles_x + tile % tiles_x]
                    : 0;
        }
        __syncthreads();
        for (int l = 0; l < m; ++l) {
            float c;
            if (off_s[l] == off_s[l + 1]) {   // no primitive of the layer reaches the tile
                c = empty_s[l][vec_inside(lay[l], bd_s[l][row])];
            } else {
                const int kind = lay[l].kind;
                CoverState s;
                cover_init(kind, s);
                for (int base = off_s[l]; base < off_s[l + 1]; base += kThreads) {
                    const int cnt = min(kThreads, off_s[l + 1] - base);
                    if (tid < cnt) stage[tid] = entries[base + tid];
                    __syncthreads();
                    for (int j = 0; j < cnt; ++j) {
                        const float4 e = stage[j];
                        cover_step(kind, px, py, e.x, e.y, e.z, e.w, s);
                    }
                    __syncthreads();
                }
                s.winding += bd_s[l][row];
                c = cover_final(lay[l], s);
            }
            if (in && cov != nullptr) cov[i] = c;
            composite_px(lay[l], c, c3, al, pk);
        }
    }
    if (in && rgb != nullptr) {
        for (int c = 0; c < 3; ++c) rgb[3 * i + c] = c3[c];
        alpha[i] = al;
        pick[i] = pk;
    }
}

}  // namespace

extern "C" {

// The binning's first pass: `table` (n_layers VecLayer) and `prims`
// (n_prims, 4) float32 on the device; `counts` (tiles * n_layers) and
// `backdrop` (polygon layers * height * tiles_x) int32, zeroed by the caller.
int f3d_vector_count(const void* table, int n_layers, const float* prims, int n_prims, int width,
                     int height, int* counts, int* backdrop, void* stream) {
    if (n_prims > 0 && width > 0 && height > 0)
        vector_count_kernel<<<blocks_for(n_prims, kPrimThreads), kPrimThreads, 0,
                              (cudaStream_t)stream>>>((const VecLayer*)table, n_layers, prims,
                                                      n_prims, width, height, counts, backdrop);
    return (int)cudaGetLastError();
}

// The rest, after the caller has scanned `counts` into `offs` (tiles *
// n_layers + 1, exclusive) and sized `entries` (offs[last] x 4 floats): the
// scatter (counts back to 0), the backdrop sums over n_poly planes, and the
// composite into cov (H, W; one layer), rgb (H, W, 3), alpha and pick
// (H, W, int32), each where not null.
int f3d_vector_compose(const void* table, int n_layers, const float* prims, int n_prims,
                       int n_poly, int width, int height, int* counts, const int* offs,
                       float* entries, int* backdrop, float* cov, float* rgb, float* alpha,
                       int* pick, void* stream) {
    if (width <= 0 || height <= 0 || n_layers <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const VecLayer* t = (const VecLayer*)table;
    const int tiles_x = vec_tiles(width), tiles = tiles_x * vec_tiles(height);
    if (n_prims > 0)
        vector_scatter_kernel<<<blocks_for(n_prims, kPrimThreads), kPrimThreads, 0, st>>>(
            t, n_layers, prims, n_prims, width, height, counts, offs, entries);
    if (n_poly > 0)
        vector_backdrop_kernel<<<blocks_for((long long)n_poly * height, kPrimThreads),
                                 kPrimThreads, 0, st>>>(backdrop, n_poly * height, tiles_x);
    vector_tiles_kernel<<<tiles, kThreads, 0, st>>>(t, n_layers, width, height, offs,
                                                    (const float4*)entries, backdrop, cov, rgb,
                                                    alpha, pick);
    return (int)cudaGetLastError();
}

}  // extern "C"
