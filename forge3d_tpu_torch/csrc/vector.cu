// forge3d_tpu_torch/csrc/vector.cu
// The CUDA kernel of the vector overlays, for sm_90a, with a plain C
// launcher for ctypes (see _kernels.py). The launcher enqueues on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
//
// E4 vector_kernel  replaces forge3d_tpu/vector/coverage.py:stroke_coverage
//                   (53), disc_coverage (73) and polygon_coverage (90), with
//                   VectorScene.render's composite (vector/__init__.py:140)
//                   fused in: one launch per layer
//
// JAX scans the primitives and carries whole (H, W) planes of running
// minima (and the winding count) from one primitive to the next. Here one
// CTA covers a 16x16 tile of pixels, one thread a pixel, and the layer's
// primitives (16 B each: a segment, a ring edge or a disc) pass through
// shared memory in chunks of 1,024; every thread reads each staged
// primitive (a broadcast) and keeps its least distance and winding count in
// registers. The coverage then composites into rgb, alpha and pick in place.
// The work is primitives x pixels of arithmetic (a division a primitive, and
// a square root per disc), so operations bound it, not bytes.

#include <cuda_runtime.h>

#include "vector.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kChunk = 1024;

template <int KIND>
__global__ void __launch_bounds__(kTile * kTile)
    vector_kernel(VectorArgs a, const float4* __restrict__ prims, float* __restrict__ cov,
                  float* __restrict__ rgb, float* __restrict__ alpha, int* __restrict__ pick) {
    __shared__ float4 staged[kChunk];
    const int x = blockIdx.x * kTile + threadIdx.x;
    const int y = blockIdx.y * kTile + threadIdx.y;
    const int tid = threadIdx.y * kTile + threadIdx.x;
    const float px = (float)x + 0.5f;
    const float py = (float)y + 0.5f;
    CoverState s;
    cover_init<KIND>(s);
    for (int base = 0; base < a.n; base += kChunk) {
        const int m = min(kChunk, a.n - base);
        __syncthreads();
        for (int j = tid; j < m; j += kTile * kTile) staged[j] = prims[base + j];
        __syncthreads();
        for (int j = 0; j < m; ++j) {
            const float4 p = staged[j];
            cover_step<KIND>(px, py, p.x, p.y, p.z, p.w, s);
        }
    }
    if (x >= a.width || y >= a.height) return;
    const float c = cover_final<KIND>(a, s);
    const int i = y * a.width + x;
    if (cov != nullptr) cov[i] = c;
    if (rgb != nullptr) composite_pixel(a, c, i, rgb, alpha, pick);
}

}  // namespace

extern "C" {

// One layer: `prims` (n, 4) float32 on the device; `color` three floats on
// the host. `cov` (H, W) and the composite planes rgb (H, W, 3), alpha
// (H, W), pick (H, W) int32 may be null (rgb null: no composite).
int f3d_vector_layer(const float* prims, int n, int kind, int width, int height, float half,
                     int evenodd, const float* color, float opacity, int pick_id, float* cov,
                     float* rgb, float* alpha, int* pick, void* stream) {
    if (width <= 0 || height <= 0) return (int)cudaGetLastError();
    const VectorArgs a = make_vector_args(n, kind, width, height, half, evenodd, color, opacity,
                                          pick_id);
    const dim3 block(kTile, kTile);
    const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
    const float4* p = reinterpret_cast<const float4*>(prims);
    cudaStream_t st = (cudaStream_t)stream;
    if (kind == F3D_VEC_DISC)
        vector_kernel<F3D_VEC_DISC><<<grid, block, 0, st>>>(a, p, cov, rgb, alpha, pick);
    else if (kind == F3D_VEC_POLYGON)
        vector_kernel<F3D_VEC_POLYGON><<<grid, block, 0, st>>>(a, p, cov, rgb, alpha, pick);
    else
        vector_kernel<F3D_VEC_STROKE><<<grid, block, 0, st>>>(a, p, cov, rgb, alpha, pick);
    return (int)cudaGetLastError();
}

}  // extern "C"
