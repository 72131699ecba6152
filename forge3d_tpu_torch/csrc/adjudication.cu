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
// One thread per pixel (adjudication.cuh). The raster thread walks the
// 1,152 quadrature directions with a nearest-hit, a BSDF and, for a blocked
// direction, the secondary closure (two shadow rays and three sphere
// terms) each; the path thread runs spp paths of up to 16 vertices with two
// shadow rays and six threefry draws a vertex. Both are arithmetic and
// divergence (paths die at different depths); they read nothing but their
// constants, the quadrature table and the key table, and write 4 bytes a
// pixel (12 more with the HDR plane).

#include <cuda_runtime.h>

#include "adjudication.cuh"

namespace {

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

__global__ void adj_raster_kernel(AdjArgs a, const float* __restrict__ quad,
                                  unsigned char* __restrict__ rgba, float* __restrict__ hdr) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.width * a.height) return;
    adj_raster_pixel(a, quad, i, rgba, hdr);
}

__global__ void adj_pt_kernel(AdjArgs a, const uint32_t* __restrict__ keys,
                              unsigned char* __restrict__ rgba, float* __restrict__ hdr) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.width * a.height) return;
    adj_pt_pixel(a, keys, i, rgba, hdr);
}

}  // namespace

extern "C" {

int f3d_adj_raster(const AdjArgs* a, const float* quad, unsigned char* rgba, float* hdr,
                   void* stream) {
    int n = a->width * a->height;
    if (n > 0)
        adj_raster_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*a, quad, rgba, hdr);
    return (int)cudaGetLastError();
}

int f3d_adj_pt(const AdjArgs* a, const uint32_t* keys, unsigned char* rgba, float* hdr,
               void* stream) {
    int n = a->width * a->height;
    if (n > 0)
        adj_pt_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*a, keys, rgba, hdr);
    return (int)cudaGetLastError();
}

}  // extern "C"
