// forge3d_tpu_torch/csrc/post.cu
// The CUDA kernels of the post passes on the offline print path, for
// sm_90a, with plain C launchers for ctypes (see _kernels.py). Each
// launcher enqueues on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().
//
// E3 atrous_kernel  replaces forge3d_tpu/ops/denoise.py:atrous_denoise (35),
//                   one launch per iteration
// E5 hosek_kernel   replaces forge3d_tpu/sky.py:hosek_radiance (261)
//
// E3: the JAX version forms each iteration as 25 shifted copies of the
// image and its guides, summed as whole arrays; here one thread per pixel
// reads its 25 edge-clamped taps and keeps the weighted sums in registers,
// so the image and the guides are read from the cache and the output is
// written once. Iterations ping-pong between two buffers, one launch each,
// as tap spacing 1 << it needs the whole previous iteration. What bounds
// it: 25 taps x (3 colour + 3 albedo + 3 normal + 1 depth) floats a pixel
// from L2 and four expf per tap; at 1080p the planes (~83 MB) exceed the
// 50 MB L2, so each pass streams them from device memory about once.
//
// E5: one thread per direction of the environment bake, arithmetic only
// (an acosf, a sqrtf and per channel two expf).

#include <cuda_runtime.h>

#include "post.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void atrous_kernel(AtrousArgs a, const float* __restrict__ in,
                              float* __restrict__ out, int step) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.width * a.height) return;
    atrous_pixel(a, in, out, step, i % a.width, i / a.width);
}

__global__ void hosek_kernel(HosekArgs s, const float* __restrict__ dx,
                             const float* __restrict__ dy, const float* __restrict__ dz, int n,
                             float* __restrict__ rgb) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    hosek_texel(s, dx[i], dy[i], dz[i], rgb + 3 * i);
}

}  // namespace

extern "C" {

int f3d_atrous_pass(const AtrousArgs* a, const float* in, float* out, int step, void* stream) {
    int n = a->width * a->height;
    if (n > 0) {
        atrous_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
            *a, in, out, step);
    }
    return (int)cudaGetLastError();
}

int f3d_hosek_radiance(const HosekArgs* s, const float* dx, const float* dy, const float* dz,
                       int n, float* rgb, void* stream) {
    if (n > 0) {
        hosek_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
            *s, dx, dy, dz, n, rgb);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
