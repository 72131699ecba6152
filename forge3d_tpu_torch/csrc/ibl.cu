// forge3d_tpu_torch/csrc/ibl.cu
// The CUDA kernel of the IBL bake, for sm_90a, with a plain C launcher for
// ctypes (see _kernels.py). The launcher enqueues on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
//
// E1 equirect_accum_kernel  replaces forge3d_tpu/ops/ibl.py:sample_equirect
//                           (48) under equirect_to_cubemap (64),
//                           prefilter_environment (92) and irradiance_map
//                           (167): one launch per cube, per mip and for the
//                           irradiance map
//
// The JAX bake gathers the whole map once per sample direction and sums the
// S gathered arrays; here one thread per output texel walks its S
// directions (a host table in float32, formed in float64 as JAX forms it)
// and keeps the sum in registers. What bounds it: the direction table,
// read once (12 bytes a sample), and four bilinear taps a sample from a
// map of a few MB that stays in L2; ~40 operations a sample, an atan2f and
// an acosf among them.

#include <cuda_runtime.h>

#include "ibl.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void equirect_accum_kernel(const float* __restrict__ env, int env_h, int env_w,
                                      const float* __restrict__ dirs,
                                      const float* __restrict__ w, int samples, int texels,
                                      int mode, float* __restrict__ out) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= texels) return;
    equirect_accum_texel(env, env_h, env_w, dirs, w, samples, texels, mode, out, t);
}

}  // namespace

extern "C" {

int f3d_equirect_accum(const float* env, int env_h, int env_w, const float* dirs,
                       const float* w, int samples, int texels, int mode, float* out,
                       void* stream) {
    if (texels > 0) {
        equirect_accum_kernel<<<(texels + kThreads - 1) / kThreads, kThreads, 0,
                                (cudaStream_t)stream>>>(env, env_h, env_w, dirs, w, samples,
                                                        texels, mode, out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
