// forge3d_tpu_torch/csrc/post.cu
// The CUDA kernels of the post passes on the offline print path, for
// sm_90a, with plain C launchers for ctypes (see _kernels.py). Each
// launcher enqueues on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().
//
// E3 atrous_kernel  replaces forge3d_tpu/ops/denoise.py:atrous_denoise (35),
//                   one launch per iteration, a CTA a lattice tile
// E5 hosek_kernel   replaces forge3d_tpu/sky.py:hosek_radiance (261)
// E2 blur_kernel       replaces forge3d_tpu/ops/post.py:gaussian_blur (39),
//                      two launches a blur (axis 0, then axis 1)
// E2 post_point_kernel replaces bloom (60), depth_of_field (75),
//                      vignette (189) and sharpen (199) around their blurs
// E2 ssr_kernel        replaces ssr (164)
// E2 taa_kernel        replaces taa_resolve (113)
// E2 ssao_kernel       replaces ssao (129)
// E2 rect_light_kernel replaces rect_area_light (206), every light of a list
//                      summed in list order in one launch
//
// E3: the JAX version forms each iteration as 25 shifted copies of the
// image and its guides, summed as whole arrays. Here a CTA takes a tile of
// one sub-lattice of the pass's spacing (post.cuh:atrous_tile), stages it
// with its halo in shared memory, forms each slot pair's weight once for
// the two taps that use it, then adds each pixel's 25 taps in order from
// shared memory; iterations ping-pong between two buffers, one launch
// each, as tap spacing 1 << it needs the whole previous iteration. What
// bounds it: the weights' four expf of an IEEE division each (the
// arithmetic, ~60 operations a tap with three guides), which the pairs
// nearly halve; the planes (~83 MB at 1080p, past the 50 MB L2) are read
// about once a pass, each slot staged once a tile, with a 2-slot halo. At
// spacing 8 and 16 a tile's slots are 8 and 16 pixels apart, each staged
// slot and each output a sector of its own, which the per-pixel form read
// through L1 from its neighbours' lines: those passes stay ~3-7% slower
// than the per-pixel form's, the others ~10% faster (PERF.md).
//
// E5: one thread per direction of the environment bake, arithmetic only
// (an acosf, a sqrtf and per channel two expf).
//
// E2: the JAX functions build each stage from whole shifted copies of the
// image (a padded slice per blur tap, a jnp.roll per SSR step and TAA
// neighbour), summed as arrays; here the sums stay in registers, so every
// intermediate copy stays out of device memory. The blur (blur_kernel) is
// bound by its multiplies and adds: at 1080p with the bloom's r = 45 each
// output takes 91 of each, separately issued (-fmad=false), ~1.1 G of each
// a blur's two passes, against 25 MB read and written once a pass. A thread
// an output with its clamp and 64-bit index in the tap loop spent ~10
// instructions and two loads a multiply-add; here a CTA stages a tile of 32
// columns by 128 positions with its halo in shared memory (the clamp
// applied as it stages), and a thread runs F3D_BLUR_M outputs of a column
// at once from a window in registers: a tap is two shared loads (the tap,
// the window's next value) and M multiplies and adds (post.cuh:blur_run).
// Both passes take the same tile: axis 0's columns are neighbouring
// elements of a row, axis 1's the channels of neighbouring rows. The point
// stages, SSR, TAA and SSAO are a few dozen operations a pixel over a few
// loads: bound by bytes. The rect lights are arithmetic bound: ~70
// operations (a sqrtf, a powf, two divisions) per light and pixel.

#include <cuda_runtime.h>

#include "post.cuh"

namespace {

constexpr int kThreads = 256;

// a CTA a tile: stage it, form its pairs' weights, then its pixels
__global__ void __launch_bounds__(F3D_ATROUS_THREADS)
atrous_kernel(AtrousArgs a, const float* __restrict__ in, float* __restrict__ out, int step) {
    extern __shared__ AtrousQuad atrous_sm[];
    const AtrousTile t = atrous_tile(a, atrous_sm, step, blockIdx.x);
    if (t.empty()) return;
    for (int e = threadIdx.x; e < kAtrousSlots; e += blockDim.x) atrous_stage(a, t, in, e);
    __syncthreads();
    atrous_weights(a, t, threadIdx.x, blockDim.x);
    __syncthreads();
    for (int e = threadIdx.x; e < F3D_ATROUS_TX * F3D_ATROUS_TY; e += blockDim.x)
        atrous_output(a, t, out, e);
}

__global__ void hosek_kernel(HosekArgs s, const float* __restrict__ dx,
                             const float* __restrict__ dy, const float* __restrict__ dz, int n,
                             float* __restrict__ rgb) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    hosek_texel(s, dx[i], dy[i], dz[i], rgb + 3 * i);
}

// a CTA a tile (post.cuh:blur_tile); kShared stages the tile, its halo and
// the taps in shared memory first
template <bool kShared>
__global__ void __launch_bounds__(F3D_BLUR_THREADS)
blur_kernel(BlurGeom g, const float* __restrict__ taps) {
    extern __shared__ float sm[];
    long long col0;
    int pos0;
    blur_tile(g, blockIdx.x, col0, pos0);
    const int k = threadIdx.x % F3D_BLUR_COLS;
    const long long base = blur_col_base(g, col0 + k);
    const float* t = taps;
    if (kShared) {
        float* staged_taps = sm + blur_staged_rows(g.radius) * F3D_BLUR_COLS;
        for (int i = threadIdx.x; i <= 2 * g.radius; i += F3D_BLUR_THREADS)
            staged_taps[i] = taps[i];
        blur_stage_column(g, base, pos0, k, threadIdx.x / F3D_BLUR_COLS,
                          F3D_BLUR_THREADS / F3D_BLUR_COLS, sm);
        __syncthreads();
        t = staged_taps;
    }
#pragma unroll 1
    for (int m = 0; m < kBlurRuns; ++m) {
        float acc[F3D_BLUR_M];
        if (blur_thread_acc<kShared>(g, base, sm, t, pos0, threadIdx.x, m, acc))
            blur_store_run(g, base, col0, pos0, threadIdx.x, m, acc);
    }
}

__global__ void post_point_kernel(int mode, int height, int width, int channels,
                                  const float* __restrict__ a, const float* __restrict__ b,
                                  const float* __restrict__ c, const float* __restrict__ d,
                                  float* __restrict__ out, PointParams q) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width * height) return;
    post_point_pixel(mode, height, width, channels, a, b, c, d, out, q, i);
}

__global__ void ssr_kernel(const float* __restrict__ color, const float* __restrict__ depth,
                           const float* __restrict__ normal, int nc, float* __restrict__ out,
                           int height, int width, int stride, int max_steps, float intensity,
                           float fade_den) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width * height) return;
    ssr_pixel(color, depth, normal, nc, height, width, stride, max_steps, intensity, fade_den,
              out, i);
}

__global__ void taa_kernel(const float* __restrict__ cur, const float* __restrict__ hist,
                           float* __restrict__ out, int height, int width, int channels,
                           float blend, float one_minus_blend, int clamp) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width * height) return;
    taa_pixel(cur, hist, out, height, width, channels, blend, one_minus_blend, clamp, i);
}

__global__ void ssao_kernel(const float* __restrict__ depth, const float* __restrict__ normal,
                            int nc, const int* __restrict__ offsets, int n_samples,
                            float* __restrict__ out, int height, int width, float bias,
                            float rden, float intensity) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width * height) return;
    out[i] = ssao_pixel(depth, normal, nc, offsets, n_samples, height, width, bias, rden,
                        intensity, i);
}

__global__ void rect_light_kernel(const float* __restrict__ p, const float* __restrict__ n,
                                  const float* __restrict__ v, int count,
                                  const RectLight* __restrict__ lights, int n_lights,
                                  float* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= count) return;
    rect_lights_point(p, n, v, lights, n_lights, out, i);
}

inline unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// one pass at spacing `step`; cudaErrorInvalidValue for a step below 1 or
// a grid past 2^31 - 1 tiles
int f3d_atrous_pass(const AtrousArgs* a, const float* in, float* out, int step, void* stream) {
    if (a->width <= 0 || a->height <= 0) return (int)cudaGetLastError();
    if (step < 1) return (int)cudaErrorInvalidValue;
    const long long tiles = atrous_tiles(*a, step);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const long long smem = atrous_shared_bytes(atrous_quads(*a));
    atrous_kernel<<<(unsigned)tiles, F3D_ATROUS_THREADS, smem, (cudaStream_t)stream>>>(*a, in, out,
                                                                                      step);
    return (int)cudaGetLastError();
}

// E3's build: out = {registers a thread, local (spilled) bytes a thread,
// resident blocks an SM and shared bytes a block with all three guides, the
// tile's slots along x and y}
int f3d_atrous_attrs(int* out) {
    const long long smem = atrous_shared_bytes(3);
    cudaFuncAttributes at;
    cudaError_t e = cudaFuncGetAttributes(&at, (const void*)atrous_kernel);
    if (e != cudaSuccess) return (int)e;
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, atrous_kernel, F3D_ATROUS_THREADS,
                                                      (size_t)smem);
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = resident;
    out[3] = (int)smem;
    out[4] = F3D_ATROUS_TX;
    out[5] = F3D_ATROUS_TY;
    return (int)e;
}

int f3d_hosek_radiance(const HosekArgs* s, const float* dx, const float* dy, const float* dz,
                       int n, float* rgb, void* stream) {
    if (n > 0) {
        hosek_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
            *s, dx, dy, dz, n, rgb);
    }
    return (int)cudaGetLastError();
}

// E2 blur along the middle axis of (outer, n, inner), the window staged in
// shared memory (`shared`; the caller picks the radii whose window fits,
// ops/post.py:blur_instance) or read from device memory; returns
// cudaErrorInvalidValue for a negative radius or a grid past 2^31 - 1
// tiles, and the launch's error where the window does not fit
int f3d_blur_axis(const float* in, float* out, const float* taps, int radius, int outer, int n,
                  int inner, int shared, void* stream) {
    const BlurGeom g{in, out, (long long)outer * inner, n, inner, radius};
    if (g.cols <= 0 || n <= 0) return (int)cudaGetLastError();
    const long long tiles = blur_tiles(g);
    if (radius < 0 || tiles > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (shared)
        blur_kernel<true><<<(unsigned)tiles, F3D_BLUR_THREADS, blur_shared_bytes(radius),
                            (cudaStream_t)stream>>>(g, taps);
    else
        blur_kernel<false><<<(unsigned)tiles, F3D_BLUR_THREADS, 0, (cudaStream_t)stream>>>(
            g, taps);
    return (int)cudaGetLastError();
}

// E2 blur's instantiation (shared as f3d_blur_axis) at `radius`: out =
// {registers a thread, local (spilled) bytes a thread, resident blocks an
// SM with the radius's window, shared bytes a block, outputs a thread run}
int f3d_blur_attrs(int shared, int radius, int* out) {
    const void* fn = shared ? (const void*)blur_kernel<true> : (const void*)blur_kernel<false>;
    const size_t smem = shared ? blur_shared_bytes(radius) : 0;
    cudaFuncAttributes at;
    cudaError_t e = cudaFuncGetAttributes(&at, fn);
    if (e != cudaSuccess) return (int)e;
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, F3D_BLUR_THREADS, smem);
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = resident;
    out[3] = (int)(at.sharedSizeBytes + smem);
    out[4] = F3D_BLUR_M;
    return (int)e;
}

int f3d_post_point(int mode, int height, int width, int channels, const float* a,
                   const float* b, const float* c, const float* d, float* out, float p0,
                   float p1, float p2, float p3, float p4, float p5, void* stream) {
    int n = width * height;
    if (n > 0) {
        PointParams q{p0, p1, p2, p3, p4, p5};
        post_point_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
            mode, height, width, channels, a, b, c, d, out, q);
    }
    return (int)cudaGetLastError();
}

int f3d_ssr(const float* color, const float* depth, const float* normal, int nc, float* out,
            int height, int width, int stride, int max_steps, float intensity, float fade_den,
            void* stream) {
    int n = width * height;
    if (n > 0) {
        ssr_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
            color, depth, normal, nc, out, height, width, stride, max_steps, intensity,
            fade_den);
    }
    return (int)cudaGetLastError();
}

int f3d_taa(const float* cur, const float* hist, float* out, int height, int width,
            int channels, float blend, float one_minus_blend, int clamp, void* stream) {
    int n = width * height;
    if (n > 0) {
        taa_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
            cur, hist, out, height, width, channels, blend, one_minus_blend, clamp);
    }
    return (int)cudaGetLastError();
}

int f3d_ssao(const float* depth, const float* normal, int nc, const int* offsets, int n_samples,
             float* out, int height, int width, float bias, float rden, float intensity,
             void* stream) {
    int n = width * height;
    if (n > 0) {
        ssao_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
            depth, normal, nc, offsets, n_samples, out, height, width, bias, rden, intensity);
    }
    return (int)cudaGetLastError();
}

int f3d_rect_lights(const float* p, const float* n, const float* v, int count,
                    const float* lights, int n_lights, float* out, void* stream) {
    if (count > 0) {
        rect_light_kernel<<<blocks(count), kThreads, 0, (cudaStream_t)stream>>>(
            p, n, v, count, reinterpret_cast<const RectLight*>(lights), n_lights, out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
