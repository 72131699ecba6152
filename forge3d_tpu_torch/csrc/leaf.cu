// forge3d_tpu_torch/csrc/leaf.cu
// The CUDA kernels of the JAX package's leaf modules, for sm_90a, with plain
// C launchers for ctypes (see _kernels.py). Each launcher enqueues on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
//
// E9 dd_kernel           replaces forge3d_tpu/precision.py:dd_add (79),
//                        dd_mul (86), dd_div (93) and dd_sqrt (104), one
//                        thread a pair, the op a launch argument
// E5 preetham_kernel     replaces forge3d_tpu/sky.py:sky_radiance (101) with
//                        _perez (94), one thread a direction
// E6 eval_lights_kernel  replaces forge3d_tpu/lighting.py:eval_lights (102),
//                        one thread a point, the lights in buffer order
// E7 octa_encode_kernel, octa_decode_kernel
//                        replace forge3d_tpu/guiding.py:octa_encode (26) and
//                        octa_decode (43), one thread a direction or bin
// E7 record: guide_keys_kernel, guide_bounds_kernel, guide_bins_kernel,
//            guide_long_kernel
//                        replace GuidingCache.record (82): one thread a
//                        record forms its flat bin; the caller sorts the
//                        records by bin, stably (torch.sort); one thread a
//                        sorted record moves its luminance into sorted
//                        order and marks where its bin's run starts or ends;
//                        each bin's run is then added to the bin's old value
//                        in record order, as JAX's CPU scatter-add does.
//                        Atomics would land in any order, so the sums would
//                        change from run to run. One thread a bin adds a
//                        short run from device memory and lists a long one
//                        (more than `threshold` records); a block a listed
//                        bin then streams its run into a shared-memory ring
//                        with bulk copies (cp.async.bulk, completion on an
//                        mbarrier a stage) kept ahead of its adder, so
//                        that the chain waits on float adds, not loads.
// E7 guide_sample_kernel replaces GuidingCache.sample (92): one thread a
//                        query walks its cell's row twice, once for the
//                        total and once for the CDF count, in XLA's sum and
//                        cumsum orders (leaf.cuh).
//
// What bounds them on the H100. Counted against the card's peaks, every one
// is bound by bytes: each reads and writes a few dozen bytes an element,
// and its float32 operations (under 100 an element; E7 sample's ~4 a bin of
// its cell's row, a row neighbouring queries share in L1/L2) take less time
// at 67 TFLOP/s than those bytes at 3.35 TB/s. E9 comes close to that
// bound. E5 Preetham, E6 and E7 sample are held back by instruction
// throughput instead: IEEE divisions, sqrtf and the libm calls (E5: six
// expf and an acosf a direction) are tens of instructions each. E7 record's
// sums are sequential by contract (record order): the longest run of
// records in one bin sets its time, one dependent add a record; a 1080p
// frame under one sun puts ~5 x 10^5 records in the bin of the cell at the
// terrain's near edge. One thread reading such a run from device memory
// waits on a load every few records (~28 cycles a record); staged ahead in
// shared memory, the chain's floor is the float add's latency, ~4 cycles
// a record.

#include <cuda_runtime.h>
#include <stdint.h>

#include "leaf.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGuideStage = F3D_GUIDE_STAGE;
constexpr int kGuideStages = 4;     // stages in flight ahead of the adder

inline unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n\t.reg .pred p;\n"
        "WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
        "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// One bulk copy of `bytes` (a multiple of 16) from src (16-byte aligned)
// into the stage at dst; the stage's barrier completes when they land.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__global__ void dd_kernel(int op, const float* __restrict__ ahi, const float* __restrict__ alo,
                          const float* __restrict__ bhi, const float* __restrict__ blo,
                          long long n, float* __restrict__ hi, float* __restrict__ lo) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float h, l;
    if (op == F3D_DD_SQRT)
        dd_op(op, ahi[i], alo[i], 0.0f, 0.0f, h, l);
    else
        dd_op(op, ahi[i], alo[i], bhi[i], blo[i], h, l);
    hi[i] = h;
    lo[i] = l;
}

__global__ void preetham_kernel(PreethamArgs s, const float* __restrict__ dx,
                                const float* __restrict__ dy, const float* __restrict__ dz,
                                long long n, float* __restrict__ rgb) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    preetham_texel(s, dx[i], dy[i], dz[i], rgb + i, rgb + n + i, rgb + 2 * n + i);
}

__global__ void eval_lights_kernel(const float* __restrict__ lights, int n_lights,
                                   const float* __restrict__ p, const float* __restrict__ nrm,
                                   const float* __restrict__ u, long long count,
                                   float* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= count) return;
    eval_lights_point(lights, n_lights, p, nrm, u, out, i);
}

__global__ void octa_encode_kernel(const float* __restrict__ dx, const float* __restrict__ dy,
                                   const float* __restrict__ dz, long long n, int res,
                                   int* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = octa_encode_dir(dx[i], dy[i], dz[i], res);
}

__global__ void octa_decode_kernel(const int* __restrict__ bins, long long n, int res,
                                   float* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float d[3];
    octa_decode_bin(bins[i], res, d);
    out[i] = d[0];
    out[n + i] = d[1];
    out[2 * n + i] = d[2];
}

__global__ void guide_keys_kernel(GuideArgs g, const float* __restrict__ px,
                                  const float* __restrict__ pz, const float* __restrict__ dx,
                                  const float* __restrict__ dy, const float* __restrict__ dz,
                                  long long n, int* __restrict__ keys) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    keys[i] = guide_key(g, px[i], pz[i], dx[i], dy[i], dz[i]);
}

__global__ void guide_bounds_kernel(const int* __restrict__ keys,
                                    const long long* __restrict__ perm,
                                    const float* __restrict__ lum, long long n,
                                    int* __restrict__ seg_start, int* __restrict__ seg_end,
                                    float* __restrict__ lum_sorted) {
    const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n) return;
    guide_bounds(keys, perm, lum, n, seg_start, seg_end, lum_sorted, s);
}

// Short runs, one thread a bin; a long run's bin goes on the list
// (long_list[0] counts them, in no fixed order: each is summed alone).
__global__ void guide_bins_kernel(const int* __restrict__ seg_start,
                                  const int* __restrict__ seg_end,
                                  const float* __restrict__ lum_sorted,
                                  const float* __restrict__ hist_in, long long bins,
                                  int threshold, int* __restrict__ long_list,
                                  float* __restrict__ hist_out) {
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= bins) return;
    if (guide_is_long(seg_start, seg_end, k, threshold)) {
        long_list[1 + atomicAdd(long_list, 1)] = (int)k;
        return;
    }
    hist_out[k] = guide_bin_sum(seg_start, seg_end, lum_sorted, hist_in, k);
}

// Long runs, a block (one warp, one working thread) a listed bin: the
// thread keeps kGuideStages bulk copies in flight and adds each stage's
// records in order as it lands.
__global__ void __launch_bounds__(32)
guide_long_kernel(const int* __restrict__ seg_start, const int* __restrict__ seg_end,
                  const float* __restrict__ lum_sorted, const float* __restrict__ hist_in,
                  const int* __restrict__ long_list, float* __restrict__ hist_out) {
    __shared__ __align__(128) float ring[kGuideStages][kGuideStage];
    __shared__ unsigned long long full[kGuideStages];
    if (threadIdx.x != 0 || (int)blockIdx.x >= long_list[0]) return;
    const int k = long_list[1 + blockIdx.x];
    const int start = seg_start[k], end = seg_end[k];
    const int n = guide_chunk_count(start, end, kGuideStage);
    for (int s = 0; s < kGuideStages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[s]))
                     : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    int src, lo, hi;
    for (int i = 0; i < n && i < kGuideStages; ++i) {
        const int m = guide_chunk(start, end, kGuideStage, i, &src, &lo, &hi);
        bulk_load(smem_addr(ring[i]), lum_sorted + src, 4u * m, smem_addr(&full[i]));
    }
    float acc = hist_in[k];
    for (int i = 0; i < n; ++i) {
        const int s = i % kGuideStages;
        mbar_wait(smem_addr(&full[s]), (uint32_t)(i / kGuideStages) & 1u);
        guide_chunk(start, end, kGuideStage, i, &src, &lo, &hi);
        acc = guide_stage_sum(acc, ring[s], lo, hi);
        const int nx = i + kGuideStages;
        if (nx < n) {
            // the stage's reads are done before the async proxy rewrites it
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            const int m = guide_chunk(start, end, kGuideStage, nx, &src, &lo, &hi);
            bulk_load(smem_addr(ring[s]), lum_sorted + src, 4u * m, smem_addr(&full[s]));
        }
    }
    hist_out[k] = acc;
}

__global__ void guide_sample_kernel(GuideArgs g, const float* __restrict__ hist,
                                    const float* __restrict__ px, const float* __restrict__ pz,
                                    const float* __restrict__ u1, const float* __restrict__ u2,
                                    long long n, float* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float o[4];
    guide_sample_query(g, hist, px[i], pz[i], u1[i], u2[i], o);
    for (int c = 0; c < 4; ++c) out[c * n + i] = o[c];
}

}  // namespace

extern "C" {

int f3d_dd(int op, const float* ahi, const float* alo, const float* bhi, const float* blo,
           long long n, float* hi, float* lo, void* stream) {
    if (n > 0)
        dd_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(op, ahi, alo, bhi, blo, n,
                                                                    hi, lo);
    return (int)cudaGetLastError();
}

int f3d_preetham(const PreethamArgs* s, const float* dx, const float* dy, const float* dz,
                 long long n, float* rgb, void* stream) {
    if (n > 0)
        preetham_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(*s, dx, dy, dz, n,
                                                                          rgb);
    return (int)cudaGetLastError();
}

int f3d_eval_lights(const float* lights, int n_lights, const float* p, const float* n,
                    const float* u, long long count, float* out, void* stream) {
    if (count > 0)
        eval_lights_kernel<<<blocks(count), kThreads, 0, (cudaStream_t)stream>>>(
            lights, n_lights, p, n, u, count, out);
    return (int)cudaGetLastError();
}

int f3d_octa_encode(const float* dx, const float* dy, const float* dz, long long n, int res,
                    int* out, void* stream) {
    if (n > 0)
        octa_encode_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(dx, dy, dz, n, res,
                                                                             out);
    return (int)cudaGetLastError();
}

int f3d_octa_decode(const int* bins, long long n, int res, float* out, void* stream) {
    if (n > 0)
        octa_decode_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(bins, n, res, out);
    return (int)cudaGetLastError();
}

int f3d_guide_keys(const GuideArgs* g, const float* px, const float* pz, const float* dx,
                   const float* dy, const float* dz, long long n, int* keys, void* stream) {
    if (n > 0)
        guide_keys_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(*g, px, pz, dx, dy,
                                                                            dz, n, keys);
    return (int)cudaGetLastError();
}

int f3d_guide_bounds(const int* keys, const long long* perm, const float* lum, long long n,
                     int* seg_start, int* seg_end, float* lum_sorted, void* stream) {
    if (n > 0)
        guide_bounds_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
            keys, perm, lum, n, seg_start, seg_end, lum_sorted);
    return (int)cudaGetLastError();
}

int f3d_guide_bins(const int* seg_start, const int* seg_end, const float* lum_sorted,
                   const float* hist_in, long long bins, int threshold, int* long_list,
                   float* hist_out, void* stream) {
    if (bins > 0)
        guide_bins_kernel<<<blocks(bins), kThreads, 0, (cudaStream_t)stream>>>(
            seg_start, seg_end, lum_sorted, hist_in, bins, threshold, long_list, hist_out);
    return (int)cudaGetLastError();
}

// max_long: the most long runs there can be (the grid; blocks past the
// listed count return at once). lum_sorted is padded to a multiple of 4.
int f3d_guide_long(const int* seg_start, const int* seg_end, const float* lum_sorted,
                   const float* hist_in, const int* long_list, int max_long, float* hist_out,
                   void* stream) {
    if (max_long > 0)
        guide_long_kernel<<<max_long, 32, 0, (cudaStream_t)stream>>>(
            seg_start, seg_end, lum_sorted, hist_in, long_list, hist_out);
    return (int)cudaGetLastError();
}

int f3d_guide_sample(const GuideArgs* g, const float* hist, const float* px, const float* pz,
                     const float* u1, const float* u2, long long n, float* out, void* stream) {
    if (n > 0)
        guide_sample_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(*g, hist, px, pz,
                                                                              u1, u2, n, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
