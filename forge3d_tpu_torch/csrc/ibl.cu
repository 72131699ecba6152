// forge3d_tpu_torch/csrc/ibl.cu
// The CUDA kernel of the IBL bake, for sm_90a, with a plain C launcher for
// ctypes (see _kernels.py). The launcher enqueues on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
//
// E1 bake_kernel  replaces forge3d_tpu/ops/ibl.py:sample_equirect (48) under
//                 equirect_to_cubemap (64), prefilter_environment (92) and
//                 irradiance_map (167): a bake's stages (the cube, mips 0-4,
//                 the irradiance map) in one launch
//
// The JAX bake gathers the whole map once per sample direction and sums the
// S gathered arrays. Here one launch runs every stage of a bake from a job
// table, the largest first, so that the small mips fill the card beside the
// large ones instead of running alone as tails (the design of S2/S3's
// pyramid, screen.cu). A texel takes a group of G lanes (a job's own
// parameter, ops/ibl.py:GROUP_LANES): lane j computes samples j, j + G, ...,
// and after each round of G samples every lane of the group adds the G
// terms in lane order, read with __shfl_sync, so the adds are the serial
// loop's adds in its order and the sums are its sums bit for bit (a tree
// over the samples would not be). The irradiance map's 2,048 texels of 128
// samples become 32,768 lanes of 8. A texel's samples are 16-byte records
// {dx, dy, dz, w}, texel-major, so a group's lanes read consecutive records;
// the tables are formed on the host in float64 once a tier and kept on the
// card (ops/ibl.py:_jobs). The map is read from its RGBx copy (ibl.py:
// _rgbx, formed once a bake), a bilinear tap one 16-byte load; a 512x256
// map's 2 MiB stay in L2. What bounds it: ~470 K bilinear samples a "high"
// bake, ~40 operations each with an atan2f and an acosf, and the tables'
// 7.5 MB read once.

#include <cuda_runtime.h>

#include "common.cuh"  // f3d_kernel_attrs
#include "ibl.cuh"

namespace {

constexpr int kThreads = 256;

struct BakePlan {
    IblJob job[kIblBakeJobs];
    int first_block[kIblBakeJobs + 1];
    int n_jobs;
};

#ifdef F3D_E1_SPANS
// measurement build: each block's first and last %globaltimer reading
constexpr int kSpanBlocks = 4096;
__device__ unsigned long long g_e1_spans[2 * kSpanBlocks];

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
#endif

__global__ void __launch_bounds__(kThreads)
bake_kernel(const float* __restrict__ env4, int env_h, int env_w, BakePlan p) {
#ifdef F3D_E1_SPANS
    if (threadIdx.x == 0 && blockIdx.x < kSpanBlocks) g_e1_spans[2 * blockIdx.x] = global_ns();
#endif
    // the block's job, selected with static indices (no local copy)
    int j = 0;
#pragma unroll
    for (int k = 1; k < kIblBakeJobs; ++k)
        j += (k < p.n_jobs && (int)blockIdx.x >= p.first_block[k]);
    IblJob job = p.job[0];
#pragma unroll
    for (int k = 1; k < kIblBakeJobs; ++k)
        if (j == k) job = p.job[k];
    // every lane of the block runs the same loops (the job, its sample count
    // and group are the block's), so the shuffles take the whole warp; a
    // texel past the end computes texel 0's sums and writes nothing
    const int g = job.group;
    const int lane = threadIdx.x & (g - 1);
    const int t = ((int)blockIdx.x - p.first_block[j]) * (kThreads / g) + (int)threadIdx.x / g;
    const bool live = t < job.n;
    const float* rec = job.tab + 4 * (long long)(live ? t : 0) * job.count;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < job.count; k0 += g) {
        float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (k0 + lane < job.count) ibl_term(env4, env_h, env_w, rec + 4 * (k0 + lane), job.mode, x);
        const int m = job.count - k0 < g ? job.count - k0 : g;
        for (int q = 0; q < m; ++q) {
            float y[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) y[c] = __shfl_sync(0xffffffffu, x[c], q, g);
            ibl_add(acc, y, job.mode);
        }
    }
    if (live && lane == 0) ibl_finish(acc, job.mode, job.count, t, job.out);
#ifdef F3D_E1_SPANS
    __syncthreads();
    if (threadIdx.x == 0 && blockIdx.x < kSpanBlocks) g_e1_spans[2 * blockIdx.x + 1] = global_ns();
#endif
}

}  // namespace

extern "C" {

// E1: `jobs` holds n_jobs (<= kIblBakeJobs) stages of a bake from the RGBx
// map env4 (env_h, env_w, 4), six words each (records, out, texels, samples
// a texel, mode, lanes a texel), in launch order; one launch runs them all.
// Returns cudaErrorInvalidValue for more than kIblBakeJobs or a group that
// is not a power of two up to 32.
int f3d_ibl_bake(const float* env4, int env_h, int env_w, const long long* jobs, int n_jobs,
                 void* stream) {
    if (n_jobs < 0 || n_jobs > kIblBakeJobs) return (int)cudaErrorInvalidValue;
    BakePlan p = {};
    p.n_jobs = n_jobs;
    long long blocks = 0;
    for (int j = 0; j < n_jobs; ++j) {
        const long long* w = jobs + 6 * j;
        IblJob& b = p.job[j];
        b.tab = (const float*)w[0];
        b.out = (float*)w[1];
        b.n = (int)w[2];
        b.count = (int)w[3];
        b.mode = (int)w[4];
        b.group = (int)w[5];
        if (b.group < 1 || b.group > 32 || (b.group & (b.group - 1)) != 0 || b.n < 0
            || b.count < 1)
            return (int)cudaErrorInvalidValue;
        p.first_block[j] = (int)blocks;
        blocks += ((long long)b.n * b.group + kThreads - 1) / kThreads;
    }
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    for (int j = n_jobs; j <= kIblBakeJobs; ++j) p.first_block[j] = (int)blocks;
    if (blocks > 0)
        bake_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(env4, env_h, env_w,
                                                                              p);
    return (int)cudaGetLastError();
}

// E1's registers, local bytes and resident blocks of kThreads an SM
int f3d_ibl_bake_attrs(int* out) {
    return f3d_kernel_attrs((const void*)bake_kernel, kThreads, out);
}

#ifdef F3D_E1_SPANS
// measurement build: the first 2 * n readings of the last launch's blocks
// (start, end of block b at 2b, 2b + 1), in ns of %globaltimer
int f3d_e1_spans(unsigned long long* out, int n) {
    if (n > kSpanBlocks) n = kSpanBlocks;
    return (int)cudaMemcpyFromSymbol(out, g_e1_spans, 2 * n * sizeof(unsigned long long));
}
#endif

}  // extern "C"
