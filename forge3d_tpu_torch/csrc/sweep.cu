// forge3d_tpu_torch/csrc/sweep.cu
// The four CUDA kernels of the sweep estimator, for sm_90a, with plain C
// launchers for ctypes (see _kernels.py). Each launcher enqueues on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
//
// K1 rotate_kernel   replaces forge3d_tpu/ops/sweep.py:rotate_heights (384)
// K2 sweep_kernel + sweep_reduce_kernel
//                    replace forge3d_tpu/ops/sweep.py:sweep_lighting (188)
// K3 polar_kernel    replaces forge3d_tpu/pt/terrain_sweep.py:frame_one (146)
// K4 resolve_kernel  replaces forge3d_tpu/ops/polarscan.py:warp_to_screen (325)
//                    and pt/terrain_sweep.py:resolve_impl (394)
//
// What bounds them on the card, and what the design does about it:
// - K1 and K4 are one thread per node / pixel, a few gathers each; they are
//   bound by memory traffic (K1 ~13 MB, K4 reads ~4-8 taps x 9 channels of
//   the 129 MB accumulator at the bench scene) and run once per render.
// - K2 is bound by the row recurrence z = max(h, shift(z_prev) - delta):
//   the lateral shift moves the shadow line by up to one column per row, so
//   every row depends on the whole previous row. One CTA owns one sky
//   stratum (its ne elevation bins) or the sun, keeps the bins' z rows in
//   shared memory (two buffers) and marches the rows with one
//   __syncthreads per row or substep; the grid is indexed through each
//   quadrant's flip / transpose instead of being copied. Only na + 1 CTAs
//   run (33 at the default stratification), so the kernel uses a quarter of
//   the SMs: latency of the row chain, not bandwidth, bounds it. For a
//   fixed summation order (no float atomics), each stratum writes its own
//   e_sky plane and sweep_reduce_kernel adds the planes in a fixed order.
// - K3 replaces the TPU's dense (E, K, A) crossing-indicator contraction,
//   which is ~3.7 G elements per frame at the bench scene, by a binary
//   search: one CTA per azimuth column builds the column's K profile
//   samples (q and 9 channels, 44 B each) in shared memory, takes their
//   running max, and each of the E rows finds its crossing in log2(K) steps
//   and lerps two rows. Its cost is the profile gathers (L2-resident rotated
//   grid and corner pack) and the accumulator's read-modify-write. Each
//   (e, a) has one writer, so the sum over frames is deterministic.
// Where a CTA's rows do not fit in shared memory (very wide grids), the
// wrapper passes a device scratch buffer and the same code runs on it.

#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSweepThreads = 1024;
constexpr int kPolarThreads = 256;

inline int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
    // past 32 KB of dynamic memory, leave room for the static part within
    // the default 48 KB window by opting in to the larger carve-out
    if (bytes <= 32 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

__global__ void rotate_kernel(RotArgs r, float* h_rot, float* du, float* dv) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)r.n_v * r.n_u) return;
    int iv = (int)(i / r.n_u), iu = (int)(i % r.n_u);
    rotate_node(r, iv, iu, h_rot[i], du[i], dv[i]);
}

// K2: one CTA per task (sun, or one stratum's bins). Shared memory holds
// the bin rows and, unless zglob is given, the two z buffers.
__global__ void __launch_bounds__(kSweepThreads)
sweep_kernel(const float* __restrict__ h, const float* __restrict__ du,
             const float* __restrict__ dv, int V, int U, const SweepTask* tasks,
             const SweepBin* table, int nb_max, float* zglob, float* partial,
             float* z_sun) {
    extern __shared__ float smem[];
    const SweepTask t = tasks[blockIdx.x];
    const int R = sweep_rows(t.q, V, U), Cw = sweep_width(t.q, V, U);
    const size_t zstride = 2 * (size_t)nb_max * (U > V ? U : V);
    SweepBin* bins = reinterpret_cast<SweepBin*>(smem);
    float* za = zglob ? zglob + blockIdx.x * zstride : smem + nb_max * 10;
    float* zb = za + t.nb * Cw;
    for (int i = threadIdx.x; i < t.nb; i += blockDim.x) bins[i] = table[t.bin0 + i];
    for (int i = threadIdx.x; i < t.nb * Cw; i += blockDim.x) za[i] = F3D_NEG;
    __syncthreads();
    for (int r = 0; r < R; ++r) {
        for (int j = 1; j < t.ss; ++j) {
            const float f = (float)((double)j / (double)t.ss);
            for (int i = threadIdx.x; i < t.nb * Cw; i += blockDim.x) {
                int b = i / Cw, c = i - b * Cw;
                zb[i] = sweep_substep(h, t.q, r, c, V, U, f, za + b * Cw, Cw, bins[b]);
            }
            __syncthreads();
            float* s = za; za = zb; zb = s;
        }
        for (int c = threadIdx.x; c < Cw; c += blockDim.x)
            sweep_column(h, du, dv, V, U, t, bins, r, c, za, zb, partial, z_sun);
        __syncthreads();
        float* s = za; za = zb; zb = s;
    }
}

__global__ void sweep_reduce_kernel(const float* partial, int n_planes, long long plane,
                                    float* e_sky) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= plane) return;
    sweep_reduce(partial, n_planes, (size_t)plane, (size_t)i, e_sky);
}

// K3: one CTA per azimuth column a. Per column (in shared memory unless
// scratch is given): M (the q values, then their running max) [K], the
// channels v [K][9] and the sample heights [K].
__global__ void __launch_bounds__(kPolarThreads)
polar_kernel(PolarArgs p, const float* __restrict__ h_rot, const float* __restrict__ e_sky,
             const float* __restrict__ z_sun, const float* __restrict__ corners, float* acc,
             float* scratch) {
    extern __shared__ float smem[];
    __shared__ int k_first;
    __shared__ Edge edge;
    __shared__ float chunk_max[kPolarThreads];
    const int a = blockIdx.x, K = p.K, tid = threadIdx.x, nt = blockDim.x;
    float* M = scratch ? scratch + (size_t)a * K * 11 : smem;
    float* v = M + K;
    float* hp = v + (size_t)K * 9;
    const float t = azimuth_t(p, a);
    if (tid == 0) k_first = K;
    __syncthreads();
    for (int k = tid; k < K; k += nt) {
        float h = sample_values(p, h_rot, e_sky, z_sun, corners, k, t, M[k], v + k * 9);
        hp[k] = h;
        if (h > -1e20f) atomicMin(&k_first, k);
    }
    __syncthreads();
    if (tid == 0) {
        edge = edge_sample(p, h_rot, e_sky, z_sun, corners, k_first, t);
        if (edge.can) {
            M[edge.slot] = edge.q;
            for (int c = 0; c < 7; ++c) v[edge.slot * 9 + c] = edge.v[c];
        }
    }
    __syncthreads();
    // boundary-entry flags, and the running max of q over k (max is exact,
    // so the blocked scan gives the sequential cummax)
    const int chunk = (K + nt - 1) / nt;
    const int k0 = tid * chunk, k1 = min(K, k0 + chunk);
    float run = -INFINITY;
    for (int k = k0; k < k1; ++k) {
        bool valid = hp[k] > -1e20f;
        bool valid_prev = k > 0 && hp[k - 1] > -1e20f;
        v[k * 9 + 8] = edge.can ? (k == edge.slot ? 1.0f : 0.0f)
                                : (valid && !valid_prev ? 1.0f : 0.0f);
        run = fmaxf(run, M[k]);
        M[k] = run;
    }
    chunk_max[tid] = run;
    __syncthreads();
    float before = -INFINITY;
    for (int i = 0; i < tid; ++i) before = fmaxf(before, chunk_max[i]);
    for (int k = k0; k < k1; ++k) M[k] = fmaxf(before, M[k]);
    __syncthreads();
    for (int e = tid; e < p.E; e += nt) polar_row(p, M, v, a, e, t, edge.h_ent, edge.s_ent, acc);
}

__global__ void resolve_kernel(ResolveArgs r, const float* __restrict__ acc,
                               unsigned char* out) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)r.width * r.height) return;
    resolve_pixel(r, acc, (int)(i % r.width), (int)(i / r.width), out);
}

}  // namespace

extern "C" {

int f3d_rotate_heights(const RotArgs* r, float* h_rot, float* du, float* dv, void* stream) {
    long long n = (long long)r->n_v * r->n_u;
    if (n > 0)
        rotate_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*r, h_rot, du, dv);
    return (int)cudaGetLastError();
}

int f3d_sweep_lighting(const float* h, const float* du, const float* dv, int V, int U,
                       const int* tasks, int n_tasks, const float* table, int nb_max,
                       float* zglob, float* partial, int n_planes, float* e_sky,
                       float* z_sun, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    size_t smem = (size_t)nb_max * sizeof(SweepBin)
                  + (zglob ? 0 : 2 * (size_t)nb_max * (U > V ? U : V) * sizeof(float));
    cudaError_t err = allow_smem(sweep_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (n_tasks > 0)
        sweep_kernel<<<n_tasks, kSweepThreads, smem, s>>>(
            h, du, dv, V, U, reinterpret_cast<const SweepTask*>(tasks),
            reinterpret_cast<const SweepBin*>(table), nb_max, zglob, partial, z_sun);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    long long plane = (long long)V * U;
    if (plane > 0)
        sweep_reduce_kernel<<<blocks_for(plane), kThreads, 0, s>>>(partial, n_planes, plane,
                                                                   e_sky);
    return (int)cudaGetLastError();
}

int f3d_polar_frame(const PolarArgs* p, const float* h_rot, const float* e_sky,
                    const float* z_sun, const float* corners, float* acc, float* scratch,
                    void* stream) {
    size_t smem = scratch ? 0 : (size_t)p->K * 11 * sizeof(float);
    cudaError_t err = allow_smem(polar_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (p->A > 0 && p->K > 0)
        polar_kernel<<<p->A, kPolarThreads, smem, (cudaStream_t)stream>>>(
            *p, h_rot, e_sky, z_sun, corners, acc, scratch);
    return (int)cudaGetLastError();
}

int f3d_resolve(const ResolveArgs* r, const float* acc, unsigned char* out, void* stream) {
    long long n = (long long)r->width * r->height;
    if (n > 0)
        resolve_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*r, acc, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
