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
//   every row depends on the previous row's neighbouring columns. A task is
//   the sun alone or one sky stratum's ne elevation bins (na + 1 tasks, 33
//   at the default stratification), 1032 rows at the bench scene, twice
//   that in the sun's quadrant (two substeps a row). One task on one SM,
//   behind a barrier a row, left three quarters of the card idle and its
//   rows waiting on loads. Here a thread block cluster marches a task: each
//   CTA owns a band of the task's columns, a thread a column and a group of
//   the bins, the z rows in shared memory with one ghost column a side; a
//   band's edge columns go to its neighbours' ghosts through distributed
//   shared memory (st.async, counted on the receiver's mbarrier), so a step
//   costs one CTA barrier and a wait for two neighbours, no barrier across
//   the cluster. The inputs (h, du, dv and the normal's 1/length) stream
//   into a shared-memory ring with cp.async a chunk of rows ahead of the
//   chain, read along device memory's rows (a quadrant-2/3 band reads its
//   columns' runs of rows; the ring serves them transposed). Each stratum
//   writes its own e_sky plane, and the sun z_sun, in the oriented layout
//   (a band's row contiguous); sweep_reduce_kernel unorients them through a
//   shared-memory tile and adds the planes in their fixed order (no float
//   atomics), so the sums do not depend on the decomposition. What bounds
//   it now is each step's chain (loads, the bins' arithmetic, the CTA
//   barrier, the neighbours' edges) and the SM's issue rate, far above the
//   operations' bound, which counts every bin-row as if all ran at once.
// - K3 replaces the TPU's dense (E, K, A) crossing-indicator contraction,
//   which is ~3.7 G elements per frame at the bench scene, by a binary
//   search: a CTA builds its azimuth columns' K profile samples (q, 7
//   channels and a validity byte, 33 B each) in shared memory, takes their
//   running max, and each of the E rows finds its crossing in log2(K) steps
//   and lerps two rows. Its cost is the profile gathers (L2-resident rotated
//   grid and corner pack) and the accumulator's read-modify-write (129 MB
//   at the bench scene, more than L2): a row's texels go to shared memory
//   and the CTA adds them along acc's rows, so a warp's loads and stores
//   touch a few sectors, not one a lane; two columns a CTA make those runs
//   72 bytes and let neighbouring lanes share the grid's lines in L1. Each
//   (e, a) has one writer, so the sum over frames is deterministic.
// Where a CTA's rows do not fit in shared memory (very wide grids), the
// wrapper passes a device scratch buffer and the same code runs on it (K2:
// the z rows and the ghosts there, the inputs read from device memory).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kSweepThreads = 1024;   // K2: at most
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

// K2. CTA blockIdx.x runs band ctas[blockIdx.x] of its task; a task's CTAs
// are consecutive ranks of one cluster, so its neighbours are blockIdx.x
// +- 1. A thread owns one column of the band and one of `groups` groups of
// the task's bins (b = g, g + groups, ...; their constants in registers):
// it reads the column's inputs once a step, loads its bins' z rows, then
// steps them. At a row's last step each bin's contribution goes to a shared
// buffer; a thread a (column, channel) weights them in bin order into the
// task's partial plane one row later, while the next row's edges travel
// (two buffers, by row parity). The band's edge columns go to
// the neighbours' ghost slots as they are made, with st.async, each landing
// counted on the neighbour's mbarrier for that z buffer; a CTA waits on its
// own before it reads its ghosts: no barrier across the cluster inside the
// march, one CTA barrier a step.
//
// Shared memory: the task's bin rows; unless zglob is given, the two z
// buffers (nb_max rows of zs floats each), two contribution buffers (a
// row's and the next's: nb_max rows of `band` floats) and the input ring:
// kRingSlots chunks of kRingRows rows of h, du, dv and the normal's 1/length
// (invn_kernel, once a call) for the band. With zglob (kGlobal) the z rows
// and contributions live in device memory, the inputs are read from their
// arrays, and the wrapper gives each task one CTA: nothing crosses SMs,
// whose L1 caches are not coherent.
constexpr int kRingRows = 4;     // rows a chunk
constexpr int kRingSlots = 3;    // chunk k + 1 in flight while k is read
constexpr int kRingArrays = 4;   // h, du, dv, and invn_kernel's 1 / sqrt(1 + du^2 + dv^2)
constexpr int kBinsPerThread = 4;
constexpr int kSweepSmemThreads = 800;

struct SweepRing {
    float* buf;
    int pitch;    // floats of one (chunk, array) tile
    bool trans;   // quadrants 2 and 3: the tile is [column][row], a column's
                  // rows padded to kRingRows + 1 so that a row read across the
                  // band's columns falls on distinct banks
    int band;     // the tile's row length (the widest band)

    __device__ float* tile(int k, int a) const {
        return buf + ((k % kRingSlots) * kRingArrays + a) * pitch;
    }
    __device__ int off(int rr, int j) const {
        return trans ? j * (kRingRows + 1) + rr : rr * band + j;
    }
    __device__ float at(int a, int r, int j) const {
        return tile(r / kRingRows, a)[off(r % kRingRows, j)];
    }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

// Chunk k of the band's rows (h, du, dv, invn) into its ring slot, one
// group of copies a thread; consecutive threads take consecutive addresses
// of one row of the (V, U) arrays (a quadrant-0/1 row's columns, a
// quadrant-2/3 column's rows).
__device__ void ring_issue(const SweepRing& rg, const float* const* src, int q, int V, int U,
                           int R, int c0, int w, int k) {
    const int r0 = k * kRingRows, nr = min(kRingRows, R - r0);
    if (nr > 0) {
        for (int i = threadIdx.x; i < nr * w; i += blockDim.x) {
            const int j = rg.trans ? i / nr : i % w, rr = rg.trans ? i % nr : i / w;
            const int o = rg.off(rr, j), g = sweep_index(q, r0 + rr, c0 + j, V, U);
#pragma unroll
            for (int a = 0; a < kRingArrays; ++a) cp_async4(rg.tile(k, a) + o, src[a] + g);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// v into float slot `slot` of the cluster peer `rank`'s copy of this CTA's
// shared array at `local`, its 4 bytes counted on the peer's mbarrier `bar`.
__device__ __forceinline__ void push(const float* local, int slot, float v, const void* bar,
                                     unsigned rank) {
    uint32_t a, m;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(local + slot)),
                 "r"(rank));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(m) : "r"(smem_u32(bar)),
                 "r"(rank));
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
                 ::"r"(a), "r"(__float_as_uint(v)), "r"(m) : "memory");
}

// Wait for the phase of parity `parity` of a local mbarrier to complete.
// A step's wait is microseconds; after ~2^26 polls something is wrong (a
// plan whose neighbours never send): trap rather than hang the card.
__device__ __forceinline__ void wait_bar(const void* bar, uint32_t parity) {
    uint32_t done = 0;
    for (long long n = 0; !done; ++n) {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
        if (n > (1ll << 26)) __trap();
    }
}

// The normal's 1/length at every node, once a call (the ring's fourth array).
__global__ void invn_kernel(const float* __restrict__ du, const float* __restrict__ dv,
                            long long n, float* __restrict__ invn) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) invn[i] = sweep_invn(du[i], dv[i]);
}

template <bool kGlobal>
__global__ void __launch_bounds__(kGlobal ? kSweepThreads : kSweepSmemThreads)
sweep_kernel(const float* __restrict__ h, const float* __restrict__ du,
             const float* __restrict__ dv, const float* __restrict__ invn, int V, int U,
             const SweepTask* tasks, const SweepCta* ctas, const SweepBin* table, int nb_max,
             int zs, int band, int groups, float* zglob, float* partial, float* z_orient) {
    extern __shared__ __align__(16) float smem[];
    __shared__ unsigned long long gbar[2];   // ghost arrivals into z buffer 0 / 1
    cg::cluster_group cluster = cg::this_cluster();
    const SweepCta me = ctas[blockIdx.x];
    const SweepTask t = tasks[me.task];
    const int R = sweep_rows(t.q, V, U), Cw = sweep_width(t.q, V, U);
    const int c0 = me.c0, w = me.w, zbuf = nb_max * zs, cbuf = nb_max * band;
    const unsigned rank = cluster.block_rank();
    // neighbours in this task: the left one's width, -1 if none
    const int lw = rank > 0 && ctas[blockIdx.x - 1].task == me.task ? ctas[blockIdx.x - 1].w : -1;
    const int rw = rank + 1 < cluster.num_blocks() && ctas[blockIdx.x + 1].task == me.task
                       ? ctas[blockIdx.x + 1].w : -1;
    const bool push_l = w > 0 && lw >= 0, push_r = w > 0 && rw >= 0;
    const uint32_t rx_bytes = 4u * t.nb * ((lw > 0) + (rw > 0));   // edges a step in
    SweepBin* bins = reinterpret_cast<SweepBin*>(smem);
    float* z = kGlobal ? zglob + (size_t)blockIdx.x * (2 * zbuf + 2 * cbuf)
                       : smem + ((nb_max * 10 + 3) & ~3);
    float* contrib = z + 2 * zbuf;
    SweepRing rg{contrib + 2 * cbuf, band * (kRingRows + 1), t.q >= 2, band};
    const float* src[kRingArrays] = {h, du, dv, invn};
    // (bin group, column) pairs: in shared memory one a thread at most, its
    // bins' constants in registers; in device memory by stride
    const int pairs = groups * w;
    const int g0 = w > 0 ? (int)threadIdx.x / w : 0, j0 = (int)threadIdx.x - g0 * w;

    for (int i = threadIdx.x; i < t.nb; i += blockDim.x) bins[i] = table[t.bin0 + i];
    for (int i = threadIdx.x; i < 2 * zbuf; i += blockDim.x) z[i] = F3D_NEG;
    if (threadIdx.x == 0) {
        for (int p = 0; p < 2; ++p)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&gbar[p]))
                         : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if constexpr (!kGlobal) ring_issue(rg, src, t.q, V, U, R, c0, w, 0);
    cluster.sync();   // every CTA's buffers and barriers are set before a neighbour sends
    SweepBin pb[kBinsPerThread];
    if constexpr (!kGlobal) {
#pragma unroll
        for (int k = 0; k < kBinsPerThread; ++k) pb[k] = bins[min(g0 + k * groups, t.nb - 1)];
    }
    // fn(b, bin) for each of the group's bins
    auto for_bins = [&](int g, auto&& fn) {
        if constexpr (kGlobal) {
            for (int b = g; b < t.nb; b += groups) fn(b, bins[b]);
        } else {
#pragma unroll
            for (int k = 0; k < kBinsPerThread; ++k) {
                const int b = g + k * groups;
                if (b < t.nb) fn(b, pb[k]);
            }
        }
    };
    // fn(g, j) for this thread's pairs
    auto for_pairs = [&](auto&& fn) {
        if constexpr (kGlobal) {
            for (int p = threadIdx.x; p < pairs; p += blockDim.x) fn(p / w, p % w);
        } else {
            if ((int)threadIdx.x < pairs) fn(g0, j0);
        }
    };
    auto H = [&](int a, int r, int j) -> float {
        if constexpr (kGlobal) return __ldg(src[a] + sweep_index(t.q, r, c0 + j, V, U));
        else return rg.at(a, r, j);
    };
    int cur = 0;
    uint32_t phases = 0;   // bit p: the parity of gbar[p]'s current phase
    // the end of a step that wrote z buffer np (after the CTA's barrier):
    // the neighbours' edges have landed
    auto finish = [&](int np) {
        if (rx_bytes > 0) wait_bar(&gbar[np], (phases >> np) & 1u);
        phases ^= 1u << np;
    };
    auto expect = [&](int np) {
        if (threadIdx.x == 0 && rx_bytes > 0)
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                             smem_u32(&gbar[np])), "r"(rx_bytes) : "memory");
    };
    // row's e_sky into the task's partial plane: a thread a (column,
    // channel) weights the row's contributions (in the buffer of the row's
    // parity since the row's barrier) in bin order
    auto column_sums = [&](int row) {
        if (t.plane < 0) return;
        const float* cb = contrib + (row & 1) * cbuf;
        float* dst = partial + ((size_t)t.plane * V * U + (size_t)row * Cw + c0) * 3;
        for_pairs([&](int g, int j) {
            for (int c = g; c < 3; c += groups)
                dst[j * 3 + c] = sweep_sum(cb + j, band, t.nb, bins, c);
        });
    };
    for (int r = 0; r < R; ++r) {
        if constexpr (!kGlobal) {
            if (r % kRingRows == 0) {
                ring_issue(rg, src, t.q, V, U, R, c0, w, r / kRingRows + 1);
                asm volatile("cp.async.wait_group %0;\n" ::"n"(kRingSlots - 2) : "memory");
                __syncthreads();
            }
        }
        for (int s = 1; s < t.ss; ++s) {
            const float f = (float)((double)s / (double)t.ss);
            const int np = 1 - cur;
            const float* __restrict__ zc = z + cur * zbuf;
            float* __restrict__ zn = z + np * zbuf;
            expect(np);
            for_pairs([&](int g, int j) {
                const float hp = H(0, r > 0 ? r - 1 : 0, j), hr = H(0, r, j);
                for_bins(g, [&](int b, const SweepBin& bn) {
                    const float v = sweep_substep(hp, hr, f, zc + b * zs, j + 1, bn);
                    zn[b * zs + j + 1] = v;
                    if (j == 0 && push_l) push(zn + b * zs, lw + 1, v, &gbar[np], rank - 1);
                    if (j == w - 1 && push_r) push(zn + b * zs, 0, v, &gbar[np], rank + 1);
                });
            });
            __syncthreads();
            finish(np);
            cur = np;
        }
        const int np = 1 - cur;
        const float* __restrict__ zc = z + cur * zbuf;
        float* __restrict__ zn = z + np * zbuf;
        float* __restrict__ cb = contrib + (r & 1) * cbuf;
        expect(np);
        for_pairs([&](int g, int j) {
            const float hr = H(0, r, j), d_u = H(1, r, j), d_v = H(2, r, j);
            const float in = H(3, r, j);
            for_bins(g, [&](int b, const SweepBin& bn) {
                float zv, z_in;
                cb[b * band + j] = sweep_bin(hr, d_u, d_v, in, bn, zc + b * zs, j + 1, zv, z_in);
                zn[b * zs + j + 1] = zv;
                if (b == 0 && t.emit) z_orient[r * Cw + c0 + j] = z_in;
                if (j == 0 && push_l) push(zn + b * zs, lw + 1, zv, &gbar[np], rank - 1);
                if (j == w - 1 && push_r) push(zn + b * zs, 0, zv, &gbar[np], rank + 1);
            });
        });
        // the row before's column sums run while this row's edges travel
        if (r > 0) column_sums(r - 1);
        __syncthreads();
        finish(np);
        cur = np;
    }
    column_sums(R - 1);
    cluster.sync();   // no CTA leaves while a peer may still address its shared memory
}

// e_sky and z_sun on a 32 x 32 tile of texels: each plane added in plane
// order; a quadrant-2/3 plane (u along its rows) is staged through shared
// memory so that both its reads and the tile's writes are coalesced.
constexpr int kTile = 32;

template <int NCH>
__device__ void stage_transposed(const float* plane, int q, int V, int U, int v0, int u0,
                                 float* tile) {
    for (int i = threadIdx.x; i < kTile * kTile * NCH; i += blockDim.x) {
        const int rr = i / (kTile * NCH), k = i - rr * (kTile * NCH);
        const int u = u0 + rr, v = v0 + k / NCH;
        if (u < U && v < V)
            tile[rr * (kTile * NCH + 1) + k] =
                plane[(size_t)sweep_oriented(q, v, u, V, U) * NCH + k % NCH];
    }
}

__global__ void __launch_bounds__(256)
sweep_reduce_kernel(const float* __restrict__ partial, const int* __restrict__ plane_q,
                    int n_planes, int V, int U, const float* __restrict__ z_orient, int sun_q,
                    float* __restrict__ e_sky, float* __restrict__ z_sun) {
    __shared__ float tile[kTile * (kTile * 3 + 1)];
    const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
    const int u0 = blockIdx.x * kTile, v0 = blockIdx.y * kTile, u = u0 + tx;
    constexpr int kRows = kTile / (256 / kTile);   // texel rows a thread
    float acc[kRows][3];
    for (int i = 0; i < kRows; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.0f;
    const size_t plane = (size_t)V * U;
    for (int p = 0; p < n_planes; ++p) {
        const int q = plane_q[p];
        const float* src = partial + p * plane * 3;
        if (q >= 2) {
            __syncthreads();
            stage_transposed<3>(src, q, V, U, v0, u0, tile);
            __syncthreads();
        }
        for (int i = 0; i < kRows; ++i) {
            const int v = v0 + ty + i * (256 / kTile);
            if (u >= U || v >= V) continue;
            for (int c = 0; c < 3; ++c)
                acc[i][c] += q >= 2 ? tile[tx * (kTile * 3 + 1) + (v - v0) * 3 + c]
                                    : src[(size_t)sweep_oriented(q, v, u, V, U) * 3 + c];
        }
    }
    if (sun_q >= 2) {
        __syncthreads();
        stage_transposed<1>(z_orient, sun_q, V, U, v0, u0, tile);
        __syncthreads();
    }
    for (int i = 0; i < kRows; ++i) {
        const int v = v0 + ty + i * (256 / kTile);
        if (u >= U || v >= V) continue;
        const size_t o = (size_t)v * U + u;
        for (int c = 0; c < 3; ++c) e_sky[o * 3 + c] = acc[i][c];
        if (sun_q >= 0)
            z_sun[o] = sun_q >= 2 ? tile[tx * (kTile + 1) + (v - v0)]
                                  : z_orient[sweep_oriented(sun_q, v, u, V, U)];
    }
}

// K3: a CTA of kPolarThreads takes kG = F3D_K3_COLUMNS (2) adjacent
// azimuth columns a0 .. a0 + kG - 1 (the last CTA's past A idle). Per column (in shared memory unless
// scratch is given) a PolarColumn; in shared memory always the staged
// texels of a pass of rows, the edges and the scan's warp maxima.
// 1. Profile: thread t takes column t % kG and every (kPolarThreads /
//    kG)-th sample k from t / kG, so neighbouring lanes read neighbouring
//    columns' samples, which share the rotated grid's lines; each thread
//    keeps its first valid k, and a warp's minimum per column (shuffles),
//    then a shared atomicMin, gives the column's first valid row.
// 2. Edge: thread g forms column g's boundary-entry sample, which replaces
//    a slot of q and of the channels before the scan.
// 3. Scan: the column's kPolarThreads / kG threads take consecutive chunks
//    of its rows; each chunk's running max, then a warp-shuffle scan of the
//    chunks' maxima and the maxima of the column's earlier warps (max is
//    exact, so any association gives the sequential cummax).
// 4. Rows, in passes of kPolarThreads / kG rows: thread t forms texel (e0 +
//    t / kG, a0 + t % kG) into the stage; after a barrier the CTA adds the
//    pass into acc along its rows, kG * 36 contiguous bytes a row, with
//    consecutive lanes on consecutive floats, each thread's 9 loads issued
//    before its adds.
// Each (e, a) has one writer and one add a frame, as before, so the sum
// over frames is deterministic and equal to the row-by-row kernel's.
// F3D_K3_SPLIT (measurement builds only): 1 stops after the scan, 2 runs
// the rows without the accumulator's read-modify-write, 3 runs the scan
// alone over a filled profile.
// The launch bound asks for as many CTAs an SM as the two columns'
// profiles leave room for in shared memory at bench.py's K (1029): 2.
// One and four columns a CTA measured slower (PERF.md, section 6).
constexpr int kG = F3D_K3_COLUMNS;

__global__ void __launch_bounds__(kPolarThreads, 2)
polar_kernel(PolarArgs p, const float* __restrict__ h_rot, const float* __restrict__ e_sky,
             const float* __restrict__ z_sun, const float* __restrict__ corners,
             float* __restrict__ acc, float* scratch) {
    extern __shared__ float profiles[];
    __shared__ float stage[kPolarThreads * 9];
    __shared__ Edge edges[kG];
    __shared__ int k_first[kG];
    __shared__ float warp_max[kPolarThreads / 32];
    constexpr int kPer = kPolarThreads / kG;    // threads a column, rows a pass
    const int a0 = blockIdx.x * kG, K = p.K, tid = threadIdx.x, lane = tid & 31;
    const int pf = PolarColumn::floats(K);
    float* base = scratch ? scratch + (size_t)blockIdx.x * kG * pf : profiles;
    const int gp = tid % kG;                     // the profile's and the rows' column
    const bool live = a0 + gp < p.A;
    auto col_of = [&](int g) { return PolarColumn(base + g * pf, K); };
    const PolarColumn col = col_of(gp);
    const float t = azimuth_t(p, a0 + gp);
    if (tid < kG) k_first[tid] = K;
    __syncthreads();
    int first = K;
#if F3D_K3_SPLIT == 3
    for (int k = tid / kG; k < K && live; k += kPer) {
        col.M[k] = (float)(k % 13);
        col.valid[k] = 1;
    }
#else
    for (int k = tid / kG; k < K && live; k += kPer)
        if (polar_sample(p, h_rot, e_sky, z_sun, corners, col, k, t) && first == K) first = k;
    for (int o = 16; o >= kG; o >>= 1) first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
    if (lane < kG && first < K) atomicMin(&k_first[lane], first);
    __syncthreads();
    if (tid < kG && a0 + tid < p.A) {
        edges[tid] = edge_sample(p, h_rot, e_sky, z_sun, corners, k_first[tid],
                                 azimuth_t(p, a0 + tid));
        polar_apply_edge(col_of(tid), edges[tid]);
    }
#endif
    __syncthreads();
    {   // the scan: column tid / kPer, chunk tid % kPer
        const int g = tid / kPer, j = tid % kPer, chunk = (K + kPer - 1) / kPer;
        const int k0 = min(K, j * chunk), k1 = min(K, k0 + chunk);
        float* M = base + g * pf;
        const bool mine = a0 + g < p.A;
        float run = mine ? polar_scan_chunk(M, k0, k1) : -INFINITY;
        float incl = run;
        for (int o = 1; o < 32; o <<= 1) {
            float up = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl = fmaxf(incl, up);
        }
        if (lane == 31) warp_max[tid >> 5] = incl;
        float before = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) before = -INFINITY;
        __syncthreads();
        for (int w = (g * kPer) >> 5; w < (tid >> 5); ++w) before = fmaxf(before, warp_max[w]);
        for (int k = k0; k < k1 && mine; ++k) M[k] = fmaxf(before, M[k]);
    }
    __syncthreads();
#if F3D_K3_SPLIT == 1 || F3D_K3_SPLIT == 3
    if (tid == 0 && base[0] == -1.2345e-37f) acc[0] = base[1];   // never: keeps the work live
    return;
#endif
    const Edge ed = edges[gp];
    for (int e0 = 0; e0 < p.E; e0 += kPer) {
        const int e = e0 + tid / kG;
        if (live && e < p.E) polar_texel(p, col, ed, e, t, stage + tid * 9);
        __syncthreads();
#if F3D_K3_SPLIT == 2
        if (stage[tid] == -1.2345e-37f) acc[tid] = stage[tid + 1];   // never: keeps the rows live
#else
        // the pass's 9 floats a thread: every load issued before an add
        const int n = min(kPer, p.E - e0) * kG * 9;
        float* rows = acc + ((size_t)e0 * p.A + a0) * 9;
        float cur[9];
        int off[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) {
            const int f = tid + j * kPolarThreads;
            off[j] = f < n ? polar_acc_offset(p, a0, f) : -1;
            if (off[j] >= 0) cur[j] = rows[off[j]];
        }
#pragma unroll
        for (int j = 0; j < 9; ++j)
            if (off[j] >= 0) rows[off[j]] = cur[j] + stage[tid + j * kPolarThreads];
#endif
        __syncthreads();
    }
}

__global__ void resolve_kernel(ResolveArgs r, const float* __restrict__ acc,
                               unsigned char* out) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)r.width * r.height) return;
    resolve_pixel(r, acc, (int)(i % r.width), (int)(i / r.width), out);
}

// K2's shared-memory bytes a CTA: the bin rows, and unless the z rows go to
// device memory, the two z buffers, the two contribution buffers and the
// input ring.
size_t sweep_smem(int nb_max, int zs, int band, int global) {
    size_t bytes = (size_t)((nb_max * 10 + 3) & ~3) * sizeof(float);
    if (!global)
        bytes += (2 * (size_t)nb_max * (zs + band)
                  + (size_t)kRingSlots * kRingArrays * band * (kRingRows + 1)) * sizeof(float);
    return bytes;
}

cudaLaunchConfig_t sweep_config(int n_ctas, int cluster, int threads, size_t smem,
                                       cudaStream_t s, cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_ctas);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

using SweepFn = void (*)(const float*, const float*, const float*, const float*, int, int,
                        const SweepTask*, const SweepCta*, const SweepBin*, int, int, int, int,
                        float*, float*, float*);

SweepFn sweep_fn(bool global) { return global ? sweep_kernel<true> : sweep_kernel<false>; }

cudaError_t sweep_prepare(SweepFn fn, size_t smem, int cluster) {
    if (fn == nullptr) return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(fn, smem);
    if (err == cudaSuccess && cluster > 8)
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
}

// K3's dynamic shared bytes: the CTA's column profiles, unless in scratch
size_t polar_smem(int K, bool global) {
    return global ? 0 : (size_t)kG * PolarColumn::floats(K) * sizeof(float);
}

}  // namespace

extern "C" {

int f3d_rotate_heights(const RotArgs* r, float* h_rot, float* du, float* dv, void* stream) {
    long long n = (long long)r->n_v * r->n_u;
    if (n > 0)
        rotate_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*r, h_rot, du, dv);
    return (int)cudaGetLastError();
}

// The most clusters of this shape the card keeps resident at once
// (cudaOccupancyMaxActiveClusters), into *n.
int f3d_sweep_clusters(int cluster, int threads, int nb_max, int zs, int band, int global,
                       int* n) {
    const size_t smem = sweep_smem(nb_max, zs, band, global);
    const SweepFn fn = sweep_fn(global);
    cudaError_t err = sweep_prepare(fn, smem, cluster);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = sweep_config(cluster, cluster, threads, smem, 0, attr);
    return (int)cudaOccupancyMaxActiveClusters(n, fn, &cfg);
}

// tasks: n_tasks SweepTask rows; ctas: n_ctas SweepCta rows, a task's CTAs
// consecutive inside one cluster of `cluster` CTAs; zs: the z rows' pitch
// (the widest band + 2); band: the widest band; threads: a CTA's threads;
// groups: the groups of a task's bins (a thread a group and a column; in
// shared memory at most kBinsPerThread bins a group, groups * band <=
// threads <= kSweepSmemThreads); invn: V * U floats of
// scratch; plane_q: each partial plane's quadrant; sun_q: the sun task's
// quadrant, or -1 (z_sun is then left as it is). zglob, if not null, holds
// every CTA's z rows and contributions (2 * nb_max * (zs + band) floats
// each) in device memory.
int f3d_sweep_lighting(const float* h, const float* du, const float* dv, int V, int U,
                       const int* tasks, int n_tasks, const int* ctas, int n_ctas, int cluster,
                       int threads, const float* table, int nb_max, int zs, int band,
                       int groups, float* invn, float* zglob, float* partial, float* z_orient,
                       const int* plane_q, int n_planes, int sun_q, float* e_sky, float* z_sun,
                       void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const bool global = zglob != nullptr;
    const size_t smem = sweep_smem(nb_max, zs, band, global);
    const SweepFn fn = sweep_fn(global);
    cudaError_t err = sweep_prepare(fn, smem, cluster);
    if (err != cudaSuccess) return (int)err;
    if (n_tasks > 0 && n_ctas > 0) {
        const long long n = (long long)V * U;
        invn_kernel<<<blocks_for(n), kThreads, 0, s>>>(du, dv, n, invn);
        cudaLaunchAttribute attr[1];
        cudaLaunchConfig_t cfg = sweep_config(n_ctas, cluster, threads, smem, s, attr);
        err = cudaLaunchKernelEx(&cfg, fn, h, du, dv, (const float*)invn, V, U,
                                 reinterpret_cast<const SweepTask*>(tasks),
                                 reinterpret_cast<const SweepCta*>(ctas),
                                 reinterpret_cast<const SweepBin*>(table), nb_max, zs, band,
                                 groups, zglob, partial, z_orient);
        if (err != cudaSuccess) return (int)err;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (V > 0 && U > 0)
        sweep_reduce_kernel<<<dim3((U + kTile - 1) / kTile, (V + kTile - 1) / kTile), 256, 0,
                              s>>>(partial, plane_q, n_planes, V, U, z_orient, sun_q, e_sky,
                                   z_sun);
    return (int)cudaGetLastError();
}

// scratch, if not null, holds every CTA's profiles (F3D_K3_COLUMNS *
// PolarColumn::floats(K) floats each).
int f3d_polar_frame(const PolarArgs* p, const float* h_rot, const float* e_sky,
                    const float* z_sun, const float* corners, float* acc, float* scratch,
                    void* stream) {
    const size_t smem = polar_smem(p->K, scratch != nullptr);
    cudaError_t err = allow_smem(polar_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (p->A > 0 && p->K > 0)
        polar_kernel<<<(p->A + kG - 1) / kG, kPolarThreads, smem, (cudaStream_t)stream>>>(
            *p, h_rot, e_sky, z_sun, corners, acc, scratch);
    return (int)cudaGetLastError();
}

// K3 over profiles of K rows (in shared memory unless global): out =
// {registers a thread, local (spilled) bytes a thread, resident CTAs an
// SM, shared bytes a CTA, columns a CTA}
int f3d_polar_attrs(int K, int global, int* out) {
    const size_t smem = polar_smem(K, global);
    cudaError_t e = allow_smem(polar_kernel, smem);
    cudaFuncAttributes at;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&at, polar_kernel);
    if (e != cudaSuccess) return (int)e;
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, polar_kernel, kPolarThreads,
                                                      smem);
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = resident;
    out[3] = (int)(at.sharedSizeBytes + smem);
    out[4] = kG;
    return (int)e;
}

int f3d_resolve(const ResolveArgs* r, const float* acc, unsigned char* out, void* stream) {
    long long n = (long long)r->width * r->height;
    if (n > 0)
        resolve_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*r, acc, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
