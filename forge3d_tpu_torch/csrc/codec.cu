// forge3d_tpu_torch/csrc/codec.cu
// The CUDA kernels of the F3DZ device decode lane C1, for sm_90a, with plain
// C launchers for ctypes (see _kernels.py). Each launcher enqueues on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
//
// C1 entropy  rans_kernel replaces the rANS scan, the escape substitution
//             and the zig-zag step of forge3d_tpu/codec/f3dz_device.py:
//             _tile_decoder (46-101): one block a tile, one thread running
//             the tile's 65,536-step chain, eight warps of helpers around
//             it, which write the residuals to a (T, 65536) int32 buffer.
// C1 reconstruction  med_kernel replaces the MED/LOCO-I reconstruction and
//             the height scale (96-133) and the host's reassembly of the
//             tiles (223-230): one block a tile, one wavefront of the
//             recurrence, a thread a row, the row above through warp
//             shuffles and, between warps, an edge row in shared memory
//             handed down 8 columns at a time (a released count); the
//             residuals staged by cp.async in a per-warp ring, the heights
//             written straight to their place in the (H, W) output.
//
// What bounds them on the H100. The entropy chain is one rANS state a tile,
// fixed by the wire format: every step's table lookup depends on the step
// before it, so the kernel is latency-bound by design: a tile's 65,536
// tokens take the same time whatever the tile count, as long as the tiles
// fit on the card at once (three blocks an SM on an H100: 396 tiles). The
// design keeps the chain's step to the shared-memory lookup and a few
// integer instructions (codec.cuh: rans_fast_step) and moves everything
// else off the chain thread: the stream is staged by the helpers in a shared ring of
// big-endian word pairs with zeros past `len`, so the chain has no global
// load and no length mask; its symbols go to a shared ring, and the helpers
// substitute the escapes (a block scan gives each escape its rank), zig-zag
// decode and store them, 16 bytes a thread, a chunk behind the chain. A
// tile whose first state is under 2^23 takes the general step instead
// (rans_chain: up to four pulls, the stream from global memory through a
// register buffer). The first designs ran the general step on one thread
// for every tile, with the stores and the escape loads on that thread:
// 7.2561 ms for the 1024^2 page's 16 tiles on an H100 (a 64-bit register
// buffer refilled a word ahead), 8.3185 (each step's four candidate bytes
// loaded at its start, nested branches), 9.2666 (a register window of
// 16-byte chunks); PERF.md §6 splits the first. The reconstruction is a
// recurrence with no scan form (the median is not associative): q[y, x]
// needs q[y, x-1], q[y-1, x] and q[y-1, x-1], so a tile takes 511
// dependent anti-diagonal steps, and it moves 4 B read and 4 B written a
// pixel. Its chain is the step's (med_kernel): a shuffle, the median, the
// add, ~48 cycles (chip_smoke.py:MED_CHAIN_CYCLES). The earlier designs: a
// wavefront over the whole tile, a thread a row of 256 with the rows above
// in a ring in device memory, 0.2189 ms for the 1024^2 page on an H100
// (every step read and wrote 256 rows' worth of scattered words); four
// 64-row passes staged in shared memory, a block barrier a step, 1,276
// steps a tile, 0.1160 ms.

#include <cuda_runtime.h>

#include "codec.cuh"

namespace {

// C1 entropy, a block a tile: warp 0's first thread runs the chain, the
// other eight warps (the helpers) build the tables, fill the stream ring
// ahead of it and drain its symbols a chunk behind it (rans_fast_step's
// comment in codec.cuh). Iteration c of the loop runs the chain's chunk c
// and the helpers' drain of chunk c - 1, and ends in one block barrier.
// The helpers' fill during iteration c covers chunk c + 1 from the chunk's
// start position pos[c & 1], and writes only entries past those chunk c
// reads (rans_fill_end): the chain can pull at most 2 bytes a token, so
// the entries chunk c reads and those written beside it span at most
// F3DZ_CHUNK + 2 of the ring's 4096.
constexpr int kRansHelpers = 256;
constexpr int kRansThreads = 32 + kRansHelpers;
constexpr uint32_t kRansChunks = F3DZ_TILE_PX / F3DZ_CHUNK;
constexpr uint32_t kRansSubs = F3DZ_CHUNK / (4u * kRansHelpers);   // symbol words a helper a chunk
constexpr size_t kRansTabBytes = F3DZ_PROB_SCALE * sizeof(uint2);
constexpr size_t kRansRingBytes = F3DZ_RING_WORDS * sizeof(uint2);
constexpr size_t kRansSymBytes = 2 * F3DZ_CHUNK;
constexpr size_t kRansSmem = kRansTabBytes + kRansRingBytes + kRansSymBytes + F3DZ_PROB_SCALE
                             + 2 * 8 * 4 + 2 * 4;

// An exclusive scan of v over the 256 helpers in order (named barrier 1,
// the chain's warp takes no part); `wsum` holds the eight warps' sums and
// alternates between two halves from one scan to the next, so one barrier
// a scan suffices. Returns the sum of v over helpers before this one;
// `total` gets the sum over all.
__device__ __forceinline__ uint32_t helper_scan(uint32_t v, uint32_t* wsum, uint32_t& total) {
    const int lane = threadIdx.x & 31, hw = (threadIdx.x >> 5) - 1;
    uint32_t inc = v;
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t n = __shfl_up_sync(0xFFFFFFFFu, inc, o);
        if (lane >= o) inc += n;
    }
    if (lane == 31) wsum[hw] = inc;
    asm volatile("bar.sync 1, %0;" ::"n"(kRansHelpers) : "memory");
    uint32_t before = 0, all = 0;
    for (int k = 0; k < kRansHelpers / 32; ++k) {
        const uint32_t w = wsum[k];
        before += k < hw ? w : 0u;
        all += w;
    }
    total = all;
    return before + inc - v;
}

__global__ void __launch_bounds__(kRansThreads) rans_kernel(
        const uint8_t* __restrict__ stream, const uint32_t* __restrict__ lens, int cap,
        const uint32_t* __restrict__ freq, const uint32_t* __restrict__ extras, int ecap,
        int32_t* __restrict__ d) {
    extern __shared__ __align__(16) unsigned char rans_smem[];
    uint2* tab = reinterpret_cast<uint2*>(rans_smem);
    uint2* ring = reinterpret_cast<uint2*>(rans_smem + kRansTabBytes);
    uint32_t* syms = reinterpret_cast<uint32_t*>(rans_smem + kRansTabBytes + kRansRingBytes);
    uint8_t* sym = rans_smem + kRansTabBytes + kRansRingBytes + kRansSymBytes;
    uint32_t* wsum = reinterpret_cast<uint32_t*>(sym + F3DZ_PROB_SCALE);   // [2][8]
    uint32_t* pos = wsum + 16;                                              // [2]
    const int t = blockIdx.x, tid = threadIdx.x, h = tid - 32;
    const uint8_t* row = stream + (size_t)t * cap;
    const uint32_t len = lens[t];
    const uint32_t* ex = extras + (size_t)t * ecap;
    int32_t* dt = d + (size_t)t * F3DZ_TILE_PX;

    // the tables (a helper a symbol) and the ring's first fill
    uint32_t par = 0, fill = rans_fill_end(4u);
    if (h >= 0) {
        const uint32_t f = freq[(size_t)t * 256 + h];
        uint32_t total;
        const uint32_t cum = helper_scan(f, wsum, total);
        par = 1;
        rans_fill_fast((uint32_t)h, f, cum, tab, sym);
        for (uint32_t w = h; w < fill; w += kRansHelpers)
            ring[w & (F3DZ_RING_WORDS - 1u)] = rans_ring_entry(row, len, (uint32_t)cap, w);
        if (h == 0) pos[0] = 4u;
    }
    __syncthreads();
    if (ring[0].x < F3DZ_RANS_LO) {   // the first state: the general step (block-uniform)
        if (tid == 0) rans_chain(tab, sym, row, len, (uint32_t)cap, ex, ecap, F3DZ_TILE_PX, dt);
        return;
    }
    RansFast c = rans_fast_start(ring);
    uint32_t carry = 0;   // escapes in the chunks drained so far
    for (uint32_t k = 0; k <= kRansChunks; ++k) {
        if (tid == 0) {
            if (k < kRansChunks) {
                rans_fast_chunk(rans_smem, sym, ring, c, syms + (k & 1u) * (F3DZ_CHUNK / 4u),
                                F3DZ_CHUNK / 4u);
                pos[(k + 1u) & 1u] = c.pb >> 3;
            }
        } else if (h >= 0) {
            if (k < kRansChunks) {   // the ring for chunk k + 1
                const uint32_t end = rans_fill_end(pos[k & 1u]);
                for (uint32_t w = fill + h; w < end; w += kRansHelpers)
                    ring[w & (F3DZ_RING_WORDS - 1u)] = rans_ring_entry(row, len, (uint32_t)cap, w);
                fill = end > fill ? end : fill;
            }
            if (k > 0) {             // drain chunk k - 1
                const uint32_t* in = syms + ((k - 1u) & 1u) * (F3DZ_CHUNK / 4u);
                int32_t* out = dt + (size_t)(k - 1u) * F3DZ_CHUNK;
                for (uint32_t q = 0; q < kRansSubs; ++q) {
                    const uint32_t g = q * kRansHelpers + h;
                    const uint32_t v = in[g];
                    uint32_t total;
                    const uint32_t before = helper_scan(rans_escapes(v), wsum + 8 * par, total);
                    par ^= 1u;
                    int4 o;
                    rans_drain_word(v, carry + before, ex, (uint32_t)ecap,
                                    reinterpret_cast<int32_t*>(&o));
                    carry += total;
                    reinterpret_cast<int4*>(out)[g] = o;
                }
            }
        }
        __syncthreads();
    }
}

// C1 reconstruction, a block a tile: one wavefront of 256 + 31 steps a
// warp, a thread a row (codec.cuh: med_lane_step), the row above from the
// lane above by a shuffle, across warps from an edge row in shared memory
// handed down F3DZ_MED_HAND columns at a time, so no block barrier runs in
// the loop. A warp runs 8 + 1 periods of 32 steps; before period c it
// drains chunk c - 2 (its lanes have passed it), refills that slot of its
// ring with chunk c + 1 (cp.async, 16 bytes a piece) and waits for chunk c.
// Warp w's lane 0 takes column x at step x, once warp w - 1's lane 31 has
// published the handoff holding x, which it does at its step x + 31
// rounded up to the handoff's end: the warps run F3DZ_MED_HAND + 31 steps
// apart, ~7 x 39 + 287 = 560 steps a tile for the recurrence's 511. A
// handoff is a count a boundary in shared memory: lane 31 of the warp above
// stores the handoff's 8 values, then releases the count of handoffs
// published (st.release); the warp below spins on it (ld.acquire), then
// reads the 8 values. Spinning beat an mbarrier a handoff by ~3% on the
// 1024^2 page (PERF.md §6).
constexpr int kMedThreads = 32 * F3DZ_MED_WARPS;
constexpr int kMedEdgeWords = (F3DZ_MED_WARPS - 1) * F3DZ_TILE;
constexpr int kMedSmem = (F3DZ_MED_WARPS * F3DZ_MED_RING_WORDS + kMedEdgeWords
                          + F3DZ_MED_WARPS) * 4;

__device__ __forceinline__ uint32_t med_smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the warp's 32 rows (from `rows`) of chunk `chunk` into its ring, a
// 16-byte copy a piece; the caller commits the group
__device__ __forceinline__ void med_fill(int32_t* ring, const int32_t* rows, int chunk,
                                         int lane) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int row, col;
        med_piece(lane, i, row, col);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         med_smem_u32(ring + med_slot(chunk, row, col))),
                     "l"(rows + row * F3DZ_TILE + chunk * F3DZ_MED_CHUNK + col)
                     : "memory");
    }
}

__device__ __forceinline__ void med_commit_wait() {   // commit a group, wait for all but it
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
}

// chunk `chunk` of the warp's 32 rows of q, as heights, 16 bytes a piece
__device__ __forceinline__ void med_drain(const int32_t* ring, int chunk, int lane, float* out,
                                          int width, double step) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int row, col;
        med_piece(lane, i, row, col);
        const int4 q = *reinterpret_cast<const int4*>(ring + med_slot(chunk, row, col));
        *reinterpret_cast<float4*>(out + (size_t)row * width + chunk * F3DZ_MED_CHUNK + col) =
            make_float4(f3dz_height(q.x, step), f3dz_height(q.y, step),
                        f3dz_height(q.z, step), f3dz_height(q.w, step));
    }
}

// wait until the warp above has published `count` handoffs
__device__ __forceinline__ void med_acquire(const uint32_t* published, uint32_t count) {
    uint32_t v;
    do {
        asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];\n" : "=r"(v)
                     : "r"(med_smem_u32(published)) : "memory");
    } while (v < count);
}

__device__ __forceinline__ void med_release(uint32_t* published, uint32_t count) {
    asm volatile("st.release.cta.shared::cta.u32 [%0], %1;\n" ::"r"(med_smem_u32(published)),
                 "r"(count) : "memory");
}

// Period c of warp w: its steps 32 c .. 32 c + 31, in groups of
// F3DZ_MED_HAND (8): the group's wait for its handoff from the warp above,
// whose 8 edge values every lane then reads in two 16-byte loads (lane 0
// takes them), then its steps unrolled. kEdge: the first and the last
// period, where some lanes are outside the tile's columns; elsewhere every
// column is past 0 and the prediction is MED alone (codec.cuh: med_inner).
// Lane 31 keeps its last 8 q in registers (`held`, the first of them, from
// the group before) and stores them in two 16-byte stores when its column
// ends a handoff, so no step branches on the lane.
template <bool kEdge>
__device__ __forceinline__ void med_period(int c, int w, int lane, int32_t* ring_row,
                                           const int32_t* edge_above, int32_t* edge_out,
                                           uint32_t* published, int32_t& q, int32_t& upleft,
                                           int32_t& held) {
    static_assert(F3DZ_MED_HAND == 8, "a handoff is two 16-byte edge loads and stores");
    const int y = 32 * w + lane;
    int col = med_ring_col(c, lane);
#pragma unroll 1
    for (int g = 0; g < F3DZ_MED_CHUNK / F3DZ_MED_HAND; ++g) {
        const int k0 = F3DZ_MED_CHUNK * c + F3DZ_MED_HAND * g;
#ifndef F3D_C1_NO_WAIT   // measurement build: the handoffs unawaited (wrong answers)
        if (med_waits(w, k0)) med_acquire(published + w - 1, k0 / F3DZ_MED_HAND + 1);
#endif
        int4 ea = make_int4(0, 0, 0, 0), eb = ea;
        if (w > 0) {
            const int4* src = reinterpret_cast<const int4*>(edge_above + (k0 & (F3DZ_TILE - 1)));
            ea = src[0];
            eb = src[1];
        }
        const int32_t ev[F3DZ_MED_HAND] = {ea.x, ea.y, ea.z, ea.w, eb.x, eb.y, eb.z, eb.w};
        int32_t out[F3DZ_MED_HAND];
        out[0] = held;
#pragma unroll
        for (int j = 0; j < F3DZ_MED_HAND; ++j) {
            const int k = k0 + j, x = k - lane;
            const int32_t from = __shfl_up_sync(0xFFFFFFFFu, q, 1);
            if (!kEdge || (unsigned)x < (unsigned)F3DZ_TILE)
                med_lane_step<!kEdge>(q, upleft, from, ev[j], ring_row + col, lane, x, y);
            col = med_next_col(col);
            // lane 31's column k - 31 is column j + 1 of its handoff (mod 8)
            if (j + 1 < F3DZ_MED_HAND) out[j + 1] = q;
            else held = q;
            const int x31 = k - 31;
            if (j == F3DZ_MED_HAND - 2 && med_publishes(w, lane)
                && (!kEdge || (unsigned)x31 < (unsigned)F3DZ_TILE)) {
                int4* dst = reinterpret_cast<int4*>(edge_out + x31 - (F3DZ_MED_HAND - 1));
                dst[0] = make_int4(out[0], out[1], out[2], out[3]);
                dst[1] = make_int4(out[4], out[5], out[6], out[7]);
                med_release(published + w, x31 / F3DZ_MED_HAND + 1);
            }
        }
    }
}

__global__ void __launch_bounds__(kMedThreads, 2) med_kernel(const int32_t* __restrict__ d,
                                                             int ntx, int width, double step,
                                                             float* __restrict__ out) {
    extern __shared__ __align__(16) int32_t med_smem[];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, t = blockIdx.x;
    int32_t* ring = med_smem + w * F3DZ_MED_RING_WORDS;
    int32_t* edge = med_smem + F3DZ_MED_WARPS * F3DZ_MED_RING_WORDS;   // [warps - 1][256]
    uint32_t* published = reinterpret_cast<uint32_t*>(edge + kMedEdgeWords);   // [warps]
    if (threadIdx.x < F3DZ_MED_WARPS) published[threadIdx.x] = 0u;
    __syncthreads();
    const int32_t* rows = d + (size_t)t * F3DZ_TILE_PX + (size_t)(32 * w) * F3DZ_TILE;
    float* orows = out + ((size_t)(t / ntx) * F3DZ_TILE + 32 * w) * width
                   + (size_t)(t % ntx) * F3DZ_TILE;
    const int32_t* edge_above = edge + (w > 0 ? w - 1 : 0) * F3DZ_TILE;
    int32_t* edge_out = edge + (w < F3DZ_MED_WARPS - 1 ? w : 0) * F3DZ_TILE;
    med_fill(ring, rows, 0, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    med_fill(ring, rows, 1, lane);
    int32_t q = 0, upleft = 0, held = 0;
    for (int c = 0; c <= F3DZ_MED_CHUNKS; ++c) {
        if (c >= 2) {
            __syncwarp();
            med_drain(ring, c - 2, lane, orows, width, step);
        }
        if (c >= 1 && c + 1 < F3DZ_MED_CHUNKS) med_fill(ring, rows, c + 1, lane);
        med_commit_wait();   // chunk c has landed
        __syncwarp();
        int32_t* ring_row = ring + lane * F3DZ_MED_RING_COLS;
        if (c == 0 || c == F3DZ_MED_CHUNKS)
            med_period<true>(c, w, lane, ring_row, edge_above, edge_out, published, q, upleft,
                             held);
        else
            med_period<false>(c, w, lane, ring_row, edge_above, edge_out, published, q, upleft,
                              held);
    }
    __syncwarp();
    med_drain(ring, F3DZ_MED_CHUNKS - 1, lane, orows, width, step);
}

}  // namespace

extern "C" {

// C1 entropy: (stream (T, cap) u8, lens (T,), cap, freq (T, 256),
// extras (T, ecap), ecap, T, d (T, 65536) int32, stream)
int f3d_rans_decode(const uint8_t* stream, const uint32_t* lens, int cap, const uint32_t* freq,
                    const uint32_t* extras, int ecap, int n_tiles, int32_t* d, void* cs) {
    if (n_tiles > 0) {
        cudaFuncSetAttribute(rans_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kRansSmem);
        rans_kernel<<<n_tiles, kRansThreads, kRansSmem, (cudaStream_t)cs>>>(
            stream, lens, cap, freq, extras, ecap, d);
    }
    return (int)cudaGetLastError();
}

// C1 entropy's kernel: out = {registers a thread, local (spilled) bytes a
// thread, resident blocks an SM, shared memory bytes a block}
int f3d_rans_attrs(int* out) {
    cudaError_t e = cudaFuncSetAttribute(rans_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kRansSmem);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes at;
    e = cudaFuncGetAttributes(&at, rans_kernel);
    if (e != cudaSuccess) return (int)e;
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, rans_kernel, kRansThreads,
                                                      kRansSmem);
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = resident;
    out[3] = (int)(kRansSmem + at.sharedSizeBytes);
    return (int)e;
}

// C1 reconstruction: (d (T, 65536) int32, T, ntx, width, step, out (H, W)
// float32, stream); tile t sits at row t / ntx, column t % ntx of tiles.
int f3d_med_reconstruct(const int32_t* d, int n_tiles, int ntx, int width, double step,
                        float* out, void* cs) {
    if (n_tiles > 0) {
        cudaFuncSetAttribute(med_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMedSmem);
        med_kernel<<<n_tiles, kMedThreads, kMedSmem, (cudaStream_t)cs>>>(d, ntx, width, step,
                                                                        out);
    }
    return (int)cudaGetLastError();
}

// C1 reconstruction's kernel: out as f3d_rans_attrs
int f3d_med_attrs(int* out) {
    cudaError_t e = cudaFuncSetAttribute(med_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMedSmem);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes at;
    e = cudaFuncGetAttributes(&at, med_kernel);
    if (e != cudaSuccess) return (int)e;
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, med_kernel, kMedThreads,
                                                      kMedSmem);
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = resident;
    out[3] = (int)(kMedSmem + at.sharedSizeBytes);
    return (int)e;
}

}  // extern "C"
