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
//             tiles (223-230): one block a tile, four passes of 64 rows; a
//             pass loads its residuals into shared memory, runs an
//             anti-diagonal wavefront there, a thread a row (at step k row
//             y computes column k - y from the value above and the one
//             above-left, which row y - 1 wrote at steps k - 1 and k - 2;
//             one barrier a step), and writes its heights straight to their
//             place in the (H, W) output.
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
// 16-byte chunks); PERF.md §6 splits the first. The reconstruction is bound
// by its 1,276 barrier steps a tile (4 x (64 + 255)) and by bytes: 4 B read
// and 4 B written a pixel. A wavefront over the whole tile in 511 steps,
// one thread a row of 256 with the rows above in a ring, took 0.2189 ms for
// the 1024^2 page on an H100: every step read and wrote 256 rows' worth of
// scattered words. Staging a pass in shared memory keeps every global
// access coalesced.

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

// The tile in four passes of kMedRows rows: load the pass's residuals into
// shared memory (coalesced), run the wavefront there (q overwrites d in
// place; the row above the pass is kept from the last pass), then write the
// pass's heights out (coalesced, 16 bytes a thread).
constexpr int kMedRows = 64;
constexpr int kMedSmem = (kMedRows + 1) * F3DZ_TILE * 4;

__global__ void __launch_bounds__(kMedRows) med_kernel(const int32_t* __restrict__ d, int ntx,
                                                      int width, double step,
                                                      float* __restrict__ out) {
    extern __shared__ int32_t smem[];
    int32_t* tile = smem;                          // (kMedRows, 256): d, then q
    int32_t* above = smem + kMedRows * F3DZ_TILE;   // q of the row above the pass
    const int t = blockIdx.x, y = threadIdx.x;
    const int tx = t % ntx, ty = t / ntx;
    float* ot = out + (size_t)ty * F3DZ_TILE * width + (size_t)tx * F3DZ_TILE;
    for (int pass = 0; pass < F3DZ_TILE / kMedRows; ++pass) {
        const int4* src = reinterpret_cast<const int4*>(d + (size_t)t * F3DZ_TILE_PX
                                                        + (size_t)pass * kMedRows * F3DZ_TILE);
        for (int i = y; i < kMedRows * F3DZ_TILE / 4; i += kMedRows)
            reinterpret_cast<int4*>(tile)[i] = src[i];
        __syncthreads();
        const int gy = pass * kMedRows + y;
        int32_t left = 0;
        for (int k = 0; k < kMedRows + F3DZ_TILE - 1; ++k) {
            const int x = k - y;
            if (x >= 0 && x < F3DZ_TILE) {
                // row y - 1 wrote q[y-1, x] at step k - 1 and q[y-1, x-1] at k - 2
                const int32_t* up_row = y > 0 ? tile + (y - 1) * F3DZ_TILE : above;
                const int32_t up = gy > 0 ? up_row[x] : 0;
                const int32_t upleft = (gy > 0 && x > 0) ? up_row[x - 1] : 0;
                const int32_t q = wrap_add(med_pred(left, up, upleft, x, gy),
                                           tile[y * F3DZ_TILE + x]);
                tile[y * F3DZ_TILE + x] = q;
                left = q;
            }
            __syncthreads();
        }
        for (int i = y; i < kMedRows * F3DZ_TILE / 4; i += kMedRows) {
            const int r = i / (F3DZ_TILE / 4), c = 4 * (i % (F3DZ_TILE / 4));
            const int4 q = *reinterpret_cast<const int4*>(tile + r * F3DZ_TILE + c);
            *reinterpret_cast<float4*>(ot + (size_t)(pass * kMedRows + r) * width + c) =
                make_float4(f3dz_height(q.x, step), f3dz_height(q.y, step),
                            f3dz_height(q.z, step), f3dz_height(q.w, step));
        }
        for (int c = y; c < F3DZ_TILE; c += kMedRows)
            above[c] = tile[(kMedRows - 1) * F3DZ_TILE + c];
        __syncthreads();
    }
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
        med_kernel<<<n_tiles, kMedRows, kMedSmem, (cudaStream_t)cs>>>(d, ntx, width, step, out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
