// forge3d_tpu_torch/csrc/codec.cu
// The CUDA kernels of the F3DZ device decode lane C1, for sm_90a, with plain
// C launchers for ctypes (see _kernels.py). Each launcher enqueues on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
//
// C1 entropy  rans_kernel replaces the rANS scan, the escape substitution
//             and the zig-zag step of forge3d_tpu/codec/f3dz_device.py:
//             _tile_decoder (46-101): one block a tile; its 256 threads
//             build the tile's decode table in shared memory (4096 words),
//             then one thread runs the tile's 65,536-step chain and writes
//             the residuals to a (T, 65536) int32 buffer.
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
// tokens take the same time whatever the tile count, up to the ~1,000 tiles
// that fit on the card at once. The design keeps each step to one
// shared-memory lookup on the chain: the table packs the symbol, its
// frequency and the slot's offset in one word, the stream's bytes come from
// a 64-bit register buffer refilled a word ahead, the pulls are counted
// from the top set bit instead of JAX's four dependent compares, and an
// escape's extra is loaded an escape ahead. A first design, which loaded
// each step's four candidate bytes from global memory at the step's start
// and pulled through nested branches, took 8.3185 ms for the 1024^2 page's
// 16 tiles on an H100; a register window of 16-byte chunks with the same
// branches, 9.2666 ms. The reconstruction is bound
// by its 1,276 barrier steps a tile (4 x (64 + 255)) and by bytes: 4 B read
// and 4 B written a pixel. A wavefront over the whole tile in 511 steps,
// one thread a row of 256 with the rows above in a ring, took 0.2189 ms for
// the 1024^2 page on an H100: every step read and wrote 256 rows' worth of
// scattered words. Staging a pass in shared memory keeps every global
// access coalesced.

#include <cuda_runtime.h>

#include "codec.cuh"

namespace {

__global__ void __launch_bounds__(256) rans_kernel(
        const uint8_t* __restrict__ stream, const uint32_t* __restrict__ lens, int cap,
        const uint32_t* __restrict__ freq, const uint32_t* __restrict__ extras, int ecap,
        int32_t* __restrict__ d) {
    __shared__ uint32_t tab[F3DZ_PROB_SCALE];
    __shared__ uint32_t cum[256];
    const int t = blockIdx.x, s = threadIdx.x;
    const uint32_t* f = freq + (size_t)t * 256;
    if (s == 0) {
        uint32_t c = 0;
        for (int k = 0; k < 256; ++k) {
            cum[k] = c;
            c += f[k];
        }
    }
    __syncthreads();
    rans_fill((uint32_t)s, f[s], cum[s], tab);
    __syncthreads();
    if (s == 0)
        rans_chain(tab, stream + (size_t)t * cap, lens[t], (uint32_t)cap,
                   extras + (size_t)t * ecap, ecap, F3DZ_TILE_PX, d + (size_t)t * F3DZ_TILE_PX);
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
    if (n_tiles > 0)
        rans_kernel<<<n_tiles, 256, 0, (cudaStream_t)cs>>>(stream, lens, cap, freq, extras, ecap,
                                                           d);
    return (int)cudaGetLastError();
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
