#!/usr/bin/env python3
"""Time C1 entropy's fast step alone: one thread runs a tile's 65,536 steps
(csrc/codec.cuh: rans_fast_chunk, the symbols packed and stored to shared
memory as the kernel's chain thread does) on tables and a stream ring in
shared memory, with no helper warps and no barriers, between two reads of
%clock64; beside it, variants of the step, each checked to decode the
same symbols.

    python3 scripts/rans_chain.py

builds a small CUDA library into build/rans_chain/ with nvcc (sm_90a, the
port's flags) over forge3d_tpu_torch/csrc/codec.cuh, and takes tile 0 of
phase 32's 1024^2 page at max_error 0.1 (chip_smoke.codec_pages, the C++
encoder): its table, and its stream's first 16 KB in the ring (the ring
wraps, so past 16 KB the chain decodes other bytes; the step's pulls stay
those of a real stream). Prints cycles a token for each variant:
  first    the first staged design's step: the table index formed from the
           selected state (a shift and a mask), the window's next word from
           two 32-bit loads of a ring of words;
  addr     "first" with the three pull counts' table offsets formed beside
           the compares (a funnel shift and a mask each) and selected, so
           the lookup follows the selects with no shift and mask between;
  noring   a diagnostic: "first" with the window's next word from registers,
           not the ring (it decodes other bytes, so its check differs);
  kernel   rans_fast_step as the kernel runs it: "addr" with the window's
           next word from one 64-bit load of a ring of overlapping word
           pairs (entry i holds words i and i + 1);
  slots    "kernel" storing each token's table offset (16 bits) instead of
           loading its symbol (its check looks each chunk's last symbol up
           from the stored offset, as a drain would).
Each check is the final state and the sum of each chunk's last symbol.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build" / "rans_chain"

SOURCE = r"""
#include <cuda_runtime.h>
#include "codec.cuh"

__device__ __forceinline__ long long clk() {
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
    return t;
}

// the table's byte offset of a state's slot: (x & 0xfff) * 8
F3D_HD uint32_t slot_off(uint32_t hi, uint32_t nx, uint32_t sh) {
    return rans_slot_off(hi, nx, sh);
}

// variant "first": the first staged design's step (the table index from the
// state, the window's next word from two 32-bit loads of a word ring)
struct First {
    uint32_t x, hi, lo, pb;
};

F3D_HD uint32_t step_first(const uint2* tab, const uint8_t* sym, const uint32_t* ring, First& c) {
    const uint32_t slot = c.x & (F3DZ_PROB_SCALE - 1u);
    const uint2 e = tab[slot];
    const uint32_t w = (c.pb >> 5) + 2u;
    const uint32_t r = rans_funnel(ring[(w + 1u) & (F3DZ_RING_WORDS - 1u)],
                                   ring[w & (F3DZ_RING_WORDS - 1u)], c.pb);
    const uint32_t nx = e.x * (c.x >> F3DZ_PROB_BITS) + e.y;
    const uint32_t x1 = rans_funnel(c.hi, nx, 8u), x2 = rans_funnel(c.hi, nx, 16u);
    const bool none = nx >= F3DZ_RANS_LO, one = nx >= (1u << 15);
    const uint32_t sh = none ? 0u : (one ? 8u : 16u);
    c.x = none ? nx : (one ? x1 : x2);
    const uint32_t hi = c.hi;
    c.hi = rans_funnel(c.lo, hi, sh);
    c.lo = rans_funnel(r, c.lo, sh);
    c.pb += sh;
    return sym[slot];
}

// variant "addr": the table offset of each pull count's state formed beside
// the compares, then selected with the state
F3D_HD uint32_t step_addr(const unsigned char* tabb, const uint8_t* sym, const uint32_t* ring,
                          First& c, uint32_t& off) {
    const uint2 e = *reinterpret_cast<const uint2*>(tabb + off);
    const uint32_t slot = off >> 3;
    const uint32_t w = (c.pb >> 5) + 2u;
    const uint32_t r = rans_funnel(ring[(w + 1u) & (F3DZ_RING_WORDS - 1u)],
                                   ring[w & (F3DZ_RING_WORDS - 1u)], c.pb);
    const uint32_t nx = e.x * (c.x >> F3DZ_PROB_BITS) + e.y;
    const bool none = nx >= F3DZ_RANS_LO, one = nx >= (1u << 15);
    const uint32_t o0 = slot_off(c.hi, nx, 0u), o1 = slot_off(c.hi, nx, 8u),
                   o2 = slot_off(c.hi, nx, 16u);
    off = none ? o0 : (one ? o1 : o2);
    const uint32_t x1 = rans_funnel(c.hi, nx, 8u), x2 = rans_funnel(c.hi, nx, 16u);
    const uint32_t sh = none ? 0u : (one ? 8u : 16u);
    c.x = none ? nx : (one ? x1 : x2);
    const uint32_t hi = c.hi;
    c.hi = rans_funnel(c.lo, hi, sh);
    c.lo = rans_funnel(r, c.lo, sh);
    c.pb += sh;
    return sym[slot];
}

// diagnostic "noring": step_first with the window's next word taken
// from registers instead of the ring (it decodes other bytes): the ring's
// loads' share of the step
F3D_HD uint32_t step_noring(const uint2* tab, const uint8_t* sym, First& c) {
    const uint32_t slot = c.x & (F3DZ_PROB_SCALE - 1u);
    const uint2 e = tab[slot];
    const uint32_t r = c.lo ^ c.pb;
    const uint32_t nx = e.x * (c.x >> F3DZ_PROB_BITS) + e.y;
    const uint32_t x1 = rans_funnel(c.hi, nx, 8u), x2 = rans_funnel(c.hi, nx, 16u);
    const bool none = nx >= F3DZ_RANS_LO, one = nx >= (1u << 15);
    const uint32_t sh = none ? 0u : (one ? 8u : 16u);
    c.x = none ? nx : (one ? x1 : x2);
    const uint32_t hi = c.hi;
    c.hi = rans_funnel(c.lo, hi, sh);
    c.lo = rans_funnel(r, c.lo, sh);
    c.pb += sh;
    return sym[slot];
}

// variant "slots": rans_fast_step storing each token's table offset
// (16 bits) instead of loading its symbol (the drain would look it up)
F3D_HD uint32_t step_slots(const unsigned char* tab, const uint2* ring, RansFast& c) {
    const uint32_t o = c.off;
    const uint2 e = *reinterpret_cast<const uint2*>(tab + c.off);
    const uint2 w = ring[((c.pb >> 5) + 2u) & (F3DZ_RING_WORDS - 1u)];
    const uint32_t r = rans_funnel(w.y, w.x, c.pb);
    const uint32_t nx = e.x * (c.x >> F3DZ_PROB_BITS) + e.y;
    const bool none = nx >= F3DZ_RANS_LO, one = nx >= (1u << 15);
    const uint32_t o0 = rans_slot_off(c.hi, nx, 0u), o1 = rans_slot_off(c.hi, nx, 8u),
                   o2 = rans_slot_off(c.hi, nx, 16u);
    c.off = none ? o0 : (one ? o1 : o2);
    const uint32_t x1 = rans_funnel(c.hi, nx, 8u), x2 = rans_funnel(c.hi, nx, 16u);
    const uint32_t sh = none ? 0u : (one ? 8u : 16u);
    c.x = none ? nx : (one ? x1 : x2);
    const uint32_t hi = c.hi;
    c.hi = rans_funnel(c.lo, hi, sh);
    c.lo = rans_funnel(r, c.lo, sh);
    c.pb += sh;
    return o;
}

extern "C" __global__ void chain_kernel(const uint2* gtab, const uint8_t* gsym,
                                        const uint32_t* gring, int variant, long long* cycles,
                                        uint32_t* check) {
    extern __shared__ __align__(16) unsigned char sm[];
    uint2* tab = reinterpret_cast<uint2*>(sm);
    uint32_t* ring = reinterpret_cast<uint32_t*>(sm + 32768);
    uint32_t* out = reinterpret_cast<uint32_t*>(sm + 49152);   // two chunks' tokens
    uint8_t* sym = sm + 57344;
    uint2* pairs = reinterpret_cast<uint2*>(sm + 61440);
    for (int i = threadIdx.x; i < 4096; i += blockDim.x) {
        tab[i] = gtab[i];
        sym[i] = gsym[i];
        ring[i] = gring[i];
        pairs[i] = make_uint2(gring[i], gring[(i + 1) & 4095]);
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    First f;
    f.x = ring[0];
    f.hi = ring[1];
    f.lo = ring[2];
    f.pb = 32u;
    RansFast c = rans_fast_start(pairs);
    uint32_t sum = 0, off = (f.x & (F3DZ_PROB_SCALE - 1u)) << 3;
    long long t0 = clk();
    for (int k = 0; k < 32; ++k) {
        uint32_t* o = out + (k & 1) * 512;
        if (variant == 0) {
            for (int g = 0; g < 512; ++g) {
                uint32_t v = step_first(tab, sym, ring, f);
                v |= step_first(tab, sym, ring, f) << 8;
                v |= step_first(tab, sym, ring, f) << 16;
                v |= step_first(tab, sym, ring, f) << 24;
                o[g] = v;
            }
        } else if (variant == 1) {
            for (int g = 0; g < 512; ++g) {
                uint32_t v = step_addr(sm, sym, ring, f, off);
                v |= step_addr(sm, sym, ring, f, off) << 8;
                v |= step_addr(sm, sym, ring, f, off) << 16;
                v |= step_addr(sm, sym, ring, f, off) << 24;
                o[g] = v;
            }
        } else if (variant == 2) {
            for (int g = 0; g < 512; ++g) {
                uint32_t v = step_noring(tab, sym, f);
                v |= step_noring(tab, sym, f) << 8;
                v |= step_noring(tab, sym, f) << 16;
                v |= step_noring(tab, sym, f) << 24;
                o[g] = v;
            }
        } else if (variant == 3) {
            rans_fast_chunk(sm, sym, pairs, c, o, 512);
        } else {
            uint2* o2 = reinterpret_cast<uint2*>(out) + (k & 1) * 512;
            for (int g = 0; g < 512; ++g) {
                uint32_t a = step_slots(sm, pairs, c);
                a |= step_slots(sm, pairs, c) << 16;
                uint32_t b = step_slots(sm, pairs, c);
                b |= step_slots(sm, pairs, c) << 16;
                o2[g] = make_uint2(a, b);
            }
            // the chunk's last symbol, looked up from its offset as a drain would
            sum += sym[(o2[511].y >> 16) >> 3];
            continue;
        }
        sum += o[511] >> 24;   // the chunk's last symbol
    }
    cycles[variant] = clk() - t0;
    check[variant] = sum ^ (variant < 3 ? f.x : c.x);
}

extern "C" int chain_run(const void* tab, const void* sym, const void* ring, int variant,
                         long long* cycles, uint32_t* check) {
    cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 94208);
    chain_kernel<<<1, 256, 94208>>>((const uint2*)tab, (const uint8_t*)sym,
                                    (const uint32_t*)ring, variant, cycles, check);
    cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) e = cudaDeviceSynchronize();
    return (int)e;
}
"""

VARIANTS = ("first", "addr", "noring", "kernel", "slots")


def tile_inputs():
    """Tile 0 of phase 32's 1024^2 page at max_error 0.1: the fast table
    (freq, slot - cum), the symbols, and the stream's first 4,096 words,
    big-endian, zero past its length."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from forge3d_tpu_torch import codec
    from forge3d_tpu_torch.codec import f3dz_device as fd

    page = fd.parse_page(codec.compress_dem(chip_smoke.codec_pages()["1024^2"], 0.1))
    f = page.freq[0].astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(f)[:-1]])
    sym = np.repeat(np.arange(256), f).astype(np.uint8)
    slot = np.arange(4096)
    tab = np.stack([f[sym], slot - cum[sym]], -1).astype(np.uint32)
    row = page.stream[0].copy()
    row[int(page.lens[0]):] = 0
    raw = np.zeros(4096 * 4, np.uint8)
    raw[:min(len(row), raw.size)] = row[:raw.size]
    ring = raw.view(">u4").astype(np.uint32)
    return tab, sym, ring


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("rans_chain: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from forge3d_tpu_torch import _kernels

    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    nvcc = nvcc if os.path.exists(nvcc) else shutil.which("nvcc")
    BUILD.mkdir(parents=True, exist_ok=True)
    src = BUILD / "chain.cu"
    src.write_text(SOURCE)
    lib = BUILD / "libchain.so"
    subprocess.run([nvcc, *_kernels.NVCC_FLAGS, "-shared", "-I", str(_kernels.CSRC), "-o",
                    str(lib), str(src)], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    so.chain_run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    so.chain_run.restype = ctypes.c_int
    dev = torch.device("cuda")
    tab, sym, ring = (torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a,
                                      device=dev) for a in tile_inputs())
    cycles = torch.zeros(len(VARIANTS), dtype=torch.int64, device=dev)
    check = torch.zeros(len(VARIANTS), dtype=torch.int32, device=dev)
    for _ in range(2):
        for v in range(len(VARIANTS)):
            err = so.chain_run(tab.data_ptr(), sym.data_ptr(), ring.data_ptr(), v,
                               cycles.data_ptr(), check.data_ptr())
            if err:
                raise RuntimeError(f"chain_kernel: CUDA error {err}")
    print(f"{torch.cuda.get_device_name(0)}: C1's fast step alone, one thread, 65,536 tokens")
    for name, cyc, chk in zip(VARIANTS, cycles.tolist(), check.tolist()):
        print(f"  {name}: {cyc / 65536:.2f} cycles a token (check {chk & 0xffffffff:08x})")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import sass_dump

    sass = subprocess.run([sass_dump.cuobjdump(), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = BUILD / "chain.sass"
    out.write_text(sass)
    print(f"  SASS in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
