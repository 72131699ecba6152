#!/usr/bin/env python3
"""Measure the issue-to-use latency, in SM cycles, of the instructions on
C1 entropy's chain (csrc/codec.cuh: rans_chain, rans_fast_step) on the
card: one thread runs a chain of 8,192 dependent instructions of each kind
between two reads of %clock64.

    python3 scripts/sass_latency.py

builds a small CUDA library into build/sass_latency/ with nvcc (sm_90a) and
prints one line a kind: a shared-memory load of 32 and of 64 bits (a
pointer chase), a global load that hits L1 and one that hits L2 (a
pointer chase, with and without its address arithmetic), the integer
multiply-add, a logic operation and an add as a pair, a mask and a
multiply-add as a pair, the funnel shift, a compare feeding a select, the
warp shuffle and a minimum and maximum as a pair (the last two are on C1
reconstruction's chain, csrc/codec.cu: med_kernel); then the opcode counts
of the compiled chains.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build" / "sass_latency"
N_ITERS, UNROLL = 256, 32

SOURCE = r"""
#include <stdint.h>
#define N_ITERS %(iters)d
#define UNROLL %(unroll)d

__device__ __forceinline__ long long clk() {
    long long t;
    asm volatile("mov.u64 %%0, %%%%clock64;" : "=l"(t) :: "memory");
    return t;
}

#define CHAIN(out, body)                                                    \
    do {                                                                    \
        long long t0 = clk();                                               \
        for (int it = 0; it < N_ITERS; ++it) {                              \
            _Pragma("unroll") for (int u = 0; u < UNROLL; ++u) { body; }    \
        }                                                                   \
        asm volatile("" ::"r"(v) : "memory");                               \
        out = clk() - t0;                                                   \
    } while (0)

extern "C" __global__ void lat_kernel(long long* out, uint32_t* sink, const uint32_t* gchase,
                                      uint32_t a, uint32_t b, uint32_t sh) {
    __shared__ uint32_t s32[1024];
    __shared__ uint2 s64[1024];
    for (int i = threadIdx.x; i < 1024; i += blockDim.x) {
        const int j = (i * 7 + 1) & 1023;
        s32[i] = (uint32_t)__cvta_generic_to_shared(&s32[j]);
        s64[i] = make_uint2((uint32_t)__cvta_generic_to_shared(&s64[j]), (uint32_t)i);
    }
    __syncthreads();
    uint32_t v;
    // the warp shuffle up by one lane (every lane of the warp takes part)
    v = a + threadIdx.x;
    CHAIN(out[10], asm volatile("shfl.sync.up.b32 %%0, %%0, 1, 0, 0xffffffff;" : "+r"(v)));
    if (threadIdx.x != 0) return;
    sink[10] = v;
    // shared 32-bit load, the address the last load's value
    v = (uint32_t)__cvta_generic_to_shared(&s32[0]);
    CHAIN(out[0], asm volatile("ld.shared.u32 %%0, [%%0];" : "+r"(v)));
    sink[0] = v;
    // shared 64-bit load
    v = (uint32_t)__cvta_generic_to_shared(&s64[0]);
    CHAIN(out[1], { uint32_t y; asm volatile("ld.shared.v2.u32 {%%0, %%1}, [%%0];" : "+r"(v), "=r"(y)); });
    sink[1] = v;
    // global load hitting L1 (the chase's 1,024 words warmed by a first pass)
    const uint32_t* p = gchase;
    for (int k = 0; k < 1024; ++k) p = gchase + *p;
    v = (uint32_t)(p - gchase);
    CHAIN(out[2], asm volatile("{ .reg .u64 q; mul.wide.u32 q, %%0, 4; add.u64 q, q, %%1; "
                               "ld.global.ca.u32 %%0, [q]; }" : "+r"(v) : "l"(gchase)));
    sink[2] = v;
    // global load hitting L2 (cached at L2 only)
    CHAIN(out[3], asm volatile("{ .reg .u64 q; mul.wide.u32 q, %%0, 4; add.u64 q, q, %%1; "
                               "ld.global.cg.u32 %%0, [q]; }" : "+r"(v) : "l"(gchase)));
    sink[3] = v;
    // the address arithmetic of the two global chases alone
    CHAIN(out[4], asm volatile("{ .reg .u64 q; mul.wide.u32 q, %%0, 4; add.u64 q, q, %%1; "
                               "cvt.u32.u64 %%0, q; }" : "+r"(v) : "l"(gchase)));
    sink[4] = v;
    v = a;
    CHAIN(out[5], asm volatile("mad.lo.u32 %%0, %%0, %%1, %%2;" : "+r"(v) : "r"(a), "r"(b)));
    sink[5] = v;
    // a logic operation then an add: ptxas fuses a run of either alone into
    // one instruction, but not the pair
    CHAIN(out[6], asm volatile("{ lop3.b32 %%0, %%0, %%1, %%2, 0x96; add.u32 %%0, %%0, %%3; }"
                               : "+r"(v) : "r"(a), "r"(b), "r"(sh)));
    sink[6] = v;
    CHAIN(out[7], asm volatile("and.b32 %%0, %%0, 4095; mad.lo.u32 %%0, %%0, %%1, %%2;"
                               : "+r"(v) : "r"(a), "r"(b)));
    sink[7] = v;
    CHAIN(out[8], asm volatile("shf.l.wrap.b32 %%0, %%1, %%0, %%2;" : "+r"(v) : "r"(b), "r"(sh)));
    sink[8] = v;
    CHAIN(out[9], asm volatile("{ .reg .pred p; setp.ge.u32 p, %%0, %%1; selp.b32 %%0, %%2, %%3, p; }"
                               : "+r"(v) : "r"(b), "r"(a), "r"(b ^ 0x55u)));
    sink[9] = v;
    // a signed minimum then a maximum (IMNMX twice)
    v = a;
    CHAIN(out[11], asm volatile("{ min.s32 %%0, %%0, %%1; max.s32 %%0, %%0, %%2; }"
                                : "+r"(v) : "r"(b), "r"(sh)));
    sink[11] = v;
}

extern "C" int lat_run(long long* out, uint32_t* sink, const uint32_t* gchase, uint32_t a,
                       uint32_t b, uint32_t sh) {
    lat_kernel<<<1, 32>>>(out, sink, gchase, a, b, sh);
    cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) e = cudaDeviceSynchronize();
    return (int)e;
}
"""

KINDS = ("LDS.32 (shared load, pointer chase)", "LDS.64 (shared 64-bit load)",
         "LDG, L1 hit (with its IMAD.WIDE + IADD address)",
         "LDG, L2 hit (with its IMAD.WIDE + IADD address)",
         "the global chase's address (IMAD.WIDE + IADD) alone", "IMAD (mad.lo.u32)",
         "LOP3 then IADD3 (a pair)", "LOP3 (and) then IMAD (a pair)", "SHF.L.W (funnel shift)",
         "ISETP + SEL (compare into a select)", "SHFL.UP (warp shuffle, every lane)",
         "IMNMX then IMNMX (a min and a max, a pair)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sass_latency: CUDA is not available", file=sys.stderr)
        return 1
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    nvcc = nvcc if os.path.exists(nvcc) else shutil.which("nvcc")
    BUILD.mkdir(parents=True, exist_ok=True)
    src = BUILD / "lat.cu"
    src.write_text(SOURCE % {"iters": N_ITERS, "unroll": UNROLL})
    lib = BUILD / "liblat.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.lat_run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_uint] * 3
    so.lat_run.restype = ctypes.c_int
    dev = torch.device("cuda")
    out = torch.zeros(len(KINDS), dtype=torch.int64, device=dev)
    sink = torch.zeros(len(KINDS), dtype=torch.int32, device=dev)
    chase = torch.as_tensor([(i * 7 + 1) & 1023 for i in range(1024)], dtype=torch.int32,
                            device=dev)
    n = N_ITERS * UNROLL
    for run in range(2):      # the first run also loads the module
        err = so.lat_run(out.data_ptr(), sink.data_ptr(), chase.data_ptr(), 0x9E3779B9,
                         0x01234567, 8)
        if err:
            raise RuntimeError(f"lat_kernel: CUDA error {err}")
    print(f"{torch.cuda.get_device_name(0)}: cycles an instruction (or pair), {n} dependent "
          f"each")
    for kind, cycles in zip(KINDS, out.tolist()):
        print(f"  {kind}: {cycles / n:.2f}")
    # what ptxas made of the chains: each chain should be its 8,192 instructions
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import sass_dump

    sass = subprocess.run([sass_dump.cuobjdump(), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for name, text in sass_dump.functions(sass).items():
        c = sass_dump.mix(text)
        print(f"  SASS of {name}: " + ", ".join(f"{op} {k}" for op, k in c.most_common(14)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
