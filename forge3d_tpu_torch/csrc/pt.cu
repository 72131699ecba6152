// forge3d_tpu_torch/csrc/pt.cu
// The SDF, TLAS and hybrid path-tracing kernels, for sm_90a, with plain C
// launchers for ctypes (see _kernels.py). Each launcher enqueues on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
//
// P6 sdf_eval_kernel    replaces forge3d_tpu/ops/sdf.py:SdfScene.evaluate (223)
//    sdf_normal_kernel  replaces forge3d_tpu/ops/sdf.py:SdfScene.normal (339)
//    sdf_march_kernel   replaces forge3d_tpu/ops/sdf.py:SdfScene.raymarch (348)
// P5 tlas_kernel        replaces forge3d_tpu/ops/tlas.py:trace_tlas (86)
// P3 hybrid_kernel      replaces forge3d_tpu/pt/hybrid.py:_trace_all (77) and
//                       hybrid_render (154)
//
// One thread per point, ray or pixel (sdf.cuh, pt.cuh). The JAX versions
// step every lane of a batch in lock step (the tape's fori_loop, the
// march's while_loop, the per-instance BVH loops); here each thread runs
// its own loops to their ends. What bounds them: the tape loop is issue,
// the same dispatch, reads and stack moves on every thread around ~20
// operations an entry (sdf.cuh); the march is that times the steps its ray
// takes (97% of a warp's lanes busy on bench.py's camera rays); the
// hybrid's mesh and terrain traces are chains of dependent loads, as K9 and
// K5 are. The TLAS walk was issue in its instance loop (each instance's
// transform, its MeshArgs through a chain of loads, three reciprocals and
// the root box, for every ray: with every walk cut at its root box it kept
// 82-95% of its time on J, where 0.5% of (ray, instance) pairs enter a
// root): here a block reads the table from shared memory and a ray pays
// the cull's world-space box test an instance, the transform and the walk
// only where it may hit.
//
// P6's three kernels are instantiated two ways: the packed tape in shared
// memory (each block copies it once) or, for tapes longer than
// F3D_SDF_SHARED, read through the read-only cache. The launchers pick by
// the tape (sdf_in_shared); both give the same bits.

#include <cuda_runtime.h>

#include "pt.cuh"

// the block's copy of P6's packed tape (sdf.cuh): 3 * tape_len 16-byte words
extern __shared__ float4 sdf_shared[];

namespace {

constexpr int kThreads = 128;
constexpr int kTileThreads = 256;
constexpr int kHybridBlocks = 3;   // P3's minimum of resident blocks (see hybrid_kernel)

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <bool kShared>
__device__ __forceinline__ const float* sdf_block_tape(const SdfArgs& s) {
    if (!kShared) return s.tape;
    const float4* g = reinterpret_cast<const float4*>(s.tape);
    for (int k = threadIdx.x; k < 3 * s.tape_len; k += blockDim.x) sdf_shared[k] = __ldg(g + k);
    __syncthreads();
    return reinterpret_cast<const float*>(sdf_shared);
}

template <bool kShared>
__global__ void sdf_eval_kernel(SdfArgs s, const float* __restrict__ px,
                                const float* __restrict__ py, const float* __restrict__ pz,
                                int n, float* __restrict__ d, int* __restrict__ mat) {
    const float* tape = sdf_block_tape<kShared>(s);
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int m;
    d[i] = sdf_eval_t<!kShared>(tape, s.tape_len, px[i], py[i], pz[i], m);
    mat[i] = m;
}

template <bool kShared>
__global__ void sdf_normal_kernel(SdfArgs s, const float* __restrict__ px,
                                  const float* __restrict__ py, const float* __restrict__ pz,
                                  int n, float eps, float* __restrict__ out) {
    const float* tape = sdf_block_tape<kShared>(s);
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    sdf_normal_t<!kShared>(tape, s.tape_len, px[i], py[i], pz[i], eps, out[i], out[n + i],
                           out[2 * n + i]);
}

template <bool kShared>
__global__ void sdf_march_kernel(SdfArgs s, const float* __restrict__ rox,
                                 const float* __restrict__ roy, const float* __restrict__ roz,
                                 const float* __restrict__ rdx, const float* __restrict__ rdy,
                                 const float* __restrict__ rdz, int n, float tmin, float tmax,
                                 int max_steps, float hit_eps, unsigned char* __restrict__ hit,
                                 float* __restrict__ t, int* __restrict__ mat) {
    const float* tape = sdf_block_tape<kShared>(s);
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    SdfHit h = sdf_march_t<!kShared>(tape, s.tape_len, rox[i], roy[i], roz[i], rdx[i], rdy[i],
                                     rdz[i], tmin, tmax, max_steps, hit_eps);
    hit[i] = (unsigned char)h.hit;
    t[i] = h.t;
    mat[i] = h.material;
}

// the instantiation of P6 kernel K that the tape `s` takes, K<shared> in
// `fn`, and its dynamic shared memory
#define F3D_SDF_PICK(K, s, fn, shmem)                                                   \
    const bool sh_ = sdf_in_shared(s);                                                  \
    const size_t shmem = sh_ ? (size_t)(s).tape_len * F3D_SDF_WORDS * sizeof(float) : 0; \
    const void* fn = sh_ ? (const void*)K<true> : (const void*)K<false>

static_assert(sizeof(TlasInst) == 128, "TlasInst is staged as eight 16-byte words");
constexpr int kInstWords = (int)(sizeof(TlasInst) / sizeof(int4));

#ifdef F3D_P5_CULL_CHECK
// measurement build: {(ray, instance) pairs the cull rejects where the
// walk's root test accepts (must stay 0), pairs the cull rejects}
__device__ unsigned long long tlas_check[2];
#endif

// P5: a thread a ray, the instances' table staged F3D_TLAS_CHUNK at a time
// (every thread reaches each barrier; rays past n only help stage)
__global__ void __launch_bounds__(kThreads)
tlas_kernel(TlasArgs a, const float* __restrict__ rox, const float* __restrict__ roy,
            const float* __restrict__ roz, const float* __restrict__ rdx,
            const float* __restrict__ rdy, const float* __restrict__ rdz, int n, float tmin,
            float tmax, unsigned char* __restrict__ hit, float* __restrict__ t,
            int* __restrict__ inst, int* __restrict__ prim, float* __restrict__ u,
            float* __restrict__ v) {
    __shared__ int4 stage[F3D_TLAS_CHUNK * kInstWords];
    const TlasInst* st = reinterpret_cast<const TlasInst*>(stage);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    const int j = live ? i : 0;
    const TlasRay r = tlas_ray_of(rox[j], roy[j], roz[j], rdx[j], rdy[j], rdz[j]);
    TlasHit b = tlas_miss(tmax);
    for (int c0 = 0; c0 < a.n_inst; c0 += F3D_TLAS_CHUNK) {
        const int m = min(F3D_TLAS_CHUNK, a.n_inst - c0);
        __syncthreads();   // the last chunk's visits are done
        const int4* g = reinterpret_cast<const int4*>(a.inst + c0);
        for (int k = threadIdx.x; k < m * kInstWords; k += blockDim.x) stage[k] = __ldg(g + k);
        __syncthreads();
        if (!live) continue;
        for (int q = 0; q < m; ++q) {
            if (tlas_cull(st[q], r, tmin, tmax)) {
                tlas_walk(st[q], c0 + q, r, tmin, tmax, b);
                continue;
            }
#ifdef F3D_P5_CULL_CHECK
            atomicAdd(&tlas_check[1], 1ull);
            if (tlas_root_accepts(st[q], r, tmin, tmax)) atomicAdd(&tlas_check[0], 1ull);
#endif
        }
    }
    if (!live) return;
    hit[i] = (unsigned char)b.hit;
    t[i] = b.t;
    inst[i] = b.instance;
    prim[i] = b.prim;
    u[i] = b.u;
    v[i] = b.v;
}

// P3 in K6's tiles: a block 16x16 pixels, a warp 8x4 (neighbouring rays
// walk the same terrain nodes and BVH boxes, and cross the cull box
// together). The minimum of 3 blocks pins its build on an H100: 68
// registers, 3 resident blocks, 1.86 ms at 1080p. Without it nvcc chose 49
// registers and 4 blocks (no bound, 1.98 ms) or 48 and 5 (a maximum of 256
// threads alone, 2.07 ms); a minimum of 4 (58 registers) was 3% slower
// (PERF.md §6). The SDF's tape is read through the read-only cache: few
// rays march it (the cull box).
__global__ void __launch_bounds__(kTileThreads, kHybridBlocks)
hybrid_kernel(SceneArgs s, MeshArgs m, SdfArgs sdf, HybridArgs a, const float* __restrict__ rdx,
              const float* __restrict__ rdy, const float* __restrict__ rdz, HybridOut o) {
    const int tiles_x = (a.width + 15) / 16;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int x = (blockIdx.x % tiles_x) * 16 + (warp & 1) * 8 + (lane & 7);
    const int y = (blockIdx.x / tiles_x) * 16 + (warp >> 1) * 4 + (lane >> 3);
    if (x >= a.width || y >= a.height) return;
    hybrid_pixel(s, m, sdf, a, rdx, rdy, rdz, o, y * a.width + x);
}

}  // namespace

extern "C" {

// P6's launchers: cudaLaunchKernel with the instantiation F3D_SDF_PICK chose
int f3d_sdf_eval(const SdfArgs* s, const float* px, const float* py, const float* pz, int n,
                 float* d, int* mat, void* stream) {
    if (n > 0) {
        F3D_SDF_PICK(sdf_eval_kernel, *s, fn, shmem);
        void* args[] = {(void*)s, &px, &py, &pz, &n, &d, &mat};
        cudaLaunchKernel(fn, blocks_for(n), kThreads, args, shmem, (cudaStream_t)stream);
    }
    return (int)cudaGetLastError();
}

int f3d_sdf_normal(const SdfArgs* s, const float* px, const float* py, const float* pz, int n,
                   float eps, float* out, void* stream) {
    if (n > 0) {
        F3D_SDF_PICK(sdf_normal_kernel, *s, fn, shmem);
        void* args[] = {(void*)s, &px, &py, &pz, &n, &eps, &out};
        cudaLaunchKernel(fn, blocks_for(n), kThreads, args, shmem, (cudaStream_t)stream);
    }
    return (int)cudaGetLastError();
}

int f3d_sdf_march(const SdfArgs* s, const float* rox, const float* roy, const float* roz,
                  const float* rdx, const float* rdy, const float* rdz, int n, float tmin,
                  float tmax, int max_steps, float hit_eps, unsigned char* hit, float* t,
                  int* mat, void* stream) {
    if (n > 0) {
        F3D_SDF_PICK(sdf_march_kernel, *s, fn, shmem);
        void* args[] = {(void*)s, &rox, &roy, &roz, &rdx,      &rdy, &rdz, &n,
                        &tmin,    &tmax, &max_steps, &hit_eps, &hit, &t,   &mat};
        cudaLaunchKernel(fn, blocks_for(n), kThreads, args, shmem, (cudaStream_t)stream);
    }
    return (int)cudaGetLastError();
}

// the march kernel that tape `s` takes: out = {registers a thread, local
// (spilled and stack) bytes a thread, resident blocks of 128 an SM, 1 if
// the tape is in shared memory}
int f3d_sdf_march_attrs(const SdfArgs* s, int* out) {
    F3D_SDF_PICK(sdf_march_kernel, *s, fn, shmem);
    out[3] = sh_;
    cudaFuncAttributes at;
    cudaError_t e = cudaFuncGetAttributes(&at, fn);
    if (e != cudaSuccess) return (int)e;
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, kThreads, shmem);
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = resident;
    return (int)e;
}

int f3d_trace_tlas(const TlasArgs* a, const float* rox, const float* roy, const float* roz,
                   const float* rdx, const float* rdy, const float* rdz, int n, float tmin,
                   float tmax, unsigned char* hit, float* t, int* inst, int* prim, float* u,
                   float* v, void* stream) {
    if (n > 0)
        tlas_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            *a, rox, roy, roz, rdx, rdy, rdz, n, tmin, tmax, hit, t, inst, prim, u, v);
    return (int)cudaGetLastError();
}

int f3d_hybrid_render(const SceneArgs* s, const MeshArgs* m, const SdfArgs* sdf,
                      const HybridArgs* a, const float* rdx, const float* rdy, const float* rdz,
                      const HybridOut* o, void* stream) {
    if (a->width > 0 && a->height > 0)
        hybrid_kernel<<<((a->width + 15) / 16) * ((a->height + 15) / 16), kTileThreads, 0,
                        (cudaStream_t)stream>>>(*s, *m, *sdf, *a, rdx, rdy, rdz, *o);
    return (int)cudaGetLastError();
}

// P3's kernel: out = {registers a thread, local (spilled) bytes a thread,
// resident blocks an SM}
int f3d_hybrid_attrs(int* out) {
    return f3d_kernel_attrs((const void*)hybrid_kernel, kTileThreads, out);
}

// P5's kernel: out = {registers a thread, local bytes a thread, resident
// blocks of kThreads an SM, shared bytes a block, instances a staged chunk,
// then the bits of mesh_inv's limits F3D_MESH_INV_MIN and
// F3D_MESH_INV_CLAMP, which the cull's margin takes}
int f3d_tlas_attrs(int* out) {
    const int e = f3d_kernel_attrs((const void*)tlas_kernel, kThreads, out);
    const float limits[2] = {F3D_MESH_INV_MIN, F3D_MESH_INV_CLAMP};
    out[3] = (int)(F3D_TLAS_CHUNK * sizeof(TlasInst));
    out[4] = F3D_TLAS_CHUNK;
    memcpy(out + 5, limits, sizeof(limits));
    return e;
}

#ifdef F3D_P5_CULL_CHECK
// measurement build: out = tlas_check's two counts, then zeroes them
int f3d_tlas_cull_check(long long* out) {
    unsigned long long h[2] = {0, 0};
    const unsigned long long zero[2] = {0, 0};
    cudaError_t e = cudaMemcpyFromSymbol(h, tlas_check, sizeof(h));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(tlas_check, zero, sizeof(zero));
    out[0] = (long long)h[0];
    out[1] = (long long)h[1];
    return (int)e;
}
#endif

}  // extern "C"
