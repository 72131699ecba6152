// forge3d_tpu_torch/csrc/smoke.cu
// The CUDA kernels of the smoke path, for sm_90a, with plain C launchers for
// ctypes (see _kernels.py). Each launcher enqueues on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
//
// E8 step        replaces forge3d_tpu/smoke.py:SmokeDomain._build_step (206,
//                jitted at 269) with _trilinear (87) and the Jacobi
//                fori_loop (251-255): per step, with j = jacobi_iters,
//   advect_velocity_kernel   the forces (223-227) and the self-advection
//                            (230): the forced velocity is formed at each
//                            corner the samples read (smoke.cuh:SmokeForced),
//                            never stored;
//   divergence_kernel        div_of (242-246) and, for j >= 2, the first
//                            sweep from zeros, (0 - div) / 6;
//   jacobi_kernel            the other j - 1 sweeps, up to F3D_JAC_LEVELS a
//                            launch, in bricks staged in shared memory
//                            (smoke.cuh:jac_brick); one sweep (j = 1) has
//                            no launch of its own: it runs inside the
//                            projection, where XLA unrolls it;
//   project_advect_kernel    the projection (256-259) fused with the four
//                            scalar advections (262-266): each voxel
//                            backtraces with its own projected velocity.
//                A step is 2 launches at j = 0, 3 at j = 1 and
//                3 + ceil((j - 1) / F3D_JAC_LEVELS) from j = 2.
// E8 march       replaces smoke.py:SmokeDomain.render_rgba (332), its
//                lax.fori_loop (429) over body (403-425) with sun_trans
//                (394-401): two launches,
//   march_check_kernel       one pass over the three grids into a device
//                            flag: some value outside the skip's bounds
//                            (smoke.cuh:smoke_skip_voxel_ok);
//   march_kernel             one thread a pixel, a warp an 8x4 tile, the ray
//                            and slab set-up, the steps with the sun march
//                            inside, the background, the tonemap and the u8
//                            pack. Where the flag stayed clear, a ray that
//                            misses the box skips its steps: the TPU marches
//                            every lane through the fori_loop, but on the card
//                            such a thread is done at once, and the result is
//                            the same bit for bit. The flag is read on the
//                            device: the host never waits for it.
//
// What bounds them on the H100. The step moves bytes: W's 256x50x256 domain
// holds 13.1 MB a grid, and its ~56 B a voxel (the seven grids read, the
// velocity and the four scalars written) take 0.055 ms at 3.35 TB/s; the
// sweeps' pressure and divergence (26 MB) stay in the 50 MB L2 between
// launches. The advection and the projection are one thread a voxel, x
// fastest across a warp, their samples' gathers through the caches. A sweep
// a launch moved three grids through L2 a level (~30 us at W); a brick
// launch moves them once for up to F3D_JAC_LEVELS levels, with its halos'
// share again, and runs its levels from registers (a thread's z column) and
// shared memory (the published planes, the divergence). Its sizes and k have
// one home, smoke.cuh:F3D_JAC_*, which f3d_jacobi_attrs reports. The march does
// operations: (3 + sun_steps) trilinear samples a step, eight gathers and
// seven lerps each, on grids that fit in L2, for the pixels whose rays
// enter the box; one thread a pixel walks its steps in registers. A warp's
// 8x4 pixels sample neighbouring voxels in y as well as x. The march's
// constants are a kernel parameter (SmokeMarchArgs); the sun offsets stay a
// device buffer, read at one address across a warp (staging them in shared
// memory measured no faster). Texture or TMA paths for the gathers are
// later work.

#include <atomic>
#include <cuda_runtime.h>

#include "smoke.cuh"

namespace {

constexpr int kThreads = 256;

int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

__global__ void advect_velocity_kernel(SmokeForced f, float* __restrict__ va, int nx, int ny,
                                       int nz, float dt, int forms) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)nx * ny * nz) return;
    smoke_advect_velocity_voxel(f, va, nx, ny, nz, dt, forms, i);
}

__global__ void divergence_kernel(const float* __restrict__ va, float* __restrict__ div,
                                  float* __restrict__ p1, int nx, int ny, int nz, float sixth) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)nx * ny * nz) return;
    smoke_divergence_voxel(va, div, p1, nx, ny, nz, sixth, i);
}

// a CTA a brick (smoke.cuh:jac_brick), a thread a column of the pressure in
// registers; the shared memory holds the published level and the divergence
__global__ void __launch_bounds__(F3D_JAC_THREADS, 1024 / F3D_JAC_THREADS)
jacobi_kernel(const float* __restrict__ p, const float* __restrict__ div,
              float* __restrict__ p_out, int nx, int ny, int nz, float sixth, int levels) {
    extern __shared__ float sm[];
    float* const dsm = sm + F3D_JAC_PLANES;
    float cp[F3D_JAC_SZ];
    jac_load(jac_brick(nx, ny, nz, blockIdx.x), threadIdx.x, p, div, cp, dsm);
    const JacColumn c = jac_column(jac_brick(nx, ny, nz, blockIdx.x), threadIdx.x);
    for (int l = 0; l < levels; ++l) {
        __syncthreads();
        jac_publish(cp, sm, threadIdx.x);
        __syncthreads();
        jac_level(c, cp, sm, dsm, sixth);
    }
    jac_store(jac_brick(nx, ny, nz, blockIdx.x), threadIdx.x, cp, p_out);
}

constexpr int kJacSmem = 2 * F3D_JAC_PLANES * (int)sizeof(float);

// jacobi_kernel's shared memory is past the 48 KB a launch takes without
// opting in: opt in once a device for the process (a bit a device below 64;
// past that at every call), not at every launch
cudaError_t jacobi_opt_in() {
    static std::atomic<unsigned long long> done{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned long long bit = dev < 64 ? 1ULL << dev : 0ULL;
    if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
    e = cudaFuncSetAttribute(jacobi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kJacSmem);
    if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
    return e;
}

__global__ void project_advect_kernel(const float* __restrict__ va, const float* __restrict__ p,
                                      const float* __restrict__ div,
                                      const float* __restrict__ dens,
                                      const float* __restrict__ temp,
                                      const float* __restrict__ soot,
                                      const float* __restrict__ emis, float* __restrict__ vel_out,
                                      float* __restrict__ dens_out, float* __restrict__ temp_out,
                                      float* __restrict__ soot_out, float* __restrict__ emis_out,
                                      int nx, int ny, int nz, float dt, float keep, float keep2,
                                      float sixth) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)nx * ny * nz) return;
    smoke_project_advect_voxel(va, p, div, dens, temp, soot, emis, vel_out, dens_out, temp_out,
                               soot_out, emis_out, nx, ny, nz, dt, keep, keep2, sixth, i);
}

// Any voxel outside the skip's bounds sets *bad (zeroed by the caller).
__global__ void march_check_kernel(const float* __restrict__ dens,
                                   const float* __restrict__ emis,
                                   const float* __restrict__ soot, long long n,
                                   int* __restrict__ bad) {
    bool out = false;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x)
        out = out || !smoke_skip_voxel_ok(dens[i], emis[i], soot[i]);
    if (__any_sync(0xffffffffu, out) && (threadIdx.x & 31) == 0) atomicOr(bad, 1);
}

// A block is a 16x16 tile of pixels, each warp 8 wide and 4 tall; the
// tiles of a row of tiles are consecutive blocks. bad null: no skip.
constexpr int kTile = 16;

__global__ void march_kernel(SmokeMarchArgs a, const float* __restrict__ dens,
                             const float* __restrict__ emis, const float* __restrict__ soot,
                             const float* __restrict__ sun_off, const int* __restrict__ bad,
                             unsigned char* __restrict__ rgba) {
    const int tiles_x = (a.width + kTile - 1) / kTile;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int px = (blockIdx.x % tiles_x) * kTile + (warp & 1) * 8 + (lane & 7);
    const int py = (blockIdx.x / tiles_x) * kTile + (warp >> 1) * 4 + (lane >> 3);
    if (px >= a.width || py >= a.height) return;
    smoke_march_pixel(a, dens, emis, soot, sun_off, bad && *bad == 0, rgba,
                      (long long)py * a.width + px);
}

}  // namespace

extern "C" {

int f3d_smoke_advect_velocity(const float* vel, const float* temp, float* va, int nx, int ny,
                              int nz, float dt, float dtb, float amb, float w0, float w1,
                              float w2, float kdamp, int forms, void* stream) {
    const long long n = (long long)nx * ny * nz;
    const SmokeForced f{vel, temp, n, dtb, amb, kdamp, {w0, w1, w2}};
    if (n > 0)
        advect_velocity_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(f, va, nx, ny,
                                                                                 nz, dt, forms);
    return (int)cudaGetLastError();
}

int f3d_smoke_divergence(const float* va, float* div, float* p1, int nx, int ny, int nz,
                         float sixth, void* stream) {
    const long long n = (long long)nx * ny * nz;
    if (n > 0)
        divergence_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(va, div, p1, nx, ny,
                                                                            nz, sixth);
    return (int)cudaGetLastError();
}

// `levels` sweeps from p (null: the zeros before the first) into p_out;
// cudaErrorInvalidValue for levels outside 1..F3D_JAC_LEVELS
int f3d_smoke_jacobi(const float* p, const float* div, float* p_out, int nx, int ny, int nz,
                     float sixth, int levels, void* stream) {
    if (levels < 1 || levels > F3D_JAC_LEVELS) return (int)cudaErrorInvalidValue;
    if (nx <= 0 || ny <= 0 || nz <= 0) return (int)cudaGetLastError();
    const cudaError_t e = jacobi_opt_in();
    if (e != cudaSuccess) return (int)e;
    jacobi_kernel<<<(unsigned)jac_bricks(nx, ny, nz), F3D_JAC_THREADS, kJacSmem,
                    (cudaStream_t)stream>>>(p, div, p_out, nx, ny, nz, sixth, levels);
    return (int)cudaGetLastError();
}

// the Jacobi bricks' build: out = {registers a thread, local (spilled)
// bytes a thread, resident blocks an SM, shared bytes a block, levels a
// launch at most (k), the staged columns along x and y and voxels along z}
int f3d_jacobi_attrs(int* out) {
    cudaError_t e = jacobi_opt_in();
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes at;
    e = cudaFuncGetAttributes(&at, (const void*)jacobi_kernel);
    if (e != cudaSuccess) return (int)e;
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, jacobi_kernel, F3D_JAC_THREADS,
                                                      kJacSmem);
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = resident;
    out[3] = kJacSmem;
    out[4] = F3D_JAC_LEVELS;
    out[5] = F3D_JAC_SX;
    out[6] = F3D_JAC_SY;
    out[7] = F3D_JAC_SZ;
    return (int)e;
}

int f3d_smoke_project_advect(const float* va, const float* p, const float* div,
                             const float* dens, const float* temp, const float* soot,
                             const float* emis, float* vel_out, float* dens_out, float* temp_out,
                             float* soot_out, float* emis_out, int nx, int ny, int nz, float dt,
                             float keep, float keep2, float sixth, void* stream) {
    project_advect_kernel<<<blocks((long long)nx * ny * nz), kThreads, 0,
                            (cudaStream_t)stream>>>(va, p, div, dens, temp, soot, emis, vel_out,
                                                    dens_out, temp_out, soot_out, emis_out, nx,
                                                    ny, nz, dt, keep, keep2, sixth);
    return (int)cudaGetLastError();
}

int f3d_smoke_march_check(const float* dens, const float* emis, const float* soot,
                          long long n, int* bad, void* stream) {
    // 16 blocks an SM, each thread looping over the rest
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long cap = 16LL * (sms > 0 ? sms : 1);
    const long long b = blocks(n) < cap ? blocks(n) : cap;
    if (n > 0)
        march_check_kernel<<<(int)b, kThreads, 0, (cudaStream_t)stream>>>(dens, emis, soot, n,
                                                                          bad);
    return (int)cudaGetLastError();
}

int f3d_smoke_march(const SmokeMarchArgs* a, const float* dens, const float* emis,
                    const float* soot, const float* sun_off, const int* bad, unsigned char* rgba,
                    void* stream) {
    const long long tiles = (long long)((a->width + kTile - 1) / kTile) *
                            ((a->height + kTile - 1) / kTile);
    if (tiles > 0)
        march_kernel<<<(unsigned)tiles, kTile * kTile, 0, (cudaStream_t)stream>>>(
            *a, dens, emis, soot, sun_off, bad, rgba);
    return (int)cudaGetLastError();
}

}  // extern "C"
