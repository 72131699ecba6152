// forge3d_tpu_torch/csrc/smoke.cu
// The CUDA kernels of the smoke path, for sm_90a, with plain C launchers for
// ctypes (see _kernels.py). Each launcher enqueues on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
//
// E8 step        replaces forge3d_tpu/smoke.py:SmokeDomain._build_step (206,
//                jitted at 269) with _trilinear (87) and the Jacobi
//                fori_loop (251-255): per step, one launch of each of
//   forces_kernel            the buoyancy, wind and damping (223-227);
//   advect_velocity_kernel   the self-advection (230), which gathers the
//                            forced velocity at neighbours, so it follows
//                            the forces in a launch of its own;
//   divergence_kernel        div_of (242-246);
//   jacobi_kernel            one sweep a launch, `jacobi_iters` launches
//                            ping-ponging two buffers (251-255); a single
//                            sweep has no launch of its own: it runs inside
//                            the projection, where XLA unrolls it;
//   project_advect_kernel    the projection (256-259) fused with the four
//                            scalar advections (262-266): each voxel
//                            backtraces with its own projected velocity.
// E8 march       replaces smoke.py:SmokeDomain.render_rgba (332), its
//                lax.fori_loop (429) over body (403-425) with sun_trans
//                (394-401): march_kernel, one thread a pixel, the ray and
//                slab set-up, the steps with the sun march inside, the
//                background, the tonemap and the u8 pack.
//
// What bounds them on the H100. The step moves bytes: about 1 GB at a
// 256x50x256 domain (20 Jacobi sweeps of six neighbour reads and a write a
// voxel, which stay in L1/L2 for the most part), ~0.3 ms at 3.35 TB/s; each
// stage here reads its neighbours straight from device memory through the
// caches, one voxel a thread, x fastest across a warp so that a warp's reads
// are contiguous. The march does operations: (3 + sun_steps) trilinear
// samples a step, eight gathers and seven lerps each, on grids that fit in
// L2; one thread a pixel walks its steps in registers. Shared-memory tiles
// of the stencil and texture or TMA paths for the gathers are later work.

#include <cuda_runtime.h>

#include "smoke.cuh"

namespace {

constexpr int kThreads = 256;

int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

__global__ void forces_kernel(const float* __restrict__ vel, const float* __restrict__ temp,
                              float* __restrict__ vf, long long n, float dtb, float amb,
                              float w0, float w1, float w2, float kdamp) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    smoke_forces_voxel(vel, temp, vf, n, dtb, amb, w0, w1, w2, kdamp, i);
}

__global__ void advect_velocity_kernel(const float* __restrict__ vf, float* __restrict__ va,
                                       int nx, int ny, int nz, float dt, int forms) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)nx * ny * nz) return;
    smoke_advect_velocity_voxel(vf, va, nx, ny, nz, dt, forms, i);
}

__global__ void divergence_kernel(const float* __restrict__ va, float* __restrict__ div, int nx,
                                  int ny, int nz) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)nx * ny * nz) return;
    div[i] = smoke_divergence_voxel(va, nx, ny, nz, i);
}

__global__ void jacobi_kernel(const float* __restrict__ p, const float* __restrict__ div,
                              float* __restrict__ p_out, int nx, int ny, int nz, float sixth) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)nx * ny * nz) return;
    p_out[i] = smoke_jacobi_voxel(p, div, nx, ny, nz, sixth, i);
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

__global__ void march_kernel(SmokeMarchArgs a, const float* __restrict__ dens,
                             const float* __restrict__ emis, const float* __restrict__ soot,
                             const float* __restrict__ sun_off, unsigned char* __restrict__ rgba) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)a.width * a.height) return;
    smoke_march_pixel(a, dens, emis, soot, sun_off, rgba, i);
}

}  // namespace

extern "C" {

int f3d_smoke_forces(const float* vel, const float* temp, float* vf, long long n, float dtb,
                     float amb, float w0, float w1, float w2, float kdamp, void* stream) {
    if (n > 0)
        forces_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(vel, temp, vf, n, dtb,
                                                                         amb, w0, w1, w2, kdamp);
    return (int)cudaGetLastError();
}

int f3d_smoke_advect_velocity(const float* vf, float* va, int nx, int ny, int nz, float dt,
                              int forms, void* stream) {
    advect_velocity_kernel<<<blocks((long long)nx * ny * nz), kThreads, 0,
                             (cudaStream_t)stream>>>(vf, va, nx, ny, nz, dt, forms);
    return (int)cudaGetLastError();
}

int f3d_smoke_divergence(const float* va, float* div, int nx, int ny, int nz, void* stream) {
    divergence_kernel<<<blocks((long long)nx * ny * nz), kThreads, 0, (cudaStream_t)stream>>>(
        va, div, nx, ny, nz);
    return (int)cudaGetLastError();
}

int f3d_smoke_jacobi(const float* p, const float* div, float* p_out, int nx, int ny, int nz,
                     float sixth, void* stream) {
    jacobi_kernel<<<blocks((long long)nx * ny * nz), kThreads, 0, (cudaStream_t)stream>>>(
        p, div, p_out, nx, ny, nz, sixth);
    return (int)cudaGetLastError();
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

int f3d_smoke_march(const SmokeMarchArgs* a, const float* dens, const float* emis,
                    const float* soot, const float* sun_off, unsigned char* rgba, void* stream) {
    const long long n = (long long)a->width * a->height;
    if (n > 0)
        march_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(*a, dens, emis, soot,
                                                                        sun_off, rgba);
    return (int)cudaGetLastError();
}

}  // extern "C"
