// forge3d_tpu_torch/csrc/kernels.cu
// The CUDA kernels of the per-ray terrain path tracer, for sm_90a, with
// plain C launchers for ctypes (see _kernels.py). Each launcher enqueues on
// the caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so that a refused launch is reported.
//
// K5 trace_kernel        replaces forge3d_tpu/ops/traversal.py:trace (211)
// K6 frame_kernel        replaces forge3d_tpu/pt/terrain_ref.py:_make_frame_step (174)
// K7 spatial_kernel      replaces forge3d_tpu/ops/restir.py:spatial_reuse (107)
// K6 band, K7 band      the same kernels on a band of rows (row0, rows): a
//                        rank's rows of the sharded render (M1,
//                        parallel/tiles.py), which replaces
//                        forge3d_tpu/parallel/tiles.py:render_frames_sharded
//                        (39); the whole frame is the band (0, height)
// K8 gbuffer_kernel      replaces forge3d_tpu/pt/terrain_ref.py:_center_gbuffer (472)
// K9 trace_mesh_kernel   replaces forge3d_tpu/ops/bvh.py:trace_mesh (333); its body
//                        (mesh.cuh:trace_mesh_ray, over the packed records) also
//                        runs inside K6, K8, P2, P3 and P5
// K10 sample_light_kernel replaces forge3d_tpu/ops/lightsample.py:sample_light_nee
//                        (101) with alias_sample (74); its body (lights.cuh:
//                        sample_light, over the packed light table) also runs
//                        inside K6
//
// K6 comes in two instantiations: the terrain-only one, and the hybrid one
// for scenes with a mesh or typed lights, so that the terrain-only render
// keeps its register budget.
//
// What bounds them on the card: the DDA in trace_ray is a chain of
// dependent loads (node index -> mm_pack pair -> next node; leaf ->
// two h_pair pairs), so a ray waits on memory latency, not bandwidth or
// arithmetic; rays that take different numbers of steps or branch
// differently (descend / leaf / advance, hit / miss) diverge within a warp.
// The JAX version stepped all rays in lock step because a TPU has no
// per-lane control flow; on the card each thread owns one ray or pixel and
// loops on its own, so a finished ray costs nothing and no global
// iteration count is needed. The pyramid and DEM pairs (~20 MB at a 1025^2
// DEM) fit in the 50 MB L2 cache and are read through the read-only path
// as one 8-byte load per pair. K5 gives a warp an 8x4 tile of an image's
// rays (a flat set in order), forms the level table's index in registers
// and, where the spacings are powers of two, the cells by exact multiplies
// (trace_kernel); K8 gives consecutive threads consecutive pixels of a row;
// K6 gives a warp an 8x4 tile of pixels and holds its terrain-only
// instantiation to 4 blocks an SM (frame_kernel).
// K7 is bound by its gather: a pixel's 9 candidates lie at random offsets
// in a 7x7 window of a frame (83 MB at 1080p) that L2 does not hold; its
// blocks stage their tile's window in shared memory once (spatial_kernel).
// K10 alone is bound by its 16 streams (64 bytes a lane, 9 read and 7
// written); its table's records come through the read-only path and stay
// in L1 (sample_light_kernel).
// Ray sorting and persistent threads are later work.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// K5: a thread a ray. Rays given as an image of rows of `width` (the
// center rays, Scene's primary and AO rays) go to the threads in K6's
// tiles: a block 16x16 rays, a warp 8x4 (tile_pixel), so that a warp's rays
// leave side by side in x and y, walk the same nodes and take more nearly
// the same number of steps; a flat set (width 0: shadow probes, hit points
// gathered from an image) keeps the linear order. The DDA addresses the
// pyramid from a LevelCursor, so no load of the level table sits on a
// step's chain before its node load; kPow2 (the launcher's choice, from the
// scene's spacings) maps offsets to cells by exact multiplies instead of
// IEEE divisions (CellMap).
template <bool kPow2>
__global__ void trace_kernel(SceneArgs s, const float* __restrict__ rox,
                             const float* __restrict__ roy, const float* __restrict__ roz,
                             const float* __restrict__ rdx, const float* __restrict__ rdy,
                             const float* __restrict__ rdz, int n, int width, float tmin,
                             float tmax, unsigned char* __restrict__ hit, float* __restrict__ t,
                             int* __restrict__ cell_x, int* __restrict__ cell_z) {
    int i;
    if (width > 0) {
        const TilePixel p = tile_pixel(width, n / width, blockIdx.x, threadIdx.x);
        if (!p.inside) return;
        i = p.y * width + p.x;
    } else {
        i = blockIdx.x * blockDim.x + threadIdx.x;
        if (i >= n) return;
    }
    Hit h = trace_ray_t<true, kPow2>(s, rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i], tmin,
                                     tmax);
    hit[i] = (unsigned char)h.hit;
    t[i] = h.t;
    cell_x[i] = h.cell_x;
    cell_z[i] = h.cell_z;
}

// K6: one thread per pixel of the band f.row0 .. f.row0 + f.rows - 1 (the
// whole frame, or a rank's rows of a sharded render) runs all spp samples
// of one frame (primary, sun and env occlusion rays through trace_ray, and
// with a mesh or lights the mesh walk and the light sample and its ray),
// then writes the accumulator, the Welford pair and the temporally merged
// reservoir, all band-sized. accum/welford may be updated in place (each
// thread reads its own pixel before writing it); res_in and res_out are
// separate buffers. A block takes a 16x16 tile of the band, a warp 8x4
// pixels (tile_pixel): a warp's primary rays leave the camera side by side in x and y,
// its sun rays start from neighbouring hit points, so they walk the same
// nodes and take more nearly the same number of steps. kMinBlocks is the
// launch bound: the terrain-only instantiation is held to 64 registers, 4
// blocks of 256 threads an SM (a DDA step waits on its node load; more
// warps hide more of it, and that pays for a few spilled bytes); the
// hybrid one keeps its registers, which its BVH walk needs.
template <bool kHybrid, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
frame_kernel(SceneArgs s, FrameArgs f, MeshArgs m, LightArgs l, const float* accum_in,
             const float* welford_in, ResArgs res_in, float* accum_out, float* welford_out,
             ResArgs res_out) {
    const TilePixel p = tile_pixel(f.width, f.rows, blockIdx.x, threadIdx.x);
    if (!p.inside) return;
    frame_pixel<kHybrid>(s, f, m, l, p.y * f.width + p.x, accum_in, welford_in, res_in,
                         accum_out, welford_out, res_out);
}

// K6's launch bounds: terrain-only, and hybrid (a mesh or typed lights)
constexpr int kTerrainBlocks = 4;
constexpr int kHybridBlocks = 1;

// K7: a block takes a 16x16 tile of the band row0 .. row0 + rows - 1, a
// warp 8x4 pixels (tile_pixel, as K6); reads the whole frame's reservoirs
// and normals (res_in, gb_n*), writes the band's (res_out). kShared: the
// block first stages the candidates of its tile and a `radius`-wide halo
// (TileWindow, 6 fields of 4 bytes an entry: 22^2 entries, 11,616 B at
// radius 3) with loads along the frame's rows, then every tap reads shared
// memory; otherwise each tap is formed from device memory (FrameWindow).
// The caller chooses (ops/restir.py:kernel_instance). Either way the
// chosen candidate's six sample fields are read once, at the end.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
spatial_kernel(ResArgs res_in, ResArgs res_out, const float* __restrict__ gb_nx,
               const float* __restrict__ gb_ny, const float* __restrict__ gb_nz, int width,
               int height, uint32_t frame_index, uint32_t seed_hi, int k_neighbors, int radius,
               int row0, int rows) {
    extern __shared__ float k7_window[];
    const TilePixel p = tile_pixel(width, rows, blockIdx.x, threadIdx.x);
    if (kShared) {
        const TileWindow win(k7_window, radius, p.x0 - radius, row0 + p.y0 - radius);
        for (int e = threadIdx.x; e < win.entries(); e += kThreads)
            win.stage(res_in, width, height, e);
        __syncthreads();
        if (!p.inside) return;
        store_res(res_out, p.y * width + p.x,
                  spatial_pixel(win, res_in, gb_nx, gb_ny, gb_nz, width, height, frame_index,
                                seed_hi, k_neighbors, radius, p.x, row0 + p.y));
    } else {
        if (!p.inside) return;
        const FrameWindow win{&res_in, width, height};
        store_res(res_out, p.y * width + p.x,
                  spatial_pixel(win, res_in, gb_nx, gb_ny, gb_nz, width, height, frame_index,
                                seed_hi, k_neighbors, radius, p.x, row0 + p.y));
    }
}

// K7's dynamic shared bytes: the window at `radius` where it is staged
inline size_t spatial_smem(bool shared, int radius) {
    return shared ? TileWindow::floats(radius) * sizeof(float) : 0;
}

struct Vec3 {
    float v[3];
};

// K8: one thread per pixel turns K5's center-ray hit record into the AOVs;
// with a mesh it traces the center ray through the BVH as well.
__global__ void gbuffer_kernel(SceneArgs s, MeshArgs m, int n, Vec3 cam_o, Vec3 alb,
                               const float* __restrict__ dx, const float* __restrict__ dy,
                               const float* __restrict__ dz,
                               const unsigned char* __restrict__ hit,
                               const float* __restrict__ t, const int* __restrict__ cell_x,
                               const int* __restrict__ cell_z, float* albedo_out,
                               float* normal_out, float* depth_out, float* vis_out,
                               float* gb_nx, float* gb_ny, float* gb_nz) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    gbuffer_pixel(s, m, cam_o.v, alb.v, i, dx[i], dy[i], dz[i], hit[i], t[i], cell_x[i],
                  cell_z[i], albedo_out, normal_out, depth_out, vis_out, gb_nx, gb_ny,
                  gb_nz);
}

// K9 standalone: one thread per ray.
__global__ void trace_mesh_kernel(MeshArgs m, const float* __restrict__ rox,
                                  const float* __restrict__ roy, const float* __restrict__ roz,
                                  const float* __restrict__ rdx, const float* __restrict__ rdy,
                                  const float* __restrict__ rdz, int n, float tmin, float tmax,
                                  unsigned char* __restrict__ hit, float* __restrict__ t,
                                  int* __restrict__ prim, float* __restrict__ u,
                                  float* __restrict__ v) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    MeshHit h = trace_mesh_ray<false, true>(m, rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i],
                                            tmin, tmax);
    hit[i] = (unsigned char)(h.prim >= 0);
    t[i] = h.t;
    prim[i] = h.prim;
    u[i] = h.u;
    v[i] = h.v;
}

// K10 standalone: one thread a lane, the light set's records through the
// read-only path as in K6. (Two to eight lanes a thread, their loads issued
// together, took 64-115 registers and ran slower: the streams are in flight
// enough at one.)
__global__ void __launch_bounds__(kThreads)
sample_light_kernel(LightArgs l, int n, const float* __restrict__ px,
                    const float* __restrict__ py, const float* __restrict__ pz,
                    const float* __restrict__ nx, const float* __restrict__ ny,
                    const float* __restrict__ nz, const float* __restrict__ u_pick,
                    const float* __restrict__ u1, const float* __restrict__ u2,
                    float* __restrict__ dx, float* __restrict__ dy, float* __restrict__ dz,
                    float* __restrict__ dist, float* __restrict__ wr, float* __restrict__ wg,
                    float* __restrict__ wb) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
#ifdef F3D_K10_COPY
    // measurement build: the same 16 streams copied (9 read, 7 written)
    const LightSample s = {px[i], py[i], pz[i], nx[i] + ny[i], nz[i], u_pick[i] + u1[i], u2[i]};
#else
    const LightSample s = sample_light(LightTable{l.table}, l.count, l.u_hi, px[i], py[i], pz[i],
                                       nx[i], ny[i], nz[i], u_pick[i], u1[i], u2[i]);
#endif
    dx[i] = s.dx;
    dy[i] = s.dy;
    dz[i] = s.dz;
    dist[i] = s.dist;
    wr[i] = s.wr;
    wg[i] = s.wg;
    wb[i] = s.wb;
}

}  // namespace

extern "C" {

const char* f3d_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int f3d_trace(const SceneArgs* s, const float* rox, const float* roy, const float* roz,
              const float* rdx, const float* rdy, const float* rdz, int n, int width,
              float tmin, float tmax, unsigned char* hit, float* t, int* cell_x, int* cell_z,
              void* stream) {
    if (n > 0) {
        const int grid = width > 0 ? tile_blocks(width, n / width) : blocks_for(n);
        auto* kernel = pow2_spacing(s->sx) && pow2_spacing(s->sz) ? trace_kernel<true>
                                                                   : trace_kernel<false>;
        kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            *s, rox, roy, roz, rdx, rdy, rdz, n, width, tmin, tmax, hit, t, cell_x, cell_z);
    }
    return (int)cudaGetLastError();
}

// K5's instantiation for power-of-two spacings (pow2 1) or the other (0):
// out = {registers a thread, local bytes a thread, resident blocks of
// kThreads an SM}
int f3d_trace_attrs(int pow2, int* out) {
    const void* fn = pow2 ? (const void*)trace_kernel<true> : (const void*)trace_kernel<false>;
    return f3d_kernel_attrs(fn, kThreads, out);
}

int f3d_frame_step(const SceneArgs* s, const FrameArgs* f, const MeshArgs* m,
                   const LightArgs* l, const float* accum_in, const float* welford_in,
                   const ResArgs* res_in, float* accum_out, float* welford_out,
                   const ResArgs* res_out, void* stream) {
    if (f->width > 0 && f->rows > 0) {
        const int grid = tile_blocks(f->width, f->rows);
        if (m->n_nodes > 0 || l->count > 0) {
            frame_kernel<true, kHybridBlocks><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
                *s, *f, *m, *l, accum_in, welford_in, *res_in, accum_out, welford_out,
                *res_out);
        } else {
            frame_kernel<false, kTerrainBlocks><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
                *s, *f, *m, *l, accum_in, welford_in, *res_in, accum_out, welford_out,
                *res_out);
        }
    }
    return (int)cudaGetLastError();
}

// K6's instantiation (hybrid or terrain-only): out = {registers a thread,
// local (spilled) bytes a thread, resident blocks of kThreads an SM}
int f3d_frame_kernel_attrs(int hybrid, int* out) {
    return f3d_kernel_attrs(hybrid ? (const void*)frame_kernel<true, kHybridBlocks>
                                   : (const void*)frame_kernel<false, kTerrainBlocks>,
                            kThreads, out);
}

// The kernels here that walk a mesh (K9's body): which 0 K9 alone, 1 K6
// hybrid, 2 K8; out as f3d_frame_kernel_attrs
int f3d_mesh_kernel_attrs(int which, int* out) {
    return f3d_kernel_attrs(which == 0   ? (const void*)trace_mesh_kernel
                            : which == 1 ? (const void*)frame_kernel<true, kHybridBlocks>
                                         : (const void*)gbuffer_kernel,
                            kThreads, out);
}

// K10 standalone: out = {registers a thread, local bytes a thread, resident
// blocks of kThreads an SM}
int f3d_sample_light_attrs(int* out) {
    return f3d_kernel_attrs((const void*)sample_light_kernel, kThreads, out);
}

// shared: the instantiation that stages each block's window
// (spatial_kernel<true>; a window past the 48 KB a block may take without
// opting in, radius > 14, is refused), else the one that reads the taps
// from device memory (spatial_kernel<false>)
int f3d_spatial_reuse(const ResArgs* res_in, const ResArgs* res_out, const float* gb_nx,
                      const float* gb_ny, const float* gb_nz, int width, int height,
                      unsigned int frame_index, unsigned int seed_hi, int k_neighbors,
                      int radius, int row0, int rows, int shared, void* stream) {
    if (width > 0 && rows > 0) {
        const int grid = tile_blocks(width, rows);
        if (shared)
            spatial_kernel<true><<<grid, kThreads, spatial_smem(true, radius),
                                   (cudaStream_t)stream>>>(
                *res_in, *res_out, gb_nx, gb_ny, gb_nz, width, height, frame_index, seed_hi,
                k_neighbors, radius, row0, rows);
        else
            spatial_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
                *res_in, *res_out, gb_nx, gb_ny, gb_nz, width, height, frame_index, seed_hi,
                k_neighbors, radius, row0, rows);
    }
    return (int)cudaGetLastError();
}

// K7's instantiation (shared as f3d_spatial_reuse) at `radius`: out =
// {registers a thread, local (spilled) bytes a thread, resident blocks of
// kThreads an SM with the radius's window, shared bytes a block}
int f3d_spatial_attrs(int shared, int radius, int* out) {
    const void* fn = shared ? (const void*)spatial_kernel<true>
                            : (const void*)spatial_kernel<false>;
    const size_t smem = spatial_smem(shared, radius);
    cudaFuncAttributes at;
    cudaError_t e = cudaFuncGetAttributes(&at, fn);
    if (e != cudaSuccess) return (int)e;
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, kThreads, smem);
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = resident;
    out[3] = (int)(at.sharedSizeBytes + smem);
    return (int)e;
}

int f3d_center_gbuffer(const SceneArgs* s, const MeshArgs* m, int n, const float* cam_o,
                       const float* alb, const float* dx, const float* dy, const float* dz,
                       const unsigned char* hit, const float* t, const int* cell_x,
                       const int* cell_z, float* albedo_out, float* normal_out,
                       float* depth_out, float* vis_out, float* gb_nx, float* gb_ny,
                       float* gb_nz, void* stream) {
    if (n > 0) {
        Vec3 o, a;
        for (int c = 0; c < 3; ++c) {
            o.v[c] = cam_o[c];
            a.v[c] = alb[c];
        }
        gbuffer_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            *s, *m, n, o, a, dx, dy, dz, hit, t, cell_x, cell_z, albedo_out, normal_out,
            depth_out, vis_out, gb_nx, gb_ny, gb_nz);
    }
    return (int)cudaGetLastError();
}

int f3d_trace_mesh(const MeshArgs* m, const float* rox, const float* roy, const float* roz,
                   const float* rdx, const float* rdy, const float* rdz, int n, float tmin,
                   float tmax, unsigned char* hit, float* t, int* prim, float* u, float* v,
                   void* stream) {
    if (n > 0) {
        trace_mesh_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            *m, rox, roy, roz, rdx, rdy, rdz, n, tmin, tmax, hit, t, prim, u, v);
    }
    return (int)cudaGetLastError();
}

int f3d_sample_light_nee(const LightArgs* l, int n, const float* px, const float* py,
                         const float* pz, const float* nx, const float* ny, const float* nz,
                         const float* u_pick, const float* u1, const float* u2, float* dx,
                         float* dy, float* dz, float* dist, float* wr, float* wg, float* wb,
                         void* stream) {
    if (n > 0) {
        sample_light_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            *l, n, px, py, pz, nx, ny, nz, u_pick, u1, u2, dx, dy, dz, dist, wr, wg, wb);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
