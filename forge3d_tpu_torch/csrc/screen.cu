// forge3d_tpu_torch/csrc/screen.cu
// The CUDA kernels of the screen-mode render, for sm_90a, with plain C
// launchers for ctypes (see _kernels.py). Each launcher enqueues on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
//
// S1    env_cube_kernel   replaces forge3d_tpu/terrain/screen.py:_ibl_env_cube (355)
// S2/S3 convolve_kernel   replaces screen.py:_ibl_irradiance (363) and
//                         _ibl_prefilter_mip (388)
// S4    raster_kernel     replaces screen.py:_raster_depth (464)
// S8    shade_kernel      replaces the `shade` program of screen.py:_build_shade_fn
//                         (1085), with pcss_visibility (S5, 656), _pom_uv (S7,
//                         979) and _render_sky with the aerial blend (S6, 748,
//                         1508) inside
// S9    clipmap_kernel    replaces the `shade` program of
//                         screen.py:_build_clipmap_shade_fn (1853), with S5 and
//                         S7 inside
//
// S1: one thread per cube texel (6 x 256^2), a bilinear read of the small
// equirect map; bound by its 4.7 MB of output.
//
// S2/S3: a pyramid's six convolutions (the 128^2 irradiance, 128 cosine
// samples a texel; mips 1-5, max(1024 >> mip, 64) GGX samples) in one
// launch, the largest first, so the small mips fill the card beside the
// large ones instead of running alone as tails. A texel takes a group of
// G lanes (a launch parameter of each convolution, screen.py:CONV_GROUPS):
// lane j computes samples j, j + G, ..., and after each round of G samples
// every lane of the group adds the G terms in lane order, read with
// __shfl_sync, so the adds are the scan's adds in the scan's order and the
// sums are the scan's bit for bit (a tree over the samples would not be).
// Mip 1, most of the work, runs on twice the lanes, mip 5 in two rounds
// instead of 64 dependent samples. The env cube is read from its RGBx copy
// (screen.py:_rgbx forms it before the launch), a bilinear tap one 16-byte
// load; the 6.3 MB copy stays in L2. What bounds it is issue: each of the
// ~70 million samples a pyramid takes eight IEEE divisions and two square
// roots, which keep every bit.
//
// S4: JAX loops over the largest box (wbb x hbb) and masks every triangle
// to its own; here one thread per triangle walks its own box and stops at
// its edge, and each covered pixel's depth is an atomicMin on the float's
// bits, which order as integers because z is clipped to [0, 1] (-0.0 is
// stored as +0.0). The 4096^2 map (67 MB) is written by atomics; 2,093,058
// triangles (75 MB) are read once.
//
// S8: one thread per pixel, a block a 16x16 tile and a warp an 8x4 patch
// of it (screen.cuh:s8_pixel). The edge term needs the shading normals of
// the pixel's 2x2 quad (dpdxCoarse / dpdyCoarse), so four consecutive lanes
// of a warp hold one quad (top left, top right, bottom left, bottom right),
// and the normals are exchanged with __shfl_sync after shade_front. Every
// lane of a warp reaches the shuffle; lanes past the image shade pixel
// (0, 0) and write nothing. What bounds it is arithmetic and the PCSS taps
// (S5): each pixel makes 12 blocker reads and 16 PCF footprints of 4 texels
// each, 76 scattered reads of the 67 MB 4096^2 depth map, every one within
// about 6 texels of the receiver's. They go through the texture unit as
// point fetches (screen.cuh:ShadowTex), so their clamps and addresses are
// its work, over a texture object on the cached map itself, with no copy
// (screen.py:shadow_texture). With POM each thread marches its own
// steps (12-40 height reads and a few refinements; over a DEM in metres
// every lane marches all its steps) and stops where JAX's masked loop
// would freeze it; the sky is computed per pixel from the per-image
// constants in SkyArgs.
//
// S9: S8's layout (a block a 16x16 tile, a warp an 8x4 patch in 2x2 quads,
// screen.cuh:s8_pixel) over the host G-buffer (uv, world position, valid):
// every pixel is shaded, and the invalid ones take the background colour
// at the write, a pixel's rgba one 32-bit store. Its PCSS taps go through
// S8's texture object over the cached map (ShadowTex), its POM marches over
// metres as S8's in D; lanes past the image shade pixel (0, 0) and write
// nothing.

#include <cuda_runtime.h>

#include "common.cuh"  // f3d_kernel_attrs
#include "screen.cuh"

namespace {

constexpr int kThreads = 256;

inline int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

__global__ void env_cube_kernel(const float* __restrict__ eq, int eq_h, int eq_w,
                                const float* __restrict__ dirs, int n, float* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    env_cube_texel(eq, eq_h, eq_w, dirs, i, out);
}

constexpr int kConvJobs = 6;   // a pyramid's convolutions

struct ConvPlan {
    ConvJob job[kConvJobs];
    int first_block[kConvJobs + 1];
    int n_jobs;
};

__global__ void __launch_bounds__(kThreads)
convolve_kernel(const float* __restrict__ env4, int env_size, ConvPlan p) {
    // the block's convolution, selected with static indices (no local copy)
    int j = 0;
#pragma unroll
    for (int k = 1; k < kConvJobs; ++k) j += (k < p.n_jobs && (int)blockIdx.x >= p.first_block[k]);
    ConvJob job = p.job[0];
#pragma unroll
    for (int k = 1; k < kConvJobs; ++k)
        if (j == k) job = p.job[k];
    // every lane of the block runs the same loops (the job, its sample count
    // and group are the block's), so the shuffles take the whole warp; a
    // texel past the end computes texel 0's sums and writes nothing
    const int g = job.group;
    const int lane = threadIdx.x & (g - 1);
    const int i = ((int)blockIdx.x - p.first_block[j]) * (kThreads / g) + (int)threadIdx.x / g;
    const bool live = i < job.n;
    float n[3], t[3], b[3];
    convolve_frame(job.dirs, live ? i : 0, n, t, b);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < job.count; k0 += g) {
        float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (k0 + lane < job.count)
            convolve_sample(env4, env_size, n, t, b, job.smp, k0 + lane, job.mode, x);
        const int m = job.count - k0 < g ? job.count - k0 : g;
        for (int q = 0; q < m; ++q) {
#pragma unroll
            for (int c = 0; c < 4; ++c)     // the irradiance has no weight sum
                if (c < 3 || job.mode != 0) acc[c] = acc[c] + __shfl_sync(0xffffffffu, x[c], q, g);
        }
    }
    if (live && lane == 0) convolve_finish(acc, job.mode, i, job.out);
}

__global__ void raster_kernel(const float* __restrict__ tris, const unsigned char* __restrict__ keep,
                              int n_tris, int res, int wbb, int hbb, float* depth) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_tris) return;
    raster_triangle(tris, keep, t, res, wbb, hbb, depth);
}

// S8's register budget: 4 resident blocks of kThreads an SM asked of ptxas
// (64 registers; 70 and 3 blocks without)
__global__ void __launch_bounds__(kThreads, 4) shade_kernel(ScreenArgs a, ScreenOut o) {
    int x, y;
    const bool live = s8_pixel(a.width, a.height, blockIdx.x, threadIdx.x, x, y);
    ShadeState s;
    shade_front(a, x, y, s);
    float tl[3], tr[3], bl[3];
    for (int c = 0; c < 3; ++c) {
        tl[c] = __shfl_sync(0xffffffffu, s.sn[c], 0, 4);
        tr[c] = __shfl_sync(0xffffffffu, s.sn[c], 1, 4);
        bl[c] = __shfl_sync(0xffffffffu, s.sn[c], 2, 4);
    }
    if (live) shade_back(a, o, x, y, s, quad_grad(tl, tr, bl));
}

// S9's register budget: 4 resident blocks of kThreads an SM, as S8's
__global__ void __launch_bounds__(kThreads, 4)
clipmap_kernel(ScreenArgs a, ClipArgs g, unsigned char* __restrict__ rgba) {
    int x, y;
    const bool live = s8_pixel(a.width, a.height, blockIdx.x, threadIdx.x, x, y);
    ClipState s;
    clip_front(a, g, x, y, s);
    float tl[3], tr[3], bl[3];
    for (int c = 0; c < 3; ++c) {
        tl[c] = __shfl_sync(0xffffffffu, s.n[c], 0, 4);
        tr[c] = __shfl_sync(0xffffffffu, s.n[c], 1, 4);
        bl[c] = __shfl_sync(0xffffffffu, s.n[c], 2, 4);
    }
    if (live)
        clip_back(ShadowTex{a.shadow_tex, a.shadow_res}, a, g, rgba, x, y, s,
                  quad_grad(tl, tr, bl));
}

// S5 alone on receivers, through the texture or the pointer (f3d_pcss_points)
__global__ void pcss_points_kernel(ScreenArgs a, const float* __restrict__ sp,
                                   const float* __restrict__ nrm, int n, int tex,
                                   float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = tex ? pcss_visibility(ShadowTex{a.shadow_tex, a.shadow_res}, a.lvp, a.pcss_ld,
                                   sp + 3 * i, nrm + 3 * i)
                 : pcss_visibility(ShadowPtr{a.shadow, a.shadow_res}, a.lvp, a.pcss_ld,
                                   sp + 3 * i, nrm + 3 * i);
}

// a kernel's parameters must fit in 4 KB
static_assert(sizeof(ScreenArgs) + sizeof(ScreenOut) <= 4096, "S8's arguments exceed 4 KB");
static_assert(sizeof(ScreenArgs) + sizeof(ClipArgs) + sizeof(void*) <= 4096,
              "S9's arguments exceed 4 KB");

}  // namespace

extern "C" {

int f3d_ibl_env_cube(const float* eq, int eq_h, int eq_w, const float* dirs, int size,
                     float* out, void* stream) {
    int n = 6 * size * size;
    if (n > 0)
        env_cube_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(eq, eq_h, eq_w, dirs,
                                                                               n, out);
    return (int)cudaGetLastError();
}

// S2/S3: `jobs` holds n_jobs (<= 6) convolutions of the RGBx cube env4, seven
// words each (dirs, samples, out, texels, samples a texel, mode, lanes a
// texel), in launch order; one launch runs them all. Returns
// cudaErrorInvalidValue for more than six or a group that is not a power of
// two up to 32.
int f3d_ibl_convolve(const float* env4, int env_size, const long long* jobs, int n_jobs,
                     void* stream) {
    if (n_jobs < 0 || n_jobs > kConvJobs) return (int)cudaErrorInvalidValue;
    ConvPlan p = {};
    p.n_jobs = n_jobs;
    int blocks = 0;
    for (int j = 0; j < n_jobs; ++j) {
        const long long* w = jobs + 7 * j;
        ConvJob& c = p.job[j];
        c.dirs = (const float*)w[0];
        c.smp = (const float*)w[1];
        c.out = (float*)w[2];
        c.n = (int)w[3];
        c.count = (int)w[4];
        c.mode = (int)w[5];
        c.group = (int)w[6];
        if (c.group < 1 || c.group > 32 || (c.group & (c.group - 1)) != 0)
            return (int)cudaErrorInvalidValue;
        p.first_block[j] = blocks;
        blocks += (int)(((long long)c.n * c.group + kThreads - 1) / kThreads);
    }
    for (int j = n_jobs; j <= kConvJobs; ++j) p.first_block[j] = blocks;
    if (blocks > 0)
        convolve_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(env4, env_size, p);
    return (int)cudaGetLastError();
}

// S2/S3's registers, local bytes and resident blocks of kThreads an SM
int f3d_ibl_convolve_attrs(int* out) {
    return f3d_kernel_attrs((const void*)convolve_kernel, kThreads, out);
}

int f3d_raster_depth(const float* tris, const unsigned char* keep, int n_tris, int res, int wbb,
                     int hbb, float* depth, void* stream) {
    if (n_tris > 0)
        raster_kernel<<<blocks_for(n_tris), kThreads, 0, (cudaStream_t)stream>>>(
            tris, keep, n_tris, res, wbb, hbb, depth);
    return (int)cudaGetLastError();
}

// S8 over a->width x a->height (even) pixels; the PCSS taps read the map
// through a->shadow_tex, which must be a texture object over a->shadow
// (f3d_shadow_texture_create)
int f3d_screen_shade(const ScreenArgs* a, const ScreenOut* o, void* stream) {
    const long long blocks = a->width > 0 && a->height > 0 ? s8_blocks(a->width, a->height) : 0;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (blocks > 0)
        shade_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*a, *o);
    return (int)cudaGetLastError();
}

// S8's registers, local bytes and resident blocks of kThreads an SM
int f3d_screen_shade_attrs(int* out) {
    return f3d_kernel_attrs((const void*)shade_kernel, kThreads, out);
}

// S5's map for S8: a texture object over the (res, res) float map `depth`
// itself, a pitch-2D resource (no copy), with point filtering, clamp
// addressing and unnormalised coordinates. Writes it to *tex; free it with
// f3d_shadow_texture_destroy while the map still lives.
int f3d_shadow_texture_create(const float* depth, int res, unsigned long long* tex) {
    *tex = 0;
    if (res <= 0) return (int)cudaErrorInvalidValue;
    cudaResourceDesc rd = {};
    rd.resType = cudaResourceTypePitch2D;
    rd.res.pitch2D.devPtr = (void*)depth;
    rd.res.pitch2D.desc = cudaCreateChannelDesc<float>();
    rd.res.pitch2D.width = res;
    rd.res.pitch2D.height = res;
    rd.res.pitch2D.pitchInBytes = (size_t)res * sizeof(float);
    cudaTextureDesc td = {};
    td.addressMode[0] = td.addressMode[1] = cudaAddressModeClamp;
    td.filterMode = cudaFilterModePoint;
    td.readMode = cudaReadModeElementType;
    td.normalizedCoords = 0;
    cudaTextureObject_t obj = 0;
    const cudaError_t e = cudaCreateTextureObject(&obj, &rd, &td, nullptr);
    if (e == cudaSuccess) *tex = (unsigned long long)obj;
    return (int)e;
}

// frees what f3d_shadow_texture_create made, once the device is idle (a
// launch may still read it)
int f3d_shadow_texture_destroy(unsigned long long tex) {
    const cudaError_t e = cudaDeviceSynchronize();
    const cudaError_t e1 = cudaDestroyTextureObject((cudaTextureObject_t)tex);
    return (int)(e != cudaSuccess ? e : e1);
}

// S5 alone on n receivers (sp, nrm: (n, 3)) with a's map, lvp and light:
// through the texture (`tex`, S8's and S9's path) or the pointer; a check
// that the two read the same texels
int f3d_pcss_points(const ScreenArgs* a, const float* sp, const float* nrm, int n, int tex,
                    float* out, void* stream) {
    if (n > 0)
        pcss_points_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*a, sp, nrm, n,
                                                                                tex, out);
    return (int)cudaGetLastError();
}

// S9's registers, local bytes and resident blocks of kThreads an SM
int f3d_clipmap_shade_attrs(int* out) {
    return f3d_kernel_attrs((const void*)clipmap_kernel, kThreads, out);
}

// S9 over a->width x a->height (even) pixels; the PCSS taps read the map
// through a->shadow_tex, as S8's
int f3d_clipmap_shade(const ScreenArgs* a, const ClipArgs* g, unsigned char* rgba, void* stream) {
    const long long blocks = a->width > 0 && a->height > 0 ? s8_blocks(a->width, a->height) : 0;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (blocks > 0)
        clipmap_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*a, *g, rgba);
    return (int)cudaGetLastError();
}

}  // extern "C"
