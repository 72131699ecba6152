// forge3d_tpu_torch/csrc/engines.cu
// The two deterministic path-tracing engines beside the terrain path
// tracer, for sm_90a, with plain C launchers for ctypes (see _kernels.py).
// Each launcher enqueues on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().
//
// P1 sphere_kernel  replaces forge3d_tpu/pt/megakernel.py:_render (186)
// P2 mesh_kernel    replaces forge3d_tpu/pt/mesh_render.py:_render_mesh (49)
//
// One thread per pixel runs the whole pixel (pbr.cuh): the camera ray, the
// nearest sphere by a loop over the N spheres (P1) or the BVH walk
// (mesh.cuh, P2), the GGX shading, the ground plane or the sun shadow ray,
// Reinhard, and the AOVs. The JAX version is one fused array program over
// the image, with an (H, W, N) sphere test and a lock-step BVH loop; on
// the card each pixel loops on its own. What bounds them: P1 is
// arithmetic (N sphere tests and one shade of ~150 float32 operations with
// two powf per pixel) and writes 68 bytes per pixel; P2 is the latency of
// its BVH walks, as K9. P2 runs in K6's tiles (common.cuh:tile_pixel): a
// block covers 16x16 pixels and a warp 8x4, so a warp's primary rays and
// its shadow rays' origins are image neighbours that walk the same subtrees;
// lanes past the image compute nothing. A hit pixel walks its shadow ray
// only where sun_intensity * n.l is not zero (pbr.cuh:mesh_pixel_t).

#include <cuda_runtime.h>

#include "common.cuh"  // f3d_kernel_attrs
#include "pbr.cuh"

namespace {

constexpr int kThreads = 256;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

__global__ void sphere_kernel(CamArgs c, SphereArgs s, AovArgs o) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= c.width * c.height) return;
    sphere_pixel(c, s, o, i);
}

// P2 at ptxas's own register count (a bound of 5 blocks an SM spilled and
// was slower)
__global__ void mesh_kernel(CamArgs c, MeshArgs m, MaterialArgs mat, AovArgs o) {
    const TilePixel p = tile_pixel(c.width, c.height, blockIdx.x, threadIdx.x);
    if (!p.inside) return;
    mesh_pixel(c, m, mat, o, p.y * c.width + p.x);
}

}  // namespace

extern "C" {

int f3d_render_spheres(const CamArgs* c, const SphereArgs* s, const AovArgs* o,
                       void* stream) {
    int n = c->width * c->height;
    if (n > 0) {
        sphere_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*c, *s, *o);
    }
    return (int)cudaGetLastError();
}

int f3d_render_mesh(const CamArgs* c, const MeshArgs* m, const MaterialArgs* mat,
                    const AovArgs* o, void* stream) {
    if (c->width > 0 && c->height > 0) {
        mesh_kernel<<<tile_blocks(c->width, c->height), kThreads, 0, (cudaStream_t)stream>>>(
            *c, *m, *mat, *o);
    }
    return (int)cudaGetLastError();
}

// P2's registers, local bytes and resident blocks of kThreads an SM
int f3d_render_mesh_attrs(int* out) {
    return f3d_kernel_attrs((const void*)mesh_kernel, kThreads, out);
}

}  // extern "C"
