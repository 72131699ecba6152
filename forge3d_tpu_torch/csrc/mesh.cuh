// forge3d_tpu_torch/csrc/mesh.cuh
// Kernel K9's body: the closest hit of one ray against a triangle mesh
// through the threaded SAH BVH (forge3d_tpu/ops/bvh.py:trace_mesh with
// _moller_trumbore). Runs inside the frame kernel K6, the G-buffer kernel
// K8 and the mesh engine P2, and alone in kernels.cu:trace_mesh_kernel.
//
// The JAX version steps every ray of a batch in lock step under one global
// iteration cap and freezes rays that left the tree; a frozen ray never
// changes, so one thread walking its own ray under the same cap,
// max_iters = 4 * n_nodes + 64, gives the same per-ray result. The walk is
// stackless: one node index in a register, node + 1 on an interior box hit,
// miss_link otherwise (also after a leaf). The leaf tests up to
// F3D_LEAF_SIZE triangles with the strict `t < best_t` update, so the
// first of two equal hits in BVH order wins, as in JAX.
//
// What bounds it on the card: a chain of dependent loads (node -> box ->
// next node; leaf -> triangles), so latency, with divergence between rays
// that take different paths through the tree. The node and triangle
// arrays (~1.2 MB for 12k triangles) stay in L2 and are read through the
// read-only path.

#pragma once

#include <math.h>
#include <stdint.h>

#ifndef F3D_HD
#ifdef __CUDACC__
#define F3D_HD __host__ __device__ __forceinline__
#else
#define F3D_HD inline
#endif
#endif

#define F3D_LEAF_SIZE 4  // bvh.py:_LEAF_SIZE

struct MeshArgs {               // mirrored by _kernels.MeshArgs
    const float* bmin;          // (n_nodes, 3)
    const float* bmax;          // (n_nodes, 3)
    const int* first;           // (n_nodes,)
    const int* count;           // (n_nodes,): 0 = interior
    const int* miss;            // (n_nodes,): DFS successor skipping the subtree
    const float* v0;            // (n_prims, 3), BVH order
    const float* e1;            // (n_prims, 3): v1 - v0
    const float* e2;            // (n_prims, 3): v2 - v0
    const float* fnorm;         // (n_prims, 3) unit face normals, or null
    int n_nodes, n_prims, max_iters;
};

struct MeshHit {
    int prim;  // BVH-order primitive, -1 on a miss
    float t, u, v;
};

#ifdef __CUDA_ARCH__
#define F3D_LDG(p) __ldg(p)
#else
#define F3D_LDG(p) (*(p))
#endif

F3D_HD float mesh_inv(float d) {
    return fabsf(d) > 1e-12f ? 1.0f / d : (d >= 0.0f ? 1e12f : -1e12f);
}

// bvh.py:_moller_trumbore for triangle p; tmax is the current best t.
F3D_HD bool moller_trumbore(const MeshArgs& m, int p, float rox, float roy, float roz,
                            float rdx, float rdy, float rdz, float tmin, float tmax,
                            float& t, float& u, float& v) {
    const float* a = m.v0 + 3 * p;
    const float* b = m.e1 + 3 * p;
    const float* c = m.e2 + 3 * p;
    float v0x = F3D_LDG(a), v0y = F3D_LDG(a + 1), v0z = F3D_LDG(a + 2);
    float e1x = F3D_LDG(b), e1y = F3D_LDG(b + 1), e1z = F3D_LDG(b + 2);
    float e2x = F3D_LDG(c), e2y = F3D_LDG(c + 1), e2z = F3D_LDG(c + 2);
    float px = rdy * e2z - rdz * e2y;
    float py = rdz * e2x - rdx * e2z;
    float pz = rdx * e2y - rdy * e2x;
    float det = e1x * px + e1y * py + e1z * pz;
    bool big = fabsf(det) > 1e-12f;
    float inv_det = big ? 1.0f / det : 0.0f;
    float sx = rox - v0x, sy = roy - v0y, sz = roz - v0z;
    u = (sx * px + sy * py + sz * pz) * inv_det;
    float qx = sy * e1z - sz * e1y;
    float qy = sz * e1x - sx * e1z;
    float qz = sx * e1y - sy * e1x;
    v = (rdx * qx + rdy * qy + rdz * qz) * inv_det;
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    return big && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin && t < tmax;
}

// bvh.py:trace_mesh for one ray. kAny (P3's shadow rays) stops the walk at
// the first triangle it accepts: up to that triangle the walk is the same
// step for step, so the ray is blocked (prim >= 0) exactly when the whole
// walk would have accepted one.
template <bool kAny = false>
F3D_HD MeshHit trace_mesh_ray(const MeshArgs& m, float rox, float roy, float roz,
                              float rdx, float rdy, float rdz, float tmin, float tmax) {
    MeshHit h;
    h.prim = -1;
    h.t = tmax;
    h.u = 0.0f;
    h.v = 0.0f;
    const float ix = mesh_inv(rdx), iy = mesh_inv(rdy), iz = mesh_inv(rdz);
    int node = 0;
    for (int it = 0; it < m.max_iters && node < m.n_nodes; ++it) {
        const float* lo = m.bmin + 3 * node;
        const float* hi = m.bmax + 3 * node;
        float t0x = (F3D_LDG(lo) - rox) * ix, t1x = (F3D_LDG(hi) - rox) * ix;
        float t0y = (F3D_LDG(lo + 1) - roy) * iy, t1y = (F3D_LDG(hi + 1) - roy) * iy;
        float t0z = (F3D_LDG(lo + 2) - roz) * iz, t1z = (F3D_LDG(hi + 2) - roz) * iz;
        float t_enter = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                              fmaxf(fminf(t0z, t1z), tmin));
        float t_exit = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), h.t));
        bool box_hit = t_enter <= t_exit;
        int cnt = F3D_LDG(m.count + node);
        if (box_hit && cnt == 0) {  // interior: first child follows
            node += 1;
            continue;
        }
        if (box_hit) {  // leaf
            int fst = F3D_LDG(m.first + node);
            for (int k = 0; k < F3D_LEAF_SIZE && k < cnt; ++k) {
                int p = fst + k < m.n_prims - 1 ? fst + k : m.n_prims - 1;
                float t, u, v;
                if (moller_trumbore(m, p, rox, roy, roz, rdx, rdy, rdz, tmin, h.t, t, u, v)) {
                    h.t = t;
                    h.prim = p;
                    h.u = u;
                    h.v = v;
                    if (kAny) return h;
                }
            }
        }
        node = F3D_LDG(m.miss + node);
    }
    return h;
}

// The face normal of hit primitive `prim`, turned against the ray
// (two-sided shading: terrain_ref.py:_hyb_primary, mesh_render.py).
F3D_HD void mesh_normal(const MeshArgs& m, int prim, float rdx, float rdy, float rdz,
                        float& nx, float& ny, float& nz) {
    int p = prim > 0 ? prim : 0;
    nx = F3D_LDG(m.fnorm + 3 * p);
    ny = F3D_LDG(m.fnorm + 3 * p + 1);
    nz = F3D_LDG(m.fnorm + 3 * p + 2);
    if (nx * rdx + ny * rdy + nz * rdz > 0.0f) {
        nx = -nx;
        ny = -ny;
        nz = -nz;
    }
}
