// forge3d_tpu_torch/csrc/mesh.cuh
// Kernel K9's body: the closest hit of one ray against a triangle mesh
// through the threaded SAH BVH (forge3d_tpu/ops/bvh.py:trace_mesh with
// _moller_trumbore). Runs inside the frame kernel K6, the G-buffer kernel
// K8, the mesh engine P2, the TLAS walk P5 and the hybrid tracer P3, and
// alone in kernels.cu:trace_mesh_kernel.
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
// The records are packed on the host (ops/bvh.py: pack_nodes, pack_tris;
// the JAX layout's arrays stay for the plain version). A node is 32 bytes,
// lo.xyz with the miss link and hi.xyz with first << 3 | count: two 16-byte
// loads in one round, so the next node's index comes with the box, where
// the arrays took seven loads and, on leaving a subtree, an eighth that
// waited on the box test. A triangle is 48 bytes (v0, e1, e2, each padded
// to 16): three loads, where the arrays took nine.
//
// What bounds it on the card: a chain of dependent loads (node -> next node;
// leaf -> triangles), so latency, with divergence between rays that take
// different paths through the tree. The records (~1 MB for 12k triangles)
// stay in L2 and are read through the read-only path.
//
// An exact 4-wide walk over the same tree (every other level of interior
// nodes folded away, a stack of the hit slots popped in DFS order and
// tested again with the best t of the pop) measured slower than this walk
// in every kernel that runs it on an H100 (PERF.md §6): it tests more
// boxes a ray for fewer load rounds, and the walks here are not bound by
// the rounds alone.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifndef F3D_HD
#ifdef __CUDACC__
#define F3D_HD __host__ __device__ __forceinline__
#else
#define F3D_HD inline
#endif
#endif

#define F3D_LEAF_SIZE 4  // bvh.py:_LEAF_SIZE

struct MeshArgs {               // mirrored by _kernels.MeshArgs
    const float* nodes;         // (n_nodes, 8): bvh.py:pack_nodes
    const float* tris;          // (n_prims, 12): bvh.py:pack_tris, BVH order
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

// one 16-byte word of a record, through the read-only path
struct MeshWord {
    float x, y, z, w;
};

F3D_HD MeshWord mesh_word(const float* p) {
    MeshWord r;
#ifdef __CUDA_ARCH__
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    r.x = v.x, r.y = v.y, r.z = v.z, r.w = v.w;
#else
    r.x = p[0], r.y = p[1], r.z = p[2], r.w = p[3];
#endif
    return r;
}

F3D_HD int mesh_bits(float f) {
#ifdef __CUDA_ARCH__
    return __float_as_int(f);
#else
    int i;
    memcpy(&i, &f, 4);
    return i;
#endif
}

// mesh_inv's limits (bvh.py:_inv): a component at or under F3D_MESH_INV_MIN
// in magnitude takes +-F3D_MESH_INV_CLAMP. Their one home: pt.cu's
// f3d_tlas_attrs reports them, and ops/tlas.py:cull_margin's argument
// takes them from here (_kernels.csrc_constant).
#define F3D_MESH_INV_MIN 1e-12f
#define F3D_MESH_INV_CLAMP 1e12f

F3D_HD float mesh_inv(float d) {
    return fabsf(d) > F3D_MESH_INV_MIN ? 1.0f / d
                                       : (d >= 0.0f ? F3D_MESH_INV_CLAMP : -F3D_MESH_INV_CLAMP);
}

// The walk's slab test of a node's box [lo, hi] for the ray ro + t rd
// (ix, iy, iz = mesh_inv of rd) clipped to [tmin, tmax]: trace_mesh_ray's,
// and P5's check of its cull (pt.cuh:tlas_root_accepts).
F3D_HD bool mesh_box_hit(const MeshWord& lo, const MeshWord& hi, float rox, float roy, float roz,
                         float ix, float iy, float iz, float tmin, float tmax) {
    float t0x = (lo.x - rox) * ix, t1x = (hi.x - rox) * ix;
    float t0y = (lo.y - roy) * iy, t1y = (hi.y - roy) * iy;
    float t0z = (lo.z - roz) * iz, t1z = (hi.z - roz) * iz;
    float t_enter = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), tmin));
    float t_exit = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fminf(fmaxf(t0z, t1z), tmax));
    return t_enter <= t_exit;
}

// bvh.py:_moller_trumbore for triangle p; tmax is the current best t.
F3D_HD bool moller_trumbore(const MeshArgs& m, int p, float rox, float roy, float roz,
                            float rdx, float rdy, float rdz, float tmin, float tmax,
                            float& t, float& u, float& v) {
    const float* r = m.tris + 12 * p;
    const MeshWord a = mesh_word(r), b = mesh_word(r + 4), c = mesh_word(r + 8);
    const float v0x = a.x, v0y = a.y, v0z = a.z;
    const float e1x = b.x, e1y = b.y, e1z = b.z;
    const float e2x = c.x, e2y = c.y, e2z = c.z;
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

// Triangle p of a leaf against the ray, the best hit updated where it is
// nearer; true where kAny stops (the best t below `stop`).
template <bool kAny>
F3D_HD bool mesh_leaf_tri(const MeshArgs& m, int p, float rox, float roy, float roz, float rdx,
                          float rdy, float rdz, float tmin, float stop, MeshHit& h) {
    float t, u, v;
    if (!moller_trumbore(m, p, rox, roy, roz, rdx, rdy, rdz, tmin, h.t, t, u, v)) return false;
    h.t = t;
    h.prim = p;
    h.u = u;
    h.v = v;
    return kAny && t < stop;
}

// A leaf's triangles in order, word = first << 3 | count (each index
// clamped to the last triangle); true where kAny stops. kUnroll unrolls the
// loop, so that the leaf's triangle loads can issue together: faster where
// the walk is most of the kernel (K9 alone, K8, P2, P5), slower inside K6
// and P3, which keep the loop (PERF.md §6).
template <bool kAny, bool kUnroll>
F3D_HD bool mesh_leaf(const MeshArgs& m, int word, float rox, float roy, float roz, float rdx,
                      float rdy, float rdz, float tmin, float stop, MeshHit& h) {
    const int fst = word >> 3, cnt = word & 7;
    const int last = m.n_prims - 1;
    // The loop twice, only the pragma differs: one loop under
    // `#pragma unroll (kUnroll ? F3D_LEAF_SIZE : 1)`, with `k < cnt` in its
    // test or as a break, compiled to more registers (K9 alone 52, not 44;
    // K8 52, not 47) and measured slower on an H100 (PERF.md §6).
    if (kUnroll) {
#pragma unroll
        for (int k = 0; k < F3D_LEAF_SIZE && k < cnt; ++k)
            if (mesh_leaf_tri<kAny>(m, fst + k < last ? fst + k : last, rox, roy, roz, rdx, rdy,
                                    rdz, tmin, stop, h))
                return true;
    } else {
#pragma unroll 1
        for (int k = 0; k < F3D_LEAF_SIZE && k < cnt; ++k)
            if (mesh_leaf_tri<kAny>(m, fst + k < last ? fst + k : last, rox, roy, roz, rdx, rdy,
                                    rdz, tmin, stop, h))
                return true;
    }
    return false;
}

// bvh.py:trace_mesh for one ray. kAny (the shadow rays of K6, P2 and P3)
// stops once a triangle is accepted with t below `stop` (by default at the
// first accepted): up to there the walk is the whole walk, whose best t can
// only fall further, so the ray is blocked (prim >= 0), or blocked before
// `stop`, exactly when the whole walk's hit is.
template <bool kAny = false, bool kUnroll = false>
F3D_HD MeshHit trace_mesh_ray(const MeshArgs& m, float rox, float roy, float roz, float rdx,
                              float rdy, float rdz, float tmin, float tmax,
                              float stop = HUGE_VALF) {
    MeshHit h;
    h.prim = -1;
    h.t = tmax;
    h.u = 0.0f;
    h.v = 0.0f;
    const float ix = mesh_inv(rdx), iy = mesh_inv(rdy), iz = mesh_inv(rdz);
    int node = 0;
    for (int it = 0; it < m.max_iters && node < m.n_nodes; ++it) {
        const MeshWord lo = mesh_word(m.nodes + 8 * node), hi = mesh_word(m.nodes + 8 * node + 4);
        const bool box_hit = mesh_box_hit(lo, hi, rox, roy, roz, ix, iy, iz, tmin, h.t);
        const int word = mesh_bits(hi.w);
        if (box_hit && (word & 7) == 0) {  // interior: first child follows
            node += 1;
            continue;
        }
        if (box_hit
            && mesh_leaf<kAny, kUnroll>(m, word, rox, roy, roz, rdx, rdy, rdz, tmin, stop, h))
            return h;
        node = mesh_bits(lo.w);
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
