// forge3d_tpu_torch/csrc/pt.cuh
// Per-thread bodies of the TLAS walk P5 (forge3d_tpu/ops/tlas.py:trace_tlas
// 86) and the hybrid tracer P3 (forge3d_tpu/pt/hybrid.py:_trace_all 77,
// _occluded_all 149, hybrid_render 154), launched by pt.cu.
//
// P5: one ray visits the instances in index order; each moves the ray into
// object space by the float32 world-to-object matrix (the direction is not
// renormalised, so t stays world-scaled) and walks that instance's BLAS with
// K9's body; a hit replaces the best only when strictly nearer, so the first
// instance wins a tie, as in JAX. JAX runs these transforms as eager array
// operations, each rounded: no multiply-add is fused. The instances' table
// (TlasInst: the transform, the BLAS's MeshArgs and a world-space box) is
// built once with the TLAS (ops/tlas.py:instance_table); a block stages it
// in shared memory F3D_TLAS_CHUNK instances at a time, and a ray skips the
// transform and the walk of an instance whose box it misses (the cull,
// below: most rays leave most instances at the root box).
//
// P3: the nearest hit over the terrain (K5 and normal_at), the mesh (K9,
// the face normal turned against the ray) and the SDF (P6's march and
// normal), compared with a strict `<` in that order, so the terrain wins a
// tie, then the mesh; then the sun's shadow ray from p + n * 1e-3 through
// every enabled kind, the sky ambient, Reinhard and the u8 encode.
// hybrid_render is eager JAX: every operation below is rounded on its own,
// as -fmad=false keeps it. The shadow ray is any-hit: once one kind blocks
// it the others cannot unblock it, so the thread stops there; a pixel that
// missed everything casts none (JAX computes its shadow ray and masks it).
//
// The SDF march is culled by the tape's box (sdf.cuh: sdf_cull_span). A
// primary ray marches only [tmin, min(t so far, the box's exit)] and not at
// all when that misses the box: a hit the bounded march finds is the
// unbounded march's first hit; where it stops without one, the unbounded
// march has none, or hits at t >= the t so far, which `r.t < t` discards,
// or beyond the box, where the tape cannot fall below the threshold. A
// shadow ray marches only to the box's exit and not at all when it misses
// the box. The shadow ray's mesh test is any-hit (mesh.cuh: kAny): it asks
// only whether some triangle blocks. The primary ray's mesh walk keeps
// tmax = 1e6 and is not cut at the terrain's t: the walk prunes its boxes
// by its best t, and a triangle lying on its leaf box's face (every wall of
// the town) can have a computed t an ulp below the box's computed entry;
// with a terrain t between the two, a walk started at the terrain's t would
// prune a box whose triangle the whole walk keeps.

#pragma once

#include "common.cuh"
#include "sdf.cuh"

#define F3D_TLAS_CHUNK 64   // instances a block stages at a time

// One instance of the kernel's table, 128 bytes (mirrored by
// _kernels.TlasInst; ops/tlas.py:instance_table forms it), aligned so that
// the cull's fields come from shared memory in 16-byte loads.
struct alignas(16) TlasInst {
    float lo[3], hi[3];    // the cull's world-space box of the BLAS's root
    float g0, g1;          // its margin for a ray from ro: g0 + g1 * |ro|_inf
    float dir_min, org_max;  // the cull applies where |rd|_inf >= dir_min, |ro|_inf <= org_max
    float xform[12];       // world->object 3x3 row-major, then translation (float32)
    MeshArgs blas;         // the instance's BLAS
};

struct TlasArgs {          // mirrored by _kernels.TlasArgs
    const TlasInst* inst;  // (n_inst,) in device memory
    int n_inst;
};

struct TlasHit {
    int hit;
    float t;
    int instance, prim;
    float u, v;
};

// A ray as the cull reads it: its world-space reciprocal direction, formed
// once, |ro|_inf and |rd|_inf, and whether every component is finite
struct TlasRay {
    float o[3], d[3], inv[3];
    float org, dir;
    bool finite;
};

F3D_HD TlasRay tlas_ray_of(float rox, float roy, float roz, float rdx, float rdy, float rdz) {
    TlasRay r;
    r.o[0] = rox, r.o[1] = roy, r.o[2] = roz;
    r.d[0] = rdx, r.d[1] = rdy, r.d[2] = rdz;
    r.finite = true;
    r.org = r.dir = 0.0f;
    for (int k = 0; k < 3; ++k) {
        r.inv[k] = mesh_inv(r.d[k]);
        r.finite = r.finite && isfinite(r.o[k]) && isfinite(r.d[k]);
        r.org = fmaxf(r.org, fabsf(r.o[k]));
        r.dir = fmaxf(r.dir, fabsf(r.d[k]));
    }
    return r;
}

// The cull: false only where the instance's root box test, as the walk
// makes it in object space, cannot accept the ray. Why the margin makes it
// so (ops/tlas.py:cull_margin forms g0, g1, dir_min and org_max in float64,
// doubled, rounded up):
//  - The walk's root test takes the ray o' = fl(M ro + m), d' = fl(M rd)
//    (M, m the float32 world-to-object matrix and translation; each
//    component 3 or 4 rounded operations, so |o' - (M ro + m)| <= 4.01u
//    (|M||ro| + |m|) and |d' - M rd| <= 3.01u |M||rd|, u = 2^-24), and its
//    reciprocals: fl(1/d') (relative error u) or, for |d'| <= F3D_MESH_INV_MIN
//    (mesh.cuh), +-F3D_MESH_INV_CLAMP, the reciprocal of a direction within
//    z = F3D_MESH_INV_MIN + 1 / F3D_MESH_INV_CLAMP (~2e-12) of d'. Call that
//    direction delta: the slabs are exactly those of the ray o' + t delta
//    save the rounding of (lo - o') * i, a relative 2u + u^2 on each end.
//  - If it accepts, t = its t_enter lies in [tmin, tmax] (t_enter is a max
//    with tmin, t_exit a min with tmax) and inside every axis' slab, so
//    Q = o' + t delta lies in the root box grown by e = 2.1u (b + |o'|)
//    (b the box's largest coordinate). The box's world image holds
//    T(Q) = A Q + c (A, c the float64 object-to-world transform) within
//    ||A|| e of the box of its eight corners (lo, hi here, rounded outward).
//  - T(Q) = R(t) + F R(t) + h + A(r_o + t (delta - M rd)), R(t) = ro + t rd
//    the exact world ray, F = A M - I and h = A m + c the float32
//    transform's residuals (measured on the host), r_o the rounding of o'.
//    |t| |rd| <= T0 = (b + e + |o'|) Ahat / 0.98 with Ahat = ||M^-1||, as
//    |delta| >= 0.98 |rd| / Ahat wherever |rd| >= dir_min (dir_min and M's
//    conditioning make 4.05u ||M|| Ahat and z Ahat / dir_min <= 0.01;
//    an instance that fails this is never culled). So R(t) lies within
//    E = ||A|| e + ||A|| 4.01u (||M|| |ro| + |m|) + ||A|| T0 (4.05u ||M|| +
//    z / dir_min) + ||F|| (|ro| + T0) + |h| of the box: linear in |ro|.
//  - This test forms the world slabs of [lo - g, hi + g] with the world
//    reciprocal (mesh_inv again); R(t) inside that box by s = (3.2u + 1.025 z
//    / dir_min) (|lo, hi| + g + |ro|) on every axis puts t inside every
//    computed slab, despite the roundings of lo - g, of (L - ro) * inv and
//    of the clamped reciprocal; t in [tmin, tmax] then passes the clip, so
//    the clip needs no margin of its own. g = g0 + g1 |ro| covers E, s and
//    the rounding of lo - g; org_max (2^40) keeps every product finite.
//  - The root test rejecting means no hit: the walk goes to the root's miss
//    link, the end of the tree (an instance whose root link is not the end,
//    or whose table is not finite, has an infinite box and is never culled).
// A ray with a component not finite, |rd| < dir_min or |ro| > org_max
// visits the instance as before.
F3D_HD bool tlas_cull(const TlasInst& in, const TlasRay& r, float tmin, float tmax) {
    if (!(r.finite && r.dir >= in.dir_min && r.org <= in.org_max)) return true;
    const float g = in.g0 + in.g1 * r.org;
    float t_enter = tmin, t_exit = tmax;
    for (int k = 0; k < 3; ++k) {
        const float t0 = ((in.lo[k] - g) - r.o[k]) * r.inv[k];
        const float t1 = ((in.hi[k] + g) - r.o[k]) * r.inv[k];
        t_enter = fmaxf(t_enter, fminf(t0, t1));
        t_exit = fminf(t_exit, fmaxf(t0, t1));
    }
    return t_enter <= t_exit;
}

// the ray in the instance's object space (tlas.py: the eager float32 products)
F3D_HD void tlas_object_ray(const TlasInst& in, const TlasRay& r, float* o, float* d) {
    const float* l = in.xform;
    o[0] = l[0] * r.o[0] + l[1] * r.o[1] + l[2] * r.o[2] + l[9];
    o[1] = l[3] * r.o[0] + l[4] * r.o[1] + l[5] * r.o[2] + l[10];
    o[2] = l[6] * r.o[0] + l[7] * r.o[1] + l[8] * r.o[2] + l[11];
    d[0] = l[0] * r.d[0] + l[1] * r.d[1] + l[2] * r.d[2];
    d[1] = l[3] * r.d[0] + l[4] * r.d[1] + l[5] * r.d[2];
    d[2] = l[6] * r.d[0] + l[7] * r.d[1] + l[8] * r.d[2];
}

// the walk's root box test of the instance, trace_mesh_ray's own
// (mesh_box_hit; F3D_P5_CULL_CHECK's and the tests' check of the cull)
F3D_HD bool tlas_root_accepts(const TlasInst& in, const TlasRay& r, float tmin, float tmax) {
    if (in.blas.n_nodes <= 0 || in.blas.max_iters <= 0) return false;
    float o[3], d[3];
    tlas_object_ray(in, r, o, d);
    return mesh_box_hit(mesh_word(in.blas.nodes), mesh_word(in.blas.nodes + 4), o[0], o[1], o[2],
                        mesh_inv(d[0]), mesh_inv(d[1]), mesh_inv(d[2]), tmin, tmax);
}

// instance `idx` (in.blas's walk) for ray r, the best hit updated where
// strictly nearer: tlas.py:trace_tlas's loop body
F3D_HD void tlas_walk(const TlasInst& in, int idx, const TlasRay& r, float tmin, float tmax,
                      TlasHit& b) {
    float o[3], d[3];
    tlas_object_ray(in, r, o, d);
#ifdef F3D_P5_ROOT_ONLY   // measurement build: every walk stops after its root box test
    MeshArgs mesh = in.blas;
    mesh.n_nodes = mesh.n_nodes < 1 ? mesh.n_nodes : 1;
#else
    const MeshArgs& mesh = in.blas;
#endif
    MeshHit h = trace_mesh_ray<false, true>(mesh, o[0], o[1], o[2], d[0], d[1], d[2], tmin, tmax);
    if (h.prim >= 0 && h.t < b.t) {
        b.hit = 1;
        b.t = h.t;
        b.instance = idx;
        b.prim = h.prim;
        b.u = h.u;
        b.v = h.v;
    }
}

F3D_HD TlasHit tlas_miss(float tmax) {
    TlasHit b;
    b.hit = 0;
    b.t = tmax;
    b.instance = -1;
    b.prim = 0;
    b.u = 0.0f;
    b.v = 0.0f;
    return b;
}

struct HybridArgs {        // mirrored by _kernels.HybridArgs
    int width, height, use_terrain, use_mesh, use_sdf;
    float cam_o[3], sun[3];
    float sun_i, env_intensity, exposure;
    float albedo[9];       // (terrain, mesh, sdf) x rgb
};

struct HybridOut {         // mirrored by _kernels.HybridOut; a null plane is not written
    unsigned char* rgba;   // (H, W, 4)
    float* depth;          // (H, W)
    float* normal;         // (H, W, 3)
    float* vis;            // (H, W)
    int* kind;             // (H, W)
    float* albedo;         // (H, W, 3)
};

#define F3D_HYB_FAR 1e6f   // hybrid.py: tmax of the primary and shadow rays
#define F3D_SDF_STEPS 128  // SdfScene.raymarch's defaults
#define F3D_SDF_HIT 1e-3f

// hybrid.py:_trace_all for one ray: the nearest hit, its normal and kind
// (0 terrain, 1 mesh, 2 sdf, -1 none; the normal (0, 1, 0) on a miss);
// the SDF's tape read through the read-only cache
F3D_HD int hybrid_nearest(const SceneArgs& s, const MeshArgs& m, const SdfArgs& sdf,
                          const HybridArgs& a, float ox, float oy, float oz, float dx, float dy,
                          float dz, float tmin, float tmax, float& t, float& nx, float& ny,
                          float& nz) {
    int kind = -1;
    t = tmax;
    nx = 0.0f;
    ny = 1.0f;
    nz = 0.0f;
    if (a.use_terrain) {
        Hit r = trace_ray(s, ox, oy, oz, dx, dy, dz, tmin, tmax);
        if (r.hit && r.t < t) {
            t = r.t;
            normal_at(s, ox + r.t * dx, oz + r.t * dz, r.cell_x, r.cell_z, nx, ny, nz);
            kind = 0;
        }
    }
    if (a.use_mesh) {
        MeshHit r = trace_mesh_ray(m, ox, oy, oz, dx, dy, dz, tmin, tmax);
        if (r.prim >= 0 && r.t < t) {
            t = r.t;
            mesh_normal(m, r.prim, dx, dy, dz, nx, ny, nz);
            kind = 1;
        }
    }
    float tm = t;
    if (a.use_sdf && sdf_cull_span(sdf, ox, oy, oz, dx, dy, dz, F3D_SDF_HIT, tmin, tm)) {
        SdfHit r = sdf_march_t<true>(sdf.tape, sdf.tape_len, ox, oy, oz, dx, dy, dz, tmin, tm,
                                     F3D_SDF_STEPS, F3D_SDF_HIT);
        if (r.hit && r.t < t) {
            t = r.t;
            sdf_normal_t<true>(sdf.tape, sdf.tape_len, ox + r.t * dx, oy + r.t * dy, oz + r.t * dz,
                               1e-4f, nx, ny, nz);
            kind = 2;
        }
    }
    return kind;
}

// hybrid.py:_occluded_all for one ray (tmin 1e-3, tmax 1e6)
F3D_HD bool hybrid_occluded(const SceneArgs& s, const MeshArgs& m, const SdfArgs& sdf,
                            const HybridArgs& a, float ox, float oy, float oz, float dx,
                            float dy, float dz) {
    if (a.use_terrain) {
        Hit r = trace_ray(s, ox, oy, oz, dx, dy, dz, 1e-3f, F3D_HYB_FAR);
        if (r.hit && r.t < F3D_HYB_FAR) return true;
    }
    if (a.use_mesh) {
        MeshHit r = trace_mesh_ray<true>(m, ox, oy, oz, dx, dy, dz, 1e-3f, F3D_HYB_FAR);
        if (r.prim >= 0 && r.t < F3D_HYB_FAR) return true;
    }
    float tm = F3D_HYB_FAR;
    if (a.use_sdf && sdf_cull_span(sdf, ox, oy, oz, dx, dy, dz, F3D_SDF_HIT, 1e-3f, tm)) {
        SdfHit r = sdf_march_t<true>(sdf.tape, sdf.tape_len, ox, oy, oz, dx, dy, dz, 1e-3f, tm,
                                     F3D_SDF_STEPS, F3D_SDF_HIT);
        if (r.hit && r.t < F3D_HYB_FAR) return true;
    }
    return false;
}

F3D_HD unsigned char hybrid_u8(float c) {
    float ldr = c / (c + 1.0f);
    return (unsigned char)(fminf(fmaxf(ldr, 0.0f), 1.0f) * 255.0f + 0.5f);
}

// hybrid_render for pixel i, whose ray direction is (rdx, rdy, rdz)
F3D_HD void hybrid_pixel(const SceneArgs& s, const MeshArgs& m, const SdfArgs& sdf,
                         const HybridArgs& a, const float* rdx, const float* rdy,
                         const float* rdz, const HybridOut& o, int i) {
    const float ox = a.cam_o[0], oy = a.cam_o[1], oz = a.cam_o[2];
    const float dx = rdx[i], dy = rdy[i], dz = rdz[i];
    float t, nx, ny, nz;
    const int kind = hybrid_nearest(s, m, sdf, a, ox, oy, oz, dx, dy, dz, 1e-3f, F3D_HYB_FAR,
                                    t, nx, ny, nz);
    const bool hit = kind >= 0;
    const int ka = kind < 0 ? 0 : kind;
    const float* alb = a.albedo + 3 * ka;
    float rgb[3];
    if (hit) {
        float px = ox + t * dx + nx * 1e-3f;
        float py = oy + t * dy + ny * 1e-3f;
        float pz = oz + t * dz + nz * 1e-3f;
        const bool sh = hybrid_occluded(s, m, sdf, a, px, py, pz, a.sun[0], a.sun[1], a.sun[2]);
        float ndl = fmaxf(nx * a.sun[0] + ny * a.sun[1] + nz * a.sun[2], 0.0f);
        float vis = sh ? 0.0f : 1.0f;
        float amb = a.env_intensity * (0.5f + 0.5f * ny);
        float lit = a.sun_i * ndl * vis / 3.14159265358979f + amb;
        for (int c = 0; c < 3; ++c) rgb[c] = alb[c] * lit;
    } else {
        float k = fminf(fmaxf(dy, 0.0f), 1.0f);
        rgb[0] = 0.45f + 0.35f * k;
        rgb[1] = 0.62f + 0.25f * k;
        rgb[2] = 0.85f + 0.1f * k;
    }
    if (o.rgba) {
        for (int c = 0; c < 3; ++c) o.rgba[4 * i + c] = hybrid_u8(rgb[c] * a.exposure);
        o.rgba[4 * i + 3] = 255;
    }
    if (o.depth) o.depth[i] = hit ? t : 0.0f;
    if (o.normal) {
        o.normal[3 * i] = nx;
        o.normal[3 * i + 1] = ny;
        o.normal[3 * i + 2] = nz;
    }
    if (o.vis) o.vis[i] = hit ? 1.0f : 0.0f;
    if (o.kind) o.kind[i] = kind;
    if (o.albedo) {
        for (int c = 0; c < 3; ++c) o.albedo[3 * i + c] = alb[c];
    }
}
