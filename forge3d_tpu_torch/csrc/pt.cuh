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
// operations, each rounded: no multiply-add is fused.
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

struct TlasArgs {          // mirrored by _kernels.TlasArgs
    const MeshArgs* blas;  // (n_blas,) in device memory
    const float* xform;    // (n_inst, 12): world->object 3x3 row-major, then translation
    const int* inst_blas;  // (n_inst,)
    int n_inst;
};

struct TlasHit {
    int hit;
    float t;
    int instance, prim;
    float u, v;
};

// tlas.py:trace_tlas for one ray
F3D_HD TlasHit tlas_ray(const TlasArgs& a, float rox, float roy, float roz, float rdx,
                        float rdy, float rdz, float tmin, float tmax) {
    TlasHit b;
    b.hit = 0;
    b.t = tmax;
    b.instance = -1;
    b.prim = 0;
    b.u = 0.0f;
    b.v = 0.0f;
    for (int i = 0; i < a.n_inst; ++i) {
        const float* m = a.xform + 12 * i;
        float l[12];
        for (int k = 0; k < 12; ++k) l[k] = F3D_LDG(m + k);
        float ox = l[0] * rox + l[1] * roy + l[2] * roz + l[9];
        float oy = l[3] * rox + l[4] * roy + l[5] * roz + l[10];
        float oz = l[6] * rox + l[7] * roy + l[8] * roz + l[11];
        float dx = l[0] * rdx + l[1] * rdy + l[2] * rdz;
        float dy = l[3] * rdx + l[4] * rdy + l[5] * rdz;
        float dz = l[6] * rdx + l[7] * rdy + l[8] * rdz;
        const MeshArgs mesh = a.blas[F3D_LDG(a.inst_blas + i)];
        MeshHit h = trace_mesh_ray<false, true>(mesh, ox, oy, oz, dx, dy, dz, tmin, tmax);
        if (h.prim >= 0 && h.t < b.t) {
            b.hit = 1;
            b.t = h.t;
            b.instance = i;
            b.prim = h.prim;
            b.u = h.u;
            b.v = h.v;
        }
    }
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
