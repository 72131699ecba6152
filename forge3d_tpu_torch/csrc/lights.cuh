// forge3d_tpu_torch/csrc/lights.cuh
// Kernel K10's body: one next-event light sample for one lane
// (forge3d_tpu/ops/lightsample.py:alias_sample and sample_light_nee). Runs
// inside the frame kernel K6 once per camera sample, and alone in
// kernels.cu:sample_light_kernel.
//
// The JAX version evaluates every light type's formula on every lane and
// selects by the picked light's type with `where` chains; here the thread
// takes the branch of its own light's type and computes the same values in
// the same order. What bounds it: a few dependent loads from the (L,)-row
// light and alias tables (a few hundred bytes, in L1), then ~60 float32
// operations with one sqrt, one division and a sin/cos pair for disk and
// sphere lights.

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

// lighting.py:LIGHT_TYPES
enum LightType { F3D_DIRECTIONAL = 0, F3D_POINT = 1, F3D_SPOT = 2, F3D_RECT = 3,
                 F3D_DISK = 4, F3D_SPHERE = 5 };

struct LightArgs {           // mirrored by _kernels.LightArgs
    const int* type_id;      // (L,)
    const float* color;      // (L, 3) premultiplied by intensity
    const float* direction;  // (L, 3)
    const float* position;   // (L, 3)
    const float* radius;     // (L,)
    const float* extent;     // (L, 2)
    const float* cones;      // (L, 2) cos(inner), cos(outer)
    const float* prob;       // alias table (L,)
    const int* alias;        // (L,)
    const float* pdf;        // (L,)
    int count;               // L; 0 = no typed lights
    float u_hi;              // float32(L - 1e-6)
};

struct LightSample {
    float dx, dy, dz, dist, wr, wg, wb;
};

#define F3D_TWO_PI_LS 6.2831853f          // lightsample.py's `two_pi`
#define F3D_PI_F 3.14159265358979323846f  // float32(pi)
#define F3D_FOUR_PI_F 12.566370614359172f // float32(4.0 * pi), a double product

// lightsample.py:alias_sample for one lane: (index, selection pdf).
F3D_HD int alias_pick(const LightArgs& L, float u, float& p_pick) {
    float x = fminf(fmaxf(u * (float)L.count, 0.0f), L.u_hi);
    int col = (int)x;
    float frac = x - (float)col;
    int idx = frac < L.prob[col] ? col : L.alias[col];
    p_pick = L.pdf[idx];
    return idx;
}

// lightsample.py:sample_light_nee for one lane at surface point p with
// normal n, from uniforms (u_pick, u1, u2).
F3D_HD LightSample sample_light(const LightArgs& L, float px, float py, float pz,
                                float nx, float ny, float nz, float u_pick, float u1,
                                float u2) {
    float p_pick;
    const int i = alias_pick(L, u_pick, p_pick);
    const int type = L.type_id[i];
    const float rad = L.radius[i];
    const float* ldir = L.direction + 3 * i;
    const float* lpos = L.position + 3 * i;

    // sampled emitter point: area lights jitter, the others use the center
    float off_x = 0.0f, off_y = 0.0f, off_z = 0.0f;
    if (type == F3D_RECT) {
        off_x = (u1 * 2.0f - 1.0f) * L.extent[2 * i];
        off_z = (u2 * 2.0f - 1.0f) * L.extent[2 * i + 1];
    } else if (type == F3D_DISK) {
        float dr = sqrtf(u1) * rad;
        float dphi = F3D_TWO_PI_LS * u2;
        off_x = dr * cosf(dphi);
        off_z = dr * sinf(dphi);
    } else if (type == F3D_SPHERE) {
        float sz = u1 * 2.0f - 1.0f;
        float sphi = F3D_TWO_PI_LS * u2;
        float sr = sqrtf(fmaxf(1.0f - sz * sz, 0.0f));
        off_x = rad * sr * cosf(sphi);
        off_y = rad * sz;
        off_z = rad * sr * sinf(sphi);
    }
    float vx = (lpos[0] + off_x) - px;
    float vy = (lpos[1] + off_y) - py;
    float vz = (lpos[2] + off_z) - pz;
    float d2 = vx * vx + vy * vy + vz * vz;
    LightSample s;
    if (type == F3D_DIRECTIONAL) {
        s.dx = -ldir[0];
        s.dy = -ldir[1];
        s.dz = -ldir[2];
        s.dist = 1e30f;
    } else {
        float dist = sqrtf(fmaxf(d2, 1e-12f));
        float inv = 1.0f / dist;
        s.dx = vx * inv;
        s.dy = vy * inv;
        s.dz = vz * inv;
        s.dist = dist;
    }
    float ndl = fmaxf(nx * s.dx + ny * s.dy + nz * s.dz, 0.0f);

    // geometric factor: 1 (directional), 1/r^2 (point, spot), and
    // area * cos_on_light / r^2 for the area lights
    float inv_d2 = 1.0f / fmaxf(d2, 1e-6f);
    float geom;
    if (type == F3D_DIRECTIONAL) {
        geom = 1.0f;
    } else if (type == F3D_RECT) {
        float area = 4.0f * L.extent[2 * i] * L.extent[2 * i + 1];
        geom = area * fabsf(s.dy) * inv_d2;
    } else if (type == F3D_DISK) {
        float area = F3D_PI_F * rad * rad;
        geom = area * fabsf(s.dy) * inv_d2;
    } else if (type == F3D_SPHERE) {
        float rs = fmaxf(rad, 1e-9f);
        float snx = rad > 0.0f ? off_x / rs : 0.0f;
        float sny = rad > 0.0f ? off_y / rs : 0.0f;
        float snz = rad > 0.0f ? off_z / rs : 0.0f;
        float cos_s = fmaxf(-(snx * s.dx + sny * s.dy + snz * s.dz), 0.0f);
        float area = F3D_FOUR_PI_F * rad * rad;
        geom = area * cos_s * inv_d2;
    } else {
        geom = inv_d2;
    }
    if (type == F3D_SPOT) {  // cone falloff
        float cd = -(s.dx * ldir[0] + s.dy * ldir[1] + s.dz * ldir[2]);
        float c_in = L.cones[2 * i], c_out = L.cones[2 * i + 1];
        float spot = fminf(fmaxf((cd - c_out) / fmaxf(c_in - c_out, 1e-6f), 0.0f), 1.0f);
        geom = geom * spot * spot;
    }
    float scale = ndl * geom / fmaxf(p_pick, 1e-12f);
    s.wr = L.color[3 * i] * scale;
    s.wg = L.color[3 * i + 1] * scale;
    s.wb = L.color[3 * i + 2] * scale;
    return s;
}
