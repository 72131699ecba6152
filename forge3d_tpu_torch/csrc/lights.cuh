// forge3d_tpu_torch/csrc/lights.cuh
// Kernel K10's body: one next-event light sample for one lane
// (forge3d_tpu/ops/lightsample.py:alias_sample and sample_light_nee). Runs
// inside the frame kernel K6 once per camera sample, and alone in
// kernels.cu:sample_light_kernel.
//
// The JAX version evaluates every light type's formula on every lane and
// selects by the picked light's type with `where` chains; here the thread
// takes the branch of its own light's type and computes the same values in
// the same order.
//
// The light set is one packed table (ops/lightsample.py:pack_lights, formed
// on the device once per light set): a light's record is 80 bytes, five
// 16-byte words. Word 0 is the alias column of the light's index (prob,
// alias, pdf[col], pdf[alias[col]]), so the pick's one 16-byte load gives
// the chosen index and its selection pdf; words 1-4 are the light's fields,
// read by four independent 16-byte loads. That is two dependent rounds
// where the ten separate (L,)-arrays took four (prob -> alias -> pdf, type
// -> the fields) and a dozen scattered 4-byte loads. What bounds it then:
// the lane's input and output streams (64 bytes a lane) and ~60 float32
// operations with one sqrt, one division and a sin/cos pair for disk and
// sphere lights; the table is a few hundred bytes, read through the
// read-only path and held in L1.

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

// lighting.py:LIGHT_TYPES
enum LightType { F3D_DIRECTIONAL = 0, F3D_POINT = 1, F3D_SPOT = 2, F3D_RECT = 3,
                 F3D_DISK = 4, F3D_SPHERE = 5 };

// A light's record in the packed table, F3D_LIGHT_WORDS floats (the ints as
// their bits):
//   word 0  prob[i], alias[i], pdf[i], pdf[alias[i]]   (the alias column i)
//   word 1  position.xyz, type
//   word 2  direction.xyz, radius
//   word 3  color.rgb (premultiplied by intensity), 0
//   word 4  extent.xz, cos(inner), cos(outer)
#define F3D_LIGHT_WORDS 20
#define F3D_LIGHT_QUADS (F3D_LIGHT_WORDS / 4)

struct LightArgs {           // mirrored by _kernels.LightArgs
    const float* table;      // (L, F3D_LIGHT_WORDS), 16-byte aligned
    int count;               // L; 0 = no typed lights
    float u_hi;              // float32(L - 1e-6)
};

struct LightSample {
    float dx, dy, dz, dist, wr, wg, wb;
};

struct LightWord {
    float x, y, z, w;
};

F3D_HD int light_bits(float f) {
#ifdef __CUDA_ARCH__
    return __float_as_int(f);
#else
    int i;
    memcpy(&i, &f, 4);
    return i;
#endif
}

// The table's 16-byte words, in device memory through the read-only path.
struct LightTable {
    const float* rec;
    F3D_HD LightWord word(int i, int q) const {
        const float* p = rec + 4 * (F3D_LIGHT_QUADS * i + q);
        LightWord r;
#ifdef __CUDA_ARCH__
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        r.x = v.x, r.y = v.y, r.z = v.z, r.w = v.w;
#else
        r.x = p[0], r.y = p[1], r.z = p[2], r.w = p[3];
#endif
        return r;
    }
};

#define F3D_TWO_PI_LS 6.2831853f          // lightsample.py's `two_pi`
#define F3D_PI_F 3.14159265358979323846f  // float32(pi)
#define F3D_FOUR_PI_F 12.566370614359172f // float32(4.0 * pi), a double product

// lightsample.py:alias_sample for one lane: (index, selection pdf), from
// word 0 of the column's record.
F3D_HD int alias_pick(const LightTable& T, int count, float u_hi, float u, float& p_pick) {
    float x = fminf(fmaxf(u * (float)count, 0.0f), u_hi);
    int col = (int)x;
    float frac = x - (float)col;
    const LightWord c = T.word(col, 0);
    const bool home = frac < c.x;
    p_pick = home ? c.z : c.w;
    return home ? col : light_bits(c.y);
}

// lightsample.py:sample_light_nee for one lane at surface point p with
// normal n, from uniforms (u_pick, u1, u2), over the light set's table T of
// `count` lights.
F3D_HD LightSample sample_light(const LightTable& T, int count, float u_hi, float px, float py,
                                float pz, float nx, float ny, float nz, float u_pick, float u1,
                                float u2) {
    float p_pick;
#ifdef F3D_K10_CONST
    // measurement build: the pick and the light's fields from constants
    // (what the table's loads cost; its outputs are not the kernel's)
    const int i0 = (int)(u_pick * (float)count);
    const int i = i0 < count - 1 ? i0 : count - 1;
    p_pick = 1.0f / (float)count;
    const LightWord pos = {24.0f, 18.0f, 30.0f, 0.0f}, dir = {0.1f, -0.97f, 0.2f, 1.5f};
    const LightWord color = {40.0f, 38.0f, 30.0f, 0.0f}, shape = {2.0f, 1.0f, 0.95f, 0.9f};
    const int type = i % 6;
#else
    const int i = alias_pick(T, count, u_hi, u_pick, p_pick);
    const LightWord pos = T.word(i, 1), dir = T.word(i, 2), color = T.word(i, 3),
                    shape = T.word(i, 4);
    const int type = light_bits(pos.w);
#endif
    const float rad = dir.w;

    // sampled emitter point: area lights jitter, the others use the center
    float off_x = 0.0f, off_y = 0.0f, off_z = 0.0f;
    if (type == F3D_RECT) {
        off_x = (u1 * 2.0f - 1.0f) * shape.x;
        off_z = (u2 * 2.0f - 1.0f) * shape.y;
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
    float vx = (pos.x + off_x) - px;
    float vy = (pos.y + off_y) - py;
    float vz = (pos.z + off_z) - pz;
    float d2 = vx * vx + vy * vy + vz * vz;
    LightSample s;
    if (type == F3D_DIRECTIONAL) {
        s.dx = -dir.x;
        s.dy = -dir.y;
        s.dz = -dir.z;
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
        float area = 4.0f * shape.x * shape.y;
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
        float cd = -(s.dx * dir.x + s.dy * dir.y + s.dz * dir.z);
        float c_in = shape.z, c_out = shape.w;
        float spot = fminf(fmaxf((cd - c_out) / fmaxf(c_in - c_out, 1e-6f), 0.0f), 1.0f);
        geom = geom * spot * spot;
    }
    float scale = ndl * geom / fmaxf(p_pick, 1e-12f);
    s.wr = color.x * scale;
    s.wg = color.y * scale;
    s.wb = color.z * scale;
    return s;
}
