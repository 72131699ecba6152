// forge3d_tpu_torch/csrc/ibl.cuh
// Per-sample device code of the IBL bake (kernel E1, forge3d_tpu/ops/ibl.py):
// the bilinear equirect lookup `sample_equirect` (48) and the terms of its
// sum over a texel's directions, as equirect_to_cubemap (64),
// prefilter_environment (92) and irradiance_map (167) form it. Float32, in
// the JAX functions' operation order, so that ibl.cu agrees with the plain
// PyTorch versions in ops/ibl.py.

#pragma once

#include <math.h>

#ifndef F3D_HD
#ifdef __CUDACC__
#define F3D_HD __host__ __device__ __forceinline__
#else
#define F3D_HD inline
#endif
#endif

enum {
    F3D_IBL_ONE = 0,       // one direction a texel: the cube faces, mip 0
    F3D_IBL_WEIGHTED = 1,  // sum of sample * w over sum of w (the GGX mips)
    F3D_IBL_MEAN = 2       // sum of samples over S (the irradiance map)
};

// a 16-byte record: an RGBx texel of the map, or a sample {dx, dy, dz, w}
struct IblWord {
    float x, y, z, w;
};

// one record through the read-only path
F3D_HD IblWord ibl_word(const float* p) {
    IblWord r;
#ifdef __CUDA_ARCH__
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    r.x = v.x, r.y = v.y, r.z = v.z, r.w = v.w;
#else
    r.x = p[0], r.y = p[1], r.z = p[2], r.w = p[3];
#endif
    return r;
}

// ibl.py:sample_equirect for one direction over the RGBx copy env4 (H, W,
// 4) of the map, a tap one 16-byte load: u wraps by `mod`, v clamps to the
// rows [0, H - 2] (a negative row indexes from the end, as JAX's gather
// reads it when H < 2).
F3D_HD void sample_equirect4(const float* env4, int env_h, int env_w, float dx, float dy,
                             float dz, float* rgb) {
    float u = (atan2f(dx, dz) / 6.28318530717958647692f + 0.5f) * (float)env_w - 0.5f;
    float v = (acosf(fminf(fmaxf(dy, -1.0f), 1.0f)) / 3.14159265358979323846f) * (float)env_h
              - 0.5f;
    int u0 = (int)floorf(u);
    int v0 = (int)floorf(v);
    v0 = v0 < 0 ? 0 : v0;
    v0 = v0 > env_h - 2 ? env_h - 2 : v0;
    float fu = u - (float)u0;
    float fv = fminf(fmaxf(v - (float)v0, 0.0f), 1.0f);
    int u0m = u0 % env_w;
    u0m = u0m < 0 ? u0m + env_w : u0m;
    int u1m = (u0 + 1) % env_w;
    u1m = u1m < 0 ? u1m + env_w : u1m;
    int r0 = v0 < 0 ? v0 + env_h : v0;
    int r1 = v0 + 1;
    const IblWord w00 = ibl_word(env4 + 4 * ((long long)r0 * env_w + u0m));
    const IblWord w01 = ibl_word(env4 + 4 * ((long long)r0 * env_w + u1m));
    const IblWord w10 = ibl_word(env4 + 4 * ((long long)r1 * env_w + u0m));
    const IblWord w11 = ibl_word(env4 + 4 * ((long long)r1 * env_w + u1m));
    const float e00[3] = {w00.x, w00.y, w00.z}, e01[3] = {w01.x, w01.y, w01.z};
    const float e10[3] = {w10.x, w10.y, w10.z}, e11[3] = {w11.x, w11.y, w11.z};
    for (int c = 0; c < 3; ++c) {
        float a = e00[c] * (1.0f - fu) + e01[c] * fu;
        float b = e10[c] * (1.0f - fu) + e11[c] * fu;
        rgb[c] = a * (1.0f - fv) + b * fv;
    }
}

// the terms sample `rec` adds to its texel's sums: x[0..2] the colour's
// (times w when WEIGHTED), x[3] the weight sum's (WEIGHTED only)
F3D_HD void ibl_term(const float* env4, int env_h, int env_w, const float* rec, int mode,
                     float* x) {
    const IblWord s = ibl_word(rec);
    float rgb[3];
    sample_equirect4(env4, env_h, env_w, s.x, s.y, s.z, rgb);
    for (int c = 0; c < 3; ++c) x[c] = mode == F3D_IBL_WEIGHTED ? rgb[c] * s.w : rgb[c];
    x[3] = mode == F3D_IBL_WEIGHTED ? s.w : 0.0f;
}

// one term x added to the sums acc, in sample order from zero; ONE keeps
// its one sample as it is (0 + -0.0 would be +0.0)
F3D_HD void ibl_add(float* acc, const float* x, int mode) {
    for (int c = 0; c < 3; ++c) acc[c] = mode == F3D_IBL_ONE ? x[c] : acc[c] + x[c];
    if (mode == F3D_IBL_WEIGHTED) acc[3] = acc[3] + x[3];
}

// texel t's output from its sums over `count` samples
F3D_HD void ibl_finish(const float* acc, int mode, int count, int t, float* out) {
    for (int c = 0; c < 3; ++c) {
        float v = acc[c];
        if (mode == F3D_IBL_WEIGHTED) v = v / fmaxf(acc[3], 1e-6f);
        if (mode == F3D_IBL_MEAN) v = v / (float)count;
        out[3 * t + c] = v;
    }
}

// One stage of a bake: n texels of `count` samples each, the samples'
// records texel-major (tab + 4 * (t * count + s)), the output (n, 3), and
// the lanes a texel (a power of two up to 32).
struct IblJob {
    const float* tab;
    float* out;
    int n, count, mode, group;
};

// the jobs one launch's table holds (a "high" bake's seven stages and one
// more; ops/ibl.py:BAKE_JOBS splits a longer list into launches of this many)
constexpr int kIblBakeJobs = 8;
