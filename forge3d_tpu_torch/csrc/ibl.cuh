// forge3d_tpu_torch/csrc/ibl.cuh
// Per-texel device code of the IBL bake (kernel E1, forge3d_tpu/ops/ibl.py):
// the bilinear equirect lookup `sample_equirect` (48) and its sum over a
// table of directions, as equirect_to_cubemap (64), prefilter_environment
// (92) and irradiance_map (167) form it. Float32, in the JAX functions'
// operation order, so that ibl.cu agrees with the plain PyTorch versions in
// ops/ibl.py.

#pragma once

#include <math.h>

#ifndef F3D_HD
#ifdef __CUDACC__
#define F3D_HD __host__ __device__ __forceinline__
#else
#define F3D_HD inline
#endif
#endif

// ibl.py:sample_equirect for one direction: u wraps by `mod`, v clamps to
// the rows [0, H - 2] (a negative row indexes from the end, as JAX's gather
// reads it when H < 2).
F3D_HD void sample_equirect(const float* env, int env_h, int env_w, float dx, float dy,
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
    const float* e00 = env + 3 * (r0 * env_w + u0m);
    const float* e01 = env + 3 * (r0 * env_w + u1m);
    const float* e10 = env + 3 * (r1 * env_w + u0m);
    const float* e11 = env + 3 * (r1 * env_w + u1m);
    for (int c = 0; c < 3; ++c) {
        float a = e00[c] * (1.0f - fu) + e01[c] * fu;
        float b = e10[c] * (1.0f - fu) + e11[c] * fu;
        rgb[c] = a * (1.0f - fv) + b * fv;
    }
}

enum {
    F3D_IBL_ONE = 0,       // one direction a texel: the cube faces, mip 0
    F3D_IBL_WEIGHTED = 1,  // sum of sample * w over sum of w (the GGX mips)
    F3D_IBL_MEAN = 2       // sum of samples over S (the irradiance map)
};

// Texel t of a bake: its S directions dirs[(s * T + t) * 3] (and weights
// w[s * T + t]) summed from zero in sample order, then divided as the mode
// says.
F3D_HD void equirect_accum_texel(const float* env, int env_h, int env_w, const float* dirs,
                                 const float* w, int samples, int texels, int mode,
                                 float* out, int t) {
    float acc[3] = {0.0f, 0.0f, 0.0f};
    float wsum = 0.0f;
    for (int s = 0; s < samples; ++s) {
        const long long k = (long long)s * texels + t;
        float rgb[3];
        sample_equirect(env, env_h, env_w, dirs[3 * k], dirs[3 * k + 1], dirs[3 * k + 2], rgb);
        if (mode == F3D_IBL_ONE) {
            acc[0] = rgb[0];
            acc[1] = rgb[1];
            acc[2] = rgb[2];
        } else if (mode == F3D_IBL_WEIGHTED) {
            for (int c = 0; c < 3; ++c) acc[c] = acc[c] + rgb[c] * w[k];
            wsum = wsum + w[k];
        } else {
            for (int c = 0; c < 3; ++c) acc[c] = acc[c] + rgb[c];
        }
    }
    for (int c = 0; c < 3; ++c) {
        float v = acc[c];
        if (mode == F3D_IBL_WEIGHTED) v = v / fmaxf(wsum, 1e-6f);
        if (mode == F3D_IBL_MEAN) v = v / (float)samples;
        out[3 * t + c] = v;
    }
}
