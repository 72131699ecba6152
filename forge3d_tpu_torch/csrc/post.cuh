// forge3d_tpu_torch/csrc/post.cuh
// Per-element device code of the post passes: one guided 5x5 a-trous
// iteration for one pixel (kernel E3, forge3d_tpu/ops/denoise.py:
// atrous_denoise, 35) and the Hosek-Wilkie RGB sky radiance for one
// direction (kernel E5, forge3d_tpu/sky.py:hosek_radiance, 261). Float32,
// in the JAX functions' operation order, so that the kernels in post.cu
// agree with the plain PyTorch versions in ops/denoise.py and sky.py.

#pragma once

#include <math.h>

#ifndef F3D_HD
#ifdef __CUDACC__
#define F3D_HD __host__ __device__ __forceinline__
#else
#define F3D_HD inline
#endif
#endif

// Mirrored by AtrousArgs in _kernels.py. Guide planes may be null (their
// weight term is dropped); `depth` is already scaled by its max |.|.
struct AtrousArgs {
    const float* albedo;  // (H, W, 3)
    const float* normal;  // (H, W, 3)
    const float* depth;   // (H, W)
    int width, height;
    // float32(sigma**2 + 1e-8) per guide
    float k_color, k_albedo, k_normal, k_depth;
};

F3D_HD int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

F3D_HD float sq_dist3(const float* p, int i, int j) {
    float d0 = p[3 * j + 0] - p[3 * i + 0];
    float d1 = p[3 * j + 1] - p[3 * i + 1];
    float d2 = p[3 * j + 2] - p[3 * i + 2];
    return d0 * d0 + d1 * d1 + d2 * d2;
}

// One a-trous iteration at pixel (x, y) with tap spacing `step`: the 25
// taps in (ky, kx) row-major order, each reading the edge-clamped pixel
// (y - ky * step, x - kx * step) as denoise.py:_shift2d does.
F3D_HD void atrous_pixel(const AtrousArgs& a, const float* in, float* out, int step, int x,
                         int y) {
    const float k1[5] = {1.0f / 16.0f, 1.0f / 4.0f, 3.0f / 8.0f, 1.0f / 4.0f, 1.0f / 16.0f};
    const int i = y * a.width + x;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, wacc = 0.0f;
    for (int ky = -2; ky <= 2; ++ky) {
        const int sy = clampi(y - ky * step, 0, a.height - 1);
        for (int kx = -2; kx <= 2; ++kx) {
            const int j = sy * a.width + clampi(x - kx * step, 0, a.width - 1);
            float w = k1[ky + 2] * k1[kx + 2];
            w = w * expf(-sq_dist3(in, i, j) / a.k_color);
            if (a.albedo != nullptr) w = w * expf(-sq_dist3(a.albedo, i, j) / a.k_albedo);
            if (a.normal != nullptr) w = w * expf(-sq_dist3(a.normal, i, j) / a.k_normal);
            if (a.depth != nullptr) {
                float dd = a.depth[j] - a.depth[i];
                w = w * expf(-(dd * dd) / a.k_depth);
            }
            acc0 = acc0 + in[3 * j + 0] * w;
            acc1 = acc1 + in[3 * j + 1] * w;
            acc2 = acc2 + in[3 * j + 2] * w;
            wacc = wacc + w;
        }
    }
    const float den = fmaxf(wacc, 1e-8f);
    out[3 * i + 0] = acc0 / den;
    out[3 * i + 1] = acc1 / den;
    out[3 * i + 2] = acc2 / den;
}

// Mirrored by HosekArgs in _kernels.py: one cooked sky (sky.py:HosekSky).
struct HosekArgs {
    float sun[3];
    float cfg[27];  // (3, 9) per-channel coefficients
    float rad[3];
    float exposure;
};

// sky.py:hosek_radiance for one direction; writes (r, g, b).
F3D_HD void hosek_texel(const HosekArgs& s, float dx, float dy, float dz, float* rgb) {
    float inv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
    float dxn = dx * inv, dyn = dy * inv, dzn = dz * inv;
    float cos_theta = fmaxf(dyn, 0.0f);
    float cos_gamma = fminf(fmaxf(dxn * s.sun[0] + dyn * s.sun[1] + dzn * s.sun[2], -1.0f), 1.0f);
    float gamma = acosf(cos_gamma);
    float ray_m = cos_gamma * cos_gamma;
    float zenith = sqrtf(cos_theta);
    for (int c = 0; c < 3; ++c) {
        const float* cf = s.cfg + 9 * c;
        float exp_m = expf(cf[4] * gamma);
        float mie_denom = fmaxf(1.0f + cf[8] * cf[8] - 2.0f * cf[8] * cos_gamma, 1e-4f);
        float mie_m = (1.0f + ray_m) / (mie_denom * sqrtf(mie_denom));
        float val = (1.0f + cf[0] * expf(cf[1] / (cos_theta + 0.01f)))
                    * (cf[2] + cf[3] * exp_m + cf[5] * ray_m + cf[6] * mie_m + cf[7] * zenith);
        rgb[c] = val * s.rad[c] * s.exposure;
    }
}
