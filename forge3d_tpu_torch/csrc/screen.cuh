// forge3d_tpu_torch/csrc/screen.cuh
// Per-thread device code of the screen-mode render (forge3d_tpu/terrain/
// screen.py): the texture and cube samplers, the equirect-to-cube resample
// of one texel (S1), the cube convolution of one texel (S2, S3), the raster
// of one triangle (S4), the PCSS visibility of one receiver (S5), the
// parallax occlusion mapping of one pixel (S7), the sky and its aerial
// perspective at one pixel (S6), the screen shade of one pixel (S8) and the
// clipmap shade of one pixel (S9), each shade split at the quad derivative
// into a front and a back half. Float32, in the operation order of the plain PyTorch
// versions in terrain/screen.py, so that with contraction off (-fmad=false)
// the kernels in screen.cu agree with them.
//
// The functions are __host__ __device__ so that the same bodies can be
// compiled for a CPU harness; nothing in the port depends on that.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_fp16.h>
#endif

#ifndef F3D_HD
#ifdef __CUDACC__
#define F3D_HD __host__ __device__ __forceinline__
#else
#define F3D_HD inline
#endif
#endif

#define SCR_PI 3.14159274f        // float32(pi)
#define SCR_TWO_PI 6.28318548f    // float32(2 pi)

// Mirrored by SkyArgs in _kernels.py: S6's per-image float32 constants
// (terrain/screen.py:sky_consts and aerial_consts), matrices row-major.
struct SkyArgs {
    int model;                       // 0 off, 1 Hosek-Wilkie, 2 Preetham
    float sun[3];                    // Y-up sun direction
    float inv_view[16], inv_proj[16];
    float cfg[27], rad[3], mie_k1[3], mie_k2[3];  // Hosek: A..I per channel
    float pA, pB, pC, pD, pE, p_den, p_col[3], p_haze, p_mix, p_alb;  // Preetham
    float daylight, night0[3], night_d[3];
    float disc_cos, limb_den, disc_c[3], glow_cos, glow_den, ring_c[3];
    float low_sun, e_fwd, e_broad, inten, k_broad, hglow_k, amb, scat_c[3], exposure;
    // the aerial perspective
    float density_neg, k_fac, k_amt, k_desat, k_target, tint[3], add[3], k_blend;
};

// Mirrored by ScreenArgs in _kernels.py: S8's and S9's textures, sizes,
// switches and float32 uniforms (terrain/screen.py:screen_args).
struct ScreenArgs {
    const float* hm;          // (hm_h, hm_w)
    const float* lut;         // (lut_n, 3)
    const float* wm;          // (wm_h, wm_w) water mask
    const float* mat_albedo;  // one rgb (stride 0) or (H, W, 3) (stride 3)
    const float* mmn;         // material maps: normal (h, w, 3), roughness and mask (h, w)
    const float* mmr;
    const float* mmk;
    const float* shadow;      // (shadow_res, shadow_res) depth
    const float* irr;         // (6, irr_size, irr_size, 3)
    const float* spec[6];     // (6, spec_size[m], spec_size[m], 3)
    const float* brdf;        // (brdf_h, brdf_w, 2)
    const float* refl;        // (refl_h, refl_w, 3) mirrored pass, u8 / 255
    unsigned long long shadow_tex;  // S8's texture object over `shadow`
    int hm_h, hm_w, lut_n, wm_h, wm_w, mat_albedo_stride;
    int mmn_h, mmn_w, mmr_h, mmr_w, mmk_h, mmk_w;
    int shadow_res, irr_size, spec_size[6], brdf_h, brdf_w, refl_h, refl_w;
    int width, height;
    int has_wm, has_mat_albedo, has_refl, albedo_mode, hue_on, filterable, srgb;
    int mm_normal, mm_rough, mm_mask, mats_on, snow_on, sss_on;
    float dom_lo, dom_hi, dom_rng, z_scale, exposure, ibl_intensity, colormap_strength,
        hue_strength, ibl_fill, shadow_rspan, vert, sun_int, f0_water;
    float texel[2], z_corners[3], wave_cs[2];
    float ldir[3], lcol[3], camera_pos[3], pcss_ld[3];
    float lvp[12];            // rows 0-2 of the light's view-projection
    float rvp[16];            // the mirrored view-projection, row-major as given
    float refl_wave, refl_intensity, refl_shore_w, refl_fresnel;
    float snow_alt_min, snow_alt_div, snow_slope_f, wet_scale, rock_mix;
    float rock_c[3], snow_c[3], layer_w[2], sss_strength[3], sss_tint[9];
    float ml[12];             // (4, 3) linear material base colours
    float filmic[7];          // A, B, C*B, D*E, D*F, E/F, white scale
    // S7: steps, refinements, occlusion, the family layer->height switch
    int pom_on, pom_min, pom_max, pom_refine, pom_occl, pom_layer;
    float pom_scale;
    SkyArgs sky;              // S6 (model 0: no sky)
};

// Mirrored by ClipArgs: S9's host G-buffer and its Sobel spacing.
struct ClipArgs {
    const float* uv;              // (H, W, 2)
    const float* world;           // (H, W, 3)
    const unsigned char* valid;   // (H, W)
    float spacing, wtex[2];       // texel * spacing
};

// Mirrored by ScreenOut: S8's output planes.
struct ScreenOut {
    unsigned char* rgba;  // (H, W, 4)
    float* albedo;        // (H, W, 3)
    float* normal;        // (H, W, 3)
    float* height;        // (H, W)
};

// ---------------------------------------------------------------------------
// Scalars
// ---------------------------------------------------------------------------

F3D_HD int sc_clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
F3D_HD float sc_clamp(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
F3D_HD float sc_clamp01(float x) { return sc_clamp(x, 0.0f, 1.0f); }

// jnp.mod(x, 1.0): fmod moved into [0, 1)
F3D_HD float sc_mod1(float x) {
    float m = fmodf(x, 1.0f);
    return m < 0.0f ? m + 1.0f : m;
}

// rgba16float storage round trip: round to nearest even, as __float2half_rn
F3D_HD float f16_round(float x) {
#ifdef __CUDA_ARCH__
    return __half2float(__float2half_rn(x));
#else
    uint32_t u;
    memcpy(&u, &x, 4);
    const uint32_t sign = u & 0x80000000u;
    uint32_t a = u ^ sign;
    float r;
    if (a >= 0x7f800000u) return x;                  // inf, nan
    if (a >= 0x477ff000u) {                          // rounds past 65504
        u = sign | 0x7f800000u;
        memcpy(&r, &u, 4);
        return r;
    }
    if (a < 0x38800000u) {                           // half subnormal: quantum 2^-24
        r = nearbyintf(fabsf(x) * 16777216.0f) / 16777216.0f;
        return sign ? -r : r;
    }
    a += 0xfffu + ((a >> 13) & 1u);
    a &= ~0x1fffu;
    u = sign | a;
    memcpy(&r, &u, 4);
    return r;
#endif
}

F3D_HD float sc_dot3(const float* a, const float* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }
F3D_HD float norm3(const float* v) { return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]); }

// v / max(|v|, eps), in place
F3D_HD void normalize3(float* v, float eps = 1e-20f) {
    const float n = fmaxf(norm3(v), eps);
    v[0] = v[0] / n;
    v[1] = v[1] / n;
    v[2] = v[2] / n;
}

F3D_HD void cross3(const float* a, const float* b, float* c) {
    c[0] = a[1] * b[2] - a[2] * b[1];
    c[1] = a[2] * b[0] - a[0] * b[2];
    c[2] = a[0] * b[1] - a[1] * b[0];
}

// ---------------------------------------------------------------------------
// Texture sampling (screen.py:194-348)
// ---------------------------------------------------------------------------

// ClampToEdge nearest sample of a (h, w, C) texture
F3D_HD void tex_nearest(const float* t, int h, int w, int C, float u, float v, float* out) {
    const int x = sc_clampi((int)floorf(u * (float)w), 0, w - 1);
    const int y = sc_clampi((int)floorf(v * (float)h), 0, h - 1);
    for (int c = 0; c < C; ++c) out[c] = t[(y * w + x) * C + c];
}

// ClampToEdge bilinear sample of a (h, w, C) texture; `rnd` rounds each
// tap to f16 first (S1's f16 equirect)
F3D_HD void tex_bilinear(const float* t, int h, int w, int C, float u, float v, float* out,
                         bool rnd = false) {
    const float x = u * (float)w - 0.5f;
    const float y = v * (float)h - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int ix0 = sc_clampi((int)x0, 0, w - 1), iy0 = sc_clampi((int)y0, 0, h - 1);
    const int ix1 = sc_clampi(ix0 + 1, 0, w - 1), iy1 = sc_clampi(iy0 + 1, 0, h - 1);
    for (int c = 0; c < C; ++c) {
        float t00 = t[(iy0 * w + ix0) * C + c], t10 = t[(iy0 * w + ix1) * C + c];
        float t01 = t[(iy1 * w + ix0) * C + c], t11 = t[(iy1 * w + ix1) * C + c];
        if (rnd) {
            t00 = f16_round(t00);
            t10 = f16_round(t10);
            t01 = f16_round(t01);
            t11 = f16_round(t11);
        }
        const float top = t00 + (t10 - t00) * fx;
        const float bot = t01 + (t11 - t01) * fx;
        out[c] = top + (bot - top) * fy;
    }
}

// 256x1 Rgba8Unorm LUT, linear filter at (u, 0.5)
F3D_HD void lut_sample(const float* lut, int n, float u, float* out) {
    const float x = u * (float)n - 0.5f;
    const float x0 = floorf(x);
    const float f = x - x0;
    const int i0 = sc_clampi((int)x0, 0, n - 1);
    const int i1 = sc_clampi(i0 + 1, 0, n - 1);
    for (int c = 0; c < 3; ++c) out[c] = lut[3 * i0 + c] + (lut[3 * i1 + c] - lut[3 * i0 + c]) * f;
}

// inverse of uv_to_direction: face index and face uv of a direction
F3D_HD void dir_to_face_uv(const float* d, int& face, float& u, float& v) {
    const float x = d[0], y = d[1], z = d[2];
    const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
    const bool is_x = (ax >= ay) && (ax >= az);
    const bool is_y = (ay > ax) && (ay >= az);
    float uc, vc, ma;
    if (is_x) {
        face = x > 0.0f ? 0 : 1;
        uc = x > 0.0f ? -z : z;
        vc = -y;
        ma = ax;
    } else if (is_y) {
        face = y > 0.0f ? 2 : 3;
        uc = x;
        vc = y > 0.0f ? z : -z;
        ma = ay;
    } else {
        face = z > 0.0f ? 4 : 5;
        uc = z > 0.0f ? x : -x;
        vc = -y;
        ma = az;
    }
    ma = fmaxf(ma, 1e-20f);
    u = (uc / ma + 1.0f) * 0.5f;
    v = (vc / ma + 1.0f) * 0.5f;
}

// bilinear sample of a (6, s, s, 3) cube
F3D_HD void cube_sample(const float* cube, int s, const float* d, float* out) {
    int face;
    float u, v;
    dir_to_face_uv(d, face, u, v);
    tex_bilinear(cube + (size_t)face * s * s * 3, s, s, 3, u, v, out);
}

// trilinear between the two prefiltered mips that bracket `mip`
F3D_HD void cube_sample_mips(const ScreenArgs& a, const float* d, float mip, float* out) {
    mip = sc_clamp(mip, 0.0f, 5.0f);
    const int lo = (int)floorf(mip);
    const float f = mip - (float)lo;
    const int hi = lo + 1 < 5 ? lo + 1 : 5;
    float sl[3], sh[3];
    cube_sample(a.spec[lo], a.spec_size[lo], d, sl);
    cube_sample(a.spec[hi], a.spec_size[hi], d, sh);
    for (int c = 0; c < 3; ++c) out[c] = sl[c] + (sh[c] - sl[c]) * f;
}

// up = |n.z| < 0.999 ? +Z : +X; t = norm(cross(up, n)); b = cross(n, t)
F3D_HD void tangent_frame(const float* n, float* t, float* b) {
    const bool zup = fabsf(n[2]) < 0.999f;
    const float up[3] = {zup ? 0.0f : 1.0f, 0.0f, zup ? 1.0f : 0.0f};
    cross3(up, n, t);
    normalize3(t);
    cross3(n, t, b);
}

// ---------------------------------------------------------------------------
// S1: one texel of the equirect-to-cube resample (screen.py:355-360)
// ---------------------------------------------------------------------------

F3D_HD void env_cube_texel(const float* eq, int eq_h, int eq_w, const float* dirs, int i,
                           float* out) {
    const float* d = dirs + 3 * i;
    const float u = atan2f(d[2], d[0]) / SCR_TWO_PI + 0.5f;
    const float v = acosf(sc_clamp(d[1], -1.0f, 1.0f)) / SCR_PI;
    float rgb[3];
    tex_bilinear(eq, eq_h, eq_w, 3, sc_mod1(u), sc_clamp01(v), rgb, true);
    for (int c = 0; c < 3; ++c) out[3 * i + c] = f16_round(rgb[c]);
}

// ---------------------------------------------------------------------------
// S2 / S3: the cube convolution (screen.py:363-422). mode 0: the cosine
// irradiance; mode 1: the GGX prefilter. `smp` holds the (count, 3) sample
// vectors in JAX's order. JAX sums them in a scan, one sample after the
// other; screen.cu gives a texel G lanes, lane j computing samples j, j + G,
// ..., and every lane adds the group's G terms of a round in lane order, so
// each add is the scan's add and the sum is the scan's, bit for bit.
// ---------------------------------------------------------------------------

// a texel's normal and tangent frame
F3D_HD void convolve_frame(const float* dirs, int i, float* n, float* t, float* b) {
    for (int c = 0; c < 3; ++c) n[c] = dirs[3 * i + c];
    tangent_frame(n, t, b);
}

struct ScWord {
    float x, y, z, w;
};

// a 16-byte word through the read-only path
F3D_HD ScWord sc_word(const float* p) {
    ScWord r;
#ifdef __CUDA_ARCH__
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    r.x = v.x, r.y = v.y, r.z = v.z, r.w = v.w;
#else
    r.x = p[0], r.y = p[1], r.z = p[2], r.w = p[3];
#endif
    return r;
}

// bilinear sample of an RGBx (6, s, s, 4) cube: tex_bilinear's arithmetic,
// a texel one 16-byte load
F3D_HD void cube_sample4(const float* cube4, int s, const float* d, float* out) {
    int face;
    float u, v;
    dir_to_face_uv(d, face, u, v);
    const float* t = cube4 + (size_t)face * s * s * 4;
    const float x = u * (float)s - 0.5f;
    const float y = v * (float)s - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int ix0 = sc_clampi((int)x0, 0, s - 1), iy0 = sc_clampi((int)y0, 0, s - 1);
    const int ix1 = sc_clampi(ix0 + 1, 0, s - 1), iy1 = sc_clampi(iy0 + 1, 0, s - 1);
    const ScWord t00 = sc_word(t + (iy0 * s + ix0) * 4);
    const ScWord t10 = sc_word(t + (iy0 * s + ix1) * 4);
    const ScWord t01 = sc_word(t + (iy1 * s + ix0) * 4);
    const ScWord t11 = sc_word(t + (iy1 * s + ix1) * 4);
    const float a00[3] = {t00.x, t00.y, t00.z}, a10[3] = {t10.x, t10.y, t10.z};
    const float a01[3] = {t01.x, t01.y, t01.z}, a11[3] = {t11.x, t11.y, t11.z};
    for (int c = 0; c < 3; ++c) {
        const float top = a00[c] + (a10[c] - a00[c]) * fx;
        const float bot = a01[c] + (a11[c] - a01[c]) * fx;
        out[c] = top + (bot - top) * fy;
    }
}

// sample k's terms of the sums: x[0..2] the colour's, x[3] the prefilter's
// weight (0 for the irradiance)
F3D_HD void convolve_sample(const float* env4, int env_size, const float* n, const float* t,
                            const float* b, const float* smp, int k, int mode, float* x) {
    const float s0 = smp[3 * k], s1 = smp[3 * k + 1], s2 = smp[3 * k + 2];
    float d[3];
    for (int c = 0; c < 3; ++c) d[c] = t[c] * s0 + b[c] * s1 + n[c] * s2;
    const float nrm = norm3(d);
    for (int c = 0; c < 3; ++c) d[c] = d[c] / nrm;
    float col[3];
    if (mode == 0) {
        cube_sample4(env4, env_size, d, col);
        for (int c = 0; c < 3; ++c) x[c] = col[c] * s2;
        x[3] = 0.0f;
    } else {
        const float vdh = sc_dot3(n, d);
        float l[3];
        for (int c = 0; c < 3; ++c) l[c] = (2.0f * vdh) * d[c] - n[c];
        normalize3(l);
        const float ndl = fmaxf(sc_dot3(n, l), 0.0f);
        cube_sample4(env4, env_size, l, col);
        for (int c = 0; c < 3; ++c) x[c] = col[c] * ndl;
        x[3] = ndl;
    }
}

// the texel's output from its sums (acc[3] the prefilter's weight); a NaN
// sum (an inf texel beside another: inf - inf in the bilinear weights) stays
// NaN, as jnp.clip and torch.clamp keep it
F3D_HD void convolve_finish(const float* acc, int mode, int i, float* out) {
    for (int c = 0; c < 3; ++c) {
        const float x = mode == 0 ? (SCR_PI * acc[c]) / 128.0f : acc[c] / fmaxf(acc[3], 1e-3f);
        out[3 * i + c] = f16_round(x != x ? x : sc_clamp01(x));
    }
}

// One convolution of a launch: the texels' directions (n, 3), the samples,
// the output (n, 3), and the lanes a texel (a power of two up to 32).
struct ConvJob {
    const float* dirs;
    const float* smp;
    float* out;
    int n, count, mode, group;
};

// ---------------------------------------------------------------------------
// S4: one triangle of the depth raster (screen.py:464-519), over its own
// box of at most wbb x hbb pixels: JAX's global loop masks each triangle to
// its own box, so the pixels written are the same. The products that XLA
// contracts into fused multiply-adds in _raster_depth are explicit fmaf
// here (its depth map matches them bit for bit on the CPU).
// ---------------------------------------------------------------------------

// min of the depth at idx and z >= 0: float bits of non-negative values
// order as integers
F3D_HD void depth_min(float* depth, int idx, float z) {
#if defined(__CUDA_ARCH__) && defined(F3D_S4_STORE)
    depth[idx] = z;   // measurement build: a plain store (what the atomics cost)
#elif defined(__CUDA_ARCH__)
    atomicMin(reinterpret_cast<int*>(depth) + idx, __float_as_int(z));
#else
    if (z < depth[idx]) depth[idx] = z;
#endif
}

// x * y - u * v as XLA contracts it on _raster_depth: fma(x, y, -(u v))
F3D_HD float xy_minus_uv(float x, float y, float u, float v) { return fmaf(x, y, -(u * v)); }

F3D_HD void raster_triangle(const float* tris, const unsigned char* keep, int t, int res, int wbb,
                            int hbb, float* depth) {
    const float* p = tris + 9 * (size_t)t;
    const float ax = p[0], ay = p[1], az = p[2], bx = p[3], by = p[4], bz = p[5];
    const float cx = p[6], cy = p[7], cz = p[8];
    const float area2 = xy_minus_uv(bx - ax, cy - ay, by - ay, cx - ax);
    if (!keep[t] || !(fabsf(area2) > 1e-12f)) return;
    const float dzdx = xy_minus_uv(cz - az, by - ay, bz - az, cy - ay) / area2;
    const float dzdy = xy_minus_uv(bz - az, cx - ax, cz - az, bx - ax) / area2;
    const float m = fmaxf(fabsf(dzdx), fabsf(dzdy));
    const float zmax = fmaxf(fmaxf(fmaxf(fabsf(az), fabsf(bz)), fabsf(cz)), 1e-20f);
    const float r_unit = ldexpf(1.0f, (int)(floorf(log2f(zmax)) - 23.0f));
    const float bias = 2.0f * m + 2.0f * r_unit;
    const float xmin = floorf(fminf(fminf(ax, bx), cx) + 0.5f);
    const float ymin = floorf(fminf(fminf(ay, by), cy) + 0.5f);
    const float xmax = ceilf(fmaxf(fmaxf(ax, bx), cx) - 0.5f);
    const float ymax = ceilf(fmaxf(fmaxf(ay, by), cy) - 0.5f);
    const float inv = 1.0f / area2;
    for (int dy = 0; dy < hbb; ++dy) {
        const float py = ymin + (float)dy + 0.5f;
        if (!(py <= ymax + 0.5f)) break;
        const int ys = sc_clampi((int)py, 0, res - 1);
        for (int dx = 0; dx < wbb; ++dx) {
            const float px = xmin + (float)dx + 0.5f;
            if (!(px <= xmax + 0.5f)) break;
            const float w0 = xy_minus_uv(bx - px, cy - py, cx - px, by - py) * inv;
            const float w1 = xy_minus_uv(cx - px, ay - py, ax - px, cy - py) * inv;
            const float w2 = 1.0f - w0 - w1;
            if (!(w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f)) continue;
            float z = sc_clamp(fmaf(w2, cz, fmaf(w0, az, w1 * bz)) + bias, 0.0f, 1.0f);
            if (z == 0.0f) z = 0.0f;  // -0.0 -> +0.0: its bits order below every depth
            depth_min(depth, ys * res + sc_clampi((int)px, 0, res - 1), z);
        }
    }
}

// ---------------------------------------------------------------------------
// S5: PCSS visibility of one receiver (screen.py:634-710), at
// pcss_visibility's defaults
// ---------------------------------------------------------------------------

// PCSS Poisson disks (terrain_pbr_pom.wgsl:1057-1069, 1245-1262): the 12
// blocker taps are the first 12 of the 16 filter taps, as (u, v) pairs
#define SCR_POISSON_16                                                              \
    {-0.94201624f, -0.39906216f, 0.94558609f,  -0.76890725f, -0.094184101f, -0.92938870f, \
     0.34495938f,  0.29387760f,  -0.91588581f, 0.45771432f,  -0.81544232f,  -0.87912464f, \
     -0.38277543f, 0.27676845f,  0.97484398f,  0.75648379f,  0.44323325f,   -0.97511554f, \
     0.53742981f,  -0.47373420f, -0.26496911f, -0.41893023f, 0.79197514f,   0.19090188f,  \
     -0.24188840f, 0.99706507f,  -0.81409955f, 0.91437590f,  0.19984126f,   0.78641367f,  \
     0.14383161f,  -0.14100790f}

// The shadow map as PCSS reads it: texel(tx, ty) is the texel at integer
// coordinates inside the map, quad(x0i, y0i, ...) the 2x2 footprint of a
// bilinear tap whose top-left texel is (x0i, y0i), its right and lower
// neighbours clamped to the map.
//
// ShadowPtr reads the map through a pointer (f3d_pcss_points' check that
// the texture's fetches read the same texels).
struct ShadowPtr {
    const float* dm;
    int r;
    F3D_HD float texel(int tx, int ty) const { return dm[(size_t)ty * r + tx]; }
    F3D_HD void quad(int x0i, int y0i, float& t00, float& t10, float& t01, float& t11) const {
        const int x1i = sc_clampi(x0i + 1, 0, r - 1), y1i = sc_clampi(y0i + 1, 0, r - 1);
        t00 = dm[(size_t)y0i * r + x0i];
        t10 = dm[(size_t)y0i * r + x1i];
        t01 = dm[(size_t)y1i * r + x0i];
        t11 = dm[(size_t)y1i * r + x1i];
    }
};

// ShadowTex reads the map through the texture unit (S8, S9): `tex` is a texture
// object over the map itself, a pitch-2D resource with no copy (screen.cu:
// f3d_shadow_texture_create: point filtering, clamp addressing,
// unnormalised coordinates). A texel is a point fetch at its centre, so its
// address and clamp are the texture unit's work; a footprint is the point
// fetches of its four texels, the right and lower ones clamped by the
// addressing: the texels ShadowPtr reads, at the map's edges too. On the
// host (the kernels' CPU twin) the handle is the map's pointer and the
// fetches are emulated by the rules the hardware follows.
struct ShadowTex {
    unsigned long long tex;
    int r;
#ifdef __CUDA_ARCH__
    __device__ float texel(int tx, int ty) const {
        return tex2D<float>((cudaTextureObject_t)tex, (float)tx + 0.5f, (float)ty + 0.5f);
    }
#else
    // the texel under unnormalised coordinate (tx + 0.5, ty + 0.5): its
    // floor, clamped to the map
    float texel(int tx, int ty) const {
        const float* dm = (const float*)(uintptr_t)tex;
        const int i = sc_clampi((int)floorf((float)tx + 0.5f), 0, r - 1);
        const int j = sc_clampi((int)floorf((float)ty + 0.5f), 0, r - 1);
        return dm[(size_t)j * r + i];
    }
#endif
    F3D_HD void quad(int x0i, int y0i, float& t00, float& t10, float& t01, float& t11) const {
        t00 = texel(x0i, y0i);
        t10 = texel(x0i + 1, y0i);
        t01 = texel(x0i, y0i + 1);
        t11 = texel(x0i + 1, y0i + 1);
    }
};

#ifdef F3D_S8_PCSS_SELF
// measurement build: every load of a map at the receiver's own texel
template <class Map>
struct ShadowSelf {
    Map m;
    int tx, ty, r;
    F3D_HD float texel(int, int) const { return m.texel(tx, ty); }
    F3D_HD void quad(int, int, float& t00, float& t10, float& t01, float& t11) const {
        m.quad(tx, ty, t00, t10, t01, t11);
    }
};
#endif

// hardware PCF: bilinear weight of per-texel (ref <= texel)
template <class Map>
F3D_HD float pcf2x2(const Map& m, float u, float v, float ref) {
    const int r = m.r;
    const float x = u * (float)r - 0.5f, y = v * (float)r - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int x0i = sc_clampi((int)x0, 0, r - 1), y0i = sc_clampi((int)y0, 0, r - 1);
    float t00, t10, t01, t11;
    m.quad(x0i, y0i, t00, t10, t01, t11);
    const float c00 = ref <= t00 ? 1.0f : 0.0f;
    const float c10 = ref <= t10 ? 1.0f : 0.0f;
    const float c01 = ref <= t01 ? 1.0f : 0.0f;
    const float c11 = ref <= t11 ? 1.0f : 0.0f;
    const float top = c00 + (c10 - c00) * fx;
    const float bot = c01 + (c11 - c01) * fx;
    return top + (bot - top) * fy;
}

template <class Map>
F3D_HD float pcss_visibility(const Map& map, const float* lvp, const float* ld, const float* sp,
                             const float* nrm) {
    const int r = map.r;
    float ndc[3];
    for (int k = 0; k < 3; ++k)
        ndc[k] = sp[0] * lvp[4 * k] + sp[1] * lvp[4 * k + 1] + sp[2] * lvp[4 * k + 2]
                 + lvp[4 * k + 3];
    const float su = ndc[0] * 0.5f + 0.5f;
    const float sv = ndc[1] * -0.5f + 0.5f;
    const float depth01 = ndc[2];
    const float ndl = fmaxf(sc_dot3(nrm, ld), 0.0f);
    const float slope = sc_clamp01(1.0f - ndl);
    const float cmp = depth01 - (0.0005f + 0.001f * slope + 0.0002f);
    const bool inb = su >= 0.0f && su <= 1.0f && sv >= 0.0f && sv <= 1.0f && depth01 >= 0.0f
                     && depth01 <= 1.0f;
#ifdef F3D_S8_PCSS_CONST
    // measurement build: PCSS replaced by a constant that the receiver keeps live
    return inb ? 1.0f : 0.5f;
#endif
#ifdef F3D_S8_PCSS_SELF
    const ShadowSelf<Map> m{map, (int)sc_clamp(su * (float)r, 0.0f, (float)r - 1.0f),
                            (int)sc_clamp(sv * (float)r, 0.0f, (float)r - 1.0f), r};
#else
    const Map& m = map;
#endif
    const float kPoisson[32] = SCR_POISSON_16;
    const float sr = 6.0f / 4096.0f;
    float bsum = 0.0f, bcnt = 0.0f;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
        const float bu = su + kPoisson[2 * k] * sr;
        const float bv = sv + kPoisson[2 * k + 1] * sr;
        const bool binb = bu >= 0.0f && bu <= 1.0f && bv >= 0.0f && bv <= 1.0f;
        const int tx = (int)sc_clamp(bu * (float)r, 0.0f, (float)r - 1.0f);
        const int ty = (int)sc_clamp(bv * (float)r, 0.0f, (float)r - 1.0f);
        const float sdep = m.texel(tx, ty);
        const bool blk = binb && sdep < cmp;
        bsum = bsum + (blk ? sdep : 0.0f);
        bcnt = bcnt + (blk ? 1.0f : 0.0f);
    }
    const bool has_blk = bcnt > 0.0f;
    const float avg = has_blk ? bsum / fmaxf(bcnt, 1.0f) : -1.0f;
    float pen = fmaxf(cmp - avg, 0.0f) * 1.0f / fmaxf(avg, 0.001f);
    pen = sc_clamp(pen, 0.0f, 100.0f);
    const float sfr = fminf(fmaxf(pen, 1.0f), 4.0f) / 4096.0f;
    const float cref = sc_clamp01(cmp);
    float ssum = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const float fu = su + kPoisson[2 * k] * sfr;
        const float fv = sv + kPoisson[2 * k + 1] * sfr;
        const bool finb = fu >= 0.0f && fu <= 1.0f && fv >= 0.0f && fv <= 1.0f;
        ssum = ssum + (finb ? pcf2x2(m, fu, fv, cref) : 1.0f);
    }
    ssum = ssum / 16.0f;
    return inb ? (has_blk ? ssum : 1.0f) : 1.0f;
}

// ---------------------------------------------------------------------------
// S8: the shade of one pixel (screen.py:1098-1561). shade_front runs up to
// the shading normal; the caller forms the 2x2 quad's normal gradient
// (dpdxCoarse / dpdyCoarse of the top-left pixel) and shade_back finishes.
// ---------------------------------------------------------------------------

struct ShadeState {
    float uu, vv, world[3], vd[3], blended[3], sn[3];
    float height_norm, occl, rough, mat_alb[3], wdv, scatter[3];
    bool is_water;
};

F3D_HD float hm_sample(const ScreenArgs& a, float u, float v) {
    float r;
    if (a.filterable)
        tex_bilinear(a.hm, a.hm_h, a.hm_w, 1, u, v, &r);
    else
        tex_nearest(a.hm, a.hm_h, a.hm_w, 1, u, v, &r);
    return r;
}

// the clamped height at (u, v), both clipped to [0, 1]
F3D_HD float geom_h(const ScreenArgs& a, float u, float v) {
    return sc_clamp(hm_sample(a, sc_clamp01(u), sc_clamp01(v)), a.dom_lo, a.dom_hi);
}

// ---------------------------------------------------------------------------
// S7: parallax occlusion mapping of one pixel (screen.py:979-1035). JAX
// marches every lane max_steps times and masks the lanes that stopped; a
// stopped lane never resumes (its layer and height freeze, and i < steps
// only gets stricter), so here each thread stops at its own last step and
// the values are the same. The refinement runs refine_steps halvings.
// ---------------------------------------------------------------------------

F3D_HD void pom_uv(const ScreenArgs& a, float u, float v, const float* n, const float* view_dir,
                   float& pu, float& pv, float& layer_out, bool& crossed) {
    const bool yup = fabsf(n[1]) > 0.99f;
    const float up[3] = {0.0f, yup ? 0.0f : 1.0f, yup ? 1.0f : 0.0f};
    float t[3], b[3], vd[3];
    cross3(up, n, t);
    normalize3(t);
    cross3(n, t, b);
    for (int c = 0; c < 3; ++c) vd[c] = t[c] * view_dir[0] + b[c] * view_dir[1] + n[c] * view_dir[2];
    normalize3(vd);
    const float blend = sc_clamp01(fabsf(vd[2]));
    const float fsteps = sc_clamp(rintf(blend * (float)(a.pom_min - a.pom_max) + (float)a.pom_max),
                                  1.0f, (float)a.pom_max);
    const int steps = (int)fsteps;
    const float L = sqrtf(vd[0] * vd[0] + vd[1] * vd[1]);
    const bool active = L >= 1e-5f;
    const float Lc = fmaxf(L, 1e-20f);
    const float pdx = vd[0] / Lc * a.pom_scale, pdy = vd[1] / Lc * a.pom_scale;
    const float step = 1.0f / fsteps;
    float cu = u, cv = v, layer = 0.0f;
    float ch = hm_sample(a, sc_clamp01(u), sc_clamp01(v));
    if (active) {
        for (int i = 0; i < steps && layer < ch; ++i) {
            cu = cu - pdx * step;
            cv = cv - pdy * step;
            layer = layer + step;
            ch = hm_sample(a, sc_clamp01(cu), sc_clamp01(cv));
        }
    }
    crossed = active && layer >= ch;
    float rss = step;
    for (int k = 0; k < a.pom_refine; ++k) {
        const float du = pdx * rss * 0.5f, dv = pdy * rss * 0.5f;
        rss = rss * 0.5f;
        const bool ge = layer >= hm_sample(a, sc_clamp01(cu), sc_clamp01(cv));
        if (active) {
            cu = ge ? cu - du : cu + du;
            cv = ge ? cv - dv : cv + dv;
            layer = ge ? layer - rss : layer + rss;
        }
    }
    pu = active ? sc_clamp01(cu) : u;
    pv = active ? sc_clamp01(cv) : v;
    layer_out = active ? layer : 0.0f;
}

// The displaced height of a pixel, clamped to the domain, and its
// occlusion (screen.py:1158-1192): the height at the parallax uv, or 1 -
// layer where the family generation's march crossed.
F3D_HD float pom_height(const ScreenArgs& a, float uu, float vv, const float* n, const float* vd,
                        float& pu, float& pv, float& occl) {
    float layer = 0.0f;
    bool crossed = false;
    pu = uu;
    pv = vv;
    if (a.pom_on) pom_uv(a, uu, vv, n, vd, pu, pv, layer, crossed);
    float hs = hm_sample(a, sc_clamp01(pu), sc_clamp01(pv));
    if (a.pom_on && a.pom_layer && crossed) hs = 1.0f - layer;
    hs = sc_clamp(hs, a.dom_lo, a.dom_hi);
    occl = a.pom_on && a.pom_occl ? sc_clamp(hs, 0.65f, 1.0f) : 1.0f;
    return hs;
}

// ---------------------------------------------------------------------------
// S6: the sky at one pixel (screen.py:748-877), in k/255 steps, and the
// aerial perspective that blends it into the exposed shade (:1508-1541)
// ---------------------------------------------------------------------------

F3D_HD void sky_pixel(const SkyArgs& k, int W, int H, int x, int y, float* out) {
    const float px = ((float)x + 0.5f) / (float)W, py = ((float)y + 0.5f) / (float)H;
    const float ndc[2] = {px * 2.0f - 1.0f, 1.0f - py * 2.0f};
    const float* P = k.inv_proj;
    const float* V = k.inv_view;
    float vp[4], vdir[3], wdir[3];
    for (int r = 0; r < 4; ++r)
        vp[r] = ndc[0] * P[4 * r] + ndc[1] * P[4 * r + 1] + P[4 * r + 2] + P[4 * r + 3];
    for (int c = 0; c < 3; ++c) vdir[c] = vp[c] / vp[3];
    const float nv = norm3(vdir);
    for (int c = 0; c < 3; ++c) vdir[c] = vdir[c] / nv;
    for (int r = 0; r < 3; ++r) wdir[r] = vdir[0] * V[4 * r] + vdir[1] * V[4 * r + 1] + vdir[2] * V[4 * r + 2];
    const float nw = norm3(wdir);
    for (int c = 0; c < 3; ++c) wdir[c] = wdir[c] / nw;
    const float ct = fmaxf(wdir[1], 0.0f);
    const float cg = sc_dot3(wdir, k.sun);
    const float gamma = acosf(sc_clamp(cg, -1.0f, 1.0f));
    const float ray_m = cg * cg;
    float color[3];
    if (k.model == 1) {
        const float zenith = sqrtf(fmaxf(ct, 0.0f));
        for (int ch = 0; ch < 3; ++ch) {
            const float* q = k.cfg + 9 * ch;
            const float mie_den = fmaxf(k.mie_k1[ch] - k.mie_k2[ch] * cg, 1e-4f);
            const float mie = (1.0f + ray_m) / powf(mie_den, 1.5f);
            color[ch] = k.rad[ch] * (1.0f + q[0] * expf(q[1] / (ct + 0.01f)))
                        * (q[2] + q[3] * expf(q[4] * gamma) + q[5] * ray_m + q[6] * mie + q[7] * zenith);
        }
    } else {
        const float Y = (1.0f + k.pA * expf(k.pB / (ct + 0.01f)))
                        * (1.0f + k.pC * expf(k.pD * gamma) + k.pE * cg * cg) / k.p_den;
        for (int c = 0; c < 3; ++c) {
            const float v = k.p_col[c] * Y;
            color[c] = (v + (k.p_haze - v) * k.p_mix) * k.p_alb;
        }
    }
    const float horizon = 1.0f - sc_clamp01(wdir[1]);
    const float h2 = horizon * horizon;
    const bool inside = cg >= k.disc_cos;
    float limb = sc_clamp01((cg - k.disc_cos) / k.limb_den);
    limb = limb * limb * (3.0f - 2.0f * limb);
    const bool ring = cg >= k.glow_cos && !inside;
    float gf = sc_clamp01((cg - k.glow_cos) / k.glow_den);
    gf = gf * gf * (3.0f - 2.0f * gf);
    const float sun_align = fmaxf(cg, 0.0f);
    const float fwd = powf(sun_align, k.e_fwd), broad = powf(sun_align, k.e_broad);
    const float hglow = h2 * k.low_sun * k.hglow_k;
    const float scat = fwd * k.inten * 0.35f + broad * k.inten * k.k_broad + hglow * k.inten * 0.22f + k.amb;
    for (int c = 0; c < 3; ++c) {
        const float night = k.night0[c] + k.night_d[c] * h2;
        float v = fmaxf(color[c], 0.0f);
        v = night + (v - night) * k.daylight;
        v = v + (ring ? k.ring_c[c] * gf : (inside ? k.disc_c[c] * limb : 0.0f));
        v = (v + k.scat_c[c] * scat) * k.exposure;
        v = v / (v + 1.0f);
        out[c] = rintf(sc_clamp01(v) * 255.0f) / 255.0f;
    }
}

F3D_HD void aerial_blend(const SkyArgs& k, const float* world, const float* cam, const float* sky,
                         float* shaded) {
    const float to_cam[3] = {cam[0] - world[0], cam[1] - world[1], cam[2] - world[2]};
    const float a_fac = 1.0f - expf(k.density_neg * norm3(to_cam) * k.k_fac);
    const float a_amt = sc_clamp01(a_fac * k.k_amt);
    const float luma = shaded[0] * 0.2126f + shaded[1] * 0.7152f + shaded[2] * 0.0722f;
    const float dk = a_amt * k.k_desat, blend = a_amt * k.k_blend;
    for (int c = 0; c < 3; ++c) {
        const float desat = shaded[c] + (luma - shaded[c]) * dk;
        shaded[c] = desat + (sky[c] * k.k_target * k.tint[c] + k.add[c] - desat) * blend;
    }
}

F3D_HD void shade_front(const ScreenArgs& a, int x, int y, ShadeState& s) {
    const float sx = ((float)x + 0.5f) / (float)a.width;
    const float sy = 1.0f - ((float)y + 0.5f) / (float)a.height;
    s.uu = sx * 0.5f;
    s.vv = sy * 0.5f;
    const float uu = s.uu, vv = s.vv;
    s.world[0] = sx - 0.5f;
    s.world[1] = sy - 0.5f;
    s.world[2] = a.z_corners[0] * (1.0f - sx * 0.5f - sy * 0.5f) + a.z_corners[1] * (sx * 0.5f)
                 + a.z_corners[2] * (sy * 0.5f);
    for (int c = 0; c < 3; ++c) s.vd[c] = a.camera_pos[c] - s.world[c];
    normalize3(s.vd);

    // heights and the LOD-aware Sobel normal (Y-up)
    const float t0 = a.texel[0], t1 = a.texel[1];
    const float tl = geom_h(a, uu - t0, vv - t1), tc = geom_h(a, uu, vv - t1);
    const float tr = geom_h(a, uu + t0, vv - t1), lc = geom_h(a, uu - t0, vv);
    const float rc = geom_h(a, uu + t0, vv), bl = geom_h(a, uu - t0, vv + t1);
    const float bc = geom_h(a, uu, vv + t1), br = geom_h(a, uu + t0, vv + t1);
    const float dx = (tr + 2.0f * rc + br) - (tl + 2.0f * lc + bl);
    const float dy = (bl + 2.0f * bc + br) - (tl + 2.0f * tc + tr);
    s.blended[0] = -dx / t0;
    s.blended[1] = a.vert;
    s.blended[2] = -dy / t1;
    normalize3(s.blended);

    // POM (S7): the water mask, the height and the material maps are read
    // at the parallax uv
    float pu, pv;
    const float hs = pom_height(a, uu, vv, s.blended, s.vd, pu, pv, s.occl);
    float wm = 0.0f;
    if (a.has_wm) tex_nearest(a.wm, a.wm_h, a.wm_w, 1, sc_clamp01(pu), sc_clamp01(pv), &wm);
    s.is_water = wm > 0.001f;
    s.height_norm = sc_clamp01((hs - a.dom_lo) / a.dom_rng);

    // material layer weights (gaussian, sigma = blend_half * 1.5)
    const float centers[4] = {0.0f, 0.333333343f, 0.666666687f, 1.0f};
    const float slope_mod[4] = {1.5f, 0.5f, 1.0f, 1.0f};
    float w[4];
    for (int k = 0; k < 4; ++k) {
        const float d = s.height_norm - centers[k];
        w[k] = expf(-(d * d) / 0.0703125f) * slope_mod[k];
    }
    const float wsum = fmaxf(w[0] + w[1] + w[2] + w[3], 1e-5f);
    for (int k = 0; k < 4; ++k) w[k] = w[k] / wsum;
    s.rough = w[0] * 0.50f + w[1] * 0.85f + w[2] * 0.50f + w[3] * 0.25f;
    const int pix = y * a.width + x;
    for (int c = 0; c < 3; ++c)
        s.mat_alb[c] = a.has_mat_albedo
                           ? a.mat_albedo[a.mat_albedo_stride * pix + c]
                           : w[0] * a.ml[c] + w[1] * a.ml[3 + c] + w[2] * a.ml[6 + c]
                                 + w[3] * a.ml[9 + c];

    for (int c = 0; c < 3; ++c) s.sn[c] = s.blended[c];
    s.wdv = 0.0f;
    s.scatter[0] = s.scatter[1] = s.scatter[2] = 0.0f;
    if (a.has_wm) {
        const bool enc = wm > 0.01f && wm < 0.99f;
        const float shore = enc ? wm : 1.0f - sc_clamp01(s.height_norm / 0.20f);
        s.wdv = s.is_water ? shore : 0.0f;
        const float shallow[3] = {0.1f, 0.5f, 0.85f};
        const float dsub[3] = {0.05f - 0.1f, 0.45f - 0.5f, 0.95f - 0.85f};
        float under[3];
        for (int c = 0; c < 3; ++c) {
            under[c] = shallow[c] + dsub[c] * s.wdv;
            s.scatter[c] = s.is_water ? under[c] * (1.0f - s.wdv * 0.3f) * 1.2f : 0.0f;
        }
        const float wx = s.world[0], wy = s.world[1];
        const float wc = a.wave_cs[0], ws = a.wave_cs[1];
        const float c1 = wx * wc + wy * ws;
        const float cp = -wx * ws + wy * wc;
        const float wscale = 0.3f + 0.7f * s.wdv;
        const float w1 = sinf(c1 * 0.05f) * 0.07f * wscale;
        const float w2 = sinf(c1 * 0.15f + cp * 0.03f) * 0.035f * wscale;
        const float w3 = sinf(c1 * 0.4f + 1.7f) * 0.018f;
        const float cw = sinf(cp * 0.12f + 0.5f) * 0.02f * wscale;
        const float s3 = w1 + w2 + w3;
        float wave_n[3] = {s3 * wc + cw * (-ws), 1.0f, s3 * ws + cw * wc};
        normalize3(wave_n);
        if (s.is_water) {
            for (int c = 0; c < 3; ++c) {
                s.sn[c] = wave_n[c];
                s.mat_alb[c] = under[c];
            }
            s.rough = 0.02f;
        }
    }

    // M4 material maps, sampled at the parallax uv with the linear sampler
    if (a.mm_normal || a.mm_rough || a.mm_mask) {
        const float mu = sc_clamp01(pu), mv = sc_clamp01(pv);
        float mask = 1.0f;
        if (a.mm_mask) tex_bilinear(a.mmk, a.mmk_h, a.mmk_w, 1, mu, mv, &mask);
        if (a.mm_normal) {
            float tn[3];
            tex_bilinear(a.mmn, a.mmn_h, a.mmn_w, 3, mu, mv, tn);
            for (int c = 0; c < 3; ++c) tn[c] = tn[c] * 2.0f - 1.0f;
            normalize3(tn);
            const float* nb = s.sn;
            const bool yup = fabsf(nb[1]) > 0.99f;
            const float up[3] = {0.0f, yup ? 0.0f : 1.0f, yup ? 1.0f : 0.0f};
            float tb[3], bb[3], mapped[3], cand[3];
            cross3(up, nb, tb);
            normalize3(tb);
            cross3(nb, tb, bb);
            for (int c = 0; c < 3; ++c) mapped[c] = tb[c] * tn[0] + bb[c] * tn[1] + nb[c] * tn[2];
            normalize3(mapped);
            const float wn = sc_clamp01(mask);
            for (int c = 0; c < 3; ++c) cand[c] = nb[c] + (mapped[c] - nb[c]) * wn;
            normalize3(cand);
            if (mask > 0.001f && !(a.has_wm && s.is_water))
                for (int c = 0; c < 3; ++c) s.sn[c] = cand[c];
        }
        if (a.mm_rough) {
            float rmap;
            tex_bilinear(a.mmr, a.mmr_h, a.mmr_w, 1, mu, mv, &rmap);
            s.rough = s.rough + (rmap - s.rough) * sc_clamp01(mask);
        }
    }
}

// _apply_slope_hue_variation at slope factor 1, with the period-1 fract quirk
F3D_HD void hue_variation(const float* alb, float hn, float strength, float* out) {
    const float r = alb[0], g = alb[1], b = alb[2];
    const float maxc = fmaxf(fmaxf(r, g), b), minc = fminf(fminf(r, g), b);
    const float delta = maxc - minc;
    const bool gray = delta < 0.001f;
    const float sd = gray ? 1.0f : delta;
    float hue = maxc == r ? ((g - b) / sd) / 6.0f
                          : (maxc == g ? (2.0f + (b - r) / sd) / 6.0f : (4.0f + (r - g) / sd) / 6.0f);
    if (hue < 0.0f) hue = hue + 1.0f;
    const float sat = delta / fmaxf(maxc, 1e-20f);
    const float val = maxc;
    const float nh = sc_mod1(hue + 0.5f * strength + (hn - 0.5f) * strength * 0.4f
                             + (sat - 0.5f) * strength * 0.5f);
    const float c = sat * val;
    const float h6 = nh * 6.0f;
    const float xx = c * (1.0f - fabsf((h6 - floorf(h6)) * 2.0f - 1.0f));
    const float m = val - c;
    float rgb[3];
    if (h6 < 1.0f) { rgb[0] = c; rgb[1] = xx; rgb[2] = 0.0f; }
    else if (h6 < 2.0f) { rgb[0] = xx; rgb[1] = c; rgb[2] = 0.0f; }
    else if (h6 < 3.0f) { rgb[0] = 0.0f; rgb[1] = c; rgb[2] = xx; }
    else if (h6 < 4.0f) { rgb[0] = 0.0f; rgb[1] = xx; rgb[2] = c; }
    else if (h6 < 5.0f) { rgb[0] = xx; rgb[1] = 0.0f; rgb[2] = c; }
    else { rgb[0] = c; rgb[1] = 0.0f; rgb[2] = xx; }
    for (int k = 0; k < 3; ++k) out[k] = gray ? alb[k] : rgb[k] + m;
}

// P4 planar water reflection blend (screen.py:1566-1600)
F3D_HD void reflection_blend(const ScreenArgs& a, const ShadeState& s, const float* base,
                             float* out) {
    const float* R = a.rvp;
    float clip4[4];
    for (int j = 0; j < 4; ++j)
        clip4[j] = s.world[0] * R[j] + s.world[1] * R[4 + j] + s.world[2] * R[8 + j] + R[12 + j];
    const bool w_ok = fabsf(clip4[3]) >= 0.001f;
    const float wdiv = w_ok ? clip4[3] : 1.0f;
    const float ru0 = (clip4[0] / wdiv) * 0.5f + 0.5f;
    const float rv0 = 1.0f - ((clip4[1] / wdiv) * 0.5f + 0.5f);
    const float t = sc_clamp01((s.wdv - 0.0f) / (a.refl_shore_w - 0.0f));
    const float shore_f = t * t * (3.0f - 2.0f * t);
    const float ru = sc_clamp(ru0 + s.sn[0] * a.refl_wave * shore_f, 0.001f, 0.999f);
    const float rv = sc_clamp(rv0 + s.sn[2] * a.refl_wave * shore_f, 0.001f, 0.999f);
    float rr[3];
    tex_bilinear(a.refl, a.refl_h, a.refl_w, 3, ru, rv, rr);
    const float ndv = fmaxf(sc_dot3(s.sn, s.vd), 0.0f);
    const float fres = sc_clamp01(powf(1.0f - ndv, a.refl_fresnel));
    const float blend = fres * a.refl_intensity * shore_f;
    for (int c = 0; c < 3; ++c) out[c] = w_ok ? base[c] + (rr[c] - base[c]) * blend : base[c];
}

F3D_HD float tonemap_filmic(const float* k, float c) {
    const float x = fmaxf(c, 0.0f);
    const float curve = ((x * (k[0] * x + k[2]) + k[3]) / (x * (k[0] * x + k[1]) + k[4])) - k[5];
    return sc_clamp01(curve / k[6]);
}

// the filmic tonemap, the gamma or sRGB encode and the u8 quantisation of
// one exposed channel
F3D_HD unsigned char encode_u8(const ScreenArgs& a, float shaded) {
    const float f = tonemap_filmic(a.filmic, shaded);
    float e;
    if (a.srgb) {
        const float csr = sc_clamp01(f);
        e = csr <= 0.0031308f ? csr * 12.92f
                              : 1.055f * powf(fmaxf(csr, 1e-8f), 0.416666657f) - 0.055f;
    } else {
        e = powf(sc_clamp01(f), 0.454545468f);
    }
    return (unsigned char)rintf(sc_clamp01(e) * 255.0f);
}

// ngrad: |n(top right) - n(top left)| + |n(bottom left) - n(top left)| of
// the pixel's 2x2 quad
F3D_HD void shade_back(const ScreenArgs& a, const ScreenOut& o, int x, int y, const ShadeState& s,
                       float ngrad) {
    const bool water = a.has_wm && s.is_water;
    // colormap overlay, hue variation
    float overlay[3], albedo[3];
    lut_sample(a.lut, a.lut_n, s.height_norm, overlay);
    for (int c = 0; c < 3; ++c) {
        float f = a.albedo_mode == 0 ? overlay[c]
                  : a.albedo_mode == 1 ? s.mat_alb[c]
                                       : s.mat_alb[c] + (overlay[c] - s.mat_alb[c]) * a.colormap_strength;
        if (water) f = s.mat_alb[c];
        albedo[c] = sc_clamp01(f);
    }
    if (a.hue_on && !water) hue_variation(albedo, s.height_norm, a.hue_strength, albedo);

    // M4 material layers and TV10 subsurface state
    float sss_s = 0.0f, sss_t[3] = {1.0f, 1.0f, 1.0f};
    if (a.mats_on) {
        float snow_w = 0.0f;
        if (a.snow_on)
            snow_w = sc_clamp01((s.world[2] - a.snow_alt_min) / a.snow_alt_div) * a.snow_slope_f;
        const float sw = sc_clamp01(snow_w);
        if (!water) {
            for (int c = 0; c < 3; ++c) {
                float l = albedo[c] * a.wet_scale;
                l = l + (a.rock_c[c] - l) * a.rock_mix;
                albedo[c] = l + (a.snow_c[c] - l) * sw;
            }
        }
        for (int k = 0; k < 3; ++k) {
            const float strength = a.sss_strength[k];
            if (strength <= 0.0f) continue;
            const float wk = k < 2 ? a.layer_w[k] : snow_w;
            const float cov = wk > 0.0f ? sc_clamp01(wk) : 0.0f;
            sss_s = sss_s + (strength - sss_s) * cov;
            for (int c = 0; c < 3; ++c) sss_t[c] = sss_t[c] + (a.sss_tint[3 * k + c] - sss_t[c]) * cov;
        }
    }
    const float rough = s.is_water ? sc_clamp(s.rough, 0.02f, 1.0f) : sc_clamp(s.rough, 0.25f, 1.0f);
    const float f0 = s.is_water ? a.f0_water : 0.04f;

    // CSM / PCSS shadows (S5)
    const float shadow_h = sc_clamp01((geom_h(a, s.uu, s.vv) - a.dom_lo) / a.dom_rng);
    const float sp[3] = {(s.uu - 0.5f) * a.shadow_rspan, (s.vv - 0.5f) * a.shadow_rspan,
                         shadow_h * a.z_scale};
    const float vis = pcss_visibility(ShadowTex{a.shadow_tex, a.shadow_res}, a.lvp, a.pcss_ld, sp,
                                      s.blended);
    const float shadow_factor = 0.8f + 0.2f * vis;

    // IBL (eval_ibl_split)
    const float* n = s.sn;
    const float ibl_i = a.ibl_intensity;
    const float ndv_raw = sc_dot3(n, s.vd);
    const float ndv = sc_clamp01(ndv_raw);
    const float rc2 = sc_clamp01(rough);
    float refl[3];
    for (int c = 0; c < 3; ++c) refl[c] = (2.0f * ndv_raw) * n[c] - s.vd[c];
    normalize3(refl);
    const float omc = sc_clamp01(1.0f - ndv);
    const float o2 = omc * omc;
    const float F = f0 + (fmaxf(1.0f - rc2, f0) - f0) * (omc * (o2 * o2));
    const float kD = 1.0f - F;
    float irr[3], pref[3], brdf[2];
    cube_sample(a.irr, a.irr_size, n, irr);
    cube_sample_mips(a, refl, rc2 * rc2 * 9.0f, pref);
    tex_bilinear(a.brdf, a.brdf_h, a.brdf_w, 2, ndv, rc2, brdf);
    const float spec_brdf = F * brdf[0] + brdf[1];
    const float ibl_occl = s.is_water ? 1.0f : sc_clamp(s.occl, 0.65f, 1.0f);
    float ibl_diffuse[3], ibl_spec[3], ibl_contrib[3];
    for (int c = 0; c < 3; ++c) {
        ibl_diffuse[c] = kD * (water ? 0.0f : albedo[c]) * irr[c];
        ibl_spec[c] = pref[c] * spec_brdf;
        ibl_contrib[c] = (ibl_diffuse[c] * shadow_factor + ibl_spec[c]) * ibl_i * ibl_occl;
    }

    float shaded[3];
    // terrain branch (P2-S4 composition)
    const float ndl = fmaxf(sc_dot3(n, a.ldir), 0.0f);
    const float base_diffuse = (0.32f + (-0.22f) * ndl) + 0.26f * ndl * a.sun_int;
    const float edge_sig = (1.0f - fabsf(n[1])) * 0.3f + ngrad * 15.0f;
    const float edge_bright = sc_clamp(edge_sig * (ndl + 0.3f), 0.0f, 0.25f);
    const float edge_dark = sc_clamp(edge_sig * (1.0f - ndl) * 0.5f, 0.0f, 0.15f);
    const float diffuse_raw = base_diffuse + edge_bright - edge_dark;
    const float cs = fmaxf(shadow_factor, 0.30f);
    const float diffuse_lit = diffuse_raw * (fmaxf(s.occl, 0.65f) * cs);
    const float ibl_dfac = norm3(ibl_diffuse) * ibl_i;
    const float lighting = diffuse_lit + ibl_dfac * a.ibl_fill;
    for (int c = 0; c < 3; ++c)
        shaded[c] = albedo[c] * lighting + fminf(ibl_spec[c] * ibl_i * 0.12f, albedo[c] * 0.20f);
    if (a.sss_on) {
        const float ndl_s = sc_clamp01(sc_dot3(n, a.ldir));
        const float wrap_w = 0.45f * sss_s;
        const float wrapped = sc_clamp01((ndl_s + wrap_w) / (1.0f + wrap_w));
        const float wrap_boost = fmaxf(wrapped - ndl_s, 0.0f);
        const float nl[3] = {-a.ldir[0], -a.ldir[1], -a.ldir[2]};
        const float vb = sc_clamp01(sc_dot3(s.vd, nl));
        const float vb2 = vb * vb;
        const float backscatter = vb2 * vb2 * (0.25f + 0.75f * (1.0f - ndl_s));
        const float profile = fmaxf(wrap_boost * 1.35f, backscatter * 0.30f);
        const float bleed = 0.20f + 0.80f * sc_clamp01(cs);
        const float fill = ibl_dfac * (0.02f + 0.06f * sss_s) * (1.0f - ndl_s * 0.5f);
        const float amount = profile * bleed + fill;
        const float scale = 0.16f + 0.44f * sss_s;
        for (int c = 0; c < 3; ++c)
            shaded[c] = shaded[c] + (sss_s > 0.0f
                                         ? sc_clamp(albedo[c] * (1.0f + (sss_t[c] - 1.0f) * 0.85f),
                                                    0.0f, 1.5f) * amount * scale
                                         : 0.0f);
    }
    if (water) {
        const float ndv_w = fmaxf(ndv_raw, 0.001f);
        const float ndl_w = fmaxf(sc_dot3(n, a.ldir), 0.0f);
        float hv[3] = {s.vd[0] + a.ldir[0], s.vd[1] + a.ldir[1], s.vd[2] + a.ldir[2]};
        normalize3(hv);
        const float ndh = fmaxf(sc_dot3(n, hv), 0.0f);
        const float vdh = fmaxf(sc_dot3(s.vd, hv), 0.001f);
        const float alpha = rough * rough;
        const float a2 = fmaxf(alpha * alpha, 1e-8f);
        const float den = ndh * ndh * (a2 - 1.0f) + 1.0f;
        const float Dt = a2 / (SCR_PI * den * den);
        const float om = 1.0f - vdh, om2 = om * om;
        const float fres = f0 + (1.0f - f0) * (om * (om2 * om2));
        const float kk = alpha / 2.0f;
        const float G = (ndv_w / (ndv_w * (1.0f - kk) + kk)) * (ndl_w / (ndl_w * (1.0f - kk) + kk));
        const float dspec = (Dt * G / (4.0f * ndv_w * ndl_w + 1e-4f)) * fres;
        const float sun_c[3] = {1.0f, 0.98f, 0.95f};
        const float tint[3] = {0.15f * 0.80f, 0.45f * 0.80f, 0.85f * 0.80f};
        const float depth_atten = 1.0f + (-0.7f) * s.wdv;
        float comb[3];
        if (a.has_refl)
            reflection_blend(a, s, ibl_contrib, comb);
        else
            for (int c = 0; c < 3; ++c) comb[c] = ibl_contrib[c];
        for (int c = 0; c < 3; ++c) {
            const float sun_spec = dspec * sun_c[c] * a.lcol[2] * ndl_w;
            shaded[c] = (comb[c] * 0.30f + sun_spec * 0.50f) * depth_atten + tint[c]
                        + s.scatter[c] * 2.0f;
        }
    }

    for (int c = 0; c < 3; ++c) shaded[c] = shaded[c] * a.exposure;
    if (a.sky.model) {   // S6: the sky and the aerial perspective
        float sky[3];
        sky_pixel(a.sky, a.width, a.height, x, y, sky);
        aerial_blend(a.sky, s.world, a.camera_pos, sky, shaded);
    }

    const int pix = y * a.width + x;
    for (int c = 0; c < 3; ++c) {
        o.rgba[4 * pix + c] = encode_u8(a, shaded[c]);
        o.albedo[3 * pix + c] = albedo[c];
        o.normal[3 * pix + c] = n[c];
    }
    o.rgba[4 * pix + 3] = 255;
    o.height[pix] = s.height_norm;
}

// |a - t| + |b - t| for the quad's top-left t, top-right a, bottom-left b
F3D_HD float quad_grad(const float* t, const float* a, const float* b) {
    const float dx[3] = {a[0] - t[0], a[1] - t[1], a[2] - t[2]};
    const float dy[3] = {b[0] - t[0], b[1] - t[1], b[2] - t[2]};
    return norm3(dx) + norm3(dy);
}

// S8's layout: a block of 256 threads shades a 16x16 tile of pixels and a
// warp an 8x4 patch of it (4x2 quads; two warps across, four down), so a
// warp's PCSS taps, height reads and material reads come from a compact
// patch of the screen. Four consecutive lanes hold a 2x2 quad, top left,
// top right, bottom left, bottom right, as quad_grad's shuffles want.
// s8_pixel gives thread t of block b its pixel and whether it lies in the
// image; a thread past the image (widths and heights are even, so whole
// quads) shades pixel (0, 0) and writes nothing, so every lane reaches the
// shuffles.
#define F3D_S8_TILE 16

F3D_HD long long s8_blocks(int width, int height) {
    return (long long)((width + F3D_S8_TILE - 1) / F3D_S8_TILE)
           * ((height + F3D_S8_TILE - 1) / F3D_S8_TILE);
}

F3D_HD bool s8_pixel(int width, int height, long long b, int t, int& x, int& y) {
    const int w = t >> 5, qi = (t & 31) >> 2, sub = t & 3;
    const int tiles_x = (width + F3D_S8_TILE - 1) / F3D_S8_TILE;
    const int px = (int)(b % tiles_x) * F3D_S8_TILE + (w & 1) * 8 + (qi & 3) * 2 + (sub & 1);
    const int py = (int)(b / tiles_x) * F3D_S8_TILE + (w >> 1) * 4 + (qi >> 2) * 2 + (sub >> 1);
    const bool live = px < width && py < height;
    x = live ? px : 0;
    y = live ? py : 0;
    return live;
}

// ---------------------------------------------------------------------------
// S9: the clipmap shade of one pixel (screen.py:1857-2025) over the host
// G-buffer: nearest height samples (the caller sets a.filterable = 0), the
// Sobel step texel * spacing, the base normal (0, 0, 1) on the apron
// (u <= 0), POM, no water, layers, maps, reflection or sky. Every pixel is
// shaded, invalid ones too (their normals enter their quad's edge term, as
// in JAX); clip_back writes the background where the G-buffer is invalid.
// The kernel runs S8's layout (s8_pixel) and reads the map through the
// texture (ShadowTex); clip_back takes the map's reader as a parameter so
// that the kernels' CPU twin can hold it against the pointer's.
// ---------------------------------------------------------------------------

struct ClipState {
    float uu, vv, world[3], vd[3], n[3], height_norm, occl;
};

F3D_HD void clip_front(const ScreenArgs& a, const ClipArgs& g, int x, int y, ClipState& s) {
    const int pix = y * a.width + x;
    s.uu = g.uv[2 * pix];
    s.vv = g.uv[2 * pix + 1];
    const float uu = s.uu, vv = s.vv;
    for (int c = 0; c < 3; ++c) {
        s.world[c] = g.world[3 * pix + c];
        s.vd[c] = a.camera_pos[c] - s.world[c];
    }
    normalize3(s.vd);
    const float t0 = a.texel[0], t1 = a.texel[1];
    const float tl = geom_h(a, uu - t0, vv - t1), tc = geom_h(a, uu, vv - t1);
    const float tr = geom_h(a, uu + t0, vv - t1), lc = geom_h(a, uu - t0, vv);
    const float rc = geom_h(a, uu + t0, vv), bl = geom_h(a, uu - t0, vv + t1);
    const float bc = geom_h(a, uu, vv + t1), br = geom_h(a, uu + t0, vv + t1);
    const float dx = (tr + 2.0f * rc + br) - (tl + 2.0f * lc + bl);
    const float dy = (bl + 2.0f * bc + br) - (tl + 2.0f * tc + tr);
    if (uu <= 0.0f) {
        s.n[0] = 0.0f;
        s.n[1] = 0.0f;
        s.n[2] = 1.0f;
    } else {
        s.n[0] = -dx / g.wtex[0];
        s.n[1] = a.vert;
        s.n[2] = -dy / g.wtex[1];
        normalize3(s.n);
    }
    float pu, pv;
    const float hs = pom_height(a, uu, vv, s.n, s.vd, pu, pv, s.occl);
    s.height_norm = sc_clamp01((hs - a.dom_lo) / a.dom_rng);
}

// a pixel's rgba as one 32-bit store (little-endian: r in the low byte)
F3D_HD void store_rgba(unsigned char* rgba, int pix, const unsigned char* c) {
    const uint32_t v = (uint32_t)c[0] | (uint32_t)c[1] << 8 | (uint32_t)c[2] << 16 | 255u << 24;
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint32_t*>(rgba + 4 * (size_t)pix) = v;
#else
    memcpy(rgba + 4 * (size_t)pix, &v, 4);
#endif
}

template <class Map>
F3D_HD void clip_back(const Map& map, const ScreenArgs& a, const ClipArgs& g, unsigned char* rgba,
                      int x, int y, const ClipState& s, float ngrad) {
    const float centers[4] = {0.0f, 0.333333343f, 0.666666687f, 1.0f};
    const float wmod[4] = {1.5f, 0.5f, 1.0f, 1.0f};
    float w[4];
    for (int k = 0; k < 4; ++k) {
        const float d = s.height_norm - centers[k];
        w[k] = expf(-(d * d) / 0.0703125f) * wmod[k];
    }
    const float wsum = fmaxf(w[0] + w[1] + w[2] + w[3], 1e-5f);
    for (int k = 0; k < 4; ++k) w[k] = w[k] / wsum;
    const float rough = sc_clamp(w[0] * 0.50f + w[1] * 0.85f + w[2] * 0.50f + w[3] * 0.25f, 0.25f, 1.0f);
    float overlay[3], albedo[3];
    lut_sample(a.lut, a.lut_n, s.height_norm, overlay);
    for (int c = 0; c < 3; ++c) {
        const float m = w[0] * a.ml[c] + w[1] * a.ml[3 + c] + w[2] * a.ml[6 + c] + w[3] * a.ml[9 + c];
        const float f = a.albedo_mode == 0 ? overlay[c]
                        : a.albedo_mode == 1 ? m
                                             : m + (overlay[c] - m) * a.colormap_strength;
        albedo[c] = sc_clamp01(f);
    }
    if (a.hue_on) hue_variation(albedo, s.height_norm, a.hue_strength, albedo);

    // PCSS at the receiver's undisplaced height, in the spacing's frame
    const float shadow_h = sc_clamp01((geom_h(a, s.uu, s.vv) - a.dom_lo) / a.dom_rng);
    const float sp[3] = {(s.uu - 0.5f) * g.spacing, (s.vv - 0.5f) * g.spacing, shadow_h * a.z_scale};
    const float vis = pcss_visibility(map, a.lvp, a.pcss_ld, sp, s.n);
    const float cs = fmaxf(0.8f + 0.2f * vis, 0.30f);

    // split-sum IBL
    const float* n = s.n;
    const float ibl_i = a.ibl_intensity;
    const float ndv_raw = sc_dot3(n, s.vd);
    const float ndv = sc_clamp01(ndv_raw);
    const float rc2 = sc_clamp01(rough);
    float refl[3];
    for (int c = 0; c < 3; ++c) refl[c] = (2.0f * ndv_raw) * n[c] - s.vd[c];
    normalize3(refl);
    const float omc = sc_clamp01(1.0f - ndv);
    const float o2 = omc * omc;
    const float F = 0.04f + (fmaxf(1.0f - rc2, 0.04f) - 0.04f) * (omc * (o2 * o2));
    float irr[3], pref[3], brdf[2], ibl_diffuse[3];
    cube_sample(a.irr, a.irr_size, n, irr);
    cube_sample_mips(a, refl, rc2 * rc2 * 9.0f, pref);
    tex_bilinear(a.brdf, a.brdf_h, a.brdf_w, 2, ndv, rc2, brdf);
    const float spec_brdf = F * brdf[0] + brdf[1];
    for (int c = 0; c < 3; ++c) ibl_diffuse[c] = (1.0f - F) * albedo[c] * irr[c];

    // beauty composition (P2-S4)
    const float ndl = fmaxf(sc_dot3(n, a.ldir), 0.0f);
    const float base_diffuse = (0.32f + (-0.22f) * ndl) + 0.26f * ndl * a.sun_int;
    const float edge_sig = (1.0f - fabsf(n[1])) * 0.3f + ngrad * 15.0f;
    const float edge_bright = sc_clamp(edge_sig * (ndl + 0.3f), 0.0f, 0.25f);
    const float edge_dark = sc_clamp(edge_sig * (1.0f - ndl) * 0.5f, 0.0f, 0.15f);
    const float diffuse_lit = (base_diffuse + edge_bright - edge_dark) * (fmaxf(s.occl, 0.65f) * cs);
    const float lighting = diffuse_lit + norm3(ibl_diffuse) * ibl_i * a.ibl_fill;
    const int pix = y * a.width + x;
    const bool valid = g.valid[pix] != 0;
    const unsigned char bg[3] = {25, 25, 38};   // floor((0.1, 0.1, 0.15) * 255)
    unsigned char out[3];
    for (int c = 0; c < 3; ++c) {
        const float spec = pref[c] * spec_brdf;
        const float shaded = (albedo[c] * lighting + fminf(spec * ibl_i * 0.12f, albedo[c] * 0.20f))
                             * a.exposure;
        // the sRGB encode of S8 equals JAX's unclamped one of S9: the branch
        // that takes the power has c > 0.0031308
        out[c] = valid ? encode_u8(a, shaded) : bg[c];
    }
    store_rgba(rgba, pix, out);
}
