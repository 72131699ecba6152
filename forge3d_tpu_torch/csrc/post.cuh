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

// ---------------------------------------------------------------------------
// E2: the post-processing suite of forge3d_tpu/ops/post.py (39-270). The JAX
// functions run eagerly, one rounded jnp operation at a time; each body below
// does the same float32 operations in the same order (the kernels are built
// with -fmad=false), so that the kernels in post.cu agree with the plain
// PyTorch versions in ops/post.py.
// ---------------------------------------------------------------------------

// post.py:gaussian_blur's conv1d (46-55) along the middle axis of a tensor
// viewed as (outer, n, inner): output a of a column is the 2r + 1 taps summed
// from i = 0 upward, starting from zero, each tap times the edge-clamped
// element a + i - r of the axis. The columns are the outer * inner
// flattened (outer, inner) pairs; column f starts at element
// (f / inner) * n * inner + f % inner and steps by inner.
//
// Kernel E2 blur (post.cu:blur_kernel) takes a tile of F3D_BLUR_COLS
// consecutive columns by F3D_BLUR_SPAN positions a CTA: a lane a column, a
// warp 16 positions. With a shared window the CTA first stages its span and
// the r-wide halo on both sides into shared memory, the clamp applied as it
// stages (staged row s of a column holds position pos0 + s - r); without,
// the taps read device memory through the clamp (the radii whose window
// does not fit shared memory, past ops/post.py:BLUR_SHARED_RADIUS). A
// thread then computes F3D_BLUR_M consecutive outputs of its column at a
// time: for tap i it reads taps[i] once, adds
// taps[i] * window[i + j] into output j's sum for each j, and slides its
// window of F3D_BLUR_M values in registers by one value a tap. Each output
// still adds its taps from i = 0 upward, starting from zero, so the sums
// are the plain version's bit for bit (the build does not contract the
// multiply and the add).
//
// Both passes take the same tile. Axis 0's 32 columns are neighbouring
// floats of an image row; axis 1's (inner = C channels) are the channels of
// 32 / C neighbouring rows, so a warp's staging load or output store at one
// position touches each row's C floats, the rest of their sectors staying
// in L1 for the next positions. (Staging and storing each row's floats in
// memory order instead, a tile of whole rows, measured slower on K's
// blurs: PERF.md.)

#define F3D_BLUR_COLS 32        // columns a tile: a lane each
#define F3D_BLUR_SPAN 128       // positions a tile: a warp 16 of them
#define F3D_BLUR_THREADS 256
#define F3D_BLUR_M 8            // outputs a thread computes together

static_assert(F3D_BLUR_SPAN % ((F3D_BLUR_THREADS / F3D_BLUR_COLS) * F3D_BLUR_M) == 0,
              "a warp's positions must be whole runs of F3D_BLUR_M");

struct BlurGeom {
    const float* in;
    float* out;
    long long cols;   // outer * inner
    int n, inner, radius;
};

F3D_HD int blur_pos_tiles(int n) { return (n + F3D_BLUR_SPAN - 1) / F3D_BLUR_SPAN; }

F3D_HD long long blur_tiles(const BlurGeom& g) {
    return (g.cols + F3D_BLUR_COLS - 1) / F3D_BLUR_COLS * blur_pos_tiles(g.n);
}

// the first element of column f (clamped to the last column: a lane past
// the columns stages the last one and writes nothing); a thread's column is
// the same in its staging and its runs, so it finds it once
F3D_HD long long blur_col_base(const BlurGeom& g, long long f) {
    if (f >= g.cols) f = g.cols - 1;
    const long long plane = (long long)g.n * g.inner;
    if (f <= 0x7fffffffLL) {   // 32-bit division where the column index fits
        const int fi = (int)f;
        return (long long)(fi / g.inner) * plane + fi % g.inner;
    }
    return f / g.inner * plane + f % g.inner;
}

// tile b's first column and first position: the tiles of a column range
// run along the axis
F3D_HD void blur_tile(const BlurGeom& g, long long b, long long& col0, int& pos0) {
    const int tn = blur_pos_tiles(g.n);
    col0 = b / tn * F3D_BLUR_COLS;
    pos0 = (int)(b % tn) * F3D_BLUR_SPAN;
}

F3D_HD int blur_staged_rows(int radius) { return F3D_BLUR_SPAN + 2 * radius; }

F3D_HD size_t blur_shared_bytes(int radius) {
    return ((size_t)blur_staged_rows(radius) * F3D_BLUR_COLS + 2 * radius + 1) * sizeof(float);
}

// stage column k (its first element at `base`) of the tile at pos0: staged
// rows s0, s0 + ds, ..., each the edge-clamped position pos0 + s - r, into
// sm[s * COLS + k]
F3D_HD void blur_stage_column(const BlurGeom& g, long long base, int pos0, int k, int s0, int ds,
                              float* sm) {
    const float* src = g.in + base;
    const int rows = blur_staged_rows(g.radius);
#pragma unroll 4
    for (int s = s0; s < rows; s += ds)
        sm[s * F3D_BLUR_COLS + k] = src[(long long)clampi(pos0 + s - g.radius, 0, g.n - 1) * g.inner];
}

// a run's window in the staged tile: value s is staged row s0 + s of column k
struct BlurSharedWindow {
    const float* sm;
    int s0, k;
    F3D_HD float operator()(int s) const { return sm[(s0 + s) * F3D_BLUR_COLS + k]; }
};

// a run's window in device memory: value s is the column's edge-clamped
// position a0 + s
struct BlurDeviceWindow {
    const float* src;
    int a0, n, inner;
    F3D_HD float operator()(int s) const {
        return src[(long long)clampi(a0 + s, 0, n - 1) * inner];
    }
};

// one tap of a run: the window's newest value loaded, the M products added
template <int M, class Window>
F3D_HD void blur_tap(const Window& w, float t, int i, float* win, float* acc) {
    win[M - 1] = w(i + M - 1);
#pragma unroll
    for (int j = 0; j < M; ++j) acc[j] = acc[j] + t * win[j];
#pragma unroll
    for (int j = 0; j + 1 < M; ++j) win[j] = win[j + 1];
}

// M consecutive outputs of one column: acc[j] = sum over i of taps[i] * w(i + j)
template <int M, class Window>
F3D_HD void blur_run(const Window& w, const float* taps, int radius, float* acc) {
    float win[M];
#pragma unroll
    for (int j = 0; j + 1 < M; ++j) win[j] = w(j);
#pragma unroll
    for (int j = 0; j < M; ++j) acc[j] = 0.0f;
    const int n_taps = 2 * radius + 1;
    int i = 0;
    for (; i + M <= n_taps; i += M) {
#pragma unroll
        for (int u = 0; u < M; ++u) blur_tap<M>(w, taps[i + u], i + u, win, acc);
    }
    for (; i < n_taps; ++i) blur_tap<M>(w, taps[i], i, win, acc);
}

// thread t's runs in its tile: column t % COLS, the runs of M positions
// starting at staged row (warp * runs + m) * M, m = 0 .. runs - 1
constexpr int kBlurRuns = F3D_BLUR_SPAN / (F3D_BLUR_THREADS / F3D_BLUR_COLS) / F3D_BLUR_M;

F3D_HD int blur_run_start(int t, int m) {
    return ((t / F3D_BLUR_COLS) * kBlurRuns + m) * F3D_BLUR_M;
}

// run m of thread t (its column's first element at `base`) in the tile at
// pos0, its window staged in `sm` (kShared) or read from device memory;
// false where the run starts past the axis (acc unset)
template <bool kShared>
F3D_HD bool blur_thread_acc(const BlurGeom& g, long long base, const float* sm, const float* taps,
                            int pos0, int t, int m, float* acc) {
    const int k = t % F3D_BLUR_COLS, s0 = blur_run_start(t, m);
    if (pos0 + s0 >= g.n) return false;
    if (kShared)
        blur_run<F3D_BLUR_M>(BlurSharedWindow{sm, s0, k}, taps, g.radius, acc);
    else
        blur_run<F3D_BLUR_M>(BlurDeviceWindow{g.in + base, pos0 + s0 - g.radius, g.n, g.inner},
                             taps, g.radius, acc);
    return true;
}

// the store of run m of thread t: its outputs inside the tensor
F3D_HD void blur_store_run(const BlurGeom& g, long long base, long long col0, int pos0, int t,
                           int m, const float* acc) {
    const int s0 = blur_run_start(t, m);
    if (col0 + t % F3D_BLUR_COLS >= g.cols) return;
#pragma unroll
    for (int j = 0; j < F3D_BLUR_M; ++j)
        if (pos0 + s0 + j < g.n) g.out[base + (long long)(pos0 + s0 + j) * g.inner] = acc[j];
}

// The pointwise stages of the chain, one thread per pixel (all channels).
enum {
    F3D_PP_BRIGHT = 0,  // bloom's brightpass (post.py:65-68); 3 channels
    F3D_PP_BLOOM,       // bloom's composite color + i * (0.65 b1 + 0.35 b2) (70-72)
    F3D_PP_DOF,         // depth_of_field's CoC and its two mixes (82-92)
    F3D_PP_VIGNETTE,    // vignette (189-196)
    F3D_PP_SHARPEN      // sharpen's unsharp composite (203)
};

// Mode parameters, float32 values formed on the host as JAX forms them:
//   BRIGHT   p0 threshold, p1 max(threshold, 1e-4)
//   BLOOM    p0 intensity
//   DOF      p0 focus, p1 max(range, 1e-4), p2 max_coc, p3 max(max_coc, 1e-4),
//            p4 near_blur (1 or 0)
//   VIGNETTE p0 strength, p1 radius, p2 max(1 - radius, 1e-4), p3 sqrt(2)
//   SHARPEN  p0 amount
struct PointParams {
    float p0, p1, p2, p3, p4, p5;
};

F3D_HD void post_point_pixel(int mode, int height, int width, int channels, const float* a,
                             const float* b, const float* c, const float* d, float* out,
                             const PointParams& q, int i) {
    const int C = channels;
    switch (mode) {
        case F3D_PP_BRIGHT: {
            const float* px = a + 3 * i;
            float lum = 0.2126f * px[0] + 0.7152f * px[1] + 0.0722f * px[2];
            float knee = fmaxf((lum - q.p0) / q.p1, 0.0f);
            float s = knee / fmaxf(lum, 1e-4f);
            for (int k = 0; k < 3; ++k) out[3 * i + k] = px[k] * s;
            break;
        }
        case F3D_PP_BLOOM:
            for (int k = 0; k < C; ++k) {
                float blurred = 0.65f * b[C * i + k] + 0.35f * c[C * i + k];
                out[C * i + k] = a[C * i + k] + q.p0 * blurred;
            }
            break;
        case F3D_PP_DOF: {
            float dep = b[i];
            float coc = fabsf(dep - q.p0) / q.p1;
            if (q.p4 == 0.0f && dep < q.p0) coc = 0.0f;
            coc = fminf(fmaxf(coc, 0.0f), 1.0f) * q.p2;
            float t = coc / q.p3;
            float sharp = fminf(fmaxf(t * 2.0f, 0.0f), 1.0f);
            float blur = fminf(fmaxf(t * 2.0f - 1.0f, 0.0f), 1.0f);
            for (int k = 0; k < C; ++k) {
                out[C * i + k] = (a[C * i + k] * (1.0f - sharp) + c[C * i + k] * sharp)
                                 * (1.0f - blur) + d[C * i + k] * blur;
            }
            break;
        }
        case F3D_PP_VIGNETTE: {
            const int y = i / width, x = i % width;
            float yy = ((float)y / (float)(height - 1) - 0.5f) * 2.0f;
            float xx = ((float)x / (float)(width - 1) - 0.5f) * 2.0f;
            float r = sqrtf(yy * yy + xx * xx) / q.p3;
            float fall = fminf(fmaxf((r - q.p1) / q.p2, 0.0f), 1.0f);
            float s = 1.0f - q.p0 * fall * fall;
            for (int k = 0; k < C; ++k) out[C * i + k] = a[C * i + k] * s;
            break;
        }
        default:  // F3D_PP_SHARPEN
            for (int k = 0; k < C; ++k) {
                float v = a[C * i + k];
                out[C * i + k] = fmaxf(v + q.p0 * (v - b[C * i + k]), 0.0f);
            }
    }
}

// post.py:ssr (164-186) for pixel i: march up the column `max_steps` times
// by `stride` rows, the rows wrapping as jnp.roll wraps them; the first
// closer depth wins, then the strength from the upward normal and the fade
// from the top edge. `nc` 3: normal is (H, W, 3) and its y is clipped to
// [0, 1]; 1: normal is the (H, W) strength itself.
F3D_HD void ssr_pixel(const float* color, const float* depth, const float* normal, int nc,
                      int height, int width, int stride, int max_steps, float intensity,
                      float fade_den, float* out, int i) {
    const int y = i / width, x = i % width;
    const float d0 = depth[i];
    bool found = false;
    float best[3] = {0.0f, 0.0f, 0.0f};
    for (int step = 1; step <= max_steps && !found; ++step) {
        int sy = (y - step * stride) % height;
        if (sy < 0) sy += height;
        const int j = sy * width + x;
        if (depth[j] < d0) {
            for (int k = 0; k < 3; ++k) best[k] = color[3 * j + k];
            found = true;
        }
    }
    float up = nc == 3 ? fminf(fmaxf(normal[3 * i + 1], 0.0f), 1.0f) : normal[i];
    float fade = fminf(fmaxf((float)y / fade_den, 0.0f), 1.0f);
    float strength = intensity * up * (found ? 1.0f : 0.0f) * fade;
    for (int k = 0; k < 3; ++k)
        out[3 * i + k] = color[3 * i + k] * (1.0f - strength) + best[k] * strength;
}

// post.py:taa_resolve (113-126) for pixel i: the history clipped to the
// min and max of the 3x3 neighbourhood (rows and columns wrapping, as
// jnp.roll does), then the exponential blend.
F3D_HD void taa_pixel(const float* cur, const float* hist, float* out, int height, int width,
                      int channels, float blend, float one_minus_blend, int clamp, int i) {
    const int y = i / width, x = i % width;
    for (int k = 0; k < channels; ++k) {
        float h = hist[channels * i + k];
        if (clamp) {
            float lo = INFINITY, hi = -INFINITY;
            for (int dy = -1; dy <= 1; ++dy) {
                int sy = y - dy;
                sy = sy < 0 ? sy + height : (sy >= height ? sy - height : sy);
                for (int dx = -1; dx <= 1; ++dx) {
                    int sx = x - dx;
                    sx = sx < 0 ? sx + width : (sx >= width ? sx - width : sx);
                    float v = cur[channels * (sy * width + sx) + k];
                    lo = fminf(lo, v);
                    hi = fmaxf(hi, v);
                }
            }
            h = fminf(fmaxf(h, lo), hi);
        }
        out[channels * i + k] = blend * cur[channels * i + k] + one_minus_blend * h;
    }
}

// post.py:ssao (129-161) for pixel i: the spiral taps (dy, dx) from the
// host's table, each reading the edge-clamped neighbour; `rden` is
// float32(radius * 0.25 + 1e-4). `nc` as in ssr_pixel (the facing term
// reads normal z, or the (H, W) plane itself).
F3D_HD float ssao_pixel(const float* depth, const float* normal, int nc, const int* offsets,
                        int n_samples, int height, int width, float bias, float rden,
                        float intensity, int i) {
    const int y = i / width, x = i % width;
    const float d0 = depth[i];
    float occl = 0.0f;
    for (int s = 0; s < n_samples; ++s) {
        const int sy = clampi(y + offsets[2 * s], 0, height - 1);
        const int sx = clampi(x + offsets[2 * s + 1], 0, width - 1);
        float delta = d0 - depth[sy * width + sx] - bias;
        float w = fminf(fmaxf(1.0f - fabsf(delta) / rden, 0.0f), 1.0f);
        occl = occl + (delta > 0.0f ? w : 0.0f);
    }
    float ao = 1.0f - intensity * occl / (float)n_samples;
    float facing = fminf(fmaxf(nc == 3 ? normal[3 * i + 2] : normal[i], 0.0f), 1.0f);
    return fminf(fmaxf(ao * (0.75f + 0.25f * facing), 0.0f), 1.0f);
}

// One rect light of post.py:rect_area_light (206-239), float32 values formed
// on the host as JAX forms them: the centre, right and up axes, the
// half-extents, the area 4 hx hy, the Blinn-Phong exponent shin and its
// normalisation (shin + 2) / (2 pi), the colour and the intensity.
#define F3D_RECT_FLOATS 18
struct RectLight {
    float c[3], r[3], u[3], hx, hy, area, shin, spec_k, color[3], intensity;
};

#ifndef F3D_PI_F
#define F3D_PI_F 3.14159265358979323846f  // float32(pi)
#endif

// jnp.linalg.norm of a 3-vector: XLA's jitted norm fuses the squares into
// its sum as fma(x2, x2, fma(x1, x1, x0 * x0)). (A jnp.sum over the last
// axis, eager, is (x0 + x1) + x2.)
F3D_HD float xla_norm3(const float* x) {
    return sqrtf(fmaf(x[2], x[2], fmaf(x[1], x[1], x[0] * x[0])));
}

// The representative-point light at point p with normal n and view v
// (each float[3]), added into acc[3].
F3D_HD void rect_light_add(const RectLight& L, const float* p, const float* n, const float* v,
                           float* acc) {
    float nt[3], nu[3];
    for (int k = 0; k < 3; ++k) {
        float neg = -(L.c[k] - p[k]);
        nt[k] = neg * L.r[k];
        nu[k] = neg * L.u[k];
    }
    float s = fminf(fmaxf(nt[0] + nt[1] + nt[2], -L.hx), L.hx);
    float t = fminf(fmaxf(nu[0] + nu[1] + nu[2], -L.hy), L.hy);
    float Lv[3];
    for (int k = 0; k < 3; ++k) Lv[k] = L.c[k] + s * L.r[k] + t * L.u[k] - p[k];
    float dist = xla_norm3(Lv);
    float dm = fmaxf(dist, 1e-6f);
    float Ld[3] = {Lv[0] / dm, Lv[1] / dm, Lv[2] / dm};
    float ndl = fminf(fmaxf(n[0] * Ld[0] + n[1] * Ld[1] + n[2] * Ld[2], 0.0f), 1.0f);
    float omega = L.area / fmaxf(dist * dist, 1e-4f);
    float diffuse = ndl * fminf(omega, F3D_PI_F) / F3D_PI_F;
    float h[3] = {Ld[0] + v[0], Ld[1] + v[1], Ld[2] + v[2]};
    float hn = fmaxf(xla_norm3(h), 1e-6f);
    for (int k = 0; k < 3; ++k) h[k] = h[k] / hn;
    float ndh = fminf(fmaxf(n[0] * h[0] + n[1] * h[1] + n[2] * h[2], 0.0f), 1.0f);
    float spec = L.spec_k * powf(ndh, L.shin) * fminf(omega, 1.0f) * ndl;
    for (int k = 0; k < 3; ++k) acc[k] = acc[k] + (diffuse + spec) * L.color[k] * L.intensity;
}

// Every light of the list at point i, summed in list order from zero (the
// Scene's `add = add + rect_area_light(...)`, scene.py:299-305).
F3D_HD void rect_lights_point(const float* p, const float* n, const float* v,
                              const RectLight* lights, int n_lights, float* out, int i) {
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int l = 0; l < n_lights; ++l)
        rect_light_add(lights[l], p + 3 * i, n + 3 * i, v + 3 * i, acc);
    for (int k = 0; k < 3; ++k) out[3 * i + k] = acc[k];
}
