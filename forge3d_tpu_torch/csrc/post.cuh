// forge3d_tpu_torch/csrc/post.cuh
// Per-element device code of the post passes: one guided 5x5 a-trous
// iteration in lattice tiles (kernel E3, forge3d_tpu/ops/denoise.py:
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

// E3 in lattice tiles (post.cu:atrous_kernel). A pass at tap spacing s
// splits the image into its sub-lattices, (x, y) = (a + u s, b + v s) for
// a, b < s, on each of which the 25 taps (ky, kx) of atrous_denoise, read
// at the edge-clamped pixel (y - ky s, x - kx s) as denoise.py:_shift2d
// does, form a dense 5x5 stencil of slots: tap (ky, kx) of slot (u, v) is
// slot (u - kx, v - ky). A CTA takes a tile of F3D_ATROUS_TX x
// F3D_ATROUS_TY slots of one sub-lattice and
// 1. stages the tile and a halo of 2 slots in shared memory, each slot the
//    pixel (clampi(a + u s), clampi(b + v s)) that the taps read there (a
//    halo slot may hold the edge's pixel, or one of another sub-lattice):
//    its colour and each guide present, as up to three 16-byte quads;
// 2. forms each pair's weight once. A tap's weight kw(o) exp(-d_c / k_c)
//    exp(-d_a / k_a) exp(-d_n / k_n) exp(-d_d / k_d) depends only on the
//    two slots' values and on kw, and it is the same for the pair (i, j) at
//    offset o as for (j, i) at -o: (a - b)^2 = (b - a)^2 exactly in IEEE,
//    each squared distance adds its channels in one order, kw(o) = kw(-o),
//    and the factors multiply in one order. So for each of the 12 forward
//    offsets o (oy > 0, or oy = 0 and ox > 0) it forms W_o(Q), the weight
//    of the pair (Q, Q - o), over the slots Q of the tile and of the tile
//    shifted by o, the CTA's threads taking the 12 boxes' entries in turn;
// 3. adds each tile pixel P's 25 taps in (ky, kx) order as atrous does:
//    the forward tap o takes W_o(P), the backward tap -o takes W_o(P + o),
//    and the centre's weight is formed in place (so a NaN or inf pixel
//    keeps its NaN weight); then the division. Every sum keeps its order,
//    so each output is the per-pixel form's bit for bit.
// A 32x12 tile forms 13.8 weights a pixel (5,286 for 384 pixels) where the
// per-pixel form formed 25: the exponentials and IEEE divisions set E3's
// issue rate (PERF.md: the parent ran 88% arithmetic).
#define F3D_ATROUS_TX 32
#define F3D_ATROUS_TY 12
#define F3D_ATROUS_THREADS 256

constexpr int kAtrousSX = F3D_ATROUS_TX + 4;   // staged slots a row
constexpr int kAtrousSlots = kAtrousSX * (F3D_ATROUS_TY + 4);

// forward offset o (0..11): (oy, ox) = (0, 1), (0, 2), (1, -2..2), (2, -2..2)
F3D_HD constexpr int atrous_oy(int o) { return o < 2 ? 0 : (o < 7 ? 1 : 2); }
F3D_HD constexpr int atrous_ox(int o) { return o < 2 ? o + 1 : (o < 7 ? o - 4 : o - 9); }
F3D_HD constexpr int atrous_o(int oy, int ox) { return oy == 0 ? ox - 1 : (oy == 1 ? ox + 4 : ox + 9); }
// W_o's rows: u from atrous_u0(o), atrous_len(o) slots, v from 0, atrous_rows(o) rows
F3D_HD constexpr int atrous_u0(int o) { return atrous_ox(o) < 0 ? atrous_ox(o) : 0; }
F3D_HD constexpr int atrous_len(int o) {
    return F3D_ATROUS_TX + (atrous_ox(o) < 0 ? -atrous_ox(o) : atrous_ox(o));
}
F3D_HD constexpr int atrous_rows(int o) { return F3D_ATROUS_TY + atrous_oy(o); }
F3D_HD constexpr int atrous_woff(int o) {
    int n = 0;
    for (int p = 0; p < o; ++p) n += atrous_len(p) * atrous_rows(p);
    return n;
}
constexpr int kAtrousWeights = atrous_woff(12);

// the 1-D kernel's taps, exact in float32
F3D_HD float atrous_k1(int k) {
    return k == 0 ? 3.0f / 8.0f : (k == 1 || k == -1 ? 1.0f / 4.0f : 1.0f / 16.0f);
}

// A staged slot is up to three 16-byte quads, each in a plane of its own so
// that a warp reads a quad a lane without bank conflicts: (colour, depth),
// then where a guide needs them (albedo, normal x), (normal y, z, -, -). A
// slot's colour and depth are one 128-bit load.
struct alignas(16) AtrousQuad {
    float v[4];
};

// the quads a slot takes: 1, 3 with albedo or normal
F3D_HD int atrous_quads(const AtrousArgs& a) { return a.albedo || a.normal ? 3 : 1; }

// a tile's shared memory with `quads` quads a slot
F3D_HD constexpr long long atrous_shared_bytes(int quads) {
    return (long long)sizeof(AtrousQuad) * quads * kAtrousSlots
           + (long long)sizeof(float) * kAtrousWeights;
}
static_assert(atrous_shared_bytes(3) <= 48 * 1024,
              "E3's tile must fit the 48 KB a launch takes without opting in");

// a pass's CTAs: the min(s, W) x min(s, H) sub-lattices that hold pixels,
// each in tiles of the largest one's size
F3D_HD long long atrous_tiles(const AtrousArgs& a, int s) {
    const int nu = (a.width + s - 1) / s, nv = (a.height + s - 1) / s;
    return (long long)(s < a.width ? s : a.width) * (s < a.height ? s : a.height)
           * ((nu + F3D_ATROUS_TX - 1) / F3D_ATROUS_TX) * ((nv + F3D_ATROUS_TY - 1) / F3D_ATROUS_TY);
}

// One CTA's tile: its staged quads (slots, row by row; q[1], q[2] null
// where no guide needs them) and its weights in shared memory; which
// guides are present; the sub-lattice (a, b), its slots (nu, nv) and the
// tile's first slot (u0, v0).
struct AtrousTile {
    AtrousQuad* q[3];
    float* w;
    bool alb, nrm, dep;
    int s, a, b, nu, nv, u0, v0;
    F3D_HD bool empty() const { return u0 >= nu || v0 >= nv; }
};

// tile `blk` of a pass at spacing s (the sub-lattices fastest), over the
// shared memory sm (16-byte aligned)
F3D_HD AtrousTile atrous_tile(const AtrousArgs& args, void* sm, int s, long long blk) {
    AtrousTile t;
    const int sa = s < args.width ? s : args.width, sb = s < args.height ? s : args.height;
    const int tiles_u = ((args.width + s - 1) / s + F3D_ATROUS_TX - 1) / F3D_ATROUS_TX;
    t.s = s;
    t.a = (int)(blk % sa);
    blk /= sa;
    t.b = (int)(blk % sb);
    blk /= sb;
    t.u0 = (int)(blk % tiles_u) * F3D_ATROUS_TX;
    t.v0 = (int)(blk / tiles_u) * F3D_ATROUS_TY;
    t.nu = (args.width - t.a + s - 1) / s;
    t.nv = (args.height - t.b + s - 1) / s;
    t.alb = args.albedo != nullptr;
    t.nrm = args.normal != nullptr;
    t.dep = args.depth != nullptr;
    AtrousQuad* q = static_cast<AtrousQuad*>(sm);
    const int nq = atrous_quads(args);
    for (int k = 0; k < 3; ++k) t.q[k] = k < nq ? q + k * kAtrousSlots : nullptr;
    t.w = reinterpret_cast<float*>(q + nq * kAtrousSlots);
    return t;
}

// stage slot e (row-major over the tile and its halo)
F3D_HD void atrous_stage(const AtrousArgs& args, const AtrousTile& t, const float* in, int e) {
#ifdef F3D_E3_SELF_TAPS   // measurement build: every slot the tile's first (no scattered reads)
    const int u = t.u0, v = t.v0;
#else
    const int u = t.u0 + e % kAtrousSX - 2, v = t.v0 + e / kAtrousSX - 2;
#endif
    const long long j = (long long)clampi(t.b + v * t.s, 0, args.height - 1) * args.width
                        + clampi(t.a + u * t.s, 0, args.width - 1);
    t.q[0][e] = AtrousQuad{{in[3 * j], in[3 * j + 1], in[3 * j + 2],
                            t.dep ? args.depth[j] : 0.0f}};
    if (t.q[1]) {
        float a[3] = {0.0f, 0.0f, 0.0f}, n[3] = {0.0f, 0.0f, 0.0f};
        for (int c = 0; c < 3; ++c) {
            if (t.alb) a[c] = args.albedo[3 * j + c];
            if (t.nrm) n[c] = args.normal[3 * j + c];
        }
        t.q[1][e] = AtrousQuad{{a[0], a[1], a[2], n[0]}};
        t.q[2][e] = AtrousQuad{{n[1], n[2], 0.0f, 0.0f}};
    }
}

// one factor exp(-d / k) of a weight
F3D_HD float atrous_term(float d, float k) {
#ifdef F3D_E3_CONST_EXP   // measurement build: each factor a constant (what the arithmetic costs)
    return 0.5f;
#else
    return expf(-d / k);
#endif
}

// a staged slot's values
struct AtrousSlot {
    AtrousQuad q0, q1, q2;   // (c, d), (a, n x), (n y, n z)
};

F3D_HD AtrousSlot atrous_slot(const AtrousTile& t, int i) {
    AtrousSlot v;
    v.q0 = t.q[0][i];
    if (t.q[1]) {
        v.q1 = t.q[1][i];
        v.q2 = t.q[2][i];
    }
    return v;
}

// sq_dist3 of two slots' three channels: (p_j - p_i)^2 added in channel order
F3D_HD float atrous_sq3(float i0, float i1, float i2, float j0, float j1, float j2) {
    const float d0 = j0 - i0;
    const float d1 = j1 - i1;
    const float d2 = j2 - i2;
    return d0 * d0 + d1 * d1 + d2 * d2;
}

// the weight of tap slot j for centre slot i, kw times the four factors in
// atrous's order
F3D_HD float atrous_weight(const AtrousArgs& args, const AtrousTile& t, float kw,
                           const AtrousSlot& i, const AtrousSlot& j) {
    float w = kw;
    w = w * atrous_term(atrous_sq3(i.q0.v[0], i.q0.v[1], i.q0.v[2], j.q0.v[0], j.q0.v[1],
                                   j.q0.v[2]),
                        args.k_color);
    if (t.alb)
        w = w * atrous_term(atrous_sq3(i.q1.v[0], i.q1.v[1], i.q1.v[2], j.q1.v[0], j.q1.v[1],
                                       j.q1.v[2]),
                            args.k_albedo);
    if (t.nrm)
        w = w * atrous_term(atrous_sq3(i.q1.v[3], i.q2.v[0], i.q2.v[1], j.q1.v[3], j.q2.v[0],
                                       j.q2.v[1]),
                            args.k_normal);
    if (t.dep) {
        const float dd = j.q0.v[3] - i.q0.v[3];
        w = w * atrous_term(dd * dd, args.k_depth);
    }
    return w;
}

// the weights W_0, W_1, ... W_11 one after the other, each row-major over
// its box (atrous_len(o) x atrous_rows(o) slots from (atrous_u0(o), 0)):
// entries first, first + step, ... (a CTA's threads take them in turn); an
// offset's constants are formed once, where a thread's entries reach it
F3D_HD void atrous_weights(const AtrousArgs& args, const AtrousTile& t, int first, int step) {
    int o = -1, off = 0, end = 0, len = 1, u0 = 0, back = 0;
    float rlen = 1.0f, kw = 0.0f;
    for (int e = first; e < kAtrousWeights; e += step) {
        while (e >= end) {
            ++o;
            off = end;
            len = atrous_len(o);
            end += len * atrous_rows(o);
            rlen = 1.0f / (float)len;
            u0 = atrous_u0(o) + 2;
            back = atrous_oy(o) * kAtrousSX + atrous_ox(o);
            kw = atrous_k1(atrous_oy(o)) * atrous_k1(atrous_ox(o));
        }
        // the row: exact, as (e - off + 0.5) / len lies at least 0.5 / 34 from an integer
        const int v = (int)(((float)(e - off) + 0.5f) * rlen);
        const int q = (v + 2) * kAtrousSX + u0 + (e - off) - v * len;
        t.w[e] = atrous_weight(args, t, kw, atrous_slot(t, q), atrous_slot(t, q - back));
    }
}

// tile pixel e (row-major over the tile): its 25 taps, then its output
F3D_HD void atrous_output(const AtrousArgs& args, const AtrousTile& t, float* out, int e) {
    const int u = e % F3D_ATROUS_TX, v = e / F3D_ATROUS_TX;
    if (t.u0 + u >= t.nu || t.v0 + v >= t.nv) return;
    const int pi = (v + 2) * kAtrousSX + u + 2;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, wacc = 0.0f;
#pragma unroll
    for (int ky = -2; ky <= 2; ++ky) {
#pragma unroll
        for (int kx = -2; kx <= 2; ++kx) {
            const int j = pi - ky * kAtrousSX - kx;
            float w;
            if (ky == 0 && kx == 0) {
                const AtrousSlot own = atrous_slot(t, pi);
                w = atrous_weight(args, t, atrous_k1(0) * atrous_k1(0), own, own);
            } else if (ky > 0 || (ky == 0 && kx > 0)) {
                const int o = atrous_o(ky, kx);
                w = t.w[atrous_woff(o) + v * atrous_len(o) + u - atrous_u0(o)];
            } else {
                const int o = atrous_o(-ky, -kx);
                w = t.w[atrous_woff(o) + (v - ky) * atrous_len(o) + u - kx - atrous_u0(o)];
            }
            const AtrousQuad cj = t.q[0][j];
            acc0 = acc0 + cj.v[0] * w;
            acc1 = acc1 + cj.v[1] * w;
            acc2 = acc2 + cj.v[2] * w;
            wacc = wacc + w;
        }
    }
    const long long i = (long long)(t.b + (t.v0 + v) * t.s) * args.width + t.a + (t.u0 + u) * t.s;
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
