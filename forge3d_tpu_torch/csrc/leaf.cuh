// forge3d_tpu_torch/csrc/leaf.cuh
// Per-element device code of the JAX package's leaf modules, the last
// kernels that need no subsystem of their own:
// - E9, double-float arithmetic (forge3d_tpu/precision.py: two_sum 42,
//   _split 50, two_prod 58, dd_add 79, dd_mul 86, dd_div 93, dd_sqrt 104);
// - E5 Preetham, the Perez/Preetham sky radiance toward one direction
//   (forge3d_tpu/sky.py: _perez 94, sky_radiance 101);
// - E6, the diffuse irradiance of a light list at one point
//   (forge3d_tpu/lighting.py: eval_lights 102);
// - E7, the path-guiding cache (forge3d_tpu/guiding.py: octa_encode 26,
//   octa_decode 43, GuidingCache._cell_of 75, record 82, sample 92).
// Float32, in the JAX functions' operation order, so that leaf.cu agrees
// with the plain PyTorch versions in precision.py, sky.py, lighting.py and
// guiding.py.
//
// None of these JAX functions is jitted: XLA rounds each jnp operation on
// its own, and the bodies below do the same (the build keeps -fmad=false,
// so nothing is contracted into a fused multiply-add; division and sqrtf
// are IEEE). The exceptions are XLA's own orders, written out here:
// - jnp.sum over a last axis of B elements: sequential when B <= 32, else
//   windows of 32 (zero-padded evenly at both ends), each summed
//   sequentially, then the window sums reduced by the same rule;
// - jnp.cumsum over B elements: sequential when B <= 16, else blocks of 16
//   (zero-padded at the end), a sequential prefix inside each block, plus
//   the exclusive prefix of the block totals, which are cumsummed by the
//   same rule;
// - jnp.linalg.norm is jitted: its squares are fused into the sum.

#pragma once

#include <math.h>

#ifndef F3D_HD
#ifdef __CUDACC__
#define F3D_HD __host__ __device__ __forceinline__
#else
#define F3D_HD inline
#endif
#endif

// ---------------------------------------------------------------------------
// E9: double-float (hi, lo) arithmetic. Error-free transformations: every
// product and sum rounded on its own, in the order written.

enum { F3D_DD_ADD = 0, F3D_DD_MUL = 1, F3D_DD_DIV = 2, F3D_DD_SQRT = 3 };

// Knuth two-sum: s + e == a + b exactly
F3D_HD void dd_two_sum(float a, float b, float& s, float& e) {
    s = a + b;
    const float bb = s - a;
    e = (a - (s - bb)) + (b - bb);
}

// Dekker split by 2^12 + 1
F3D_HD void dd_split(float a, float& hi, float& lo) {
    const float c = 4097.0f * a;
    hi = c - (c - a);
    lo = a - hi;
}

// Dekker two-product: p + e == a b exactly (barring overflow), no FMA
F3D_HD void dd_two_prod(float a, float b, float& p, float& e) {
    p = a * b;
    float ah, al, bh, bl;
    dd_split(a, ah, al);
    dd_split(b, bh, bl);
    e = (((ah * bh - p) + ah * bl) + al * bh) + al * bl;
}

// one DD op on element (ahi, alo) [op] (bhi, blo); sqrt ignores b
F3D_HD void dd_op(int op, float ahi, float alo, float bhi, float blo, float& hi, float& lo) {
    float s, e;
    if (op == F3D_DD_ADD) {
        dd_two_sum(ahi, bhi, s, e);
        e = e + (alo + blo);
        dd_two_sum(s, e, hi, lo);
    } else if (op == F3D_DD_MUL) {
        dd_two_prod(ahi, bhi, s, e);
        e = e + (ahi * blo + alo * bhi);
        dd_two_sum(s, e, hi, lo);
    } else if (op == F3D_DD_DIV) {
        const float q1 = ahi / bhi;
        float p, pe, r_hi, r_e;
        dd_two_prod(q1, bhi, p, pe);
        dd_two_sum(ahi, -p, r_hi, r_e);
        const float r = r_hi + (((r_e + alo) - pe) - q1 * blo);
        const float q2 = r / bhi;
        dd_two_sum(q1, q2, hi, lo);
    } else {
        // sqrt of a negative hi is NaN, NaN > 0 is false: (0, 0), as JAX
        const float q1 = sqrtf(ahi);
        const bool safe = q1 > 0.0f;
        const float q1s = safe ? q1 : 1.0f;
        float p, pe, r_hi, r_e;
        dd_two_prod(q1s, q1s, p, pe);
        dd_two_sum(ahi, -p, r_hi, r_e);
        const float r = r_hi + ((r_e + alo) - pe);
        const float q2 = r / (2.0f * q1s);
        dd_two_sum(q1s, q2, hi, lo);
        if (!safe) {
            hi = 0.0f;
            lo = 0.0f;
        }
    }
}

// ---------------------------------------------------------------------------
// E5 Preetham: sky.py:sky_radiance for one direction.

// Mirrored by PreethamArgs in _kernels.py. `den` is the per-channel Perez
// value at the sun, max(., 1e-6), which JAX forms with eager float32 scalar
// operations; the host forms it once and both versions read it.
struct PreethamArgs {
    float sun[3];
    float perez[15];   // (Y, x, y) x (A, B, C, D, E)
    float zenith[3];   // Y, x, y
    float den[3];
    float exposure;
};

// _perez (94): the denominator's cos_theta clamps to 0.01
F3D_HD float preetham_perez(const float* c, float cos_theta, float gamma, float cos_gamma) {
    const float ct = fmaxf(cos_theta, 0.01f);
    return (1.0f + c[0] * expf(c[1] / ct))
           * ((1.0f + c[2] * expf(c[3] * gamma)) + (c[4] * cos_gamma) * cos_gamma);
}

F3D_HD void preetham_texel(const PreethamArgs& s, float dx, float dy, float dz, float* r,
                           float* g, float* b) {
    const float dyc = fmaxf(dy, 0.0f);
    const float norm = sqrtf((dx * dx + dyc * dyc) + dz * dz) + 1e-9f;
    const float vx = dx / norm, vy = dyc / norm, vz = dz / norm;
    const float cg = fminf(fmaxf((vx * s.sun[0] + vy * s.sun[1]) + vz * s.sun[2], -1.0f), 1.0f);
    const float gamma = acosf(cg);
    float ch[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)   // unrolled: constant offsets into the by-value args
        ch[c] = (s.zenith[c] * preetham_perez(s.perez + 5 * c, vy, gamma, cg)) / s.den[c];
    const float Y = ch[0], x = ch[1], y = ch[2];
    const float ys = fmaxf(y, 1e-4f);
    const float X = (x / ys) * Y;
    const float Z = (((1.0f - x) - y) / ys) * Y;
    const float rr = (3.2406f * X - 1.5372f * Y) - 0.4986f * Z;
    const float gg = (-0.9689f * X + 1.8758f * Y) + 0.0415f * Z;
    const float bb = (0.0557f * X - 0.2040f * Y) + 1.0570f * Z;
    *r = fmaxf(rr, 0.0f) * s.exposure;
    *g = fmaxf(gg, 0.0f) * s.exposure;
    *b = fmaxf(bb, 0.0f) * s.exposure;
}

// ---------------------------------------------------------------------------
// E6: lighting.py:eval_lights for one point, the lights in buffer order.

// One light as 16 floats (lighting.py:leaf_rows): type id, colour x
// intensity (3), direction (3), position (3), radius, extent (2), cos inner,
// cos outer, unused.
enum { F3D_LIGHT_FLOATS = 16 };
enum {
    F3D_LT_DIRECTIONAL = 0, F3D_LT_POINT = 1, F3D_LT_SPOT = 2, F3D_LT_RECT = 3, F3D_LT_DISK = 4,
    F3D_LT_SPHERE = 5
};

// p, n (count, 3); u (count, 2) or null; out (count, 3)
F3D_HD void eval_lights_point(const float* lights, int n_lights, const float* p, const float* n,
                              const float* u, float* out, long long i) {
    const float px = p[3 * i], py = p[3 * i + 1], pz = p[3 * i + 2];
    const float nx = n[3 * i], ny = n[3 * i + 1], nz = n[3 * i + 2];
    float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f;
    for (int l = 0; l < n_lights; ++l) {
        const float* q = lights + F3D_LIGHT_FLOATS * l;
        const int t = (int)q[0];
        if (t == F3D_LT_DIRECTIONAL) {
            const float ndl = fmaxf((nx * -q[4] + ny * -q[5]) + nz * -q[6], 0.0f);
            o0 = o0 + q[1] * ndl;
            o1 = o1 + q[2] * ndl;
            o2 = o2 + q[3] * ndl;
            continue;
        }
        float lx = q[7], ly = q[8], lz = q[9];
        if (u != nullptr && t >= F3D_LT_RECT) {
            const float u0 = u[2 * i], u1 = u[2 * i + 1];
            if (t == F3D_LT_RECT) {
                lx = lx + (u0 * 2.0f - 1.0f) * q[11];
                ly = ly + 0.0f;
                lz = lz + (u1 * 2.0f - 1.0f) * q[12];
            } else {
                const float ang = (u0 * 2.0f) * 3.14159265f;
                const float rr = sqrtf(u1) * q[10];
                lx = lx + rr * cosf(ang);
                ly = ly + 0.0f;
                lz = lz + rr * sinf(ang);
            }
        }
        const float tx = lx - px, ty = ly - py, tz = lz - pz;
        const float d2 = fmaxf((tx * tx + ty * ty) + tz * tz, 1e-6f);
        const float rs = 1.0f / sqrtf(d2);
        const float ldx = tx * rs, ldy = ty * rs, ldz = tz * rs;
        const float ndl = fmaxf((nx * ldx + ny * ldy) + nz * ldz, 0.0f);
        float atten = 1.0f / d2;
        if (t == F3D_LT_SPOT) {
            const float cd = (-ldx * q[4] + -ldy * q[5]) + -ldz * q[6];
            const float spot =
                fminf(fmaxf((cd - q[14]) / fmaxf(q[13] - q[14], 1e-6f), 0.0f), 1.0f);
            atten = (atten * spot) * spot;
        } else if (t == F3D_LT_SPHERE) {
            atten = atten * fminf(1.0f + (q[10] * q[10]) / d2, 4.0f);
        }
        const float w = ndl * atten;
        o0 = o0 + q[1] * w;
        o1 = o1 + q[2] * w;
        o2 = o2 + q[3] * w;
    }
    out[3 * i] = o0;
    out[3 * i + 1] = o1;
    out[3 * i + 2] = o2;
}

// ---------------------------------------------------------------------------
// E7: the guiding cache.

// Mirrored by GuideArgs in _kernels.py: the cache's float32 geometry.
struct GuideArgs {
    float ox, oz, ex, ez;   // origin and extent in x and z
    float cells_f;          // float32(cells)
    float ang_k;            // float32(2 pi / octa_res)
    int cells, res;
};

// XLA's float32 -> int32 conversion: toward zero, saturating, NaN -> 0
F3D_HD int leaf_to_int(float x) {
    if (!(x == x)) return 0;
    if (x >= 2147483647.0f) return 2147483647;
    if (x <= -2147483648.0f) return (int)(-2147483647 - 1);
    return (int)x;
}

F3D_HD int leaf_clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// jnp.sign: NaN stays NaN, a zero keeps its sign
F3D_HD float leaf_sign(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x); }

// octa_encode (26): direction -> octahedral bin in [0, res^2)
F3D_HD int octa_encode_dir(float dx, float dy, float dz, int res) {
    const float nrm = (fabsf(dx) + fabsf(dy)) + fabsf(dz);
    const float u = dx / nrm, v = dz / nrm;
    const bool lower = dy < 0.0f;
    const float u2 = lower ? (1.0f - fabsf(v)) * leaf_sign(u) : u;
    const float v2 = lower ? (1.0f - fabsf(u)) * leaf_sign(v) : v;
    const int iu = leaf_clampi(leaf_to_int((u2 * 0.5f + 0.5f) * (float)res), 0, res - 1);
    const int iv = leaf_clampi(leaf_to_int((v2 * 0.5f + 0.5f) * (float)res), 0, res - 1);
    return iv * res + iu;
}

// octa_decode (43): bin centre -> unit direction (d[0], d[1], d[2])
F3D_HD void octa_decode_bin(int bin, int res, float* d) {
    const int iv = bin / res, iu = bin % res;
    const float u = (((float)iu + 0.5f) / (float)res) * 2.0f - 1.0f;
    const float v = (((float)iv + 0.5f) / (float)res) * 2.0f - 1.0f;
    const float y = (1.0f - fabsf(u)) - fabsf(v);
    const bool lower = y < 0.0f;
    const float u2 = lower ? (1.0f - fabsf(v)) * leaf_sign(u) : u;
    const float v2 = lower ? (1.0f - fabsf(u)) * leaf_sign(v) : v;
    const float nrm = sqrtf(fmaf(v2, v2, fmaf(y, y, u2 * u2)));
    d[0] = u2 / nrm;
    d[1] = y / nrm;
    d[2] = v2 / nrm;
}

// GuidingCache._cell_of (75)
F3D_HD int guide_cell(const GuideArgs& g, float px, float pz) {
    const int cx = leaf_clampi(leaf_to_int(((px - g.ox) / g.ex) * g.cells_f), 0, g.cells - 1);
    const int cz = leaf_clampi(leaf_to_int(((pz - g.oz) / g.ez) * g.cells_f), 0, g.cells - 1);
    return cz * g.cells + cx;
}

// record (82): a record's flat histogram index, cell * res^2 + bin
F3D_HD int guide_key(const GuideArgs& g, float px, float pz, float dx, float dy, float dz) {
    return guide_cell(g, px, pz) * (g.res * g.res) + octa_encode_dir(dx, dy, dz, g.res);
}

// record's scatter-add in record order, in two passes over the records
// sorted (stably) by key. Pass one, for sorted position s: the record's
// luminance into sorted order, and the bounds of its key's run of records
// [seg_start, seg_end) where s starts or ends one.
F3D_HD void guide_bounds(const int* keys, const long long* perm, const float* lum, long long n,
                         int* seg_start, int* seg_end, float* lum_sorted, long long s) {
    const int k = keys[s];
    lum_sorted[s] = lum[perm[s]];
    if (s == 0 || keys[s - 1] != k) seg_start[k] = (int)s;
    if (s == n - 1 || keys[s + 1] != k) seg_end[k] = (int)(s + 1);
}

// Pass two, for bin k: its old value plus its records' luminance in record
// order (an untouched bin has an empty run and keeps its value).
F3D_HD float guide_bin_sum(const int* seg_start, const int* seg_end, const float* lum_sorted,
                           const float* hist_in, long long k) {
    float acc = hist_in[k];
    const int b = seg_end[k];
    for (int t = seg_start[k]; t < b; ++t) acc = acc + lum_sorted[t];
    return acc;
}

// Pass two splits the bins: a run of more than `threshold` records is
// summed by a block of its own (leaf.cu:guide_long_kernel), which stages
// the run in chunks of S floats. Chunk i copies the floats from
// a0 + i * S, a0 = the run's start rounded down to 4 floats (16 bytes, the
// bulk copy's unit), the last chunk ending at the run's end rounded up to
// 4 floats (lum_sorted is padded to a multiple of 4). The sum is the same
// chain as guide_bin_sum's, in record order.
#define F3D_GUIDE_STAGE 1024   // S: floats a stage of a long run (4 KB)

F3D_HD bool guide_is_long(const int* seg_start, const int* seg_end, long long k,
                          int threshold) {
    return seg_end[k] - seg_start[k] > threshold;
}

F3D_HD int guide_chunk_count(int start, int end, int S) {
    const int a0 = start & ~3, a1 = (end + 3) & ~3;
    return (a1 - a0 + S - 1) / S;
}

// Chunk i of the run [start, end): returns the floats it copies (a multiple
// of 4) from lum_sorted + *src; [lo, hi) are the run's records in it, as
// offsets into the chunk.
F3D_HD int guide_chunk(int start, int end, int S, int i, int* src, int* lo, int* hi) {
    const int base = (start & ~3) + i * S, a1 = (end + 3) & ~3;
    *src = base;
    *lo = start > base ? start - base : 0;
    *hi = end - base < S ? end - base : S;
    return a1 - base < S ? a1 - base : S;
}

// Four records from a 16-byte-aligned address: one vector load on the card.
F3D_HD void guide_load4(const float* p, float& a, float& b, float& c, float& d) {
#ifdef __CUDA_ARCH__
    const float4 v = *reinterpret_cast<const float4*>(p);
    a = v.x, b = v.y, c = v.z, d = v.w;
#else
    a = p[0], b = p[1], c = p[2], d = p[3];
#endif
}

// acc plus stage[lo, hi) in record order, stage 16-byte aligned: to a
// 16-byte boundary, then four records a load (on the card the loads run
// ahead of the chain of adds), then the rest. guide_long_kernel's sum of a
// staged chunk, and the host twin's.
F3D_HD float guide_stage_sum(float acc, const float* stage, int lo, int hi) {
    int t = lo;
    for (; t < hi && (t & 3); ++t) acc = acc + stage[t];
#ifdef __CUDA_ARCH__
#pragma unroll 8
#endif
    for (int u = t >> 2; u < (hi >> 2); ++u) {
        float a, b, c, d;
        guide_load4(stage + 4 * u, a, b, c, d);
        acc = acc + a;
        acc = acc + b;
        acc = acc + c;
        acc = acc + d;
    }
    for (t = t > (hi & ~3) ? t : hi & ~3; t < hi; ++t) acc = acc + stage[t];
    return acc;
}

// sequential sum of row[lo, hi) from zero
F3D_HD float leaf_seq_sum(const float* row, int lo, int hi) {
    float acc = 0.0f;
    for (int j = lo; j < hi; ++j) acc = acc + row[j];
    return acc;
}

// jnp.sum(row, -1) over B elements, XLA's order (see the top of the file);
// two levels of windows cover B <= 32768
F3D_HD float xla_row_sum(const float* row, int B) {
    if (B <= 32) return leaf_seq_sum(row, 0, B);
    const int nw = (B + 31) / 32;
    const int lo = (nw * 32 - B) / 2;
    if (nw <= 32) {
        float acc = 0.0f;
        for (int w = 0; w < nw; ++w) {
            const int a = 32 * w - lo;
            acc = acc + leaf_seq_sum(row, a < 0 ? 0 : a, a + 32 > B ? B : a + 32);
        }
        return acc;
    }
    const int nw2 = (nw + 31) / 32;
    const int lo2 = (nw2 * 32 - nw) / 2;
    float acc2 = 0.0f;
    for (int w2 = 0; w2 < nw2; ++w2) {
        float acc = 0.0f;
        for (int k = 32 * w2 - lo2; k < 32 * w2 - lo2 + 32; ++k) {
            if (k < 0 || k >= nw) continue;
            const int a = 32 * k - lo;
            acc = acc + leaf_seq_sum(row, a < 0 ? 0 : a, a + 32 > B ? B : a + 32);
        }
        acc2 = acc2 + acc;
    }
    return acc2;
}

// the number of bins whose cdf, XLA's cumsum(row) / den, is below u:
// jnp.sum(cdf < u). The prefix of bin 16 b + j is the in-block prefix plus
// the exclusive prefix of the block totals; with more than 16 blocks the
// totals are themselves summed in groups of 16. Covers B <= 4096.
F3D_HD int xla_cdf_count(const float* row, int B, float den, float u) {
    const int nb = (B + 15) / 16;
    int count = 0;
    float ex = 0.0f;                  // exclusive prefix of this block
    float g_in = 0.0f, ex2 = 0.0f;    // more than 16 blocks: the groups' prefixes
    for (int b = 0; b < nb; ++b) {
        float acc = 0.0f;
        for (int j = 16 * b; j < 16 * b + 16 && j < B; ++j) {
            acc = acc + row[j];
            count += ((acc + ex) / den < u) ? 1 : 0;
        }
        if (nb <= 16) {
            ex = ex + acc;
        } else {
            if (b % 16 == 0) g_in = 0.0f;
            g_in = g_in + acc;
            ex = g_in + ex2;
            if (b % 16 == 15) ex2 = ex2 + g_in;
        }
    }
    return count;
}

// sample (92) for one query: (dx, dy, dz, pdf)
F3D_HD void guide_sample_query(const GuideArgs& g, const float* hist, float px, float pz,
                               float u1, float u2, float* out) {
    const int B = g.res * g.res;
    const float* row = hist + (long long)guide_cell(g, px, pz) * B;
    const float den = fmaxf(xla_row_sum(row, B), 1e-20f);
    const int bin = leaf_clampi(xla_cdf_count(row, B, den, u1), 0, B - 1);
    out[3] = ((row[bin] / den) * (float)B) / 12.5663706f;
    float d[3];
    octa_decode_bin(bin, g.res, d);
    const float ang = (u2 - 0.5f) * g.ang_k;
    const float ca = cosf(ang), sa = sinf(ang);
    out[0] = d[0] * ca - d[2] * sa;
    out[1] = d[1];
    out[2] = d[0] * sa + d[2] * ca;
}
