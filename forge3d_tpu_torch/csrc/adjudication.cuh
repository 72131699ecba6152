// forge3d_tpu_torch/csrc/adjudication.cuh
// Per-thread bodies of the AEQUITAS adjudication pair P4
// (forge3d_tpu/pt/adjudication.py): the raster twin `_raster_frame` (327,
// its scan over the 24 x 48 quadrature at 375) and the path-traced lane
// `_pt_sample` (382, its depth loop at 453) summed over the samples of
// render_adjudication_builtin (471-488), each followed by `_tonemap`.
// Launched by adjudication.cu.
//
// The scene is three spheres and a 40-unit ground quad; its constants,
// and the products of constants XLA folds at compile time, come from the
// host in AdjArgs (pt/adjudication.py:adj_constants), so both versions read
// the same float32 values. Dot products and norms are written as XLA
// reduces them (x*x rounded, then two multiply-adds); every other
// operation is rounded on its own (-fmad=false).
//
// The raster thread runs the 1,152 directions in JAX's scan order and adds
// each contribution to its own sum, so the sum rounds as JAX's does. The
// path thread hashes its pixel's row-major counter under the keys of each
// sample, depth and draw (threefry-2x32, the key table built on the host),
// sums its samples in order, and stops a path once it dies: every update
// of JAX's masked loop is masked by `alive`, so nothing after that changes.
// It runs as a hit loop (adj_pt_lane, below).

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

#define F3D_ADJ_PI 3.14159265358979f
#define F3D_ADJ_DEPTH 16   // adjudication.py:MAX_DEPTH
#define F3D_ADJ_RR 4       // RR_START_DEPTH
#define F3D_ADJ_KEYS 98    // keys per sample: 2 jitter + 16 depths x 6 draws
#define F3D_ADJ_QUAD 1152  // the quadrature's directions: ENV_QUAD_U x ENV_QUAD_V

struct AdjArgs {           // mirrored by _kernels.AdjArgs
    int width, height, spp, n_quad;
    float sph[12];         // (cx, cy, cz, r) per sphere
    float r2[3];           // r * r
    float alb[12];         // material albedo, slots 0-2 spheres, 3 the ground
    float rough[4];
    float sun_wi[3];       // unit vector toward the sun
    float li[3];           // SUN_INTENSITY * SUN_COLOR
    float amb[3], sky[3];
    float pe_sun[3];       // (albedo_3 / pi) * SUN_INTENSITY * SUN_COLOR * sun_wi.y
    float pe_amb[3];       // albedo_3 * AMBIENT * 0.43752
    float pe_sky[3];       // albedo_3 * SKY
    float pe_s[9];         // plane_exit_radiance below each sphere's centre
    float cam_o[3], right[3], up[3], fwd[3];
    float half_w, half_h, quad_w;  // quad_w = pi / 1152
};

struct V3 {
    float x, y, z;
};

F3D_HD V3 v3(float x, float y, float z) {
    V3 r;
    r.x = x;
    r.y = y;
    r.z = z;
    return r;
}
F3D_HD V3 vadd(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
F3D_HD V3 vsub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
F3D_HD V3 vmul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
F3D_HD V3 vscale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
F3D_HD V3 vld(const float* p) { return v3(p[0], p[1], p[2]); }
// jnp.sum(a * b, -1) as XLA reduces it
F3D_HD float adj_dot(V3 a, V3 b) { return fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)); }
// adjudication.py:_normalize: v / max(|v|, 1e-12)
F3D_HD V3 adj_normalize(V3 v) {
    float n = fmaxf(sqrtf(adj_dot(v, v)), 1e-12f);
    return v3(v.x / n, v.y / n, v.z / n);
}

// _nearest_hit: 3 spheres (t0, else t1) then the ground quad; kind -1 miss
F3D_HD int adj_nearest(const AdjArgs& a, V3 ro, V3 rd, float& tbest) {
    const float tmin = 1e-3f;
    tbest = 1e30f;
    int kind = -1;
    for (int i = 0; i < 3; ++i) {
        V3 oc = vsub(ro, vld(a.sph + 4 * i));
        float b = adj_dot(oc, rd);
        float disc = b * b - (adj_dot(oc, oc) - a.r2[i]);
        float sq = sqrtf(fmaxf(disc, 0.0f));
        float t0 = -b - sq, t1 = -b + sq;
        bool ok0 = disc > 0.0f && t0 > tmin && t0 < tbest;
        bool ok1 = disc > 0.0f && !ok0 && t1 > tmin && t1 < tbest;
        if (ok0 || ok1) {
            tbest = ok0 ? t0 : t1;
            kind = i;
        }
    }
    float denom = rd.y;
    float tp = -ro.y / (fabsf(denom) < 1e-7f ? 1e-7f : denom);
    float px = ro.x + tp * rd.x, pz = ro.z + tp * rd.z;
    if (fabsf(denom) > 1e-7f && tp > tmin && tp < tbest && fabsf(px) <= 40.0f &&
        fabsf(pz) <= 40.0f) {
        tbest = tp;
        kind = 3;
    }
    return kind;
}

// _occluded: any root of a sphere in (1e-3, 1e30), or the ground quad
F3D_HD bool adj_occluded(const AdjArgs& a, V3 ro, V3 rd) {
    const float tmin = 1e-3f, tmax = 1e30f;
    for (int i = 0; i < 3; ++i) {
        V3 oc = vsub(ro, vld(a.sph + 4 * i));
        float b = adj_dot(oc, rd);
        float disc = b * b - (adj_dot(oc, oc) - a.r2[i]);
        float sq = sqrtf(fmaxf(disc, 0.0f));
        float t0 = -b - sq, t1 = -b + sq;
        bool h0 = t0 > tmin && t0 < tmax, h1 = t1 > tmin && t1 < tmax;
        if (disc > 0.0f && (h0 || h1)) return true;
    }
    float denom = rd.y;
    float tp = -ro.y / (fabsf(denom) < 1e-7f ? 1e-7f : denom);
    float px = ro.x + tp * rd.x, pz = ro.z + tp * rd.z;
    return fabsf(denom) > 1e-7f && tp > tmin && tp < tmax && fabsf(px) <= 40.0f &&
           fabsf(pz) <= 40.0f;
}

// _surface: the normal (up for the ground) of a hit of `kind` at pos
F3D_HD V3 adj_normal(const AdjArgs& a, V3 pos, int kind) {
    if (kind >= 0 && kind < 3) return adj_normalize(vsub(pos, vld(a.sph + 4 * kind)));
    return v3(0.0f, 1.0f, 0.0f);
}

// _tangent_basis (branchless ONB)
F3D_HD void adj_basis(V3 n, V3& t, V3& bt) {
    float sign = n.z < 0.0f ? -1.0f : 1.0f;
    float a = -1.0f / (sign + n.z);
    float b = n.x * n.y * a;
    t = v3(1.0f + sign * (n.x * n.x) * a, sign * b, -sign * n.x);
    bt = v3(b, sign + (n.y * n.y) * a, -n.y);
}

// _to_world(n, x, y, z)
F3D_HD V3 adj_to_world(V3 n, float x, float y, float z) {
    V3 t, bt;
    adj_basis(n, t, bt);
    return adj_normalize(vadd(vadd(vscale(t, x), vscale(bt, y)), vscale(n, z)));
}

// _bsdf_eval_pdf's terms that depend on the view side alone (wo, n and the
// material): a raster pixel's escaped directions share them, so it forms
// them once, with the same operations as the whole evaluation
struct AdjView {
    V3 fd;          // albedo / pi
    float ndv, a2, k, k1, gv;   // k1 = 1 - k; gv the view's Smith factor
};

F3D_HD AdjView adj_view(V3 wo, V3 n, V3 albedo, float rough) {
    AdjView v;
    v.ndv = fmaxf(adj_dot(n, wo), 0.0f);
    v.fd = v3(albedo.x / F3D_ADJ_PI, albedo.y / F3D_ADJ_PI, albedo.z / F3D_ADJ_PI);
    float m = fmaxf(0.02f, rough * rough);
    v.a2 = m * m;
    float mk = m + 1.0f;
    v.k = (mk * mk) / 8.0f;
    v.k1 = 1.0f - v.k;
    v.gv = v.ndv / (v.ndv * v.k1 + v.k);
    return v;
}

// _bsdf_eval_pdf: Lambert + isotropic GGX (metallic 0); returns f, pdf
F3D_HD V3 adj_bsdf_view(const AdjView& v, V3 wo, V3 wi, V3 n, float& pdf) {
    float ndl = fmaxf(adj_dot(n, wi), 0.0f);
    bool valid = ndl > 0.0f && v.ndv > 0.0f;
    if (!valid) {
        pdf = 0.0f;
        return v3(0.0f, 0.0f, 0.0f);
    }
    float pdf_d = ndl / F3D_ADJ_PI;
    V3 h = adj_normalize(vadd(wi, wo));
    float ndh = fmaxf(adj_dot(n, h), 0.0f);
    float vdh = fmaxf(adj_dot(wo, h), 0.0f);
    float q = ndh * ndh * (v.a2 - 1.0f) + 1.0f;
    float d = v.a2 / fmaxf(F3D_ADJ_PI * (q * q), 1e-6f);
    float g = (ndl / (ndl * v.k1 + v.k)) * v.gv;
    float f = 0.04f + 0.96f * powf(1.0f - fminf(fmaxf(vdh, 0.0f), 1.0f), 5.0f);
    float spec = d * g / fmaxf(4.0f * ndl * v.ndv, 1e-6f);
    float fs = spec * f;
    pdf = fmaxf(pdf_d, 1e-8f);
    return v3(v.fd.x + fs, v.fd.y + fs, v.fd.z + fs);
}

F3D_HD V3 adj_bsdf(V3 wo, V3 wi, V3 n, V3 albedo, float rough, float& pdf) {
    return adj_bsdf_view(adj_view(wo, n, albedo, rough), wo, wi, n, pdf);
}

// _env_mixture_pdf
F3D_HD float adj_env_pdf(V3 n, V3 wi) {
    float c = fmaxf(wi.y, 0.0f);
    float pdf_up = 17.0f * powf(c, 16.0f) / (2.0f * F3D_ADJ_PI);
    float pdf_cos = fmaxf(adj_dot(n, wi), 0.0f) / F3D_ADJ_PI;
    return 0.5f * pdf_up + 0.5f * pdf_cos;
}

// _sun_nee
F3D_HD V3 adj_sun_nee(const AdjArgs& a, V3 pos, V3 n, V3 wo, V3 alb, float rough) {
    V3 wi = vld(a.sun_wi);
    float cos_surf = fmaxf(adj_dot(n, wi), 0.0f);
    float pdf;
    V3 f = adj_bsdf(wo, wi, n, alb, rough, pdf);
    bool vis = !adj_occluded(a, vadd(pos, vscale(n, 1e-3f)), wi);
    float w = cos_surf * (vis ? 1.0f : 0.0f);
    return vscale(vmul(f, vld(a.li)), w);
}

// adj_sun_nee without the work an exact zero multiplies, for the raster
// lane: where cos_surf is not above 0, adj_bsdf's ndl (the same value) is
// not either, so f is 0 and the result is (0 * li) * w, where w = cos_surf *
// (vis ? 1 : 0) has cos_surf's bits (a zero times 1 or +0 keeps its sign):
// the BSDF and the shadow ray change no bit of it
F3D_HD V3 adj_sun_nee_lit(const AdjArgs& a, V3 pos, V3 n, V3 wo, V3 alb, float rough) {
    float cos_surf = fmaxf(adj_dot(n, vld(a.sun_wi)), 0.0f);
    if (!(cos_surf > 0.0f)) return vscale(vmul(v3(0.0f, 0.0f, 0.0f), vld(a.li)), cos_surf);
    return adj_sun_nee(a, pos, n, wo, alb, rough);
}

// _plane_exit_radiance at (qx, 0, qz)
F3D_HD V3 adj_plane_exit(const AdjArgs& a, float qx, float qz) {
    V3 q = v3(qx, 0.0f, qz);
    bool vis = !adj_occluded(a, vadd(q, v3(0.0f, 1e-3f, 0.0f)), vld(a.sun_wi));
    V3 l_sun = vscale(vld(a.pe_sun), vis ? 1.0f : 0.0f);
    float ao = 1.0f;
    for (int i = 0; i < 3; ++i) {
        V3 d = vsub(vld(a.sph + 4 * i), q);
        float d2 = adj_dot(d, d);
        float cosf_ = fminf(fmaxf(d.y / sqrtf(fmaxf(d2, 1e-12f)), 0.0f), 1.0f);
        ao = ao - (d2 > a.r2[i] ? (a.r2[i] / fmaxf(d2, 1e-12f)) * cosf_ : 0.0f);
    }
    ao = fminf(fmaxf(ao, 0.0f), 1.0f);
    return vadd(vadd(l_sun, vscale(vld(a.pe_amb), ao)), vscale(vld(a.pe_sky), ao));
}

// _secondary_radiance at p2 (normal n2, hit kind idx2, toward wo2)
F3D_HD V3 adj_secondary(const AdjArgs& a, V3 p2, V3 n2, int idx2, V3 wo2) {
    int ic = idx2 < 0 ? 0 : (idx2 > 3 ? 3 : idx2);
    V3 alb2 = vld(a.alb + 3 * ic);
    V3 l = adj_sun_nee_lit(a, p2, n2, wo2, alb2, a.rough[ic]);
    float ny = n2.y;
    float fp = idx2 != 3 ? 0.5f * (1.0f - ny) : 0.0f;
    float ao = 1.0f - fp;
    float fss[3];
    for (int i = 0; i < 3; ++i) {
        V3 d = vsub(vld(a.sph + 4 * i), p2);
        float d2 = adj_dot(d, d);
        float cosf_ = fminf(fmaxf(adj_dot(n2, d) / sqrtf(fmaxf(d2, 1e-12f)), 0.0f), 1.0f);
        float f = (a.r2[i] / fmaxf(d2, 1e-12f)) * cosf_;
        fss[i] = (idx2 != i && d2 > a.r2[i]) ? f : 0.0f;
        ao = ao - fss[i];
    }
    ao = fminf(fmaxf(ao, 0.0f), 1.0f);
    float c = fminf(fmaxf(ny, -1.0f), 1.0f);
    float tmis = 0.35583f + c * (0.06546f + c * (0.03152f - c * 0.01529f));
    l = vadd(l, vscale(vmul(alb2, vld(a.amb)), tmis * ao));
    l = vadd(l, vscale(vmul(alb2, vld(a.sky)), ao));
    // the plane's share only where fp != 0: the term is (alb2 * pe) * fp with
    // alb2 and pe finite and >= +0 (the scene's albedos and radiances), so
    // at fp == +0 (the ground, or ny == 1) it is +0, and l is a sum of such
    // terms whose ambient term above already made it >= +0 and not -0
    if (fp != 0.0f) l = vadd(l, vscale(vmul(alb2, adj_plane_exit(a, p2.x, p2.z)), fp));
    for (int i = 0; i < 3; ++i)
        l = vadd(l, vscale(vmul(vmul(alb2, vld(a.alb + 3 * i)), vld(a.pe_s + 3 * i)), fss[i]));
    return l;
}

// _camera_rays for pixel (x, y) with jitter (jx, jy)
F3D_HD V3 adj_camera_ray(const AdjArgs& a, int x, int y, float jx, float jy) {
    float u = (((float)x + jx) / (float)a.width * 2.0f - 1.0f) * a.half_w;
    float v = (1.0f - ((float)y + jy) / (float)a.height * 2.0f) * a.half_h;
    return adj_normalize(vadd(vadd(vscale(vld(a.right), u), vscale(vld(a.up), v)), vld(a.fwd)));
}

// _tonemap: Reinhard, then the exact piecewise sRGB encode, +0.5 round
F3D_HD unsigned char adj_u8(float hdr) {
    float x = fmaxf(hdr, 0.0f);
    float y = x / (1.0f + x);
    float lin = fminf(fmaxf(y, 0.0f), 1.0f);
    float s = lin <= 0.0031308f ? lin * 12.92f
                                : 1.055f * powf(fmaxf(lin, 1e-7f), 1.0f / 2.4f) - 0.055f;
    s = fminf(fmaxf(s, 0.0f), 1.0f);
    return (unsigned char)fminf(fmaxf(s * 255.0f + 0.5f, 0.0f), 255.0f);
}

F3D_HD void adj_store(const AdjArgs& a, V3 c, int i, unsigned char* rgba, float* hdr) {
    if (hdr) {
        hdr[3 * i] = c.x;
        hdr[3 * i + 1] = c.y;
        hdr[3 * i + 2] = c.z;
    }
    rgba[4 * i] = adj_u8(c.x);
    rgba[4 * i + 1] = adj_u8(c.y);
    rgba[4 * i + 2] = adj_u8(c.z);
    rgba[4 * i + 3] = 255;
}

// _raster_frame for pixel i; quad holds the (x, y, z) of each direction's
// _cosine_local in scan order. The pixel's view side of the BSDF is formed
// once, before the directions (adj_view: the same operations, so the same
// bits; nvcc hoists the secondary rays' sphere terms from `so` itself); the
// sun NEE and the plane's share skip the work an exact zero multiplies
// (adj_sun_nee_lit, adj_secondary).
F3D_HD void adj_raster_pixel(const AdjArgs& a, const float* quad, int i, unsigned char* rgba,
                             float* hdr) {
    const int x = i % a.width, y = i / a.width;
    V3 ro = vld(a.cam_o);
    V3 rd = adj_camera_ray(a, x, y, 0.5f, 0.5f);
    float t;
    int kind = adj_nearest(a, ro, rd, t);
    if (kind < 0) {
        adj_store(a, vld(a.sky), i, rgba, hdr);
        return;
    }
    V3 pos = vadd(ro, vscale(rd, t));
    V3 n = adj_normal(a, pos, kind);
    V3 alb = vld(a.alb + 3 * kind);
    float rough = a.rough[kind];
    V3 wo = adj_normalize(vsub(ro, pos));
    V3 radiance = adj_sun_nee_lit(a, pos, n, wo, alb, rough);
    V3 so = vadd(pos, vscale(n, 1e-3f));
    const AdjView view = adj_view(wo, n, alb, rough);
    V3 tv, bt;
    adj_basis(n, tv, bt);
    V3 alb_pi = v3(alb.x / F3D_ADJ_PI, alb.y / F3D_ADJ_PI, alb.z / F3D_ADJ_PI);
    V3 acc = v3(0.0f, 0.0f, 0.0f);
    for (int q = 0; q < a.n_quad; ++q) {
        const float lx = quad[3 * q], ly = quad[3 * q + 1], lz = quad[3 * q + 2];
        V3 wi = adj_normalize(vadd(vadd(vscale(tv, lx), vscale(bt, ly)), vscale(n, lz)));
        float cos_surf = fmaxf(adj_dot(n, wi), 0.0f);
        if (!(cos_surf > 0.0f)) continue;  // JAX adds where(live, ., 0): + 0 changes no sum
        float t2;
        int kind2 = adj_nearest(a, so, wi, t2);
        V3 contrib;
        if (kind2 < 0) {
            float pdf_b;
            V3 f = adj_bsdf_view(view, wo, wi, n, pdf_b);
            float pdf_l = adj_env_pdf(n, wi);
            float w_mis = pdf_l / fmaxf(pdf_l + pdf_b, 1e-8f);
            contrib = vadd(vscale(vmul(f, vld(a.amb)), w_mis), vmul(alb_pi, vld(a.sky)));
        } else {
            V3 p2 = vadd(so, vscale(wi, t2));
            V3 n2 = adj_normal(a, p2, kind2);
            contrib = vmul(alb_pi, adj_secondary(a, p2, n2, kind2, vscale(wi, -1.0f)));
        }
        acc = vadd(acc, contrib);
    }
    radiance = vadd(radiance, vscale(acc, a.quad_w));
    adj_store(a, radiance, i, rgba, hdr);
}

// ---------------------------------------------------------------------------
// threefry-2x32 (jax.random's key stream, 20 rounds)
// ---------------------------------------------------------------------------

F3D_HD uint32_t adj_rotl(uint32_t v, int r) { return (v << r) | (v >> (32 - r)); }

// one Threefry round: x0 += x1, x1 = rotl(x1, r) ^ x0
#define F3D_TF_ROUND(r) \
    x0 += x1;            \
    x1 = adj_rotl(x1, r) ^ x0;

// the 20 rounds written out, so the rotations and key words are constants:
// a loop over per-thread tables of them ran the PT lane ~20x slower on the
// card (the tables lived in local memory)
F3D_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    x0 += k0;
    x1 += k1;
    F3D_TF_ROUND(13) F3D_TF_ROUND(15) F3D_TF_ROUND(26) F3D_TF_ROUND(6)
    x0 += k1;
    x1 += k2 + 1u;
    F3D_TF_ROUND(17) F3D_TF_ROUND(29) F3D_TF_ROUND(16) F3D_TF_ROUND(24)
    x0 += k2;
    x1 += k0 + 2u;
    F3D_TF_ROUND(13) F3D_TF_ROUND(15) F3D_TF_ROUND(26) F3D_TF_ROUND(6)
    x0 += k0;
    x1 += k1 + 3u;
    F3D_TF_ROUND(17) F3D_TF_ROUND(29) F3D_TF_ROUND(16) F3D_TF_ROUND(24)
    x0 += k1;
    x1 += k2 + 4u;
    F3D_TF_ROUND(13) F3D_TF_ROUND(15) F3D_TF_ROUND(26) F3D_TF_ROUND(6)
    x0 += k2;
    x1 += k0 + 5u;
}
#undef F3D_TF_ROUND

// jax.random.uniform(key, (H, W)) at the row-major element `idx`
F3D_HD float adj_uniform(const uint32_t* key, uint32_t idx) {
    uint32_t a = 0u, b = idx;
    threefry2x32(key[0], key[1], a, b);
    uint32_t bits = ((a ^ b) >> 9) | 0x3F800000u;
#ifdef __CUDA_ARCH__
    float f = __uint_as_float(bits);
#else
    float f;
    memcpy(&f, &bits, 4);
#endif
    return fmaxf(0.0f, f - 1.0f);
}

// ---------------------------------------------------------------------------
// The path-traced lane as a hit loop (adj_pt_kernel)
// ---------------------------------------------------------------------------
//
// JAX's _pt_sample steps a sample's paths depth by depth, and the spp loop
// sums the samples in order. A thread that ran its pixel's samples the same
// way would keep a warp in the depth loop until its longest path ended,
// with the lanes whose paths had ended idle through the vertex's shading,
// the expensive part (44% of the lanes busy there at 512^2, 87% in a hit
// loop: pt/adjudication.py:pt_work). Here a lane instead carries its
// pixel's state (AdjLane) from pass to pass. A pass first runs the cheap
// steps (adj_pt_advance) until the lane holds a hit to shade: a new
// sample's jitter and camera ray, the nearest hit, the sky term of a miss,
// the end of the sample, and once its pixel's spp samples are done, the
// pixel's store and the next pixel if the lane is given one. Only then
// does it shade the vertex (adj_pt_vertex), with the other lanes of the
// warp that hold one. Each sample computes what _pt_sample computes, in
// its order, under the keys of its own index and depth, and a pixel's
// samples are added to its sum in order 0..spp-1 by the one lane that
// holds it: no bit depends on which lane, pass or block runs a pixel.
//
// On an H100 the vertex step still sets the time: its warp-steps fell to
// half, the kernel's time by a fifth (PERF.md §6). The threefry
// draws, the IEEE divisions and square roots, the transcendentals and the
// shadow rays that keep every bit JAX's take most of it.

struct AdjLane {
    int pix;         // the pixel (its row-major index is the threefry counter); -1: none left
    int s;           // the sample being traced; spp: the pixel is done
    int depth;       // the vertex the held ray reaches; -1: sample s has not started
    V3 ro, rd, thr, acc;
    V3 sum;          // the pixel's samples before s, summed in order
};

F3D_HD void adj_pt_begin(AdjLane& L, int pix) {
    L.pix = pix;
    L.s = 0;
    L.depth = -1;
    L.sum = v3(0.0f, 0.0f, 0.0f);
}

// the end of sample s's path: its radiance joins the pixel's sum
F3D_HD void adj_pt_end_sample(AdjLane& L) {
    L.sum = vadd(L.sum, L.acc);
    L.s += 1;
    L.depth = -1;
}

// The cheap steps of a pass: true with the held hit (t, kind) of the ray
// (L.ro, L.rd) at vertex L.depth; false once the lane's pixels are done.
// `next()` gives the lane its next pixel, or -1.
template <class Next>
F3D_HD bool adj_pt_advance(const AdjArgs& a, const uint32_t* keys, AdjLane& L, Next& next,
                           unsigned char* rgba, float* hdr, float& t, int& kind) {
    for (;;) {
        if (L.pix < 0) return false;
        if (L.s == a.spp) {   // render_adjudication_builtin: the mean, tone mapped
            const float spp = (float)a.spp;
            adj_store(a, v3(L.sum.x / spp, L.sum.y / spp, L.sum.z / spp), L.pix, rgba, hdr);
            adj_pt_begin(L, next());
            continue;
        }
        if (L.depth < 0) {    // _pt_sample's camera ray under sample s's jitter keys
            const uint32_t* ks = keys + 2 * F3D_ADJ_KEYS * L.s;
            const uint32_t idx = (uint32_t)L.pix;
            float jx = adj_uniform(ks, idx), jy = adj_uniform(ks + 2, idx);
            L.ro = vld(a.cam_o);
            L.rd = adj_camera_ray(a, L.pix % a.width, L.pix / a.width, jx, jy);
            L.thr = v3(1.0f, 1.0f, 1.0f);
            L.acc = v3(0.0f, 0.0f, 0.0f);
            L.depth = 0;
        }
        kind = adj_nearest(a, L.ro, L.rd, t);
        if (kind >= 0) return true;
        L.acc = vadd(L.acc, vmul(L.thr, vld(a.sky)));   // a miss ends the path
        adj_pt_end_sample(L);
    }
}

// _pt_sample's vertex at the held hit (t, kind): the sun and environment
// NEE, then the bounce and Russian roulette; the path ends where JAX's
// `alive` goes false. Three skips change no bit:
// - the sun NEE is adj_sun_nee_lit, whose argument holds here as in the
//   raster lane: the same pos, n, wo, albedo and roughness reach
//   adj_sun_nee, and where cos_surf is not above 0 its BSDF (ndl is the
//   same value) and shadow ray only multiply an exact zero;
// - the environment sample's BSDF, pdfs, MIS weight and shadow ray are
//   formed only where cos_surf > 0: _pt_sample adds their product under
//   that condition alone, and adds nothing elsewhere;
// - the roulette's draw is made only from depth F3D_ADJ_RR: before it q is
//   0, and a uniform is never below 0 (adj_uniform: max(0, f - 1)), so the
//   draw cannot end the path.
F3D_HD void adj_pt_vertex(const AdjArgs& a, const uint32_t* keys, AdjLane& L, float t,
                          int kind) {
    const uint32_t* kd = keys + 2 * F3D_ADJ_KEYS * L.s + 4 + 12 * L.depth;
    const uint32_t idx = (uint32_t)L.pix;
    V3 pos = vadd(L.ro, vscale(L.rd, t));
    V3 n = adj_normal(a, pos, kind);
    V3 alb = vld(a.alb + 3 * kind);
    float rough = a.rough[kind];
    V3 wo = vscale(L.rd, -1.0f);
    L.acc = vadd(L.acc, vmul(L.thr, adj_sun_nee_lit(a, pos, n, wo, alb, rough)));
    float u[6];  // the vertex's six draws, fold_in(kd, j) for j = 0..5
    for (int j = 0; j < 5; ++j) u[j] = adj_uniform(kd + 2 * j, idx);
    u[5] = L.depth >= F3D_ADJ_RR ? adj_uniform(kd + 10, idx) : 0.0f;
    const float u1 = u[0], u2 = u[1], u3 = u[2];
    float cos_t = powf(1.0f - u2, 1.0f / 17.0f);
    float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
    float phi = 2.0f * F3D_ADJ_PI * u3;
    V3 wi_l;
    if (u1 < 0.5f) {
        wi_l = v3(sin_t * cosf(phi), cos_t, sin_t * sinf(phi));
    } else {
        float r = sqrtf(u2), ph = 2.0f * F3D_ADJ_PI * u3;
        wi_l = adj_to_world(n, r * cosf(ph), r * sinf(ph), sqrtf(fmaxf(1.0f - u2, 0.0f)));
    }
    float cos_surf = fmaxf(adj_dot(n, wi_l), 0.0f);
    if (cos_surf > 0.0f) {
        float pdf_l = adj_env_pdf(n, wi_l);
        float pdf_b;
        V3 f = adj_bsdf(wo, wi_l, n, alb, rough, pdf_b);
        float w_mis = pdf_l / fmaxf(pdf_l + pdf_b, 1e-8f);
        bool vis = !adj_occluded(a, vadd(pos, vscale(n, 1e-3f)), wi_l);
        float w = cos_surf / fmaxf(pdf_l, 1e-8f) * w_mis * (vis ? 1.0f : 0.0f);
        L.acc = vadd(L.acc, vmul(L.thr, vscale(vmul(f, vld(a.amb)), w)));
    }
    const float u4 = u[3], u5 = u[4];
    float r4 = sqrtf(u4), ph4 = 2.0f * F3D_ADJ_PI * u5;
    V3 d = adj_to_world(n, r4 * cosf(ph4), r4 * sinf(ph4), sqrtf(fmaxf(1.0f - u4, 0.0f)));
    V3 thr_new = vmul(L.thr, alb);
    float max_c = fmaxf(fmaxf(thr_new.x, thr_new.y), thr_new.z);
    float q = L.depth >= F3D_ADJ_RR ? fminf(fmaxf(1.0f - max_c, 0.0f), 0.95f) : 0.0f;
    if (!(u[5] >= q) || L.depth + 1 >= F3D_ADJ_DEPTH) {
        adj_pt_end_sample(L);
        return;
    }
    float inv = fmaxf(1.0f - q, 1e-6f);
    L.thr = v3(thr_new.x / inv, thr_new.y / inv, thr_new.z / inv);
    L.ro = vadd(pos, vscale(n, 1e-3f));
    L.rd = d;
    L.depth += 1;
}

// a lane that holds one pixel: no next one
struct AdjNoQueue {
    F3D_HD int operator()() const { return -1; }
};

// one lane's work from its first pixel until `next()` gives none: the
// kernel's lanes hold a pixel each; the host twin hands a lane further
// pixels in other orders to show that the schedule changes no bit
template <class Next>
F3D_HD void adj_pt_lane(const AdjArgs& a, const uint32_t* keys, int first, Next& next,
                        unsigned char* rgba, float* hdr) {
    AdjLane L;
    adj_pt_begin(L, first);
    float t;
    int kind;
    while (adj_pt_advance(a, keys, L, next, rgba, hdr, t, kind))
        adj_pt_vertex(a, keys, L, t, kind);
}

// The lanes' order: lane k of adj_pt_lanes takes pixel (x, y) of K6's 8x4
// warps over the frame's 8x4 tiles in row-major order, or none (-1) past
// the frame's ragged edge
F3D_HD int adj_pt_pixel_of(int width, int height, int k) {
    const int tiles_x = (width + 7) / 8, tile = k >> 5, lane = k & 31;
    const int x = (tile % tiles_x) * 8 + (lane & 7), y = (tile / tiles_x) * 4 + (lane >> 3);
    return x < width && y < height ? y * width + x : -1;
}

F3D_HD int adj_pt_lanes(int width, int height) {
    return ((width + 7) / 8) * ((height + 3) / 4) * 32;
}
