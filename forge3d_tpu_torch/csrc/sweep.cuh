// forge3d_tpu_torch/csrc/sweep.cuh
// Per-thread, per-column and per-pixel code of the sweep estimator's four
// kernels (launched from sweep.cu):
//
// K1 rotate_node    replaces forge3d_tpu/ops/sweep.py:rotate_heights (384)
// K2 sweep_*        replaces forge3d_tpu/ops/sweep.py:sweep_lighting (188),
//                   _propagate_group (119)
// K3 profile_sample, edge_sample, polar_row
//                   replace forge3d_tpu/pt/terrain_sweep.py:frame_one (146)
//                   with ops/polarscan.py:extract_profiles (179),
//                   profile_hit_tangents (226), synthesize_polar (250),
//                   polar_directions (161)
// K4 resolve_pixel  replaces forge3d_tpu/ops/polarscan.py:warp_to_screen
//                   (325) and pt/terrain_sweep.py:resolve_impl (394)
//
// Every function computes what its JAX counterpart computes, operation for
// operation in float32 (the build turns contraction off), so that the
// kernels agree with the plain PyTorch versions. Where the JAX version
// contracts a dense one-hot or hat-weight operand (the column and azimuth
// resamples, the first-crossing indicator), the code here sums the same
// products over the taps whose weight is not zero.
//
// The functions are __host__ __device__ (F3D_HD, common.cuh) so that a CPU
// harness can drive the same bodies.

#pragma once

#include "common.cuh"

#define F3D_NEG (-1.0e30f)

// ---------------------------------------------------------------------------
// K1: the rotated grid
// ---------------------------------------------------------------------------

struct RotArgs {
    const float* heights;  // (dem_h, dem_w)
    int dem_w, dem_h, n_v, n_u;
    float u0, v0, spacing, cam_x, cam_z, eu0, eu2, ev0, ev2;
    float ox, oz, sx, sz, ex, ex_sx, ex_sz;
};

// rotate_heights(with_derivatives=True) at node (iv, iu).
F3D_HD void rotate_node(const RotArgs& r, int iv, int iu, float& h, float& du, float& dv) {
    const int W = r.dem_w, H = r.dem_h;
    float u = r.u0 + (float)iu * r.spacing;
    float v = r.v0 + (float)iv * r.spacing;
    float x = (r.cam_x + u * r.eu0) + v * r.ev0;
    float z = (r.cam_z + u * r.eu2) + v * r.ev2;
    float fx = (x - r.ox) / r.sx;
    float fz = (z - r.oz) / r.sz;
    bool valid = fx >= 0.0f && fx <= (float)(W - 1) && fz >= 0.0f && fz <= (float)(H - 1);
    float ixf = fminf(fmaxf(floorf(fx), 0.0f), (float)(W - 2));
    float izf = fminf(fmaxf(floorf(fz), 0.0f), (float)(H - 2));
    float ax = fx - ixf;
    float az = fz - izf;
    int base = (int)izf * W + (int)ixf;
    float h00 = r.heights[base], h10 = r.heights[base + 1];
    float h01 = r.heights[base + W], h11 = r.heights[base + W + 1];
    float hv = ((h00 * (1.0f - ax) * (1.0f - az) + h10 * ax * (1.0f - az))
                + h01 * (1.0f - ax) * az + h11 * ax * az) * r.ex;
    h = valid ? hv : F3D_NEG;
    float dydx = ((h10 - h00) * (1.0f - az) + (h11 - h01) * az) * r.ex_sx;
    float dydz = ((h01 - h00) * (1.0f - ax) + (h11 - h10) * ax) * r.ex_sz;
    if (!valid) {
        dydx = 0.0f;
        dydz = 0.0f;
    }
    du = dydx * r.eu0 + dydz * r.eu2;
    dv = dydx * r.ev0 + dydz * r.ev2;
}

// ---------------------------------------------------------------------------
// K2: shadow-line propagation
// ---------------------------------------------------------------------------

struct SweepBin {  // one row of the bin table (ops/sweep.py:kernel_tables)
    float wu, wv, wy, one_m, tpos, tneg, deltab, er, eg, eb;
};

struct SweepTask {  // one task: the sun alone, or one sky stratum's bins
    int q, ss, bin0, nb, plane, emit;
};

struct SweepCta {  // one CTA of a task: its band of columns [c0, c0 + w)
    int task, c0, w;
};

// Rows along the march and the row width of quadrant q's oriented view.
F3D_HD int sweep_rows(int q, int V, int U) { return q < 2 ? V : U; }
F3D_HD int sweep_width(int q, int V, int U) { return q < 2 ? U : V; }

// Flat (v, u) index of oriented row r, column c: q=0 marches +v, q=1 -v
// (rows flipped), q=2 +u (transposed), q=3 -u (transposed, flipped).
F3D_HD int sweep_index(int q, int r, int c, int V, int U) {
    switch (q) {
        case 0: return r * U + c;
        case 1: return (V - 1 - r) * U + c;
        case 2: return c * U + r;
        default: return c * U + (U - 1 - r);
    }
}

// Flat index of texel (v, u) in quadrant q's oriented layout (row r of
// sweep_width columns): where the task's partial plane and z_sun rows are
// written, row by row, so that a band's writes are contiguous.
F3D_HD int sweep_oriented(int q, int v, int u, int V, int U) {
    switch (q) {
        case 0: return v * U + u;
        case 1: return (V - 1 - v) * U + u;
        case 2: return u * V + v;
        default: return (U - 1 - u) * V + v;
    }
}

// _propagate_group.shift_drop at a column whose z is zc, with its
// neighbours zp (column - 1) and zm (column + 1), F3D_NEG past the grid.
F3D_HD float shift_drop(float zp, float zc, float zm, const SweepBin& b) {
    return zc * b.one_m + b.tpos * zp + b.tneg * zm - b.deltab;
}

// A band's z rows: a row of zs floats a bin, slot j + 1 holding the band's
// column c0 + j; slots 0 and w + 1 hold the neighbouring bands' edge
// columns, or F3D_NEG at the grid's edges (never written).

// Sub-row step (f = j / ss) of row r, for bin b at band slot j:
// z <- max(lerp(h_prev, h_row, f), shift_drop(z)).
F3D_HD float sweep_substep(float h_prev, float h_row, float f, const float* z, int j,
                           const SweepBin& b) {
    float h_mid = h_prev + f * (h_row - h_prev);
    return fmaxf(h_mid, shift_drop(z[j - 1], z[j], z[j + 1], b));
}

// 1 / |(-du, 1, -dv)|, the normal's length at a node
F3D_HD float sweep_invn(float d_u, float d_v) {
    return 1.0f / sqrtf(1.0f + d_u * d_u + d_v * d_v);
}

// The last (or only) step of a row for bin b at band slot j: the bin's new
// z (z_nxt) and incoming z_in, and its contribution lit * max(cos, 0).
F3D_HD float sweep_bin(float h_row, float d_u, float d_v, float invn, const SweepBin& bn,
                       const float* z, int j, float& z_nxt, float& z_in) {
    z_in = shift_drop(z[j - 1], z[j], z[j + 1], bn);
    float lit = h_row >= z_in ? 1.0f : 0.0f;
    float cosb = (bn.wy - bn.wu * d_u - bn.wv * d_v) * invn;
    z_nxt = fmaxf(h_row, z_in);
    return lit * fmaxf(cosb, 0.0f);
}

// Channel c (0 r, 1 g, 2 b) of a column's e_sky: its nb bins'
// contributions (stride floats apart) weighted and summed in bin order.
F3D_HD float sweep_sum(const float* __restrict__ contrib, int stride, int nb,
                       const SweepBin* __restrict__ bins, int c) {
    float e = 0.0f;
#ifdef __CUDA_ARCH__
#pragma unroll 4
#endif
    for (int b = 0; b < nb; ++b) e += contrib[b * stride] * (&bins[b].er)[c];
    return e;
}

// e_sky at texel (v, u): the partial planes (oriented by plane_q) summed
// in their fixed order.
F3D_HD void sweep_reduce(const float* partial, const int* plane_q, int n_planes, int V, int U,
                         int v, int u, float* e_sky) {
    const size_t plane = (size_t)V * U;
    for (int c = 0; c < 3; ++c) {
        float s = 0.0f;
        for (int p = 0; p < n_planes; ++p)
            s += partial[(p * plane + sweep_oriented(plane_q[p], v, u, V, U)) * 3 + c];
        e_sky[((size_t)v * U + u) * 3 + c] = s;
    }
}

// ---------------------------------------------------------------------------
// K3: one frame of the polar first-hit scan, per azimuth column
// ---------------------------------------------------------------------------

struct PolarArgs {
    const float* env_rgb;  // (env_h, env_w, 3) or null for constant white
    int env_w, env_h;
    float env_intensity;
    int n_v, n_u, K, A, E, r1, r2, dem_w, dem_h, shadows;
    // polar plan (float32 of PolarStatic's fields)
    float t_lo, t_step, y_step, fv, uvhh, fy, uyhh, cam_y, cam_iu, cam_iv, spacing;
    float base;   // float32(k0 + 1 - cam_iv)
    float row0;   // float32(k0 + 1)
    // rotated grid and DEM
    float u0, v0, cam_x, cam_z, eu0, eu2, ev0, ev2, v0ev0, v0ev2;
    float sx, sz, ex, ex_sx, ex_sz, xmax, zmax;
    float sun[3], lc[3], alb[3];
    float eps;
    // this frame's jitter
    float xi, ja, je;
};

struct PSample {
    float h, es[3], zs;
};

// Azimuth tangent of column a.
F3D_HD float azimuth_t(const PolarArgs& p, int a) {
    return p.t_lo + ((float)a + 0.5f + p.ja) * p.t_step;
}

// PolarStatic.q_rows at row e.
F3D_HD float q_row(const PolarArgs& p, int e) {
    float ndc = 1.0f - ((float)e + 0.5f + p.je) * p.y_step;
    float cv = fmaxf(p.fv + ndc * p.uvhh, 0.02f);
    return (p.fy + ndc * p.uyhh) / cv;
}

// extract_profiles at (k, a): the radial row lerp, then the column hat
// weights (two taps), for the five rotbuf channels (h, e_sky rgb, z_sun).
F3D_HD PSample profile_sample(const PolarArgs& p, const float* h_rot, const float* e_sky,
                              const float* z_sun, int k, float t) {
    float koff = (float)k + p.base + p.xi;
    float pc = p.cam_iu + koff * t;
    float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (pc > -1.0f && pc < (float)p.n_u) {
        int j0 = (int)floorf(pc);
        float omx = 1.0f - p.xi;
        for (int j = j0; j <= j0 + 1; ++j) {
            if (j < 0 || j >= p.n_u) continue;
            float w = fmaxf(0.0f, 1.0f - fabsf(pc - (float)j));
            size_t i1 = (size_t)(p.r1 + k) * p.n_u + j;
            size_t i2 = (size_t)(p.r2 + k) * p.n_u + j;
            float src[5];
            src[0] = omx * h_rot[i1] + p.xi * h_rot[i2];
            for (int c = 0; c < 3; ++c)
                src[1 + c] = omx * e_sky[i1 * 3 + c] + p.xi * e_sky[i2 * 3 + c];
            src[4] = omx * z_sun[i1] + p.xi * z_sun[i2];
            for (int c = 0; c < 5; ++c) acc[c] += w * src[c];
        }
    }
    PSample s;
    bool oob = pc < 0.0f || pc > (float)(p.n_u - 1);
    s.h = oob ? F3D_NEG : acc[0];
    s.es[0] = acc[1];
    s.es[1] = acc[2];
    s.es[2] = acc[3];
    s.zs = acc[4];
    return s;
}

// Exact bilinear-patch normal of the DEM cell holding (fx, fz) (cell
// coordinates), from the corner pack (h00, h10, h01, h11 per cell).
F3D_HD void patch_normal(const PolarArgs& p, const float* corners, float fx, float fz,
                         float& nx, float& ny, float& nz, float* h_out) {
    float x0 = fminf(fmaxf(floorf(fx), 0.0f), (float)(p.dem_w - 2));
    float z0 = fminf(fmaxf(floorf(fz), 0.0f), (float)(p.dem_h - 2));
    float tx = clamp01(fx - x0);
    float tz = clamp01(fz - z0);
    const float* c = corners + ((size_t)((int)z0 * (p.dem_w - 1) + (int)x0)) * 4;
    float h00, h10, h01, h11;
#ifdef __CUDA_ARCH__
    float4 cv = __ldg(reinterpret_cast<const float4*>(c));
    h00 = cv.x;
    h10 = cv.y;
    h01 = cv.z;
    h11 = cv.w;
#else
    h00 = c[0];
    h10 = c[1];
    h01 = c[2];
    h11 = c[3];
#endif
    if (h_out)
        *h_out = ((h00 * (1.0f - tx) + h10 * tx) * (1.0f - tz)
                  + (h01 * (1.0f - tx) + h11 * tx) * tz) * p.ex;
    float gx = ((h10 - h00) * (1.0f - tz) + (h11 - h01) * tz) * p.ex_sx;
    float gz = ((h01 - h00) * (1.0f - tx) + (h11 - h10) * tx) * p.ex_sz;
    float invn = 1.0f / sqrtf(1.0f + gx * gx + gz * gz);
    nx = -gx * invn;
    ny = invn;
    nz = -gz * invn;
}

// Shaded rgb of a profile sample at height h with sky term es and sun
// shadow height zs, on a patch of normal n.
F3D_HD void shade(const PolarArgs& p, float nx, float ny, float nz, float h, const float* es,
                  float zs, float* rgb) {
    float ndotl = fmaxf(nx * p.sun[0] + ny * p.sun[1] + nz * p.sun[2], 0.0f);
    float vis = p.shadows ? (h + p.eps >= zs ? 1.0f : 0.0f) : 1.0f;
    float lit = ndotl * vis;
    for (int c = 0; c < 3; ++c) rgb[c] = p.alb[c] * (p.lc[c] * lit + es[c]);
}

// Everything frame_one computes for profile sample (k, a) before the edge
// replacement: the reduced tangent q, the channels v[0..7] (rgb, t, normal,
// 1) and the sample height. Returns the height (-1e30 outside the grid).
F3D_HD float sample_values(const PolarArgs& p, const float* h_rot, const float* e_sky,
                           const float* z_sun, const float* corners, int k, float t,
                           float& q, float* v) {
    PSample s = profile_sample(p, h_rot, e_sky, z_sun, k, t);
    float koff = (float)k + p.base + p.xi;
    float pc = p.cam_iu + koff * t;
    float row = p.row0 + p.xi + (float)k;
    float u_w = p.u0 + pc * p.spacing;
    float v_w = p.v0 + row * p.spacing;
    float x_w = p.cam_x + u_w * p.eu0 + v_w * p.ev0;
    float z_w = p.cam_z + u_w * p.eu2 + v_w * p.ev2;
    float nx, ny, nz;
    patch_normal(p, corners, x_w / p.sx, z_w / p.sz, nx, ny, nz, nullptr);
    shade(p, nx, ny, nz, s.h, s.es, s.zs, v);
    // profile_hit_tangents
    float s_f = fmaxf(koff * p.spacing, 1e-6f);
    float qr = (s.h - p.cam_y) / s_f;
    qr = fminf(fmaxf(qr, -1e4f), 1e4f);
    if (!(koff > 0.25f)) qr = -1e4f;
    q = qr;
    v[3] = s_f * sqrtf((1.0f + t * t) + qr * qr);
    v[4] = nx;
    v[5] = ny;
    v[6] = nz;
    v[7] = 1.0f;
    return s.h;
}

F3D_HD void slab1(float p0, float d, float lim, float& lo, float& hi) {
    float dd = fabsf(d) > 1e-12f ? d : 1e-12f;
    float t1 = (0.0f - p0) / dd;
    float t2 = (lim - p0) / dd;
    lo = fminf(t1, t2);
    hi = fmaxf(t1, t2);
    if (fabsf(d) <= 1e-12f) {
        bool inside = p0 >= 0.0f && p0 <= lim;
        lo = inside ? -1e9f : 1e9f;
        hi = inside ? 1e9f : -1e9f;
    }
}

struct Edge {
    int can;          // the exact boundary-entry sample replaces row slot
    int slot;
    float q, v[7];    // its tangent and channels 0..6
    float h_ent, s_ent;  // entry height and forward distance (phantom rule)
};

// frame_one's exact boundary-entry sample of column a. k_first is the first
// valid profile row (K if none).
F3D_HD Edge edge_sample(const PolarArgs& p, const float* h_rot, const float* e_sky,
                        const float* z_sun, const float* corners, int k_first, float t) {
    Edge E;
    const bool has_valid = k_first < p.K;
    const int k_entry = has_valid ? k_first : 0;   // jnp.argmax of all-false
    float u_c = p.u0 + (p.cam_iu - p.cam_iv * t) * p.spacing;
    float x0w = p.cam_x + u_c * p.eu0 + p.v0ev0;
    float z0w = p.cam_z + u_c * p.eu2 + p.v0ev2;
    float dxr = p.spacing * (t * p.eu0 + p.ev0);
    float dzr = p.spacing * (t * p.eu2 + p.ev2);
    float lox, hix, loz, hiz;
    slab1(x0w, dxr, p.xmax, lox, hix);
    slab1(z0w, dzr, p.zmax, loz, hiz);
    float r_in = fmaxf(lox, loz);
    float r_out = fminf(hix, hiz);
    float koff_e = r_in - p.cam_iv;
    E.can = has_valid && k_entry >= 1 && koff_e > 0.25f && r_in < r_out;
    E.slot = k_entry - 1;
    float xe = x0w + r_in * dxr;
    float ze = z0w + r_in * dzr;
    float fxe = fminf(fmaxf(xe / p.sx, 0.0f), (float)p.dem_w - 1.0f);
    float fze = fminf(fmaxf(ze / p.sz, 0.0f), (float)p.dem_h - 1.0f);
    float nx, ny, nz, h_edge;
    patch_normal(p, corners, fxe, fze, nx, ny, nz, &h_edge);
    PSample s = profile_sample(p, h_rot, e_sky, z_sun, k_entry, t);
    shade(p, nx, ny, nz, h_edge, s.es, s.zs, E.v);
    float s_edge = fmaxf(koff_e, 1e-6f) * p.spacing;
    float s_e = fmaxf(s_edge, 1e-6f);
    float q_edge = fminf(fmaxf((h_edge - p.cam_y) / s_e, -1e4f), 1e4f);
    E.q = q_edge;
    E.v[3] = s_e * sqrtf((1.0f + t * t) + q_edge * q_edge);
    E.v[4] = nx;
    E.v[5] = ny;
    E.v[6] = nz;
    E.h_ent = E.can ? h_edge : s.h;
    E.s_ent = E.can ? s_edge : ((float)k_entry + p.base + p.xi) * p.spacing;
    return E;
}

// env_radiance for the polar texel (e, a)'s direction (polar_directions).
F3D_HD void miss_radiance(const PolarArgs& p, float t, float Q, float* rgb) {
    if (p.env_rgb == nullptr) {
        rgb[0] = rgb[1] = rgb[2] = p.env_intensity;
        return;
    }
    float inv_sec = 1.0f / sqrtf(1.0f + t * t);
    float q = Q * inv_sec;
    float hx = (p.ev0 + t * p.eu0) * inv_sec;
    float hz = (p.ev2 + t * p.eu2) * inv_sec;
    float inv = 1.0f / sqrtf(1.0f + q * q);
    float dx = hx * inv, dy = q * inv, dz = hz * inv;
    float n = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
    float nxd = dx * n, nyd = dy * n, nzd = dz * n;
    float uu = atan2f(nzd, nxd) / (2.0f * F3D_PI) + 0.5f;
    float vv = acosf(fminf(fmaxf(nyd, -1.0f), 1.0f)) / F3D_PI;
    int px = imin((int)(uu * (float)p.env_w), p.env_w - 1);
    int py = imin((int)(vv * (float)p.env_h), p.env_h - 1);
    const float* tex = p.env_rgb + 3 * (py * p.env_w + px);
    for (int c = 0; c < 3; ++c) rgb[c] = tex[c] * p.env_intensity;
}

// The soft crossing indicator of synthesize_polar at profile row k, for
// running maxima M (K rows) and row tangent Q.
F3D_HD float crossing_alpha(const float* M, int K, int k, float Q) {
    float m = M[k];
    float mn = M[k + 1 < K ? k + 1 : K - 1];
    float rden = 1.0f / fmaxf(mn - m, 1e-9f);
    return fminf(fmaxf((mn - Q) * rden, 0.0f), 1.0f);
}

// synthesize_polar's contraction for one (e, a): sum_k (alpha[k] -
// alpha[k-1]) * v[k] over C channels, and hit_any = alpha[K-1].
// m_next[k] = M[k+1] is non-decreasing, so alpha is 0 exactly up to the
// first row k* with m_next[k*] > Q (found by binary search) and reaches 1
// within a row or two after it: the walk from k* stops at the first row
// whose alpha is 1. Rows after it differ from 1 by at most an ulp of a
// ratio that is > 1 exactly, which the dense form sums as well; those are
// dropped. Plateaus (M[k+1] - M[k] < 1e-9) take the 1e9 reciprocal as in
// the dense form and are walked through.
F3D_HD float crossing(const float* M, const float* v, int stride, int C, int K, float Q,
                      float* out) {
    for (int c = 0; c < C; ++c) out[c] = 0.0f;
    int lo = 0, hi = K;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        float mn = M[mid + 1 < K ? mid + 1 : K - 1];
        if (mn > Q) hi = mid;
        else lo = mid + 1;
    }
    float prev = 0.0f;
    for (int k = lo; k < K; ++k) {
        float a = crossing_alpha(M, K, k, Q);
        if (a != prev) {
            float d = a - prev;
            for (int c = 0; c < C; ++c) out[c] += d * v[(size_t)k * stride + c];
        }
        prev = a;
        if (a >= 1.0f) break;
    }
    return crossing_alpha(M, K, K - 1, Q);
}

// One polar texel (e, a) of the frame: the first-crossing lerp, the miss
// blend and the phantom rule; adds the 9 channels into acc.
F3D_HD void polar_row(const PolarArgs& p, const float* M, const float* v, int a, int e,
                      float t, float h_ent, float s_ent, float* acc) {
    float Q = q_row(p, e);
    float out[9];
    float hit = crossing(M, v, 9, 9, p.K, Q, out);
    float omh = 1.0f - hit;
    float z_ray = p.cam_y + Q * s_ent;
    bool phantom = out[8] > 0.98f && z_ray < h_ent - p.eps;
    float miss[3] = {0.0f, 0.0f, 0.0f};
    if (omh != 0.0f || phantom) miss_radiance(p, t, Q, miss);
    float* dst = acc + ((size_t)e * p.A + a) * 9;
    for (int c = 0; c < 9; ++c) {
        float m = c < 3 ? miss[c] : 0.0f;
        float r = phantom ? m : out[c] + omh * m;
        dst[c] += r;
    }
}

// ---------------------------------------------------------------------------
// K4: screen warp, AOV finalize and packing, per pixel
// ---------------------------------------------------------------------------

struct ResolveArgs {
    int A, E, row_ss, width, height;
    float hw, t_lo, t_step, n_frames;  // n_frames: float32 frame count
    double fv, uvhh, y_step;                 // the warp's tables are built in double
};

// One polar row's azimuth resample at pixel x with ss sub-positions, for
// channels [c0, c0 + C) of the mean polar image (acc / n_frames).
F3D_HD void warp_row(const ResolveArgs& r, const float* acc, int row, int x, int ss, int c0,
                     int C, float* out) {
    double ndc = 1.0 - ((double)row + 0.5) * r.y_step;
    double cvd = r.fv + ndc * r.uvhh;
    float cv = (float)(cvd > 0.02 ? cvd : 0.02);
    float hwc = r.hw / cv;
    float af[2];
    for (int s = 0; s < ss; ++s) {
        double sub = ((double)s + 0.5) / ss;
        float ndc_x = (float)((((double)x + sub) / r.width) * 2.0 - 1.0);
        float tanb = ndc_x * hwc;
        float a_f = (tanb - r.t_lo) / r.t_step - 0.5f;
        af[s] = fminf(fmaxf(a_f, 0.0f), (float)r.A - 1.0f);
    }
    for (int c = 0; c < C; ++c) out[c] = 0.0f;
    int a_lo = (int)floorf(af[0]);
    int a_hi = (int)floorf(af[ss - 1]) + 1;
    if (a_hi > r.A - 1) a_hi = r.A - 1;
    float inv_ss = 1.0f / (float)ss;
    for (int a = a_lo; a <= a_hi; ++a) {
        float w = 0.0f;
        for (int s = 0; s < ss; ++s) w += fmaxf(0.0f, 1.0f - fabsf(af[s] - (float)a));
        w = w * inv_ss;
        if (w == 0.0f) continue;
        const float* src = acc + ((size_t)row * r.A + a) * 9 + c0;
        for (int c = 0; c < C; ++c) out[c] += w * (src[c] / r.n_frames);
    }
}

// float32 -> float16 bits, round to nearest even; NaN -> 0x7E00 | sign
// (the bits numpy, PyTorch and XLA give for a positive NaN).
F3D_HD uint16_t f32_to_f16_bits(float f) {
    union {
        float f;
        uint32_t u;
    } v, magic;
    v.f = f;
    uint32_t sign = v.u & 0x80000000u;
    v.u ^= sign;
    uint16_t o;
    if (v.u >= (uint32_t)(127 + 16) << 23) {
        o = v.u > 0x7f800000u ? 0x7e00 : 0x7c00;
    } else if (v.u < (uint32_t)113 << 23) {
        magic.u = (uint32_t)((127 - 15) + (23 - 10) + 1) << 23;
        v.f += magic.f;
        o = (uint16_t)(v.u - magic.u);
    } else {
        uint32_t mant_odd = (v.u >> 13) & 1u;
        v.u += ((uint32_t)(15 - 127) << 23) + 0xfffu;
        v.u += mant_odd;
        o = (uint16_t)(v.u >> 13);
    }
    return (uint16_t)(o | (sign >> 16));
}

F3D_HD float signf0(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

F3D_HD unsigned char to_u8(float x) {
    return (unsigned char)(int)fminf(fmaxf(x, 0.0f), 255.0f);
}

// Pixel (x, y): box average of row_ss warped rows, then resolve_impl's
// finalize; writes vis u8, octahedral normal u8x2, depth f16 bytes and
// RGBE u8x4 into the packed buffer.
F3D_HD void resolve_pixel(const ResolveArgs& r, const float* acc, int x, int y,
                          unsigned char* out) {
    float hdr[3] = {0.0f, 0.0f, 0.0f}, aov[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < r.row_ss; ++i) {
        float b[3], o[5];
        warp_row(r, acc, y * r.row_ss + i, x, 2, 0, 3, b);
        warp_row(r, acc, y * r.row_ss + i, x, 1, 3, 5, o);
        for (int c = 0; c < 3; ++c) hdr[c] += b[c];
        for (int c = 0; c < 5; ++c) aov[c] += o[c];
    }
    for (int c = 0; c < 3; ++c) hdr[c] = hdr[c] / (float)r.row_ss;
    for (int c = 0; c < 5; ++c) aov[c] = aov[c] / (float)r.row_ss;

    const size_t hw = (size_t)r.width * r.height;
    const size_t i = (size_t)y * r.width + x;
    float vis = aov[4];
    bool hitm = vis >= 0.5f;
    float n[3] = {aov[1], aov[2], aov[3]};
    float nlen = sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (hitm) {
        float d = fmaxf(nlen, 1e-9f);
        for (int c = 0; c < 3; ++c) n[c] = n[c] / d;
    } else {
        n[0] = 0.0f;
        n[1] = 1.0f;
        n[2] = 0.0f;
    }
    float s1 = fabsf(n[0]) + fabsf(n[1]) + fabsf(n[2]);
    float px = n[0] / s1, pz = n[2] / s1;
    bool neg = n[1] < 0.0f;
    float fx = neg ? (1.0f - fabsf(pz)) * signf0(px) : px;
    float fz = neg ? (1.0f - fabsf(px)) * signf0(pz) : pz;
    out[hw + 2 * i + 0] = to_u8((fx * 0.5f + 0.5f) * 255.0f + 0.5f);
    out[hw + 2 * i + 1] = to_u8((fz * 0.5f + 0.5f) * 255.0f + 0.5f);
    uint16_t d16 = hitm ? f32_to_f16_bits(fminf(aov[0] / fmaxf(vis, 1e-6f), 6.0e4f)) : 0x7e00;
    out[3 * hw + 2 * i + 0] = (unsigned char)(d16 & 0xff);
    out[3 * hw + 2 * i + 1] = (unsigned char)(d16 >> 8);
    out[i] = to_u8(vis * 255.0f + 0.5f);
    float m = fmaxf(fmaxf(hdr[0], hdr[1]), hdr[2]);
    int ex;
    frexpf(fmaxf(m, 1e-30f), &ex);
    float scale = ldexpf(1.0f, 8 - ex);
    unsigned char* rgbe = out + 5 * hw + 4 * i;
    bool live = m > 1e-30f;
    for (int c = 0; c < 3; ++c) rgbe[c] = live ? to_u8(floorf(hdr[c] * scale)) : 0;
    int eb = ex + 128;
    rgbe[3] = live ? (unsigned char)(eb < 0 ? 0 : (eb > 255 ? 255 : eb)) : 0;
}
