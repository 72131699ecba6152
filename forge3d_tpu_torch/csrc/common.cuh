// forge3d_tpu_torch/csrc/common.cuh
// Per-thread device code of the terrain path tracer, shared by the
// kernels in kernels.cu: the xorshift32 stream, tent jitter, camera rays,
// the slab test, the bilinear patch, the exact leaf solve, the stackless
// max-mip DDA (`trace_ray`), `normal_at`, shading, the ReSTIR reservoir
// steps, and the frame and G-buffer bodies, which also trace a mesh
// (mesh.cuh) and sample typed lights (lights.cuh) when the scene has them.
//
// Every function computes what its JAX counterpart computes, operation for
// operation and in float32, so that with contraction off (-fmad=false) the
// kernels agree with the plain PyTorch versions beside them. Names of the
// JAX functions are given at each function.
//
// The functions are __host__ __device__ so that the same bodies can be
// compiled for a CPU harness; nothing in the port depends on that.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define F3D_HD __host__ __device__ __forceinline__
#else
#define F3D_HD inline
#endif

#include "lights.cuh"  // K10: typed-light sampling, folded into K6
#include "mesh.cuh"    // K9: the mesh BVH walk, folded into K6 and K8

// ---------------------------------------------------------------------------
// Argument blocks (mirrored by ctypes structures in _kernels.py)
// ---------------------------------------------------------------------------

struct SceneArgs {
    const float* h_pair;       // (dem_h*dem_w, 2): (h[i], h[i+1 in row])
    const float* mm_pack;      // (total, 2): (min, max) per pyramid texel
    const int* level_offset;   // (mip_count,)
    const int* level_w;        // (mip_count,)
    int dem_w, cell_w, cell_h, mip_count, max_iters;
    float ox, oz, sx, sz, ex;  // origin_xz, spacing_xz, exaggeration
};

struct ResArgs {  // SoA reservoirs, field order of ops/restir.py:Reservoirs
    float* dir_x;
    float* dir_y;
    float* dir_z;
    float* intensity;
    int* light_type;
    int* light_index;
    float* w_sum;
    int* m;
    float* weight;
    float* target_pdf;
};

struct FrameArgs {
    const float* env_rgb;  // (env_h, env_w, 3) or null for constant white
    int width, height, spp, env_w, env_h, shadows, restir;
    uint32_t frame_index, seed_hi, seed_lo;
    float cam_o[3], right[3], up[3], fwd[3];
    float half_w, half_h;
    float sun[3];
    float alb[3];    // float32(albedo)
    float alc[3];    // float32(albedo * sun_intensity * sun_color), rounded once
    float lum_lc;    // luminance of float32(sun_intensity * sun_color)
    float env_intensity;
    float inv_spp;   // float32(1 / spp)
    float lc[3];     // float32(sun_intensity * sun_color): with a mesh, the
                     // albedo is a float32 per pixel and multiplies this
    int row0, rows;  // the band of rows the launch covers (0, height: the frame)
};

struct Hit {
    int hit;
    float t;
    int cell_x, cell_z;
};

struct Res {
    float dir_x, dir_y, dir_z, intensity;
    int light_type, light_index;
    float w_sum;
    int m;
    float weight, target_pdf;
};

#define F3D_EPS_CELL (1.0f / 4096.0f)  // traversal.py:_EPS_CELL = 2**-12
#define F3D_PI 3.14159265358979323846f
#define F3D_M_CAP 512                  // restir.py:M_CAP
#define F3D_WELFORD_WINDOW 32u         // terrain_ref.py:WELFORD_WINDOW

#ifdef __CUDACC__
// A kernel's build on this card, for the attrs entry points: out =
// {registers a thread, local (spilled) bytes a thread, resident blocks of
// `threads` an SM}
inline int f3d_kernel_attrs(const void* fn, int threads, int* out) {
    cudaFuncAttributes at;
    cudaError_t e = cudaFuncGetAttributes(&at, fn);
    if (e != cudaSuccess) return (int)e;
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, threads, 0);
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = resident;
    return (int)e;
}
#endif

F3D_HD int imin(int a, int b) { return a < b ? a : b; }
F3D_HD int imax(int a, int b) { return a > b ? a : b; }
F3D_HD float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

F3D_HD float qnan() {
#ifdef __CUDA_ARCH__
    return __int_as_float(0x7fc00000);
#else
    return NAN;
#endif
}

// Read-only pair load: one 8-byte load through the non-coherent cache on
// the card.
F3D_HD void ld2(const float* p, int i, float& a, float& b) {
#ifdef __CUDA_ARCH__
    float2 v = __ldg(reinterpret_cast<const float2*>(p) + i);
    a = v.x;
    b = v.y;
#else
    a = p[2 * i];
    b = p[2 * i + 1];
#endif
}

// ---------------------------------------------------------------------------
// RNG (ops/rng.py)
// ---------------------------------------------------------------------------

F3D_HD uint32_t xorshift32(uint32_t x, float& u) {
    x ^= x << 13;
    x ^= x >> 17;
    x ^= x << 5;
    u = (float)x / 4294967296.0f;  // rounds to 1.0 for x >= 0xFFFFFF80, as in JAX
    return x;
}

F3D_HD float tent_offset(float u) {
    float lo = sqrtf(2.0f * u) - 1.0f;
    float hi = 1.0f - sqrtf(fmaxf(2.0f * (1.0f - u), 0.0f));
    return u < 0.5f ? lo : hi;
}

// ---------------------------------------------------------------------------
// Shading (ops/shading.py)
// ---------------------------------------------------------------------------

F3D_HD float luminance(float r, float g, float b) {
    return 0.2126f * r + 0.7152f * g + 0.0722f * b;
}

F3D_HD void cosine_dir(float nx, float ny, float nz, float u1, float u2,
                       float& dx, float& dy, float& dz) {
    float sign = nz < 0.0f ? -1.0f : 1.0f;
    float a = -1.0f / (sign + nz);
    float b = nx * ny * a;
    float tx = 1.0f + sign * nx * nx * a;
    float ty = sign * b;
    float tz = -sign * nx;
    float bx = b;
    float by = sign + ny * ny * a;
    float bz = -ny;
    float r = sqrtf(u1);
    float phi = (2.0f * F3D_PI) * u2;
    float lx = r * cosf(phi);
    float ly = r * sinf(phi);
    float lz = sqrtf(fmaxf(0.0f, 1.0f - u1));
    float x = lx * tx + ly * bx + lz * nx;
    float y = lx * ty + ly * by + lz * ny;
    float z = lx * tz + ly * bz + lz * nz;
    float inv = 1.0f / sqrtf(x * x + y * y + z * z);
    dx = x * inv;
    dy = y * inv;
    dz = z * inv;
}

// Equirect nearest-texel lookup of a bound (env_h, env_w, 3) map by
// direction, scaled by the intensity.
F3D_HD void env_lookup(const float* env_rgb, int env_w, int env_h, float intensity,
                       float dx, float dy, float dz, float& r, float& g, float& b) {
    float inv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
    float nxd = dx * inv, nyd = dy * inv, nzd = dz * inv;
    float uu = atan2f(nzd, nxd) / (2.0f * F3D_PI) + 0.5f;
    float vv = acosf(fminf(fmaxf(nyd, -1.0f), 1.0f)) / F3D_PI;
    int px = imin((int)(uu * (float)env_w), env_w - 1);
    int py = imin((int)(vv * (float)env_h), env_h - 1);
    int flat = py * env_w + px;
    r = env_rgb[3 * flat + 0] * intensity;
    g = env_rgb[3 * flat + 1] * intensity;
    b = env_rgb[3 * flat + 2] * intensity;
}

F3D_HD void env_radiance(const FrameArgs& f, float dx, float dy, float dz,
                         float& r, float& g, float& b) {
    if (f.env_rgb == nullptr) {
        r = g = b = f.env_intensity;
        return;
    }
    env_lookup(f.env_rgb, f.env_w, f.env_h, f.env_intensity, dx, dy, dz, r, g, b);
}

// terrain_ref.py:_camera_rays for one pixel and jitter.
F3D_HD void camera_ray(const FrameArgs& f, int x, int y, float jx, float jy,
                       float& dx, float& dy, float& dz) {
    float ndc_x = (((float)x + 0.5f + jx) / (float)f.width) * 2.0f - 1.0f;
    float ndc_y = (1.0f - ((float)y + 0.5f + jy) / (float)f.height) * 2.0f - 1.0f;
    float cx = ndc_x * f.half_w;
    float cy = ndc_y * f.half_h;
    float inv = 1.0f / sqrtf(cx * cx + cy * cy + 1.0f);
    cx = cx * inv;
    cy = cy * inv;
    float mcz = inv;  // -cz, with cz = -1 * inv
    float x3 = cx * f.right[0] + cy * f.up[0] + mcz * f.fwd[0];
    float y3 = cx * f.right[1] + cy * f.up[1] + mcz * f.fwd[1];
    float z3 = cx * f.right[2] + cy * f.up[2] + mcz * f.fwd[2];
    float inv2 = 1.0f / sqrtf(x3 * x3 + y3 * y3 + z3 * z3);
    dx = x3 * inv2;
    dy = y3 * inv2;
    dz = z3 * inv2;
}

// ---------------------------------------------------------------------------
// Traversal (ops/traversal.py) -- kernel K5's body
// ---------------------------------------------------------------------------

F3D_HD float safe_inv(float d) {
    float ad = fmaxf(fabsf(d), 1e-12f);
    return d < 0.0f ? -1.0f / ad : 1.0f / ad;
}

F3D_HD void slab_xz(float rox, float roz, float inv_dx, float inv_dz,
                    float x0, float x1, float z0, float z1,
                    float& t_enter, float& t_exit) {
    float tx0 = (x0 - rox) * inv_dx;
    float tx1 = (x1 - rox) * inv_dx;
    float tz0 = (z0 - roz) * inv_dz;
    float tz1 = (z1 - roz) * inv_dz;
    t_enter = fmaxf(fminf(tx0, tx1), fminf(tz0, tz1));
    t_exit = fminf(fmaxf(tx0, tx1), fmaxf(tz0, tz1));
}

F3D_HD float bilinear_h(float h00, float h10, float h01, float h11, float u, float v) {
    return (h00 * (1.0f - u) + h10 * u) * (1.0f - v) + (h01 * (1.0f - u) + h11 * u) * v;
}

// Exaggerated corner heights of DEM cell (cx, cz): two pair loads.
F3D_HD void cell_heights(const SceneArgs& s, int cx, int cz,
                         float& h00, float& h10, float& h01, float& h11) {
    int base = cz * s.dem_w + cx;
    float a, b, c, d;
    ld2(s.h_pair, base, a, b);
    ld2(s.h_pair, base + s.dem_w, c, d);
    h00 = a * s.ex;
    h10 = b * s.ex;
    h01 = c * s.ex;
    h11 = d * s.ex;
}

struct Patch {
    float h00, h10, h01, h11, cxf, czf;
};

// Whether spacing s is a power of two whose reciprocal is a normal float:
// then 1 / s is exact, and x / s and x * (1 / s) round the same real number
// once, so they give the same bits.
F3D_HD bool pow2_spacing(float s) {
    uint32_t b;
    memcpy(&b, &s, sizeof(b));
    const uint32_t e = b >> 23;   // the sign bit clear, the exponent 1 .. 253
    return (b & 0x7FFFFFu) == 0u && e >= 1u && e <= 253u;
}

// World offsets to cell units, d / s: an IEEE division, or with kPow2 (both
// spacings pow2_spacing) a multiply by the exact reciprocal, the same bits.
template <bool kPow2>
struct CellMap {
    float sx, sz, rsx, rsz;
    F3D_HD explicit CellMap(const SceneArgs& s)
        : sx(s.sx), sz(s.sz), rsx(kPow2 ? 1.0f / s.sx : 0.0f), rsz(kPow2 ? 1.0f / s.sz : 0.0f) {}
    F3D_HD float x(float d) const { return kPow2 ? d * rsx : d / sx; }
    F3D_HD float z(float d) const { return kPow2 ? d * rsz : d / sz; }
};

template <bool kPow2>
F3D_HD float patch_dev(const SceneArgs& s, const CellMap<kPow2>& cm, const Patch& p, float rox,
                       float roy, float roz, float rdx, float rdy, float rdz, float t) {
    float px = rox + t * rdx;
    float pz = roz + t * rdz;
    float u = clamp01(cm.x(px - s.ox) - p.cxf);
    float v = clamp01(cm.z(pz - s.oz) - p.czf);
    return (roy + t * rdy) - bilinear_h(p.h00, p.h10, p.h01, p.h11, u, v);
}

// traversal.py:_leaf_intersect: the ray's height above the patch is
// quadratic in t; fit it through t0, the midpoint and t1 and take the first
// root in [0, 1] (Citardauq form), with a linear fallback.
template <bool kPow2>
F3D_HD bool leaf_intersect(const SceneArgs& s, const CellMap<kPow2>& cm, float rox, float roy,
                           float roz, float rdx, float rdy, float rdz, int cx, int cz,
                           float t0, float t1, float tmin, float tmax, float& t_out) {
    Patch p;
    cell_heights(s, cx, cz, p.h00, p.h10, p.h01, p.h11);
    p.cxf = (float)cx;
    p.czf = (float)cz;
    float tm = 0.5f * (t0 + t1);
    float d0 = patch_dev(s, cm, p, rox, roy, roz, rdx, rdy, rdz, t0);
    float dm = patch_dev(s, cm, p, rox, roy, roz, rdx, rdy, rdz, tm);
    float d1 = patch_dev(s, cm, p, rox, roy, roz, rdx, rdy, rdz, t1);

    float c = d0;
    float a = 2.0f * d1 + 2.0f * d0 - 4.0f * dm;
    float b = d1 - d0 - a;

    bool b_big = fabsf(b) > 1e-12f;
    float s_lin = -c / (b_big ? b : 1.0f);
    bool lin_ok = b_big && (s_lin >= 0.0f) && (s_lin <= 1.0f);

    float disc = b * b - 4.0f * a * c;
    float sq = sqrtf(fmaxf(disc, 0.0f));
    float q = -0.5f * (b + (b >= 0.0f ? sq : -sq));
    float safe_a = fabsf(a) < 1e-12f ? 1.0f : a;
    float r0 = q / safe_a;
    bool q_small = fabsf(q) < 1e-30f;
    float r1 = q_small ? 1e30f : c / q;
    float rlo = fminf(r0, r1);
    float rhi = fmaxf(r0, r1);
    float s_quad = (rlo >= 0.0f && rlo <= 1.0f) ? rlo
                   : ((rhi >= 0.0f && rhi <= 1.0f) ? rhi : 1e30f);
    bool quad_ok = (disc >= 0.0f) && (s_quad <= 1.0f);

    bool is_lin = fabsf(a) < 1e-12f;
    float s_hit = is_lin ? (lin_ok ? s_lin : 1e30f) : (quad_ok ? s_quad : 1e30f);
    float t_hit = t0 + s_hit * (t1 - t0);
    t_out = t_hit;
    return (s_hit <= 1.0f) && (t_hit > tmin) && (t_hit < tmax);
}

// The pyramid's level table in registers. ops/pyramid.py:build_minmax_levels
// pads level 0 to power-of-two dims (2^wlog, 2^hlog) and halves each to 1,
// so level L is 2^max(wlog - L, 0) texels wide and 2^max(hlog - L, 0) high,
// flattened finest first. A node's row is then a shift, and the offset of
// the DDA's level moves by one level's texel count when it descends or
// coarsens: the step addresses mm_pack from registers, with no load of the
// level table on its chain. ops/traversal.py:check_level_layout holds a
// scene's tables to this layout.
F3D_HD int pow2_log(int x) {   // log2 of the power of two >= x (1 for x <= 1)
#ifdef __CUDA_ARCH__
    return x <= 1 ? 0 : 32 - __clz(x - 1);
#else
    return x <= 1 ? 0 : 32 - __builtin_clz((unsigned)(x - 1));
#endif
}

struct LevelCursor {
    int wlog, hlog;   // level 0's padded width and height, log2
    int off;          // the flat index of the current level's texel (0, 0)

    // at the top level, top = max(wlog, hlog): the texels of the levels
    // below it, sum over L < top of 2^(max(wlog - L, 0) + max(hlog - L, 0)),
    // in closed form: with a >= b the two logs, (4^(b+1) - 4) / 3 * 2^(a-b)
    // over the levels where both halve and 2^(a-b+1) - 2 over the rest
    F3D_HD LevelCursor(int cell_w, int cell_h) : wlog(pow2_log(cell_w)), hlog(pow2_log(cell_h)) {
        const int a = imax(wlog, hlog), b = imin(wlog, hlog);
        const uint32_t fours = b > 0 ? 0x55555555u >> (32 - 2 * b) : 0u;   // (4^b - 1) / 3
        off = (int)(((fours << 2) << (a - b)) + (2u << (a - b)) - 2u);
    }
    F3D_HD int texels_log(int level) const {
        return imax(wlog - level, 0) + imax(hlog - level, 0);
    }
    // node (nx, nz) of `level`: level_offset[level] + nz * level_w[level] + nx
    F3D_HD int node(int level, int nx, int nz) const {
        return off + (nz << imax(wlog - level, 0)) + nx;
    }
    F3D_HD void down(int level) { off -= 1 << texels_log(level - 1); }   // to level - 1
    F3D_HD void up(int level) { off += 1 << texels_log(level); }         // to level + 1
};

// traversal.py:trace for one ray: a stackless front-to-back max-mip DDA.
// Each step probes the node containing t + eps, tests the ray's height
// span over the node against the node's [min, max] band, then descends one
// level (band overlap, inner node), solves the leaf patch (band overlap,
// leaf), or advances past the node and coarsens one level. The JAX version
// steps all rays in lock step under one global `max_iters` cap and freezes
// rays that are done; a per-thread loop with the same cap gives the same
// per-ray result. K5's instantiations: kLevelRegs, the node's flat index
// from a LevelCursor instead of the level table in device memory, and
// kPow2, the cell coordinates by multiplies where both spacings are
// pow2_spacing (CellMap). The other kernels take neither: with the cursor
// in trace_ray, K6 spilled 72 B a thread against 56 and ran 4% slower, K6
// hybrid rose from 97 to 104 registers and 2% slower, P3 5% and R1 render
// 2% slower (PERF.md §6). Each gives the same index and the same bits, so
// the same visits and the same result.
template <bool kLevelRegs, bool kPow2>
F3D_HD Hit trace_ray_t(const SceneArgs& s, float rox, float roy, float roz,
                       float rdx, float rdy, float rdz, float tmin, float tmax) {
    Hit h;
    h.hit = 0;
    h.t = tmax;
    h.cell_x = 0;
    h.cell_z = 0;
    const int cw = s.cell_w, ch = s.cell_h, top = s.mip_count - 1;
    const float inv_dx = safe_inv(rdx);
    const float inv_dz = safe_inv(rdz);
    float dom_enter, dom_exit;
    slab_xz(rox, roz, inv_dx, inv_dz, s.ox, s.ox + (float)cw * s.sx,
            s.oz, s.oz + (float)ch * s.sz, dom_enter, dom_exit);
    float t = fmaxf(dom_enter, tmin);
    const float t_exit = fminf(dom_exit, tmax);
    const float lat = fmaxf(fabsf(rdx) / s.sx, fabsf(rdz) / s.sz);
    const float eps_t = F3D_EPS_CELL / fmaxf(lat, 1e-8f);
    if (t > t_exit) return h;
    int level = top;
    LevelCursor lc(kLevelRegs ? cw : 1, kLevelRegs ? ch : 1);
    const CellMap<kPow2> cm(s);
    for (int it = 0; it < s.max_iters; ++it) {
        float pt = t + eps_t;
        float px = rox + pt * rdx;
        float pz = roz + pt * rdz;
        int cx = (int)fminf(fmaxf(floorf(cm.x(px - s.ox)), 0.0f), (float)(cw - 1));
        int cz = (int)fminf(fmaxf(floorf(cm.z(pz - s.oz)), 0.0f), (float)(ch - 1));
        int nx = cx >> level;
        int nz = cz >> level;
        // node bounds, clamped to the logical domain at ragged edges
        float bx0 = (float)(nx << level);
        float bx1 = (float)imin((nx + 1) << level, cw);
        float bz0 = (float)(nz << level);
        float bz1 = (float)imin((nz + 1) << level, ch);
        float nt0, nt1;
        slab_xz(rox, roz, inv_dx, inv_dz, s.ox + bx0 * s.sx, s.ox + bx1 * s.sx,
                s.oz + bz0 * s.sz, s.oz + bz1 * s.sz, nt0, nt1);
        nt0 = fmaxf(nt0, fmaxf(t, tmin));
        nt1 = fminf(nt1, t_exit);

        int flat = kLevelRegs ? lc.node(level, nx, nz)
                              : s.level_offset[level] + nz * s.level_w[level] + nx;
        float mn, mx;
        ld2(s.mm_pack, flat, mn, mx);
        float bmin = mn * s.ex;
        float bmax = mx * s.ex;
        float ya = roy + nt0 * rdy;
        float yb = roy + nt1 * rdy;
        bool band = (nt0 <= nt1) && !(fminf(ya, yb) > bmax) && !(fmaxf(ya, yb) < bmin);

        if (band && level > 0) {  // descend
            if (kLevelRegs) lc.down(level);
            level -= 1;
            continue;
        }
        if (band) {  // banded leaf
            float th;
            if (leaf_intersect(s, cm, rox, roy, roz, rdx, rdy, rdz, cx, cz, nt0, nt1,
                               tmin, tmax, th)) {
                h.hit = 1;
                h.t = th;
                h.cell_x = cx;
                h.cell_z = cz;
                return h;
            }
        }
        // advance past the node, at least eps_t, and coarsen
        float new_t = fmaxf(nt1, t + eps_t);
        if (kLevelRegs && level < top) lc.up(level);
        level = imin(level + 1, top);
        t = new_t;
        if (new_t >= t_exit) return h;
    }
    return h;
}

F3D_HD Hit trace_ray(const SceneArgs& s, float rox, float roy, float roz,
                     float rdx, float rdy, float rdz, float tmin, float tmax) {
    return trace_ray_t<false, false>(s, rox, roy, roz, rdx, rdy, rdz, tmin, tmax);
}

// traversal.py:normal_at: analytic bilinear gradient at (px, pz) in a cell.
F3D_HD void normal_at(const SceneArgs& s, float px, float pz, int cx, int cz,
                      float& nx, float& ny, float& nz) {
    float h00, h10, h01, h11;
    cell_heights(s, cx, cz, h00, h10, h01, h11);
    float u = clamp01((px - s.ox) / s.sx - (float)cx);
    float v = clamp01((pz - s.oz) / s.sz - (float)cz);
    float dh_du = (h10 - h00) * (1.0f - v) + (h11 - h01) * v;
    float dh_dv = (h01 - h00) * (1.0f - u) + (h11 - h10) * u;
    float x = -dh_du / s.sx;
    float y = 1.0f;
    float z = -dh_dv / s.sz;
    float inv = 1.0f / sqrtf(x * x + y * y + z * z);
    nx = x * inv;
    ny = y * inv;
    nz = z * inv;
}

// ---------------------------------------------------------------------------
// ReSTIR reservoirs (ops/restir.py)
// ---------------------------------------------------------------------------

F3D_HD Res load_res(const ResArgs& r, int i) {
    Res v;
    v.dir_x = r.dir_x[i];
    v.dir_y = r.dir_y[i];
    v.dir_z = r.dir_z[i];
    v.intensity = r.intensity[i];
    v.light_type = r.light_type[i];
    v.light_index = r.light_index[i];
    v.w_sum = r.w_sum[i];
    v.m = r.m[i];
    v.weight = r.weight[i];
    v.target_pdf = r.target_pdf[i];
    return v;
}

F3D_HD void store_res(const ResArgs& r, int i, const Res& v) {
    r.dir_x[i] = v.dir_x;
    r.dir_y[i] = v.dir_y;
    r.dir_z[i] = v.dir_z;
    r.intensity[i] = v.intensity;
    r.light_type[i] = v.light_type;
    r.light_index[i] = v.light_index;
    r.w_sum[i] = v.w_sum;
    r.m[i] = v.m;
    r.weight[i] = v.weight;
    r.target_pdf[i] = v.target_pdf;
}

F3D_HD bool res_valid(const Res& r) {
    return r.m > 0 && r.weight > 0.0f && r.target_pdf > 0.0f;
}

// restir.py:m_clamp
F3D_HD Res m_clamp(Res r) {
    bool over = r.m > F3D_M_CAP;
    float scale = over ? (float)F3D_M_CAP / fmaxf((float)r.m, 1.0f) : 1.0f;
    r.w_sum = r.w_sum * scale;
    int m = over ? F3D_M_CAP : r.m;
    if (over && r.target_pdf > 0.0f) r.weight = r.w_sum / ((float)m * r.target_pdf);
    r.m = m;
    return r;
}

// restir.py:temporal_merge
F3D_HD Res temporal_merge(const Res& prev, const Res& curr) {
    bool pv = res_valid(prev);
    bool cv = res_valid(curr);
    if (!(pv && cv)) return pv ? prev : curr;
    Res out = prev.weight > curr.weight ? prev : curr;
    int m = prev.m + curr.m;
    float w_sum = prev.w_sum + curr.w_sum;
    float tp = out.target_pdf;
    out.weight = (w_sum > 0.0f && tp > 0.0f) ? w_sum / ((float)m * fmaxf(tp, 1e-30f)) : 0.0f;
    out.w_sum = w_sum;
    out.m = m;
    return out;
}

// K7's view of a candidate reservoir: what restir.py:spatial_reuse.consider
// reads of it, formed once a candidate. `inv` is consider's 1/|dir|; `w` is
// its weight before the receiver's facing test (the light directional and
// target_pdf > 0: p_curr 1, w_sum * (1 / max(target_pdf, 1e-6)); else 0),
// so consider's operations run as they did, each on the same operands.
struct Cand {
    float dx, dy, dz, inv, w;
    int m;
};

F3D_HD Cand spatial_cand(const ResArgs& r, int i) {
    Cand c;
    c.dx = r.dir_x[i];
    c.dy = r.dir_y[i];
    c.dz = r.dir_z[i];
    c.inv = 1.0f / sqrtf(c.dx * c.dx + c.dy * c.dy + c.dz * c.dz + 1e-30f);
    const float tp = r.target_pdf[i];
    c.w = (r.light_type[i] == 1 && tp > 0.0f) ? r.w_sum[i] * (1.0f / fmaxf(tp, 1e-6f)) : 0.0f;
    c.m = r.m[i];
    return c;
}

// restir.py:spatial_reuse.consider -- streaming RIS with one directional
// light: selection pdf 1, gated by the receiver facing the sample. Adds the
// candidate's weight into w_acc, draws from the stream, and returns whether
// the candidate is chosen (its pdf is then 1).
F3D_HD bool consider(float& w_acc, uint32_t& seed, const Cand& c, float gx, float gy, float gz) {
    float cosr = gx * c.dx * c.inv + gy * c.dy * c.inv + gz * c.dz * c.inv;
    float w = cosr > 0.0f ? c.w : 0.0f;
    bool take = w > 0.0f;
    w_acc = w_acc + (take ? w : 0.0f);
    float u;
    seed = xorshift32(seed, u);
    return take && (u < w / fmaxf(w_acc, 1e-30f));
}

// K6's and K7's tiles: a block takes a 16x16 tile of the band, a warp 8x4
// pixels. Thread t of block b covers band pixel (x, y) of the tile whose
// corner is (x0, y0); `inside` is false past the band.
#define F3D_TILE 16

struct TilePixel {
    int x0, y0, x, y;
    bool inside;
};

F3D_HD int tile_blocks(int width, int rows) {
    return ((width + F3D_TILE - 1) / F3D_TILE) * ((rows + F3D_TILE - 1) / F3D_TILE);
}

F3D_HD TilePixel tile_pixel(int width, int rows, int b, int t) {
    const int tiles_x = (width + F3D_TILE - 1) / F3D_TILE;
    const int lane = t & 31, warp = t >> 5;
    TilePixel p;
    p.x0 = (b % tiles_x) * F3D_TILE;
    p.y0 = (b / tiles_x) * F3D_TILE;
    p.x = p.x0 + (warp & 1) * 8 + (lane & 7);
    p.y = p.y0 + (warp >> 1) * 4 + (lane >> 3);
    p.inside = p.x < width && p.y < rows;
    return p;
}

// K7's window, staged: the candidates of a tile and its `radius`-wide
// halo, span x span entries (span = F3D_TILE + 2 radius) as
// structure-of-arrays (in shared memory on the card). Entry (sx, sy) holds
// the pixel at the clamped frame coordinate (x0 + sx, y0 + sy): the one
// spatial_reuse reads for a tap there, so a tap reads its entry with no
// clamp. Which radii are staged is the caller's choice
// (ops/restir.py:kernel_instance).
struct TileWindow {
    float *dx, *dy, *dz, *inv, *w;
    int* m;
    int span, x0, y0;

    F3D_HD static int floats(int radius) {
        const int span = F3D_TILE + 2 * radius;
        return 6 * span * span;
    }
    // over `buf` of floats(radius) floats (the m field as int)
    F3D_HD TileWindow(float* buf, int radius, int x0_, int y0_)
        : span(F3D_TILE + 2 * radius), x0(x0_), y0(y0_) {
        const int n = span * span;
        dx = buf;
        dy = buf + n;
        dz = buf + 2 * n;
        inv = buf + 3 * n;
        w = buf + 4 * n;
        m = reinterpret_cast<int*>(buf + 5 * n);
    }
    F3D_HD int entries() const { return span * span; }
    // entry e of the window from the frame's reservoirs
    F3D_HD void stage(const ResArgs& r, int width, int height, int e) const {
        const int X = imin(imax(x0 + e % span, 0), width - 1);
        const int Y = imin(imax(y0 + e / span, 0), height - 1);
        const Cand c = spatial_cand(r, Y * width + X);
        dx[e] = c.dx;
        dy[e] = c.dy;
        dz[e] = c.dz;
        inv[e] = c.inv;
        w[e] = c.w;
        m[e] = c.m;
    }
    // the candidate at unclamped frame coordinates (x, y) of the window
    F3D_HD Cand at(int x, int y) const {
        const int e = (y - y0) * span + (x - x0);
        Cand c;
        c.dx = dx[e];
        c.dy = dy[e];
        c.dz = dz[e];
        c.inv = inv[e];
        c.w = w[e];
        c.m = m[e];
        return c;
    }
};

// K7's window for a radius whose halo is not staged: each tap formed from
// the frame's reservoirs.
struct FrameWindow {
    const ResArgs* r;
    int width, height;

    F3D_HD Cand at(int x, int y) const {
        return spatial_cand(*r, imin(imax(y, 0), height - 1) * width + imin(imax(x, 0), width - 1));
    }
};

// restir.py:spatial_reuse for pixel (x, y) of the frame: the self
// candidate, then K random taps in a (2r+1)^2 window, read through `win`. A
// (0, 0) tap keeps its two offset draws but skips the candidate and its
// draw. The chosen candidate is kept as its pixel index; its six sample
// fields are read from `rin` (the whole frame's reservoirs) at the end.
template <class Window>
F3D_HD Res spatial_pixel(const Window& win, const ResArgs& rin, const float* gb_nx,
                         const float* gb_ny, const float* gb_nz, int width, int height,
                         uint32_t frame_index, uint32_t seed_hi, int k_neighbors, int radius,
                         int x, int y) {
    const int i = y * width + x;
    const float gx = gb_nx[i], gy = gb_ny[i], gz = gb_nz[i];
    float w_acc = 0.0f;
    uint32_t seed = (seed_hi ^ frame_index) + (uint32_t)i * 1664525u + 1013904223u;
    int ch = i;
    float ch_pdf = rin.target_pdf[i];
    const Cand self = win.at(x, y);
    if (consider(w_acc, seed, self, gx, gy, gz)) ch_pdf = 1.0f;
    uint32_t m_total = (uint32_t)self.m;
    const int span = 2 * radius + 1;
    for (int k = 0; k < k_neighbors; ++k) {
        float u1, u2;
        seed = xorshift32(seed, u1);
        seed = xorshift32(seed, u2);
        int rx = (int)floorf(u1 * (float)span) - radius;
        int ry = (int)floorf(u2 * (float)span) - radius;
        if (rx == 0 && ry == 0) continue;
#ifdef F3D_K7_SELF_TAPS   // measurement build: every tap reads the pixel itself
        rx = ry = 0;
#endif
        const Cand c = win.at(x + rx, y + ry);
        if (consider(w_acc, seed, c, gx, gy, gz)) {
            ch = imin(imax(y + ry, 0), height - 1) * width + imin(imax(x + rx, 0), width - 1);
            ch_pdf = 1.0f;
        }
        m_total += (uint32_t)c.m;
    }
    Res out;
    out.dir_x = rin.dir_x[ch];
    out.dir_y = rin.dir_y[ch];
    out.dir_z = rin.dir_z[ch];
    out.intensity = rin.intensity[ch];
    out.light_type = rin.light_type[ch];
    out.light_index = rin.light_index[ch];
    out.weight = (w_acc > 0.0f && ch_pdf > 0.0f)
                     ? w_acc / ((float)m_total * fmaxf(ch_pdf, 1e-30f)) : 0.0f;
    out.w_sum = w_acc;
    out.m = (int)m_total;
    out.target_pdf = ch_pdf;
    return out;
}

// ---------------------------------------------------------------------------
// The hybrid seam (terrain_ref.py:_hyb_primary / _occl_any): a mesh, when
// the scene has one, is traced beside the terrain for every ray.
// ---------------------------------------------------------------------------

// Any-hit occlusion of a shadow ray by the terrain or the mesh (the mesh
// walk stops at its first accepted triangle: mesh.cuh, kAny).
template <bool kHybrid>
F3D_HD bool occluded(const SceneArgs& s, const MeshArgs& m, float ox, float oy, float oz,
                     float dx, float dy, float dz) {
    if (trace_ray(s, ox, oy, oz, dx, dy, dz, 1e-3f, 1e30f).hit) return true;
    return kHybrid && m.n_nodes > 0
           && trace_mesh_ray<true>(m, ox, oy, oz, dx, dy, dz, 1e-4f, 1e30f).prim >= 0;
}

// Whether the nearer of the terrain's and the mesh's hits (3e38 for a
// miss) lies before `limit`: the light-ray occlusion test `lt < limit`. The
// mesh walk stops once its best t is below `limit` (mesh.cuh: kAny).
template <bool kHybrid>
F3D_HD bool blocked_before(const SceneArgs& s, const MeshArgs& m, float ox, float oy,
                           float oz, float dx, float dy, float dz, float limit) {
    Hit ht = trace_ray(s, ox, oy, oz, dx, dy, dz, 1e-3f, 1e30f);
    if ((ht.hit ? ht.t : 3.0e38f) < limit) return true;
    if (!(kHybrid && m.n_nodes > 0)) return 3.0e38f < limit;
    MeshHit hm = trace_mesh_ray<true>(m, ox, oy, oz, dx, dy, dz, 1e-4f, 1e30f, limit);
    return (hm.prim >= 0 ? hm.t : 3.0e38f) < limit;
}

// ---------------------------------------------------------------------------
// One accumulation frame for pixel i of the band f.row0 .. f.row0 + f.rows - 1
// (terrain_ref.py:_make_frame_step): the pixel's seeds and camera ray take
// its place in the frame, its buffers are the band's. With the band the
// whole frame (row0 0, rows = height), i is the frame's pixel index.
// M-clamp of the history, the spp loop, the fresh candidate reservoir,
// accumulation, the windowed Welford, and the temporal merge of the
// history with the fresh candidates (the first half of the reuse step).
// kHybrid = the scene has a mesh or typed lights; the terrain-only
// instantiation is the same code with those branches compiled out.
// ---------------------------------------------------------------------------

template <bool kHybrid>
F3D_HD void frame_pixel(const SceneArgs& s, const FrameArgs& f, const MeshArgs& m,
                        const LightArgs& L, int i, const float* accum_in,
                        const float* welford_in, const ResArgs& rin, float* accum_out,
                        float* welford_out, const ResArgs& rout) {
    const int x = i % f.width;
    const int y = f.row0 + i / f.width;
    uint32_t st = f.seed_hi ^ ((uint32_t)x * 1664525u) ^ ((uint32_t)y * 1013904223u)
                  ^ f.seed_lo ^ (f.frame_index * 92837111u);

    Res prev = m_clamp(load_res(rin, i));
    bool prev_ok = f.restir && f.frame_index > 0u && prev.m > 0 && prev.weight > 0.0f
                   && prev.target_pdf > 0.0f && prev.light_type == 1;
    float pinv = 1.0f / sqrtf(prev.dir_x * prev.dir_x + prev.dir_y * prev.dir_y
                              + prev.dir_z * prev.dir_z + 1e-30f);
    float sdx = prev_ok ? prev.dir_x * pinv : f.sun[0];
    float sdy = prev_ok ? prev.dir_y * pinv : f.sun[1];
    float sdz = prev_ok ? prev.dir_z * pinv : f.sun[2];
    float rw = prev_ok ? fminf(fmaxf(prev.weight, 0.0f), 4.0f) : 1.0f;
    const bool has_mesh = kHybrid && m.n_nodes > 0;
    const bool has_lights = kHybrid && L.count > 0;

    const float cox = f.cam_o[0], coy = f.cam_o[1], coz = f.cam_o[2];
    float fr = 0.0f, fg = 0.0f, fb = 0.0f, c_wsum = 0.0f, c_pdf = 0.0f;
    uint32_t c_m = 0u;
    for (int k = 0; k < f.spp; ++k) {
        float u1, u2;
        st = xorshift32(st, u1);
        st = xorshift32(st, u2);
        float jx = tent_offset(u1) * 0.5f;
        float jy = tent_offset(u2) * 0.5f;
        float dx, dy, dz;
        camera_ray(f, x, y, jx, jy, dx, dy, dz);
        Hit hp = trace_ray(s, cox, coy, coz, dx, dy, dz, 1e-3f, 1e30f);
        bool hit = hp.hit;
        float t = hp.t;
        bool mesh_won = false;
        int prim = -1;
        if (has_mesh) {  // closest of the terrain and the mesh
            MeshHit mh = trace_mesh_ray(m, cox, coy, coz, dx, dy, dz, 1e-4f, 1e30f);
            mesh_won = mh.prim >= 0 && mh.t < (hp.hit ? hp.t : 3.0e38f);
            if (mesh_won) t = mh.t;
            hit = hit || mh.prim >= 0;
            prim = mh.prim;
        }
        // albedo and albedo * sun radiance: with a mesh both are float32
        // per pixel (mesh hits keep the constant (0.7, 0.7, 0.8)), without
        // one the product was rounded once on the host
        float alb[3] = {f.alb[0], f.alb[1], f.alb[2]};
        float alc[3] = {f.alc[0], f.alc[1], f.alc[2]};
        if (has_mesh) {
            if (mesh_won) {
                alb[0] = 0.7f;
                alb[1] = 0.7f;
                alb[2] = 0.8f;
            }
            for (int c = 0; c < 3; ++c) alc[c] = alb[c] * f.lc[c];
        }
        float r, g, b;
        float cand_pdf = 0.0f;
        float hx = 0.0f, hy = 0.0f, hz = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
        if (hit) {
            hx = cox + t * dx;
            hy = coy + t * dy;
            hz = coz + t * dz;
            if (mesh_won) {
                mesh_normal(m, prim, dx, dy, dz, nx, ny, nz);
            } else {
                normal_at(s, hx, hz, hp.cell_x, hp.cell_z, nx, ny, nz);
            }
            // sun candidate target pdf (streaming RIS, one directional light)
            float ndotl = fmaxf(nx * f.sun[0] + ny * f.sun[1] + nz * f.sun[2], 0.0f);
            cand_pdf = luminance(alc[0] * ndotl, alc[1] * ndotl, alc[2] * ndotl);
            float nd = fmaxf(nx * sdx + ny * sdy + nz * sdz, 0.0f);
            // env-sample draws come before the occlusion queries; misses
            // draw nothing here
            float u3, u4;
            st = xorshift32(st, u3);
            st = xorshift32(st, u4);
            float ex, ey, ez;
            cosine_dir(nx, ny, nz, u3, u4, ex, ey, ez);
            float ox = hx + nx * 1e-3f;
            float oy = hy + ny * 1e-3f;
            float oz = hz + nz * 1e-3f;
            float vis = 1.0f;
            if (f.shadows) vis = occluded<kHybrid>(s, m, ox, oy, oz, sdx, sdy, sdz) ? 0.0f : 1.0f;
            float evis = occluded<kHybrid>(s, m, ox, oy, oz, ex, ey, ez) ? 0.0f : 1.0f;
            float lit = nd * vis * rw;
            float er, eg, eb;
            env_radiance(f, ex, ey, ez, er, eg, eb);
            r = alc[0] * lit + alb[0] * er * evis;
            g = alc[1] * lit + alb[1] * eg * evis;
            b = alc[2] * lit + alb[2] * eb * evis;
        } else {
            env_radiance(f, dx, dy, dz, r, g, b);
        }
        float lr = 0.0f, lg = 0.0f, lb = 0.0f;
        if (has_lights) {  // typed-light NEE: every lane draws its three words
            float u5, u6, u7;
            st = xorshift32(st, u5);
            st = xorshift32(st, u6);
            st = xorshift32(st, u7);
            if (hit) {
                LightSample ls = sample_light(LightTable{L.table}, L.count, L.u_hi, hx, hy, hz, nx,
                                               ny, nz, u5, u6, u7);
                float lvis = blocked_before<kHybrid>(s, m, hx + nx * 1e-3f, hy + ny * 1e-3f,
                                                     hz + nz * 1e-3f, ls.dx, ls.dy, ls.dz,
                                                     ls.dist * 0.999f) ? 0.0f : 1.0f;
                lr = alb[0] * ls.wr * lvis;
                lg = alb[1] * ls.wg * lvis;
                lb = alb[2] * ls.wb * lvis;
            }
        }
        if (hit) {
            r = r + lr;
            g = g + lg;
            b = b + lb;
        }
        if (cand_pdf > 0.0f) {
            c_wsum = c_wsum + cand_pdf;
            c_m += 1u;
            c_pdf = cand_pdf;
        }
        fr = fr + r;
        fg = fg + g;
        fb = fb + b;
    }
    fr = fr * f.inv_spp;
    fg = fg * f.inv_spp;
    fb = fb * f.inv_spp;

    // fresh candidate reservoir
    bool fin = c_m > 0u && c_wsum > 0.0f && c_pdf > 0.0f;
    Res curr;
    float any = c_m > 0u ? 1.0f : 0.0f;
    curr.dir_x = f.sun[0] * any;
    curr.dir_y = f.sun[1] * any;
    curr.dir_z = f.sun[2] * any;
    curr.intensity = c_m > 0u ? f.lum_lc : 0.0f;
    curr.light_type = c_m > 0u ? 1 : 0;
    curr.light_index = 0;
    curr.w_sum = c_wsum;
    curr.m = (int)c_m;
    curr.weight = fin ? c_wsum / ((float)c_m * fmaxf(c_pdf, 1e-30f)) : 0.0f;
    curr.target_pdf = c_pdf;
    store_res(rout, i, temporal_merge(prev, curr));

    // accumulate the frame's mean radiance
    float a0 = accum_in[4 * i + 0] + fr;
    float a1 = accum_in[4 * i + 1] + fg;
    float a2 = accum_in[4 * i + 2] + fb;
    float a3 = accum_in[4 * i + 3] + 1.0f;
    accum_out[4 * i + 0] = a0;
    accum_out[4 * i + 1] = a1;
    accum_out[4 * i + 2] = a2;
    accum_out[4 * i + 3] = a3;

    // windowed Welford over the running-mean luminance
    uint32_t in_window = f.frame_index % F3D_WELFORD_WINDOW;
    float w0 = in_window == 0u ? 0.0f : welford_in[2 * i + 0];
    float w1 = in_window == 0u ? 0.0f : welford_in[2 * i + 1];
    float mean_lum = luminance(a0, a1, a2) / a3;
    float kf = (float)in_window + 1.0f;
    float delta = mean_lum - w0;
    float mean = w0 + delta / kf;
    welford_out[2 * i + 0] = mean;
    welford_out[2 * i + 1] = w1 + delta * (mean_lum - mean);
}

// terrain_ref.py:_center_gbuffer for pixel i, given the K5 hit record of
// the unjittered center ray (d); with a mesh (m.n_nodes > 0) the ray is
// also traced against it and the nearer hit wins.
F3D_HD void gbuffer_pixel(const SceneArgs& s, const MeshArgs& m, const float* cam_o,
                          const float* alb, int i, float dx, float dy, float dz, int hit,
                          float t, int cell_x, int cell_z, float* albedo_out,
                          float* normal_out, float* depth_out, float* vis_out,
                          float* gb_nx, float* gb_ny, float* gb_nz) {
    float nx = 0.0f, ny = 0.0f, nz = 1.0f;  // the sky record stays finite
    if (hit) {
        float hx = cam_o[0] + t * dx;
        float hz = cam_o[2] + t * dz;
        normal_at(s, hx, hz, cell_x, cell_z, nx, ny, nz);
    }
    float a[3] = {alb[0], alb[1], alb[2]};
    if (m.n_nodes > 0) {
        MeshHit mh = trace_mesh_ray<false, true>(m, cam_o[0], cam_o[1], cam_o[2], dx, dy, dz,
                                                 1e-4f, 1e30f);
        if (mh.prim >= 0 && mh.t < (hit ? t : 3.0e38f)) {
            t = mh.t;
            mesh_normal(m, mh.prim, dx, dy, dz, nx, ny, nz);
            a[0] = 0.7f;
            a[1] = 0.7f;
            a[2] = 0.8f;
        }
        hit = hit || mh.prim >= 0;
    }
    for (int c = 0; c < 3; ++c) albedo_out[3 * i + c] = hit ? a[c] : 0.0f;
    normal_out[3 * i + 0] = hit ? nx : 0.0f;
    normal_out[3 * i + 1] = hit ? ny : 0.0f;
    normal_out[3 * i + 2] = hit ? nz : 0.0f;
    depth_out[i] = hit ? t : qnan();
    vis_out[i] = hit ? 1.0f : 0.0f;
    gb_nx[i] = nx;
    gb_ny[i] = ny;
    gb_nz[i] = nz;
}
