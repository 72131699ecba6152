// forge3d_tpu_torch/csrc/sdf.cuh
// Kernel P6's body: the signed-distance tape of forge3d_tpu/ops/sdf.py
// (SdfScene.evaluate 223, its fori_loop 334; normal 339; raymarch 348 and
// its while_loop 382) for one point or ray. Runs alone in
// pt.cu:sdf_eval_kernel, sdf_normal_kernel and sdf_march_kernel, and
// inside the hybrid tracer P3 (pt.cu:hybrid_kernel).
//
// The tape is post-order: a primitive pushes its distance and material, an
// operation pops two and pushes one. Each instruction computes only its own
// primitive or operation (a `switch` on the kind), where JAX computes every
// branch of its lax.switch and keeps one; the capsule's division is guarded
// by max(., 1e-12) as JAX's is, so no untaken branch can matter.
//
// What bounds a step on the card is issue, not arithmetic: every thread
// walks the same tape in the same order, so the dispatch, the tape's reads
// and the stack's traffic are overhead on each of the ~20 operations an
// entry computes. ops/sdf.py packs the tape into 48-byte entries (a header
// and the params in three 16-byte words), which the eval, normal and march
// kernels copy to shared memory once a block: an entry is then one or
// three broadcast loads for a warp, where the unpacked arrays took up to
// nine loads from the cache. The top of the value stack stays in
// registers, so a primitive stores one 8-byte slot of local memory and an
// operation loads one, where the unpacked stack took two loads and two
// stores an operation. A tape longer than F3D_SDF_SHARED entries is read
// through the read-only cache with the same loop; pt.cu's launchers pick
// the instantiation from the tape (sdf_in_shared). Both compute the same
// operations in the same order, so both give the same bits.
//
// Holding the slots in registers too (switches on a slot index that is the
// same for every thread, for tapes no deeper than 8) measured slower on an
// H100: 2.50 ms against 1.59 for the landmark's march, 64 registers against
// 42 and chains of compares and moves at each entry (PERF.md §6).
//
// XLA compiles the tape loop with a*b + c fused into one multiply-add; the
// sums below are written as the fmaf calls that match it on every point
// (-fmad=false keeps everything else unfused). The sphere trace steps one
// ray until it hits, passes tmax or runs out of steps: JAX freezes a lane
// once it is done, so stopping there gives the same t, hit and material.
//
// The cull box (P3 only; P6's own kernels ignore it). ops/sdf.py:cull_box
// derives, when the scene is compiled, a box outside which the tape's
// float32 value is >= F3D_SDF_HIT (1e-3) at every point, so no march can hit
// there. It works top-down in float64 with a level c for each node (the
// root's c is 1e-3): a primitive's box is its support inflated by c plus a
// margin (a plane is unbounded); a union or intersection takes the union's
// bounding box or the intersection of its operands' boxes at c, a
// subtraction its left operand's (max(d1, -d2) >= d1); a smooth union takes
// its operands at c + k/4 (smin >= min - k/4), a smooth intersection and a
// smooth subtraction at c (smax >= max; for k < 1e-6, where h takes
// max(k, 1e-6), at c + 1e-6 + max(-k, 0)/4). The margin, 2^-16 (4 S + 1)
// at each node, S the largest |parameter| plus the sum of |k|, covers the
// float32 evaluation: each primitive and smooth operation is within
// 64 u (|p| + S), u = 2^-24, of the exact value on float32 inputs, and at a
// point a distance delta outside a primitive's box the exact distance
// grows by delta. The box is rounded outward to float32. A tape with an
// unbounded root (a plane in a union) has no box, and P3 marches as before.
//
// sdf_cull_span turns the box into the march's interval: for a ray it
// finds, in double, the exact t at which the ray enters and leaves the box
// (each widened by 2^-40 of itself, above double's rounding), and returns
// false if [tmin, tmax] misses it; otherwise it lowers tmax to the exit,
// rounded up to float32. The march evaluates fmaf(t, d, o): one rounding of
// o + t d, which is monotone, so a t beyond the exit gives a point outside
// the box. That is exact: sdf_march_t steps through the same t whatever its
// tmax, so a hit it finds is the unbounded march's first hit, and when it
// stops at a t past the box's exit the unbounded march cannot hit later.
// Rays with |o| > 2^40 or |d| > 2^8 (and NaN) are not culled: beyond those
// the tape's values could overflow, where the margin argument ends.

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

#define F3D_SDF_STACK 66  // ops/sdf.py:MAX_STACK (trees of depth <= 64)
#define F3D_SDF_SHARED 1024  // the longest tape a block copies to shared memory (48 KB)
#define F3D_SDF_WORDS 12   // words of a packed tape entry (ops/sdf.py:pack_tape)

struct SdfArgs {            // mirrored by _kernels.SdfArgs
    const float* tape;      // (T, 12) packed: is_op, kind, material (int bits), smoothing;
                            // then the 8 params, as three 16-byte words an entry
    int tape_len, stack_depth;
    int cull;               // 0 no box (unbounded), 1 the box below, 2 never below the threshold
    float cull_lo[3], cull_hi[3];
    float cull_eps;         // the threshold the box was derived for (ops/sdf.py:CULL_THRESHOLD)
};

struct SdfHit {
    int hit;
    float t;
    int material;
};

// The tape's reads. An entry is three 16-byte words: the header, then the
// params in two. Every thread of a launch reads the same entry at the same
// step, so a word is one broadcast load for the warp: from shared memory
// where the block copied the tape (kGlobal false; pt.cu:sdf_block_tape), else
// through the read-only cache.
struct SdfWord {
    float x, y, z, w;
};

template <bool kGlobal>
F3D_HD SdfWord sdf_word(const float* p) {
    SdfWord r;
#ifdef __CUDA_ARCH__
    const float4 v = kGlobal ? __ldg(reinterpret_cast<const float4*>(p))
                             : *reinterpret_cast<const float4*>(p);
    r.x = v.x, r.y = v.y, r.z = v.z, r.w = v.w;
#else
    r.x = p[0], r.y = p[1], r.z = p[2], r.w = p[3];
#endif
    return r;
}

F3D_HD int sdf_bits(float f) {
#ifdef __CUDA_ARCH__
    return __float_as_int(f);
#else
    int i;
    memcpy(&i, &f, 4);
    return i;
#endif
}

// which instantiation a launch takes: the tape in shared memory where it fits
F3D_HD bool sdf_in_shared(const SdfArgs& s) { return s.tape_len <= F3D_SDF_SHARED; }

// The value stack. The top value and its material stay in registers (top,
// topm); the values below it live in slots 1 .. depth - 1 of a per-thread
// array in local memory, slot 0 taking the empty stack's dummy top at the
// first push, so a primitive stores one 8-byte slot and an operation loads
// one.
struct alignas(8) SdfSlot {
    float d;
    int m;
};

// a1*b1 + a2*b2 + a3*b3 as XLA fuses it in the tape loop: a2*b2 rounded,
// then a1*b1 and a3*b3 each fused in
F3D_HD float sdf_dot3(float a1, float b1, float a2, float b2, float a3, float b3) {
    return fmaf(a3, b3, fmaf(a1, b1, a2 * b2));
}

// ops/sdf.py:prim_dist, the branch of `kind` alone; p the params
// (p0, p1, p2, p3) and (p4, p5, p6, p7)
F3D_HD float sdf_prim(int kind, const SdfWord& p, const SdfWord& q, float px, float py,
                      float pz) {
    switch (kind) {
        case 0: {  // sphere
            float dx = px - p.x, dy = py - p.y, dz = pz - p.z;
            return sqrtf(sdf_dot3(dx, dx, dy, dy, dz, dz)) - p.w;
        }
        case 1: {  // box
            float qx = fabsf(px - p.x) - p.w;
            float qy = fabsf(py - p.y) - q.x;
            float qz = fabsf(pz - p.z) - q.y;
            float mx = fmaxf(qx, 0.0f), my = fmaxf(qy, 0.0f), mz = fmaxf(qz, 0.0f);
            float outer = sqrtf(fmaf(mz, mz, fmaf(my, my, mx * mx)));
            float inner = fminf(fmaxf(qx, fmaxf(qy, qz)), 0.0f);
            return outer + inner;
        }
        case 2: {  // cylinder about y
            float dx = px - p.x, dz = pz - p.z;
            float dxz = sqrtf(fmaf(dx, dx, dz * dz)) - p.w;
            float dy = fabsf(py - p.y) - q.x;
            float a = fmaxf(dxz, 0.0f), b = fmaxf(dy, 0.0f);
            return fminf(fmaxf(dxz, dy), 0.0f) + sqrtf(fmaf(a, a, b * b));
        }
        case 3:  // plane: dot(n, p) - d
            return sdf_dot3(px, p.x, py, p.y, pz, p.z) - p.w;
        case 4: {  // torus about y
            float dx = px - p.x, dz = pz - p.z;
            float tq = sqrtf(fmaf(dx, dx, dz * dz)) - p.w;
            float dy = py - p.y;
            return sqrtf(fmaf(tq, tq, dy * dy)) - q.x;
        }
        default: {  // capsule a..b
            float pax = px - p.x, pay = py - p.y, paz = pz - p.z;
            float bax = p.w - p.x, bay = q.x - p.y, baz = q.y - p.z;
            float den = fmaxf(sdf_dot3(bax, bax, bay, bay, baz, baz), 1e-12f);
            float h = fminf(fmaxf(sdf_dot3(pax, bax, pay, bay, paz, baz) / den, 0.0f), 1.0f);
            float ex = fmaf(h, -bax, pax), ey = fmaf(h, -bay, pay), ez = fmaf(h, -baz, paz);
            return sqrtf(sdf_dot3(ex, ex, ey, ey, ez, ez)) - q.z;
        }
    }
}

// ops/sdf.py:apply_op, the branch of `kind` alone (d1 left, d2 right)
F3D_HD void sdf_op(int kind, float k, float d1, int m1, float d2, int m2, float& d, int& m) {
    float kk = fmaxf(k, 1e-6f);
    switch (kind) {
        case 0:  // union
            d = fminf(d1, d2);
            m = d1 <= d2 ? m1 : m2;
            break;
        case 1:  // intersection
            d = fmaxf(d1, d2);
            m = d1 >= d2 ? m1 : m2;
            break;
        case 2:  // subtraction
            d = fmaxf(d1, -d2);
            m = m1;
            break;
        case 3: {  // smooth union
            float h = fminf(fmaxf(0.5f + 0.5f * (d2 - d1) / kk, 0.0f), 1.0f);
            d = fmaf(-(k * h), 1.0f - h, fmaf(d1 - d2, h, d2));
            m = d1 <= d2 ? m1 : m2;
            break;
        }
        case 4: {  // smooth intersection
            float h = fminf(fmaxf(0.5f - 0.5f * (d2 - d1) / kk, 0.0f), 1.0f);
            d = fmaf(k * h, 1.0f - h, fmaf(d1 - d2, h, d2));
            m = d1 >= d2 ? m1 : m2;
            break;
        }
        default: {  // smooth subtraction
            float h = fminf(fmaxf(0.5f - 0.5f * (d2 + d1) / kk, 0.0f), 1.0f);
            d = fmaf(k * h, 1.0f - h, fmaf(-d2 - d1, h, d1));
            m = m1;
            break;
        }
    }
}

// SdfScene.evaluate for one point over the packed tape at `tape` (global or
// shared memory by kGlobal): the distance, and the material of the winning
// leaf or operation in `mat`
template <bool kGlobal>
F3D_HD float sdf_eval_t(const float* tape, int n, float px, float py, float pz, int& mat) {
    SdfSlot st[F3D_SDF_STACK];
    float top = 0.0f;
    int topm = 0, sp = 0;   // sp: values on the stack, the top included
    for (int i = 0; i < n; ++i) {
        const float* e = tape + F3D_SDF_WORDS * i;
        const SdfWord h = sdf_word<kGlobal>(e);
        const int kind = sdf_bits(h.y);
        if (sdf_bits(h.x)) {
            const SdfSlot below = st[sp - 1];
            sdf_op(kind, h.w, below.d, below.m, top, topm, top, topm);
            sp -= 1;
        } else {
            const float d = sdf_prim(kind, sdf_word<kGlobal>(e + 4), sdf_word<kGlobal>(e + 8),
                                     px, py, pz);
            st[sp].d = top;
            st[sp].m = topm;
            top = d;
            topm = sdf_bits(h.z);
            sp += 1;
        }
    }
    mat = topm;
    return top;
}

// SdfScene.normal: central differences, then JAX's eager normalisation
// (each operation rounded)
template <bool kGlobal>
F3D_HD void sdf_normal_t(const float* tape, int n, float px, float py, float pz, float eps,
                         float& nx, float& ny, float& nz) {
    int m;
    float x = sdf_eval_t<kGlobal>(tape, n, px + eps, py, pz, m) -
              sdf_eval_t<kGlobal>(tape, n, px - eps, py, pz, m);
    float y = sdf_eval_t<kGlobal>(tape, n, px, py + eps, pz, m) -
              sdf_eval_t<kGlobal>(tape, n, px, py - eps, pz, m);
    float z = sdf_eval_t<kGlobal>(tape, n, px, py, pz + eps, m) -
              sdf_eval_t<kGlobal>(tape, n, px, py, pz - eps, m);
    float inv = 1.0f / sqrtf(x * x + y * y + z * z + 1e-20f);
    nx = x * inv;
    ny = y * inv;
    nz = z * inv;
}

// SdfScene.raymarch for one ray (XLA fuses t * d into the ray's origin)
template <bool kGlobal>
F3D_HD SdfHit sdf_march_t(const float* tape, int n, float rox, float roy, float roz, float rdx,
                          float rdy, float rdz, float tmin, float tmax, int max_steps,
                          float hit_eps) {
    SdfHit h;
    h.hit = 0;
    h.t = tmin;
    h.material = -1;
    const float half = hit_eps * 0.5f;
    for (int i = 0; i < max_steps; ++i) {
        int m;
        float d = sdf_eval_t<kGlobal>(tape, n, fmaf(h.t, rdx, rox), fmaf(h.t, rdy, roy),
                                             fmaf(h.t, rdz, roz), m);
        if (d < hit_eps) {
            h.hit = 1;
            h.material = m;
            break;
        }
        const bool over = h.t > tmax;
        h.t = h.t + fmaxf(d, half);
        if (over) break;
    }
    return h;
}

// P3's cull of one march with threshold hit_eps (see the head of this
// file): false if the ray cannot hit the tape in [tmin, tmax]; else true
// with tmax lowered to the cull box's exit. A march whose threshold exceeds
// the box's own is not culled: the box holds only the points below that.
F3D_HD bool sdf_cull_span(const SdfArgs& s, float ox, float oy, float oz, float dx, float dy,
                          float dz, float hit_eps, float tmin, float& tmax) {
    if (s.cull == 0 || !(hit_eps <= s.cull_eps)) return true;
    if (s.cull == 2) return false;
    const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
    for (int a = 0; a < 3; ++a)
        if (!(fabsf(o[a]) <= 1099511627776.0f && fabsf(d[a]) <= 256.0f)) return true;
    double t0 = -HUGE_VAL, t1 = HUGE_VAL;
    for (int a = 0; a < 3; ++a) {
        const double lo = (double)s.cull_lo[a], hi = (double)s.cull_hi[a], oa = (double)o[a];
        if (d[a] == 0.0f) {
            if (oa < lo || oa > hi) return false;
            continue;
        }
        const double inv = 1.0 / (double)d[a];
        double ta = (lo - oa) * inv, tb = (hi - oa) * inv;
        if (ta > tb) {
            const double tt = ta;
            ta = tb;
            tb = tt;
        }
        t0 = ta > t0 ? ta : t0;
        t1 = tb < t1 ? tb : t1;
    }
    t0 = t0 - fabs(t0) * 0x1p-40;
    t1 = t1 + fabs(t1) * 0x1p-40;
    if (t0 > t1 || t1 < (double)tmin || t0 > (double)tmax) return false;
#ifdef __CUDA_ARCH__
    const float exit = __double2float_ru(t1);
#else
    float exit = (float)t1;
    if ((double)exit < t1) exit = nextafterf(exit, HUGE_VALF);
#endif
    tmax = exit < tmax ? exit : tmax;
    return true;
}
