// forge3d_tpu_torch/csrc/smoke.cuh
// Per-voxel and per-pixel device code of the smoke path (kernels E8 step and
// E8 march, forge3d_tpu/smoke.py): the trilinear sample `_trilinear` (87),
// the fluid step of `_build_step` (206-269) cut into its stages, and the
// volume march of `SmokeDomain.render_rgba` (332-447). Float32, in the JAX
// functions' operation order, so that smoke.cu agrees with the plain
// PyTorch versions in ops/smoke.py.
//
// Grids are (nz, ny, nx), x fastest, y up; the velocity is (3, nz, ny, nx).
//
// Rounding. The JAX step is one jitted program, and XLA's CPU code fuses
// some multiply-adds; the plain versions and these bodies fuse the same ones
// with fmaf (the build keeps -fmad=false, so nothing else is fused):
// - a lerp a (1 - f) + b f is fmaf(a, 1 - f, b f) ("fused"), except in the
//   stored self-advected velocity's y and z components when the step runs
//   no Jacobi sweep, where it is fmaf(b, f, a (1 - f)) ("swapped");
//   `sample_density` runs `_trilinear` op by op: no fusion ("eager");
// - the backtrace x - dt v is fmaf(-dt, v, x);
// - the buoyancy dt (b (T - T0)) is fmaf(T - T0, dt b, v), dt b folded in
//   float32; a division by a constant is a multiplication by its float32
//   reciprocal (the Jacobi / 6 and the march's / voxel size);
// - with one Jacobi sweep XLA unrolls the loop into the projection, and
//   each difference of two neighbours' pressures keeps one of the two
//   products by 1/6 unrounded (smoke_project_advect_voxel).
//
// One fault of the reference is not carried over: `_trilinear` clips to
// n - 1.000001, which rounds to n - 1 in float32 for n >= 34, and its +1
// neighbour then leaves the grid (jnp.take returns NaN past the end). Here
// each +1 neighbour is clamped to n - 1 on its own axis; where JAX reads
// inside the array the result is the same, bit for bit (the clamped read
// carries the weight 0 that JAX's wrapped read carries).

#pragma once

#include <math.h>

#ifndef F3D_HD
#ifdef __CUDACC__
#define F3D_HD __host__ __device__ __forceinline__
#else
#define F3D_HD inline
#endif
#endif

enum {
    F3D_LERP_EAGER = 0,    // a (1 - f) + b f, each operation rounded
    F3D_LERP_FUSED = 1,    // fmaf(a, 1 - f, b f)
    F3D_LERP_SWAPPED = 2   // fmaf(b, f, a (1 - f))
};

F3D_HD float smoke_lerp(float a, float b, float t, int form) {
    const float u = 1.0f - t;
    if (form == F3D_LERP_FUSED) return fmaf(a, u, b * t);
    if (form == F3D_LERP_SWAPPED) return fmaf(b, t, a * u);
    return a * u + b * t;
}

// _trilinear: sample grid (nz, ny, nx) at fractional voxel coordinates,
// clamped to [0, float32(n - 1.000001)] per axis; the +1 neighbours clamp
// to n - 1. g(i) is the grid's value at flat voxel i (SmokeGrid, or the
// forced velocity formed where it is read, SmokeForcedGrid).
template <class Grid>
F3D_HD float smoke_trilinear_of(const Grid& g, int nx, int ny, int nz, float px, float py,
                                float pz, int form) {
    const float hx = (float)((double)nx - 1.000001);
    const float hy = (float)((double)ny - 1.000001);
    const float hz = (float)((double)nz - 1.000001);
    const float x = fminf(fmaxf(px, 0.0f), hx);
    const float y = fminf(fmaxf(py, 0.0f), hy);
    const float z = fminf(fmaxf(pz, 0.0f), hz);
    const int x0 = (int)floorf(x);
    const int y0 = (int)floorf(y);
    const int z0 = (int)floorf(z);
    const float fx = x - (float)x0;
    const float fy = y - (float)y0;
    const float fz = z - (float)z0;
    const int x1 = x0 + 1 < nx ? x0 + 1 : nx - 1;
    const int y1 = y0 + 1 < ny ? y0 + 1 : ny - 1;
    const int z1 = z0 + 1 < nz ? z0 + 1 : nz - 1;
    const long long r00 = ((long long)z0 * ny + y0) * nx;
    const long long r01 = ((long long)z0 * ny + y1) * nx;
    const long long r10 = ((long long)z1 * ny + y0) * nx;
    const long long r11 = ((long long)z1 * ny + y1) * nx;
    const float c00 = smoke_lerp(g(r00 + x0), g(r00 + x1), fx, form);
    const float c01 = smoke_lerp(g(r01 + x0), g(r01 + x1), fx, form);
    const float c10 = smoke_lerp(g(r10 + x0), g(r10 + x1), fx, form);
    const float c11 = smoke_lerp(g(r11 + x0), g(r11 + x1), fx, form);
    const float c0 = smoke_lerp(c00, c01, fy, form);
    const float c1 = smoke_lerp(c10, c11, fy, form);
    return smoke_lerp(c0, c1, fz, form);
}

struct SmokeGrid {
    const float* p;
    F3D_HD float operator()(long long i) const { return p[i]; }
};

F3D_HD float smoke_trilinear(const float* g, int nx, int ny, int nz, float px, float py,
                             float pz, int form) {
    return smoke_trilinear_of(SmokeGrid{g}, nx, ny, nz, px, py, pz, form);
}

// ---------------------------------------------------------------------------
// E8 step, stage by stage (smoke.py:220-267)

// The forces (223-227): buoyancy along +y, wind, damping. Component c of the
// forced velocity at voxel i of n, formed where it is read: the
// self-advection samples it at its own voxel and at the eight corners of
// each component's sample, so it is never stored.
struct SmokeForced {
    const float* vel;   // (3, n)
    const float* temp;  // (n)
    long long n;
    float dtb, amb, kdamp;
    float wind[3];
    F3D_HD float at(int c, long long i) const {
        if (c == 1) return (fmaf(temp[i] - amb, dtb, vel[n + i]) + wind[1]) * kdamp;
        return (vel[c * n + i] + wind[c]) * kdamp;
    }
};

struct SmokeForcedGrid {
    SmokeForced f;
    int c;
    F3D_HD float operator()(long long i) const { return f.at(c, i); }
};

F3D_HD void smoke_voxel_xyz(int nx, int ny, long long i, int& x, int& y, int& z) {
    x = (int)(i % nx);
    y = (int)((i / nx) % ny);
    z = (int)(i / ((long long)nx * ny));
}

// the forces and the self-advection of the forced velocity (230) at voxel
// i: each component sampled at the voxel's backtrace; forms holds the lerp
// form of component c in bits 2c..2c+1
F3D_HD void smoke_advect_velocity_voxel(const SmokeForced& f, float* va, int nx, int ny, int nz,
                                        float dt, int forms, long long i) {
    const long long n = (long long)nx * ny * nz;
    int x, y, z;
    smoke_voxel_xyz(nx, ny, i, x, y, z);
    const float bx = fmaf(-dt, f.at(0, i), (float)x);
    const float by = fmaf(-dt, f.at(1, i), (float)y);
    const float bz = fmaf(-dt, f.at(2, i), (float)z);
    for (int c = 0; c < 3; ++c)
        va[c * n + i] = smoke_trilinear_of(SmokeForcedGrid{f, c}, nx, ny, nz, bx, by, bz,
                                           (forms >> (2 * c)) & 3);
}

// lap_nb (233-240): the six neighbours with edges replicated
F3D_HD void smoke_neighbours(const float* p, int nx, int ny, int nz, int x, int y, int z,
                             float nb[6]) {
    const long long row = ((long long)z * ny + y) * nx;
    const long long plane = (long long)nx * ny;
    nb[0] = p[row + (x > 0 ? x - 1 : 0)];
    nb[1] = p[row + (x < nx - 1 ? x + 1 : nx - 1)];
    nb[2] = p[row + x + (y > 0 ? -nx : 0)];
    nb[3] = p[row + x + (y < ny - 1 ? nx : 0)];
    nb[4] = p[row + x + (z > 0 ? -plane : 0)];
    nb[5] = p[row + x + (z < nz - 1 ? plane : 0)];
}

// div_of (242-246) at voxel i: 0.5 ((xp - xm) + (yp - ym) + (zp - zm)). A
// non-null p1 also takes the first Jacobi sweep from zeros there: jac's
// (s - div) / 6 with the six zero neighbours' sum s, which is 0, so
// (0 - div) * float32(1 / 6), the same two rounded operations.
F3D_HD void smoke_divergence_voxel(const float* va, float* div, float* p1, int nx, int ny, int nz,
                                   float sixth, long long i) {
    const long long n = (long long)nx * ny * nz;
    int x, y, z;
    smoke_voxel_xyz(nx, ny, i, x, y, z);
    float a[6], b[6], c[6];
    smoke_neighbours(va, nx, ny, nz, x, y, z, a);
    smoke_neighbours(va + n, nx, ny, nz, x, y, z, b);
    smoke_neighbours(va + 2 * n, nx, ny, nz, x, y, z, c);
    const float d = 0.5f * (((a[1] - a[0]) + (b[3] - b[2])) + (c[5] - c[4]));
    div[i] = d;
    if (p1) p1[i] = (0.0f - d) * sixth;
}

// The Jacobi sweeps (jac, 251-255) after the first, up to F3D_JAC_LEVELS a
// launch (smoke.cu:jacobi_kernel). A CTA takes a brick of the domain and
// stages the pressure and the divergence over it and a halo of
// F3D_JAC_LEVELS voxels on each side where the brick does not reach the
// domain's edge; a brick on the edge has no halo there and reaches that much
// further instead. A thread holds one staged (x, y) column of the pressure
// over z in registers, F3D_JAC_SX x F3D_JAC_SY columns a CTA, F3D_JAC_SZ
// voxels a column; the divergence goes to shared memory once. A level
// publishes every column to shared memory, then each thread forms its
// column's next level from its four xy neighbours there and its z
// neighbours in its registers, in place, and waits for the others before the
// next level publishes. The last level writes the brick itself to device
// memory. Each voxel is formed as jac forms it: ((((xm + xp) + ym) + yp) +
// zm) + zp, minus div, times float32(1 / 6), each neighbour clamped in the
// domain's coordinates (lap_nb's replicated edge: a voxel on the domain's
// edge is its own outside neighbour, at the same level). A voxel l from a
// halo's outer face is wrong from level l on, so the brick, F3D_JAC_LEVELS
// inside, is right at every level a launch runs, bit for bit.
#define F3D_JAC_LEVELS 4
#define F3D_JAC_SX 32
#define F3D_JAC_SY 32
#define F3D_JAC_SZ 24
#define F3D_JAC_THREADS (F3D_JAC_SX * F3D_JAC_SY)
// a CTA's shared floats: the published pressure, then the divergence
#define F3D_JAC_PLANES (F3D_JAC_SZ * F3D_JAC_THREADS)

// bricks along an axis of n voxels with S staged and a halo K: the first and
// the last reach the edge (interior S - K), the others S - 2K
F3D_HD int jac_axis_count(int n, int S, int K) {
    return n <= S ? 1 : 2 + (n - 2 * (S - K) + (S - 2 * K) - 1) / (S - 2 * K);
}

// brick i's interior [in_lo, in_hi) and staged [lo, hi) along the axis
F3D_HD void jac_axis(int n, int S, int K, int i, int& in_lo, int& in_hi, int& lo, int& hi) {
    in_lo = i == 0 ? 0 : (S - K) + (i - 1) * (S - 2 * K);
    in_hi = i + 1 == jac_axis_count(n, S, K) ? n : (i == 0 ? S - K : in_lo + S - 2 * K);
    lo = in_lo - K > 0 ? in_lo - K : 0;
    hi = in_hi + K < n ? in_hi + K : n;
}

struct JacBrick {
    int n[3];               // the domain (nx, ny, nz)
    int lo[3], hi[3];       // the staged box, [lo, hi) on x, y, z
    int in_lo[3], in_hi[3]; // the brick, which the last level writes
};

F3D_HD long long jac_bricks(int nx, int ny, int nz) {
    return (long long)jac_axis_count(nx, F3D_JAC_SX, F3D_JAC_LEVELS)
           * jac_axis_count(ny, F3D_JAC_SY, F3D_JAC_LEVELS)
           * jac_axis_count(nz, F3D_JAC_SZ, F3D_JAC_LEVELS);
}

// brick b, x fastest
F3D_HD JacBrick jac_brick(int nx, int ny, int nz, long long b) {
    JacBrick k;
    const int size[3] = {F3D_JAC_SX, F3D_JAC_SY, F3D_JAC_SZ};
    k.n[0] = nx;
    k.n[1] = ny;
    k.n[2] = nz;
    for (int a = 0; a < 3; ++a) {
        const int count = jac_axis_count(k.n[a], size[a], F3D_JAC_LEVELS);
        jac_axis(k.n[a], size[a], F3D_JAC_LEVELS, (int)(b % count), k.in_lo[a], k.in_hi[a],
                 k.lo[a], k.hi[a]);
        b /= count;
    }
    return k;
}

// thread t's column in a CTA's planes: its place t in each plane (t = ty
// SX + tx), the offsets of its xy neighbours (0: itself, at the domain's
// edge, or at the staged box's face, where the column is wrong from level 1
// on anyway), and the last staged z whose upper neighbour is the next voxel
// (the domain's top face is its own)
struct JacColumn {
    int t;
    int oxm, oxp, oym, oyp;
    int ztop;
};

F3D_HD JacColumn jac_column(const JacBrick& k, int t) {
    const int tx = t % F3D_JAC_SX, ty = t / F3D_JAC_SX;
    const int gx = k.lo[0] + tx, gy = k.lo[1] + ty;
    JacColumn c;
    c.t = t;
    c.oxm = gx > 0 && tx > 0 ? -1 : 0;
    c.oxp = gx < k.n[0] - 1 && tx + 1 < F3D_JAC_SX ? 1 : 0;
    c.oym = gy > 0 && ty > 0 ? -F3D_JAC_SX : 0;
    c.oyp = gy < k.n[1] - 1 && ty + 1 < F3D_JAC_SY ? F3D_JAC_SX : 0;
    c.ztop = k.hi[2] == k.n[2] ? k.hi[2] - k.lo[2] - 1 : F3D_JAC_SZ - 1;
    return c;
}

// the voxel index of thread t's column at staged z 0, or -1 outside the
// staged box
F3D_HD long long jac_base(const JacBrick& k, int t) {
    const int gx = k.lo[0] + t % F3D_JAC_SX, gy = k.lo[1] + t / F3D_JAC_SX;
    if (gx >= k.hi[0] || gy >= k.hi[1]) return -1;
    return ((long long)k.lo[2] * k.n[1] + gy) * k.n[0] + gx;
}

// thread t's column of the pressure over the staged z into cp (null p: the
// zeros before the first sweep) and of the divergence into the CTA's plane
// dsm; zeros outside the staged box
F3D_HD void jac_load(const JacBrick& k, int t, const float* p, const float* div, float* cp,
                     float* dsm) {
    const long long plane = (long long)k.n[0] * k.n[1], base = jac_base(k, t);
#pragma unroll
    for (int z = 0; z < F3D_JAC_SZ; ++z) {
        const bool in = base >= 0 && k.lo[2] + z < k.hi[2];
        cp[z] = in && p ? p[base + z * plane] : 0.0f;
        dsm[z * F3D_JAC_THREADS + t] = in ? div[base + z * plane] : 0.0f;
    }
}

// the column's level into the published planes sm
F3D_HD void jac_publish(const float* cp, float* sm, int t) {
#pragma unroll
    for (int z = 0; z < F3D_JAC_SZ; ++z) sm[z * F3D_JAC_THREADS + t] = cp[z];
}

// the column's next level, in place, from the published planes sm and the
// divergence's dsm
F3D_HD void jac_level(const JacColumn& c, float* cp, const float* sm, const float* dsm,
                      float sixth) {
    float prev = cp[0];
#pragma unroll
    for (int z = 0; z < F3D_JAC_SZ; ++z) {
        const float cur = cp[z];
        const float zm = z == 0 ? cur : prev;
        const float zp = z + 1 < F3D_JAC_SZ && z < c.ztop ? cp[z + 1 < F3D_JAC_SZ ? z + 1 : z] : cur;
        const float* s = sm + z * F3D_JAC_THREADS + c.t;
        const float sum = ((((s[c.oxm] + s[c.oxp]) + s[c.oym]) + s[c.oyp]) + zm) + zp;
        cp[z] = (sum - dsm[z * F3D_JAC_THREADS + c.t]) * sixth;
        prev = cur;
    }
}

// the brick's part of thread t's column into out
F3D_HD void jac_store(const JacBrick& k, int t, const float* cp, float* out) {
    const int gx = k.lo[0] + t % F3D_JAC_SX, gy = k.lo[1] + t / F3D_JAC_SX;
    if (gx < k.in_lo[0] || gx >= k.in_hi[0] || gy < k.in_lo[1] || gy >= k.in_hi[1]) return;
    const long long plane = (long long)k.n[0] * k.n[1], base = jac_base(k, t);
#pragma unroll
    for (int z = 0; z < F3D_JAC_SZ; ++z) {
        const int gz = k.lo[2] + z;
        if (gz >= k.in_lo[2] && gz < k.in_hi[2]) out[base + z * plane] = cp[z];
    }
}

// the projection (256-259) and the scalar advection with dissipation
// (262-266) of one voxel: its projected velocity, then its four scalars
// sampled at the backtrace of that velocity. A non-null p is the pressure
// after two or more sweeps. A non-null div (p null) is the step with one
// sweep, which XLA unrolls into the projection: each neighbour's pressure
// a s, a = 0 - div, is formed in place, and each difference of two
// neighbours keeps one product unrounded, fmaf(-a_m, s, a_p s) along x
// and y and fmaf(a_p, s, -(a_m s)) along z. Both null (no sweep) leave
// the velocity as advected.
F3D_HD void smoke_project_advect_voxel(const float* va, const float* p, const float* div,
                                       const float* dens, const float* temp, const float* soot,
                                       const float* emis, float* vel_out, float* dens_out,
                                       float* temp_out, float* soot_out, float* emis_out, int nx,
                                       int ny, int nz, float dt, float keep, float keep2,
                                       float sixth, long long i) {
    const long long n = (long long)nx * ny * nz;
    int x, y, z;
    smoke_voxel_xyz(nx, ny, i, x, y, z);
    float v0 = va[i], v1 = va[n + i], v2 = va[2 * n + i];
    float nb[6];
    if (p) {
        smoke_neighbours(p, nx, ny, nz, x, y, z, nb);
        v0 = v0 + -0.5f * (nb[1] - nb[0]);
        v1 = v1 + -0.5f * (nb[3] - nb[2]);
        v2 = v2 + -0.5f * (nb[5] - nb[4]);
    } else if (div) {
        smoke_neighbours(div, nx, ny, nz, x, y, z, nb);
        for (int k = 0; k < 6; ++k) nb[k] = 0.0f - nb[k];
        v0 = v0 + -0.5f * fmaf(-nb[0], sixth, nb[1] * sixth);
        v1 = v1 + -0.5f * fmaf(-nb[2], sixth, nb[3] * sixth);
        v2 = v2 + -0.5f * fmaf(nb[5], sixth, -(nb[4] * sixth));
    }
    vel_out[i] = v0;
    vel_out[n + i] = v1;
    vel_out[2 * n + i] = v2;
    const float bx = fmaf(-dt, v0, (float)x);
    const float by = fmaf(-dt, v1, (float)y);
    const float bz = fmaf(-dt, v2, (float)z);
    dens_out[i] = smoke_trilinear(dens, nx, ny, nz, bx, by, bz, F3D_LERP_FUSED) * keep;
    temp_out[i] = smoke_trilinear(temp, nx, ny, nz, bx, by, bz, F3D_LERP_FUSED) * keep;
    soot_out[i] = smoke_trilinear(soot, nx, ny, nz, bx, by, bz, F3D_LERP_FUSED) * keep;
    emis_out[i] = smoke_trilinear(emis, nx, ny, nz, bx, by, bz, F3D_LERP_FUSED) * keep2;
}

// ---------------------------------------------------------------------------
// E8 march (smoke.py:332-447)

// Host-made constants of one render, all float32 as JAX forms them.
struct SmokeMarchArgs {
    int nx, ny, nz, width, height, steps, sun_steps;
    float half_w, half_h, steps_f;
    float right[3], up[3], fwd[3], cam_o[3];
    float lo[3], hi[3];          // the box, entry and exit slabs
    float org[3], rcp[3];        // to_vox: (w - org) * (1 / voxel size) - 0.5
    float sigma_t, sun_k, scat_k;  // absorption + scattering; -sigma_t ds; scattering / sigma_t
    float alb[3], sun_c[3], emis_c[3], bg[3];
};

F3D_HD float smoke_to_vox(float w, float org, float rcp) { return fmaf(w - org, rcp, -0.5f); }

// numpy's (clip(v, 0, 1) * 255 + 0.5).astype(uint8) in float32
F3D_HD unsigned char smoke_u8(float v) {
    return (unsigned char)(fminf(fmaxf(v, 0.0f), 1.0f) * 255.0f + 0.5f);
}

// The skip of a ray that misses the box. Such a ray's steps force the
// absorption to 0, so each step adds oat = (1 - expf(-0)) tr = 0 times the
// step's samples, and the pixel ends as the background with alpha 0 exactly
// when every product of 0 is 0: every sample finite, and lsun =
// expf(acc sun_k) finite. Sufficient, and checked before a march: every
// density in [0, 2^100] and every emission and soot value within +-2^100 on
// the device (a trilinear sample of such values is finite, a sun march's sum
// of densities finite and >= 0), and on the host every float constant finite,
// sun_k <= 0 and sun_steps <= 2^20 (MarchSetup.skip_consts_ok). NaN fails
// every comparison.
#define F3D_SMOKE_SKIP_BOUND 0x1p100f

F3D_HD bool smoke_skip_voxel_ok(float dens, float emis, float soot) {
    return dens >= 0.0f && dens <= F3D_SMOKE_SKIP_BOUND && fabsf(emis) <= F3D_SMOKE_SKIP_BOUND
           && fabsf(soot) <= F3D_SMOKE_SKIP_BOUND;
}

// One pixel: the camera ray (eager ops: every operation rounded), the slab
// entry and exit, `steps` steps of three samples and the sun march of
// `sun_steps` samples along the offsets sun_off (3 a step), then the
// background, Reinhard and the u8 pack with alpha = 1 - transmittance. With
// skip_misses (the check above held) a ray that misses the box goes straight
// to the background: what its steps would give, bit for bit.
F3D_HD void smoke_march_pixel(const SmokeMarchArgs& a, const float* dens, const float* emis,
                              const float* soot, const float* sun_off, bool skip_misses,
                              unsigned char* rgba, long long i) {
    const int px = (int)(i % a.width);
    const int py = (int)(i / a.width);
    const float cx = ((2.0f * ((float)px + 0.5f)) / (float)a.width - 1.0f) * a.half_w;
    const float cy = (1.0f - (2.0f * ((float)py + 0.5f)) / (float)a.height) * a.half_h;
    float d[3];
    for (int c = 0; c < 3; ++c) d[c] = (cx * a.right[c] + cy * a.up[c]) + a.fwd[c];
    const float inv = 1.0f / sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
    float t0[3], t1[3];
    for (int c = 0; c < 3; ++c) {
        d[c] = d[c] * inv;
        const float invd = fabsf(d[c]) > 1e-9f ? 1.0f / d[c] : (d[c] >= 0.0f ? 1e9f : -1e9f);
        const float ta = (a.lo[c] - a.cam_o[c]) * invd;
        const float tb = (a.hi[c] - a.cam_o[c]) * invd;
        t0[c] = fminf(ta, tb);
        t1[c] = fmaxf(ta, tb);
    }
    const float t_in = fmaxf(fmaxf(t0[0], t0[1]), fmaxf(t0[2], 0.0f));
    const float t_out = fminf(fminf(t1[0], t1[1]), t1[2]);
    const bool has = t_in < t_out;
    const float dtm = (t_out - t_in) / a.steps_f;
    const int steps = (has || !skip_misses) ? a.steps : 0;
    float tr = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
    for (int s = 0; s < steps; ++s) {
        const float t = fmaf((float)s + 0.5f, dtm, t_in);
        float w[3], p[3];
        for (int c = 0; c < 3; ++c) {
            w[c] = fmaf(t, d[c], a.cam_o[c]);
            p[c] = smoke_to_vox(w[c], a.org[c], a.rcp[c]);
        }
        const float de = smoke_trilinear(dens, a.nx, a.ny, a.nz, p[0], p[1], p[2], F3D_LERP_FUSED);
        const float em = smoke_trilinear(emis, a.nx, a.ny, a.nz, p[0], p[1], p[2], F3D_LERP_FUSED);
        const float so = smoke_trilinear(soot, a.nx, a.ny, a.nz, p[0], p[1], p[2], F3D_LERP_FUSED);
        const float ab = has ? (a.sigma_t * de) * dtm : 0.0f;
        const float att = expf(-ab);
        float acc = 0.0f;
        for (int k = 0; k < a.sun_steps; ++k) {
            const float* o = sun_off + 3 * k;
            acc = acc + smoke_trilinear(dens, a.nx, a.ny, a.nz,
                                        smoke_to_vox(w[0] + o[0], a.org[0], a.rcp[0]),
                                        smoke_to_vox(w[1] + o[1], a.org[1], a.rcp[1]),
                                        smoke_to_vox(w[2] + o[2], a.org[2], a.rcp[2]),
                                        F3D_LERP_FUSED);
        }
        const float lsun = expf(acc * a.sun_k);
        // jnp.clip, which keeps a NaN (fminf and fmaxf would drop it)
        const float q = so / (de + 1e-4f);
        const float sf = q < 0.0f ? 0.0f : (q > 1.0f ? 1.0f : q);
        const float oat = (1.0f - att) * tr;
        const float scat = (oat * lsun) * a.scat_k;
        const float glow = oat * em;
        const float sn = 1.0f - sf, s5 = 0.05f * sf;
        r = fmaf(glow, a.emis_c[0], fmaf(scat * fmaf(a.alb[0], sn, s5), a.sun_c[0], r));
        g = fmaf(glow, a.emis_c[1], fmaf(scat * fmaf(a.alb[1], sn, s5), a.sun_c[1], g));
        b = fmaf(glow, a.emis_c[2], fmaf(scat * fmaf(a.alb[2], sn, s5), a.sun_c[2], b));
        tr = tr * att;
    }
    const float lin[3] = {r + tr * a.bg[0], g + tr * a.bg[1], b + tr * a.bg[2]};
    unsigned char* out = rgba + 4 * i;
    for (int c = 0; c < 3; ++c) out[c] = smoke_u8(lin[c] / (1.0f + lin[c]));
    out[3] = smoke_u8(1.0f - tr);
}
