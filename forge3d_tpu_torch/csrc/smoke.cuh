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
// to n - 1.
F3D_HD float smoke_trilinear(const float* g, int nx, int ny, int nz, float px, float py,
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
    const float c00 = smoke_lerp(g[r00 + x0], g[r00 + x1], fx, form);
    const float c01 = smoke_lerp(g[r01 + x0], g[r01 + x1], fx, form);
    const float c10 = smoke_lerp(g[r10 + x0], g[r10 + x1], fx, form);
    const float c11 = smoke_lerp(g[r11 + x0], g[r11 + x1], fx, form);
    const float c0 = smoke_lerp(c00, c01, fy, form);
    const float c1 = smoke_lerp(c10, c11, fy, form);
    return smoke_lerp(c0, c1, fz, form);
}

// ---------------------------------------------------------------------------
// E8 step, stage by stage (smoke.py:220-267)

// forces (223-227): buoyancy along +y, wind, damping; voxel i of n
F3D_HD void smoke_forces_voxel(const float* vel, const float* temp, float* vf, long long n,
                               float dtb, float amb, float w0, float w1, float w2, float kdamp,
                               long long i) {
    vf[i] = (vel[i] + w0) * kdamp;
    vf[n + i] = (fmaf(temp[i] - amb, dtb, vel[n + i]) + w1) * kdamp;
    vf[2 * n + i] = (vel[2 * n + i] + w2) * kdamp;
}

F3D_HD void smoke_voxel_xyz(int nx, int ny, long long i, int& x, int& y, int& z) {
    x = (int)(i % nx);
    y = (int)((i / nx) % ny);
    z = (int)(i / ((long long)nx * ny));
}

// self-advection of the forced velocity (230): each component sampled at
// the voxel's backtrace; forms holds the lerp form of component c in bits
// 2c..2c+1
F3D_HD void smoke_advect_velocity_voxel(const float* vf, float* va, int nx, int ny, int nz,
                                        float dt, int forms, long long i) {
    const long long n = (long long)nx * ny * nz;
    int x, y, z;
    smoke_voxel_xyz(nx, ny, i, x, y, z);
    const float bx = fmaf(-dt, vf[i], (float)x);
    const float by = fmaf(-dt, vf[n + i], (float)y);
    const float bz = fmaf(-dt, vf[2 * n + i], (float)z);
    for (int c = 0; c < 3; ++c)
        va[c * n + i] = smoke_trilinear(vf + c * n, nx, ny, nz, bx, by, bz, (forms >> (2 * c)) & 3);
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

// div_of (242-246): 0.5 ((xp - xm) + (yp - ym) + (zp - zm))
F3D_HD float smoke_divergence_voxel(const float* va, int nx, int ny, int nz, long long i) {
    const long long n = (long long)nx * ny * nz;
    int x, y, z;
    smoke_voxel_xyz(nx, ny, i, x, y, z);
    float a[6], b[6], c[6];
    smoke_neighbours(va, nx, ny, nz, x, y, z, a);
    smoke_neighbours(va + n, nx, ny, nz, x, y, z, b);
    smoke_neighbours(va + 2 * n, nx, ny, nz, x, y, z, c);
    return 0.5f * (((a[1] - a[0]) + (b[3] - b[2])) + (c[5] - c[4]));
}

// jac (251-253): (xm + xp + ym + yp + zm + zp - div) / 6, the division a
// multiplication by float32(1 / 6); a null p is the first sweep's zeros
F3D_HD float smoke_jacobi_voxel(const float* p, const float* div, int nx, int ny, int nz,
                                float sixth, long long i) {
    float s = 0.0f;
    if (p) {
        int x, y, z;
        smoke_voxel_xyz(nx, ny, i, x, y, z);
        float nb[6];
        smoke_neighbours(p, nx, ny, nz, x, y, z, nb);
        s = ((((nb[0] + nb[1]) + nb[2]) + nb[3]) + nb[4]) + nb[5];
    }
    return (s - div[i]) * sixth;
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

// One pixel: the camera ray (eager ops: every operation rounded), the slab
// entry and exit, `steps` steps of three samples and the sun march of
// `sun_steps` samples along the offsets sun_off (3 a step), then the
// background, Reinhard and the u8 pack with alpha = 1 - transmittance.
F3D_HD void smoke_march_pixel(const SmokeMarchArgs& a, const float* dens, const float* emis,
                              const float* soot, const float* sun_off, unsigned char* rgba,
                              long long i) {
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
    float tr = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
    for (int s = 0; s < a.steps; ++s) {
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
        const float sf = fminf(fmaxf(so / (de + 1e-4f), 0.0f), 1.0f);
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
