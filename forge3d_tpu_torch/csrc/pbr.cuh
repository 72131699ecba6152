// forge3d_tpu_torch/csrc/pbr.cuh
// Per-pixel device code of the sphere engine P1 and the mesh engine P2
// (engines.cu): the shading (forge3d_tpu/pt/megakernel.py:_shade_pbr with
// its GGX helpers, and _env_color: isotropic or anisotropic GGX for one
// directional sun, an env-gradient reflection term and emission), the
// pixel-center camera ray, and the two pixel bodies (megakernel.py:_render,
// mesh_render.py:_render_mesh). Every function repeats its JAX
// counterpart's float32 operations in the same order.

#pragma once

#include <math.h>
#include <stdint.h>

#include "mesh.cuh"

#ifndef F3D_HD
#ifdef __CUDACC__
#define F3D_HD __host__ __device__ __forceinline__
#else
#define F3D_HD inline
#endif
#endif

#define F3D_PBR_PI 3.14159265358979323846f  // megakernel.py:_PI as float32

struct Pbr {
    float color[3], albedo[3], direct[3], indirect[3];
};

F3D_HD float dot3(const float* a, const float* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

// megakernel.py:_env_color: gradient sky by the direction's y.
F3D_HD void env_color(float dir_y, float* out) {
    const float s0[3] = {0.9f, 0.95f, 1.0f}, s1[3] = {0.2f, 0.4f, 0.8f};
    float t = fminf(fmaxf(0.5f * (dir_y + 1.0f), 0.0f), 1.0f);
    for (int c = 0; c < 3; ++c) {
        float sky = (1.0f - t) * s0[c] + t * s1[c];
        out[c] = (1.0f - t) * 0.08f + t * sky;
    }
}

F3D_HD float ggx_d(float ndh, float alpha) {
    float a2 = alpha * alpha;
    float q = ndh * ndh * (a2 - 1.0f) + 1.0f;
    return a2 / fmaxf(F3D_PBR_PI * (q * q), 1e-6f);
}

F3D_HD float smith_g1(float ndx, float alpha) {
    float k = (alpha + 1.0f) * (alpha + 1.0f) / 8.0f;
    return ndx / (ndx * (1.0f - k) + k);
}

F3D_HD float smith_g_aniso(const float* v, const float* t, const float* b, const float* n,
                           float ax, float ay) {
    float vx = dot3(v, t);
    float vy = dot3(v, b);
    float vz = fmaxf(dot3(v, n), 1e-6f);
    float av = sqrtf(vx * vx * ax * ax + vy * vy * ay * ay) / vz;
    return 2.0f / (1.0f + sqrtf(1.0f + av * av));
}

// megakernel.py:_shade_pbr for view direction v and normal n. `l` is the
// unit sun direction and `li` the sun radiance, float32 on the host.
F3D_HD void shade_pbr(const float* v, const float* n, const float* m_albedo, float m_metallic,
                      float m_roughness, const float* m_emissive, float m_ax, float m_ay,
                      const float* l, const float* li, Pbr& out) {
    float albedo[3];
    for (int c = 0; c < 3; ++c) albedo[c] = fmaxf(m_albedo[c], 0.0f);
    float metallic = fminf(fmaxf(m_metallic, 0.0f), 1.0f);
    float rough = fminf(fmaxf(m_roughness, 0.0f), 1.0f);
    float ax = fmaxf(0.002f, m_ax);
    float ay = fmaxf(0.002f, m_ay);

    float h[3] = {l[0] + v[0], l[1] + v[1], l[2] + v[2]};
    float hn = sqrtf(dot3(h, h));
    for (int c = 0; c < 3; ++c) h[c] = h[c] / hn;
    float ndl = fmaxf(dot3(n, l), 0.0f);
    float nv = dot3(n, v);
    float ndv = fmaxf(nv, 0.0f);
    float ndh = fmaxf(dot3(n, h), 0.0f);
    float vdh = fmaxf(dot3(v, h), 0.0f);

    float D, G;
    if (fabsf(ax - ay) < 1e-4f) {
        float a_iso = fmaxf(0.02f, rough * rough);
        D = ggx_d(ndh, a_iso);
        G = smith_g1(ndl, a_iso) * smith_g1(ndv, a_iso);
    } else {
        // megakernel.py:_tangent_basis
        float sign = n[2] < 0.0f ? -1.0f : 1.0f;
        float a = -1.0f / (sign + n[2]);
        float b0 = n[0] * n[1] * a;
        float t[3] = {1.0f + sign * (n[0] * n[0]) * a, sign * b0, -sign * n[0]};
        float b[3] = {b0, sign + (n[1] * n[1]) * a, -n[1]};
        float hx = dot3(h, t), hy = dot3(h, b), hz = fmaxf(dot3(h, n), 0.0f);
        float x2 = hx * hx / fmaxf(ax * ax, 1e-8f);
        float y2 = hy * hy / fmaxf(ay * ay, 1e-8f);
        float denom = x2 + y2 + hz * hz;
        D = 1.0f / fmaxf(F3D_PBR_PI * ax * ay * denom * denom, 1e-6f);
        G = smith_g_aniso(l, t, b, n, ax, ay) * smith_g_aniso(v, t, b, n, ax, ay);
    }

    float p_v = powf(1.0f - fminf(fmaxf(vdh, 0.0f), 1.0f), 5.0f);
    float p_n = powf(1.0f - ndv, 5.0f);
    float sdg = D * G / fmaxf(4.0f * ndl * ndv, 1e-6f);
    float r[3] = {2.0f * nv * n[0] - v[0], 2.0f * nv * n[1] - v[1], 2.0f * nv * n[2] - v[2]};
    float env[3];
    env_color(r[1], env);
    for (int c = 0; c < 3; ++c) {
        float f0 = 0.04f * (1.0f - metallic) + albedo[c] * metallic;
        float F = f0 + (1.0f - f0) * p_v;
        float spec = sdg * F;
        float kd = (1.0f - F) * (1.0f - metallic);
        float diffuse = kd * albedo[c] / F3D_PBR_PI;
        float direct = (diffuse + spec) * li[c] * ndl;
        float f_ibl = f0 + (fmaxf(1.0f - rough, f0) - f0) * p_n;
        float indirect = env[c] * (f_ibl * 0.5f + 0.5f * kd * albedo[c]);
        out.color[c] = direct + indirect + fmaxf(m_emissive[c], 0.0f);
        out.albedo[c] = albedo[c];
        out.direct[c] = direct;
        out.indirect[c] = indirect;
    }
}

// ---------------------------------------------------------------------------
// The engines' pixels
// ---------------------------------------------------------------------------

struct CamArgs {  // mirrored by _kernels.CamArgs
    int width, height;
    float origin[3], right[3], up[3], fwd[3];
    float aspect, tan_half, exposure;  // float32(W / H), float32 tan(fov_y / 2)
    float sun_l[3], sun_li[3];         // _shade_pbr's sun direction and radiance
};

struct SphereArgs {  // megakernel.py:SphereBatch, (N, ...) rows
    const float* center;
    const float* radius;
    const float* albedo;
    const float* metallic;
    const float* emissive;
    const float* roughness;
    const float* ax;
    const float* ay;
    int n;
};

struct MaterialArgs {  // mesh_render.py:MeshMaterial and the sun of P2
    float albedo[3];
    float metallic, roughness;
    float emissive[3];
    float sun_dir[3];
    float sun_intensity;
};

struct AovArgs {  // (H, W, 3) planes and (H, W) planes
    float* ldr;
    float* albedo;
    float* normal;
    float* depth;
    float* direct;
    float* indirect;
    float* vis;
};

// megakernel.py:_render's pixel-center ray.
F3D_HD void engine_ray(const CamArgs& c, int x, int y, float* rd) {
    float ndc_x = 2.0f * ((float)x + 0.5f) / (float)c.width - 1.0f;
    float ndc_y = 1.0f - 2.0f * ((float)y + 0.5f) / (float)c.height;
    float a = ndc_x * c.aspect * c.tan_half;
    float b = ndc_y * c.tan_half;
    float d[3];
    for (int k = 0; k < 3; ++k) d[k] = c.fwd[k] + a * c.right[k] + b * c.up[k];
    float n = sqrtf(dot3(d, d));
    for (int k = 0; k < 3; ++k) rd[k] = d[k] / n;
}

F3D_HD void store3(float* plane, int i, const float* v) {
    plane[3 * i] = v[0];
    plane[3 * i + 1] = v[1];
    plane[3 * i + 2] = v[2];
}

// Reinhard on exposed radiance, then the pixel's AOVs.
F3D_HD void store_pixel(const CamArgs& c, const AovArgs& o, int i, const float* color,
                        const float* albedo, const float* normal, float depth,
                        const float* direct, const float* indirect, float vis) {
    float ldr[3];
    for (int k = 0; k < 3; ++k) {
        float e = color[k] * fmaxf(c.exposure, 1e-4f);
        ldr[k] = e / (e + 1.0f);
    }
    store3(o.ldr, i, ldr);
    store3(o.albedo, i, albedo);
    store3(o.normal, i, normal);
    store3(o.direct, i, direct);
    store3(o.indirect, i, indirect);
    o.depth[i] = depth;
    o.vis[i] = vis;
}

// megakernel.py:_render for pixel i: the nearest sphere (first of equal
// minima, as argmin), else the ground plane y = 0 with distance fog, else
// the sky.
F3D_HD void sphere_pixel(const CamArgs& c, const SphereArgs& sp, const AovArgs& o, int i) {
    const int x = i % c.width, y = i / c.width;
    float rd[3];
    engine_ray(c, x, y, rd);
    const float* ro = c.origin;
    float best_t = 1e30f;
    int best = 0;
    for (int j = 0; j < sp.n; ++j) {
        float oc[3] = {ro[0] - sp.center[3 * j], ro[1] - sp.center[3 * j + 1],
                       ro[2] - sp.center[3 * j + 2]};
        float r = sp.radius[j];
        float b = dot3(rd, oc);
        float cc = dot3(oc, oc) - r * r;
        float disc = b * b - cc;
        float sd = sqrtf(fmaxf(disc, 0.0f));
        float t0 = -b - sd, t1 = -b + sd;
        float t = t0 > 1e-4f ? t0 : t1;
        if (!(disc >= 0.0f && t > 1e-4f && r > 0.0f)) t = 1e30f;
        if (t < best_t) {
            best_t = t;
            best = j;
        }
    }
    const float v[3] = {-rd[0], -rd[1], -rd[2]};
    const float zero[3] = {0.0f, 0.0f, 0.0f};
    if (best_t < 1e30f) {
        float n[3];
        for (int k = 0; k < 3; ++k) n[k] = (ro[k] + best_t * rd[k]) - sp.center[3 * best + k];
        float nn = fmaxf(sqrtf(dot3(n, n)), 1e-12f);
        for (int k = 0; k < 3; ++k) n[k] = n[k] / nn;
        Pbr s;
        shade_pbr(v, n, sp.albedo + 3 * best, sp.metallic[best], sp.roughness[best],
                  sp.emissive + 3 * best, sp.ax[best], sp.ay[best], c.sun_l, c.sun_li, s);
        float nm = fmaxf(sqrtf(dot3(n, n)), 1e-12f);
        float nrm[3] = {n[0] / nm, n[1] / nm, n[2] / nm};
        store_pixel(c, o, i, s.color, s.albedo, nrm, best_t, s.direct, s.indirect, 1.0f);
        return;
    }
    const float ng[3] = {0.0f, 1.0f, 0.0f};
    float tg = -ro[1] / (rd[1] >= -1e-5f ? -1.0f : rd[1]);
    if (rd[1] < -1e-5f && tg > 0.0f) {
        const float alb_g[3] = {0.6f, 0.6f, 0.6f};
        Pbr s;
        shade_pbr(v, ng, alb_g, 0.0f, 0.2f, zero, 0.2f, 0.2f, c.sun_l, c.sun_li, s);
        float dv[3];
        for (int k = 0; k < 3; ++k) dv[k] = (ro[k] + tg * rd[k]) - ro[k];
        float fog = fminf(fmaxf(sqrtf(dot3(dv, dv)) / 50.0f, 0.0f), 1.0f);
        const float horizon[3] = {0.2f, 0.4f, 0.8f};  // _env_color((0, 1, 0))
        float col[3];
        for (int k = 0; k < 3; ++k) col[k] = (1.0f - fog) * s.color[k] + fog * horizon[k];
        store_pixel(c, o, i, col, s.albedo, ng, tg, s.direct, s.indirect, 1.0f);
        return;
    }
    float env[3];
    env_color(rd[1], env);
    store_pixel(c, o, i, env, zero, ng, 1.0f, zero, env, 0.0f);
}

// mesh_render.py:_render_mesh for pixel i: the primary hit through the BVH,
// the two-sided face normal, PBR shading and a sun shadow ray through the
// BVH (tmax 1e6). With kSkipDark the shadow ray is walked only where its
// answer can change the pixel: where sun_intensity * ndl is zero (a face
// turned from the sun, or no sun), w is that signed zero whichever mask the
// walk returns, and the adds below still run, so the bits are the walk's;
// a NaN or infinite product still walks. Returns whether it walked.
template <bool kSkipDark>
F3D_HD bool mesh_pixel_t(const CamArgs& c, const MeshArgs& m, const MaterialArgs& mat,
                         const AovArgs& o, int i) {
    const int x = i % c.width, y = i / c.width;
    float rd[3];
    engine_ray(c, x, y, rd);
    const float* ro = c.origin;
    const float ng[3] = {0.0f, 1.0f, 0.0f};
    const float zero[3] = {0.0f, 0.0f, 0.0f};
    MeshHit h = trace_mesh_ray<false, true>(m, ro[0], ro[1], ro[2], rd[0], rd[1], rd[2], 1e-4f,
                                            1e30f);
    if (h.prim < 0) {
        float env[3];
        env_color(rd[1], env);
        store_pixel(c, o, i, env, zero, ng, 1.0f, zero, env, 0.0f);
        return false;
    }
    float n[3];
    mesh_normal(m, h.prim, rd[0], rd[1], rd[2], n[0], n[1], n[2]);
    const float v[3] = {-rd[0], -rd[1], -rd[2]};
    Pbr s;
    shade_pbr(v, n, mat.albedo, mat.metallic, mat.roughness, mat.emissive, mat.roughness,
              mat.roughness, c.sun_l, c.sun_li, s);
    const float* sd = mat.sun_dir;
    float ndl = fmaxf(n[0] * sd[0] + n[1] * sd[1] + n[2] * sd[2], 0.0f);
    const float li = mat.sun_intensity * ndl;
    const bool walk = !kSkipDark || li != 0.0f;
    bool blocked = false;
    if (walk) {
        float sp[3];
        for (int k = 0; k < 3; ++k) sp[k] = (ro[k] + h.t * rd[k]) + n[k] * 1e-3f;
        MeshHit sh = trace_mesh_ray<true, true>(m, sp[0], sp[1], sp[2], sd[0], sd[1], sd[2],
                                                1e-4f, 1e6f);
        blocked = sh.prim >= 0;
    }
    float w = li * (blocked ? 0.0f : 1.0f);
    for (int k = 0; k < 3; ++k) {
        float sun = (mat.albedo[k] / F3D_PBR_PI) * w;
        s.color[k] = s.color[k] + sun;
        s.direct[k] = s.direct[k] + sun;
    }
    store_pixel(c, o, i, s.color, s.albedo, n, h.t, s.direct, s.indirect, 1.0f);
    return walk;
}

// P2's pixel (engines.cu:mesh_kernel): the shadow walk skipped where it
// cannot change the pixel
F3D_HD void mesh_pixel(const CamArgs& c, const MeshArgs& m, const MaterialArgs& mat,
                       const AovArgs& o, int i) {
    mesh_pixel_t<true>(c, m, mat, o, i);
}
