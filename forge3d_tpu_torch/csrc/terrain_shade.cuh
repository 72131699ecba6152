// forge3d_tpu_torch/csrc/terrain_shade.cuh
// Per-pixel device code of the perspective TerrainRenderer (kernel R1):
// the shading closure forge3d_tpu/terrain/renderer.py:_make_shade (653)
// for one pixel and one sample, the one-shot program `_build_program`
// (1036: the AA loop, the tonemap, the sRGB or gamma encode and the u8
// rgba) and the offline accumulation `step` (1150: one jittered sample into
// the RGBA32F accumulator and the luminance of the running mean).
//
// Rays go through common.cuh's trace_ray (the K5 DDA) and normal_at; the
// random stream, the cosine lobe and the env lookup are common.cuh's too.
// Every function computes what its JAX counterpart computes, operation for
// operation and in float32 (the kernels are built with -fmad=false), so
// that the kernels agree with the plain PyTorch versions in
// forge3d_tpu_torch/terrain/renderer.py.
//
// The JAX program shades every pixel of the image as one array and traces
// shadow, AO and reflection rays for all of them, then selects with
// `where`; here a thread skips the rays whose result no output reads (the
// sun and AO rays of a pixel whose primary ray missed the terrain, the
// reflection ray of a pixel without water in front), but draws the random
// numbers of every pixel, so the stream stays the same.

#pragma once

#include "common.cuh"

#define F3D_VT_MAX_LEVELS 16  // renderer.py:VT_MAX_LEVELS

// Mirrored by TerrainArgs in _kernels.py. Flags select the settings groups
// of _make_shade; values are the float32 uniforms of renderer.py:_uniforms.
struct TerrainArgs {
    const float* lut;      // (lut_n, 3) colormap
    const float* env_rgb;  // (env_h, env_w, 3) IBL map, or null: the sky gradient
    int lut_n, env_w, env_h;
    int width, height, aa;
    int use_colormap, tonemap, srgb_out, debug_normals, curve_mode;
    int shadow_samples;    // 0: shadows off
    int ao_samples;        // 0: height AO off
    int fog_on, water_on, wrefl_on, clouds_on, layers_on, tri_on, det_on, pom_on;
    uint32_t aa_seed;
    float cam_o[3], right[3], up[3], fwd[3];
    float half_h, aspect;  // aspect = float32(W / H)
    float sun[3], sun_rgb[3], ambient_rgb[3];
    float zenith[3];       // sky_rgb's zenith colour, from the ambient colour
    float ibl_intensity, hmin, hmax, exposure, inv_gamma, white_point, colormap_strength;
    float constant_albedo[3];
    float lambert_contrast, shadow_softness, shadow_intensity, shadow_bias;
    float curve_power, curve_strength, ao_mix_weight, time;
    float fog_density, fog_rgb[3], fog_falloff, fog_start;
    float water_level, water_rgb[3], water_reflectivity, refl_intensity;
    float cloud_coverage, cloud_strength, cloud_scale;
    float ao_radius, ao_strength, tri_scale, tri_sharp;
    float det_strength, det_scale, det_fade, pom_scale;
    float snow_h, snow_blend, snow_rgb[3], rock_cos, rock_blend, rock_rgb[3];
    // the virtual-texture albedo (renderer.py:833-871); vt_atlas null: off
    const float* vt_atlas;  // (slots * page * page, 3) resident pages
    const int* vt_table;    // slot per (level, tile), level by level; -1: not resident
    int vt_levels, vt_level0, vt_level_last, vt_page;
    int vt_tiles[F3D_VT_MAX_LEVELS], vt_offs[F3D_VT_MAX_LEVELS];  // per entry of the level list
    float vt_pix_angle, vt_tpw0, vt_inv_span;
};

// Output planes; a null pointer is not written.
struct TerrainOut {
    unsigned char* rgba;  // (H, W, 4)
    float* hdr;           // (H, W, 3)
    float* albedo;        // (H, W, 3), 0 off the terrain
    float* normal;        // (H, W, 3), 0 off the terrain
    float* depth;         // (H, W), NaN off the terrain
    float* vis;           // (H, W), 1 on the terrain
    unsigned int* vt_fallback;  // VT: terrain pixels of sample 0 whose page was not resident
};

enum { F3D_TM_OFF = 0, F3D_TM_REINHARD, F3D_TM_REINHARD_EXT, F3D_TM_FILMIC, F3D_TM_ACES };
enum { F3D_CURVE_LINEAR = 0, F3D_CURVE_POW, F3D_CURVE_SMOOTHSTEP };

#define F3D_SEED_RENDER 0x9E3779B9u  // renderer.py:1048
#define F3D_SEED_STEP 0x85EBCA6Bu    // renderer.py:1153

struct ShadeAux {
    int hit;   // the primary ray hit the terrain
    float t;   // its distance, or the water plane's where water is in front
    float n[3];
    float alb[3];
    int vt_miss;  // a terrain hit whose VT page was not resident
};

// float32 -> int32 as the lattice takes it; saturates (CUDA's conversion)
// so that the host build has no undefined conversion. Only pixels whose
// value the sky replaces are ever outside the int32 range.
F3D_HD int32_t f2i_sat(float x) {
    return (int32_t)fminf(fmaxf(x, -2147483648.0f), 2147483520.0f);
}

// renderer.py:vnoise2's hash: int32 products that wrap (done in uint32) and
// an arithmetic shift of the int32 value.
F3D_HD float lattice(int32_t ix, int32_t iz) {
    uint32_t n = ((uint32_t)ix * 374761393u + (uint32_t)iz * 668265263u) ^ 1274126177u;
    n = (n ^ (uint32_t)((int32_t)n >> 13)) * 1103515245u;
    return (float)(((int32_t)n >> 8) & 0xFFFF) / 65535.0f;
}

// renderer.py:vnoise2: 2-D value noise, hash lattice + smoothstep.
F3D_HD float vnoise2(float x, float z) {
    float xi = floorf(x);
    float zi = floorf(z);
    float xf = x - xi;
    float zf = z - zi;
    int32_t ix0 = f2i_sat(xi), ix1 = f2i_sat(xi + 1.0f);
    int32_t iz0 = f2i_sat(zi), iz1 = f2i_sat(zi + 1.0f);
    float sx = xf * xf * (3.0f - 2.0f * xf);
    float sz = zf * zf * (3.0f - 2.0f * zf);
    float a = lattice(ix0, iz0) * (1.0f - sx) + lattice(ix1, iz0) * sx;
    float b = lattice(ix0, iz1) * (1.0f - sx) + lattice(ix1, iz1) * sx;
    return a * (1.0f - sz) + b * sz;
}

// colormaps.py:sample_lut_jnp for one value.
F3D_HD void sample_lut(const float* lut, int n, float t, float& r, float& g, float& b) {
    float tt = clamp01(t) * (float)(n - 1);
    int i0 = (int)floorf(tt);
    int i1 = imin(i0 + 1, n - 1);
    float f = tt - (float)i0;
    r = lut[3 * i0 + 0] * (1.0f - f) + lut[3 * i1 + 0] * f;
    g = lut[3 * i0 + 1] * (1.0f - f) + lut[3 * i1 + 1] * f;
    b = lut[3 * i0 + 2] * (1.0f - f) + lut[3 * i1 + 2] * f;
}

F3D_HD void sky_rgb(const TerrainArgs& a, float dy, float& r, float& g, float& b) {
    float t = clamp01(0.5f * (dy + 1.0f));
    r = 0.95f * (1.0f - t) + a.zenith[0] * t;
    g = 0.97f * (1.0f - t) + a.zenith[1] * t;
    b = 1.0f * (1.0f - t) + a.zenith[2] * t;
}

F3D_HD void env_sample(const TerrainArgs& a, float dx, float dy, float dz,
                       float& r, float& g, float& b) {
    if (a.env_rgb != nullptr) {
        env_lookup(a.env_rgb, a.env_w, a.env_h, a.ibl_intensity, dx, dy, dz, r, g, b);
        return;
    }
    sky_rgb(a, dy, r, g, b);
    r = r * a.ibl_intensity;
    g = g * a.ibl_intensity;
    b = b * a.ibl_intensity;
}

F3D_HD float cloud_shadow(const TerrainArgs& a, float px, float pz) {
    float sc = a.cloud_scale;
    float tshift = a.time * 0.02f;
    float n = 0.65f * vnoise2(px * sc + tshift, pz * sc)
              + 0.35f * vnoise2(px * sc * 2.7f + 13.7f + tshift * 1.7f, pz * sc * 2.7f);
    float cov = clamp01((n - (1.0f - a.cloud_coverage)) / fmaxf(a.cloud_coverage, 1e-4f));
    return 1.0f - a.cloud_strength * cov;
}

// renderer.py:728-736: the camera ray is cx * right + cy * up + fwd,
// normalised once (not common.cuh:camera_ray's two normalisations).
F3D_HD void camera_ray_r1(const TerrainArgs& a, int x, int y, float jx, float jy,
                          float& dx, float& dy, float& dz) {
    float ndc_x = (((float)x + 0.5f + jx) / (float)a.width) * 2.0f - 1.0f;
    float ndc_y = (1.0f - ((float)y + 0.5f + jy) / (float)a.height) * 2.0f - 1.0f;
    float cx = ndc_x * a.aspect * a.half_h;
    float cy = ndc_y * a.half_h;
    float x3 = cx * a.right[0] + cy * a.up[0] + a.fwd[0];
    float y3 = cx * a.right[1] + cy * a.up[1] + a.fwd[1];
    float z3 = cx * a.right[2] + cy * a.up[2] + a.fwd[2];
    float inv = 1.0f / sqrtf(x3 * x3 + y3 * y3 + z3 * z3);
    dx = x3 * inv;
    dy = y3 * inv;
    dz = z3 * inv;
}

F3D_HD void surface_albedo(const TerrainArgs& a, float hn, float& r, float& g, float& b) {
    if (a.use_colormap) {
        sample_lut(a.lut, a.lut_n, hn, r, g, b);
        float cs = a.colormap_strength;
        r = r * cs + a.constant_albedo[0] * (1.0f - cs);
        g = g * cs + a.constant_albedo[1] * (1.0f - cs);
        b = b * cs + a.constant_albedo[2] * (1.0f - cs);
    } else {
        r = a.constant_albedo[0];
        g = a.constant_albedo[1];
        b = a.constant_albedo[2];
    }
}

// renderer.py:833-871, the virtual-texture albedo of a terrain hit at
// distance t and world (px, pz): the mip level from the pixel's footprint
// (log2, rounded half to even, clamped to the store's levels), the page
// table, then the atlas texel. Returns false, leaving the albedo as it is,
// where the page is not resident. The level indexes the store's level list
// from its first level, as JAX's does; past the list's end (a store whose
// levels are not contiguous) jnp.take fills INT_MIN, which no page matches.
F3D_HD bool vt_resolve(const TerrainArgs& a, float t, float px, float pz, float& r, float& g,
                       float& b) {
    float foot = t * a.vt_pix_angle;
    float des = log2f(fmaxf(foot * a.vt_tpw0, 1e-9f));
    float lvl = fminf(fmaxf(rintf(des), (float)a.vt_level0), (float)a.vt_level_last);
    int li = (int)(lvl - (float)a.vt_level0);
    if (li < 0 || li >= a.vt_levels) return false;
    const int ntl = a.vt_tiles[li];
    const float ntl_f = (float)ntl;
    const float page = (float)a.vt_page;
    float uu = fminf(fmaxf(px * a.vt_inv_span, 0.0f), 0.999999f);
    float vv = fminf(fmaxf(pz * a.vt_inv_span, 0.0f), 0.999999f);
    float gx = uu * ntl_f * page;
    float gz = vv * ntl_f * page;
    int tx = (int)floorf(uu * ntl_f);
    int tz = (int)floorf(vv * ntl_f);
    int tix = (int)fminf(fmaxf(gx - (float)tx * page, 0.0f), page - 1.0f);
    int tiz = (int)fminf(fmaxf(gz - (float)tz * page, 0.0f), page - 1.0f);
    int slot = a.vt_table[a.vt_offs[li] + tz * ntl + tx];
    if (slot < 0) return false;
    long long addr = (long long)slot * (a.vt_page * a.vt_page) + tiz * a.vt_page + tix;
    r = a.vt_atlas[3 * addr + 0];
    g = a.vt_atlas[3 * addr + 1];
    b = a.vt_atlas[3 * addr + 2];
    return true;
}

// renderer.py:_make_shade.shade for pixel (x, y) and jitter (jx, jy);
// advances the random state `st` by the draws of the soft-shadow and AO
// samples.
F3D_HD void shade_sample(const SceneArgs& s, const TerrainArgs& a, int x, int y, float jx,
                         float jy, uint32_t& st, float& r, float& g, float& b, ShadeAux& aux) {
    float dx, dy, dz;
    camera_ray_r1(a, x, y, jx, jy, dx, dy, dz);
    const float ox = a.cam_o[0], oy = a.cam_o[1], oz = a.cam_o[2];
    const Hit hp = trace_ray(s, ox, oy, oz, dx, dy, dz, 1e-3f, 1e30f);
    float t = hp.t;
    const float px = ox + t * dx;
    const float py = oy + t * dy;
    const float pz = oz + t * dz;
    float nx, ny, nz;
    normal_at(s, px, pz, hp.cell_x, hp.cell_z, nx, ny, nz);

    // parallax-offset material lookups and the procedural detail field
    float dfreq = 0.0f;
    if (a.pom_on || a.det_on || a.tri_on) dfreq = a.det_scale / fmaxf(a.hmax - a.hmin, 1e-6f);
    float pxs = px, pzs = pz;
    if (a.pom_on) {
        float hdet = (vnoise2(px * dfreq, pz * dfreq) - 0.5f) * a.pom_scale;
        pxs = px - dx * hdet;
        pzs = pz - dz * hdet;
    }
    float detail = 0.0f, dist_fade = 0.0f;
    if (a.det_on || a.tri_on) {
        float d_top = vnoise2(pxs * dfreq, pzs * dfreq);
        if (a.tri_on) {
            float sharp = a.tri_sharp;
            float wx = powf(fabsf(nx), sharp);
            float wy = powf(fabsf(ny), sharp);
            float wz = powf(fabsf(nz), sharp);
            float wsum = fmaxf(wx + wy + wz, 1e-6f);
            float d_x = vnoise2(py * dfreq * a.tri_scale, pzs * dfreq * a.tri_scale);
            float d_z = vnoise2(pxs * dfreq * a.tri_scale, py * dfreq * a.tri_scale);
            detail = (wx * d_x + wy * d_top + wz * d_z) / wsum;
        } else {
            detail = d_top;
        }
        dist_fade = clamp01(1.0f - t / a.det_fade);
    }
    if (a.det_on) {  // detail normals, reoriented onto the geometric normal
        float eps_d = 0.5f / dfreq;
        float gdx = (vnoise2((pxs + eps_d) * dfreq, pzs * dfreq)
                     - vnoise2((pxs - eps_d) * dfreq, pzs * dfreq)) / (2.0f * eps_d);
        float gdz = (vnoise2(pxs * dfreq, (pzs + eps_d) * dfreq)
                     - vnoise2(pxs * dfreq, (pzs - eps_d) * dfreq)) / (2.0f * eps_d);
        float s_d = a.det_strength * dist_fade;
        float gx = gdx * s_d, gz = gdz * s_d;
        float tinv = 1.0f / sqrtf(1.0f + gx * gx + gz * gz);
        float tnx = -gdx * s_d * tinv;
        float tny = tinv;
        float tnz = -gdz * s_d * tinv;
        float qx = nx, qy = ny + 1.0f, qz = nz;
        float qdot = qx * tnx + qy * tny + qz * tnz;
        float qy_safe = fmaxf(qy, 1e-4f);
        float bnx = qx * qdot / qy_safe - tnx;
        float bny = qy * qdot / qy_safe - tny;
        float bnz = qz * qdot / qy_safe - tnz;
        float binv = 1.0f / sqrtf(bnx * bnx + bny * bny + bnz * bnz);
        nx = bnx * binv;
        ny = bny * binv;
        nz = bnz * binv;
    }

    // albedo
    float hn = clamp01((py - a.hmin) / fmaxf(a.hmax - a.hmin, 1e-6f));
    if (a.curve_mode == F3D_CURVE_POW) {
        hn = powf(hn, a.curve_power);
    } else if (a.curve_mode == F3D_CURVE_SMOOTHSTEP) {
        float sm = hn * hn * (3.0f - 2.0f * hn);
        hn = hn + (sm - hn) * a.curve_strength;
    }
    float ar, ag, ab;
    surface_albedo(a, hn, ar, ag, ab);
    // a missed ray's t is unbounded: its page indices are never formed
    aux.vt_miss = a.vt_atlas != nullptr && hp.hit && !vt_resolve(a, t, px, pz, ar, ag, ab);
    if (a.layers_on) {
        float snow = clamp01((hn - a.snow_h) / a.snow_blend) * clamp01((ny - 0.6f) / 0.4f);
        float rock = clamp01((a.rock_cos - ny) / a.rock_blend + 1.0f)
                     * (ny < a.rock_cos ? 1.0f : 0.0f);
        ar = ar * (1.0f - rock) + a.rock_rgb[0] * rock;
        ag = ag * (1.0f - rock) + a.rock_rgb[1] * rock;
        ab = ab * (1.0f - rock) + a.rock_rgb[2] * rock;
        ar = ar * (1.0f - snow) + a.snow_rgb[0] * snow;
        ag = ag * (1.0f - snow) + a.snow_rgb[1] * snow;
        ab = ab * (1.0f - snow) + a.snow_rgb[2] * snow;
    }
    if (a.det_on) {
        float mod = 1.0f + a.det_strength * (detail - 0.5f) * dist_fade;
        ar = ar * mod;
        ag = ag * mod;
        ab = ab * mod;
    }

    // sun term and visibility
    const float sd0 = a.sun[0], sd1 = a.sun[1], sd2 = a.sun[2];
    float ndl = fmaxf(nx * sd0 + ny * sd1 + nz * sd2, 0.0f);
    ndl = ndl + (ndl * ndl * (3.0f - 2.0f * ndl) - ndl) * a.lambert_contrast;
    float vis = 1.0f;
    if (a.shadow_samples > 0) {
        float acc = 0.0f;
        float sox = px + nx * 1e-3f + sd0 * a.shadow_bias;
        float soy = py + ny * 1e-3f + sd1 * a.shadow_bias;
        float soz = pz + nz * 1e-3f + sd2 * a.shadow_bias;
        for (int k = 0; k < a.shadow_samples; ++k) {
            float sdx = sd0, sdy = sd1, sdz = sd2;
            if (a.shadow_samples > 1) {  // a direction jittered in the sun's cone
                float u1, u2, cx, cy, cz;
                st = xorshift32(st, u1);
                st = xorshift32(st, u2);
                cosine_dir(sd0, sd1, sd2, u1, u2, cx, cy, cz);
                float soft = a.shadow_softness;
                float jdx = sd0 + (cx - sd0) * soft;
                float jdy = sd1 + (cy - sd1) * soft;
                float jdz = sd2 + (cz - sd2) * soft;
                float jinv = 1.0f / sqrtf(jdx * jdx + jdy * jdy + jdz * jdz);
                sdx = jdx * jinv;
                sdy = jdy * jinv;
                sdz = jdz * jinv;
            }
            bool occ = hp.hit && trace_ray(s, sox, soy, soz, sdx, sdy, sdz, 1e-3f, 1e30f).hit;
            acc = acc + (occ ? 0.0f : 1.0f);
        }
        vis = acc / (float)a.shadow_samples;
        vis = 1.0f - a.shadow_intensity * (1.0f - vis);
    }
    if (a.clouds_on) vis = vis * cloud_shadow(a, px, pz);

    // ambient, height AO, IBL
    float ao = 1.0f;
    if (a.ao_samples > 0) {
        float occf = 0.0f;
        for (int k = 0; k < a.ao_samples; ++k) {
            float u1, u2, adx, ady, adz;
            st = xorshift32(st, u1);
            st = xorshift32(st, u2);
            cosine_dir(nx, ny, nz, u1, u2, adx, ady, adz);
            bool occ = hp.hit && trace_ray(s, px + nx * 1e-3f, py + ny * 1e-3f, pz + nz * 1e-3f,
                                           adx, ady, adz, 1e-3f, a.ao_radius).hit;
            occf = occf + (occ ? 1.0f : 0.0f);
        }
        ao = 1.0f - a.ao_strength * occf / (float)a.ao_samples;
    }
    float ao_mix = 1.0f + (ao - 1.0f) * a.ao_mix_weight;
    float er, eg, eb;
    env_sample(a, nx, ny, nz, er, eg, eb);
    float lit = ndl * vis;
    r = ar * (a.sun_rgb[0] * lit + (a.ambient_rgb[0] + er) * ao_mix);
    g = ag * (a.sun_rgb[1] * lit + (a.ambient_rgb[1] + eg) * ao_mix);
    b = ab * (a.sun_rgb[2] * lit + (a.ambient_rgb[2] + eb) * ao_mix);

    // water plane
    bool hit_any = hp.hit;
    if (a.water_on) {
        float twp = (a.water_level - oy) / (fabsf(dy) > 1e-7f ? dy : 1e-7f);
        bool water_first = (twp > 0.0f) && (twp < t);
        float wx = ox + twp * dx;
        float wz = oz + twp * dz;
        float cosv = clamp01(-dy);
        float fres = 0.02f + 0.98f * powf(1.0f - cosv, 5.0f);
        float skr, skg, skb;
        env_sample(a, dx, fabsf(dy), dz, skr, skg, skb);
        float refl = a.water_reflectivity;
        if (a.wrefl_on && water_first) {  // planar reflection: trace the mirrored ray
            float rdy = fabsf(dy);
            Hit rh = trace_ray(s, wx, a.water_level + 1e-3f, wz, dx, rdy, dz, 1e-3f, 1e30f);
            float rpx = wx + rh.t * dx;
            float rpy = a.water_level + rh.t * rdy;
            float rpz = wz + rh.t * dz;
            float rnx, rny, rnz;
            normal_at(s, rpx, rpz, rh.cell_x, rh.cell_z, rnx, rny, rnz);
            float rhn = clamp01((rpy - a.hmin) / fmaxf(a.hmax - a.hmin, 1e-6f));
            float rar, rag, rab;
            if (a.use_colormap) {
                sample_lut(a.lut, a.lut_n, rhn, rar, rag, rab);
            } else {
                rar = a.constant_albedo[0];
                rag = a.constant_albedo[1];
                rab = a.constant_albedo[2];
            }
            float rndl = fmaxf(rnx * sd0 + rny * sd1 + rnz * sd2, 0.0f);
            float ri = a.refl_intensity;
            if (rh.hit) {
                skr = rar * (a.sun_rgb[0] * rndl + a.ambient_rgb[0]) * ri;
                skg = rag * (a.sun_rgb[1] * rndl + a.ambient_rgb[1]) * ri;
                skb = rab * (a.sun_rgb[2] * rndl + a.ambient_rgb[2]) * ri;
            }
        }
        float glint = powf(fmaxf(dx * sd0 + fabsf(dy) * sd1 + dz * sd2, 0.0f), 64.0f);
        if (water_first) {
            r = a.water_rgb[0] * (1.0f - fres) + skr * fres * refl * 4.0f
                + glint * a.sun_rgb[0] * refl;
            g = a.water_rgb[1] * (1.0f - fres) + skg * fres * refl * 4.0f
                + glint * a.sun_rgb[1] * refl;
            b = a.water_rgb[2] * (1.0f - fres) + skb * fres * refl * 4.0f
                + glint * a.sun_rgb[2] * refl;
            t = twp;
        }
        hit_any = hit_any || water_first;
    }

    if (a.fog_on) {
        float d = fmaxf(t - a.fog_start, 0.0f);
        float dens = a.fog_density * expf(-a.fog_falloff * fmaxf(py, 0.0f));
        float fogf = 1.0f - expf(-dens * d);
        r = r + (a.fog_rgb[0] - r) * fogf;
        g = g + (a.fog_rgb[1] - g) * fogf;
        b = b + (a.fog_rgb[2] - b) * fogf;
    }
    if (!hit_any) sky_rgb(a, dy, r, g, b);

    aux.hit = hp.hit;
    aux.t = t;
    aux.n[0] = nx;
    aux.n[1] = ny;
    aux.n[2] = nz;
    aux.alb[0] = ar;
    aux.alb[1] = ag;
    aux.alb[2] = ab;
}

// renderer.py:1077-1086 for one channel: the tonemap, then sRGB or gamma.
F3D_HD float tonemap_encode(const TerrainArgs& a, float v) {
    float c = v * a.exposure;
    float l;
    switch (a.tonemap) {
        case F3D_TM_OFF:
            l = clamp01(c);
            break;
        case F3D_TM_REINHARD_EXT:
            l = c * (1.0f + c / (a.white_point * a.white_point)) / (1.0f + c);
            break;
        case F3D_TM_FILMIC: {
            float f = fmaxf(c - 0.004f, 0.0f);
            l = (f * (6.2f * f + 0.5f)) / (f * (6.2f * f + 1.7f) + 0.06f);
            break;
        }
        case F3D_TM_ACES:
            l = clamp01((c * (2.51f * c + 0.03f)) / (c * (2.43f * c + 0.59f) + 0.14f));
            break;
        default:  // reinhard
            l = c / (1.0f + c);
    }
    if (a.srgb_out) {
        float lin = clamp01(l);
        // the exponent is float32(1 / 2.4) of the double quotient, as in JAX
        return lin <= 0.0031308f ? lin * 12.92f
                                 : 1.055f * powf(fmaxf(lin, 1e-7f), 0.41666666666666669f) - 0.055f;
    }
    return powf(clamp01(l), a.inv_gamma);
}

// The AOV planes of one pixel from a sample's record (renderer.py:1096-1099):
// albedo and normal times the hit mask, depth NaN off the terrain.
F3D_HD void write_aovs(const TerrainOut& o, int i, const ShadeAux& aux) {
    float m = aux.hit ? 1.0f : 0.0f;
    if (o.albedo != nullptr) {
        for (int c = 0; c < 3; ++c) o.albedo[3 * i + c] = aux.alb[c] * m;
    }
    if (o.normal != nullptr) {
        for (int c = 0; c < 3; ++c) o.normal[3 * i + c] = aux.n[c] * m;
    }
    if (o.depth != nullptr) o.depth[i] = aux.hit ? aux.t : qnan();
    if (o.vis != nullptr) o.vis[i] = m;
}

// One more fallback texel (an integer count, exact in any order).
F3D_HD void count_fallback(unsigned int* counter) {
#ifdef __CUDA_ARCH__
    atomicAdd(counter, 1u);
#else
    *counter += 1u;
#endif
}

// The random state at the start of pixel (x, y)'s first AA sample.
F3D_HD uint32_t r1_seed(const TerrainArgs& a, int x, int y) {
    return a.aa_seed ^ ((uint32_t)x * 1664525u) ^ ((uint32_t)y * 1013904223u) ^ F3D_SEED_RENDER;
}

// The draws one AA sample takes from the stream, whatever its rays hit: 2
// for the jitter (aa > 1), 2 for each sun ray when shadow_samples > 1, 2 for
// each AO ray (shade_sample).
F3D_HD int r1_sample_draws(const TerrainArgs& a) {
    return (a.aa > 1 ? 2 : 0) + (a.shadow_samples > 1 ? 2 * a.shadow_samples : 0)
           + (a.ao_samples > 0 ? 2 * a.ao_samples : 0);
}

// The state n draws further on.
F3D_HD uint32_t xorshift_skip(uint32_t st, int n) {
    float u;
    for (int j = 0; j < n; ++j) st = xorshift32(st, u);
    return st;
}

// One AA sample of pixel (x, y) from the stream state `st` at its start:
// its jitter (aa > 1), then shade_sample.
F3D_HD void r1_sample(const SceneArgs& s, const TerrainArgs& a, int x, int y, uint32_t& st,
                      float& r, float& g, float& b, ShadeAux& aux) {
    float jx = 0.0f, jy = 0.0f;
    if (a.aa > 1) {
        float u1, u2;
        st = xorshift32(st, u1);
        st = xorshift32(st, u2);
        jx = u1 - 0.5f;
        jy = u2 - 0.5f;
    }
    shade_sample(s, a, x, y, jx, jy, st, r, g, b, aux);
}

// Pixel i's outputs from the sums of its samples (taken in sample order)
// and sample 0's record: their mean, the tonemap and the u8 rgba by the
// host's float32 formula (renderer.py:349-356), and the AOVs.
F3D_HD void r1_write(const TerrainArgs& a, const TerrainOut& o, int i, float racc, float gacc,
                     float bacc, const ShadeAux& aux0) {
    float hdr[3] = {racc / (float)a.aa, gacc / (float)a.aa, bacc / (float)a.aa};
    for (int c = 0; c < 3; ++c) {
        float l = a.debug_normals ? aux0.n[c] * 0.5f + 0.5f : tonemap_encode(a, hdr[c]);
        if (o.rgba != nullptr) o.rgba[4 * i + c] = (unsigned char)(clamp01(l) * 255.0f + 0.5f);
        if (o.hdr != nullptr) o.hdr[3 * i + c] = hdr[c];
    }
    if (o.rgba != nullptr) o.rgba[4 * i + 3] = 255;
    write_aovs(o, i, aux0);
}

// renderer.py:_build_program.program for pixel i: `aa` samples (jittered
// when aa > 1) in order, their mean, the tonemap and the u8 rgba; the AOVs
// and the VT fallback count are sample 0's.
F3D_HD void render_pixel(const SceneArgs& s, const TerrainArgs& a, const TerrainOut& o, int i) {
    const int x = i % a.width;
    const int y = i / a.width;
    uint32_t st = r1_seed(a, x, y);
    float racc = 0.0f, gacc = 0.0f, bacc = 0.0f;
    ShadeAux aux0, aux;
    for (int k = 0; k < a.aa; ++k) {
        float r, g, b;
        r1_sample(s, a, x, y, st, r, g, b, aux);
        if (k == 0) {
            aux0 = aux;
            if (aux.vt_miss && o.vt_fallback != nullptr) count_fallback(o.vt_fallback);
        }
        racc = racc + r;
        gacc = gacc + g;
        bacc = bacc + b;
    }
    r1_write(a, o, i, racc, gacc, bacc, aux0);
}

// R1 render's pixel mapping (renderer.cu:render_kernel, K6's): a block of
// 256 threads takes a 16x16 tile, its warp w the 8x4 pixels at (8 (w & 1),
// 4 (w >> 1)), lane l the pixel (l & 7, l >> 3) of those. False for a
// thread of a ragged tile that has no pixel.
F3D_HD bool r1_tile_pixel(const TerrainArgs& a, int block, int thread, int& x, int& y) {
    const int tiles_x = (a.width + 15) / 16;
    const int lane = thread & 31, warp = thread >> 5;
    x = (block % tiles_x) * 16 + (warp & 1) * 8 + (lane & 7);
    y = (block / tiles_x) * 16 + (warp >> 1) * 4 + (lane >> 3);
    return x < a.width && y < a.height;
}

// renderer.py:begin_offline_accumulation.step for pixel i: one jittered
// sample added to the (H, W, 4) accumulator in place and this sample's
// AOVs; returns the luminance of the running mean, which the metric tiles
// average.
F3D_HD float step_pixel(const SceneArgs& s, const TerrainArgs& a, float* accum,
                        uint32_t sample_idx, const TerrainOut& o, int i) {
    const int x = i % a.width;
    const int y = i / a.width;
    uint32_t st = (a.aa_seed ^ ((uint32_t)x * 1664525u) ^ ((uint32_t)y * 1013904223u)
                   ^ F3D_SEED_STEP) ^ (sample_idx * 92837111u);
    float u1, u2;
    st = xorshift32(st, u1);
    st = xorshift32(st, u2);
    float r, g, b;
    ShadeAux aux;
    shade_sample(s, a, x, y, u1 - 0.5f, u2 - 0.5f, st, r, g, b, aux);
    float a0 = accum[4 * i + 0] + r;
    float a1 = accum[4 * i + 1] + g;
    float a2 = accum[4 * i + 2] + b;
    float a3 = accum[4 * i + 3] + 1.0f;
    accum[4 * i + 0] = a0;
    accum[4 * i + 1] = a1;
    accum[4 * i + 2] = a2;
    accum[4 * i + 3] = a3;
    write_aovs(o, i, aux);
    return luminance(a0 / a3, a1 / a3, a2 / a3);
}

#define F3D_TILE 32          // renderer.py:_TILE
#define F3D_TILE_THREADS 256 // the partial sums of a tile's reduction

// Thread j's partial sum of one 32x32 metric tile whose image pixels are
// `rows` x `cols` (fewer at the image's last row and column of tiles),
// `lum` its first pixel, rows `pitch` apart: elements j, j + 256, j + 512,
// j + 768 (element k is row k / 32, column k % 32) in that order. The image
// is padded by replicating its last row and column (renderer.py:1147),
// which lie in the same tile.
F3D_HD float tile_partial(const float* lum, int pitch, int rows, int cols, int j) {
    float acc = 0.0f;
    for (int k = j; k < F3D_TILE * F3D_TILE; k += F3D_TILE_THREADS)
        acc += lum[imin(k / F3D_TILE, rows - 1) * pitch + imin(k % F3D_TILE, cols - 1)];
    return acc;
}

// The mean of a tile in the kernel's summation order, one thread at a time
// (the host build's launcher): the 256 partial sums, then a halving tree.
F3D_HD float tile_mean_serial(const float* lum, int pitch, int rows, int cols) {
    float part[F3D_TILE_THREADS];
    for (int j = 0; j < F3D_TILE_THREADS; ++j) part[j] = tile_partial(lum, pitch, rows, cols, j);
    for (int w = F3D_TILE_THREADS / 2; w > 0; w >>= 1)
        for (int j = 0; j < w; ++j) part[j] += part[j + w];
    return part[0] / (float)(F3D_TILE * F3D_TILE);
}
