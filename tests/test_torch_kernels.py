# The CUDA kernels' code against the plain PyTorch versions, on two
# backends:
# - "host": the per-thread bodies of the kernels (forge3d_tpu_torch/csrc/
#   common.cuh, sweep.cuh) compiled for the CPU with g++ and driven through
#   the kernel wrappers' launch code. This checks the CUDA sources' arithmetic, the
#   ctypes argument blocks and the wrappers without a GPU; it cannot show
#   that nvcc builds the kernels or that they run on the card. The host
#   launchers below loop over the threads in order, as the CUDA launchers in
#   kernels.cu and sweep.cu run them in parallel (the sweep launchers step
#   rows in the order the CTAs' barriers impose).
# - "cuda": the kernels themselves, built with nvcc, on a GPU. These cases
#   carry the `cuda` marker and skip without a CUDA device; on the card run
#   `python -m pytest tests/test_torch_kernels.py -m cuda`.
#
# Tolerances, as in the other port tests: trace hit masks equal on >= 99.9%
# of rays with |dt|/t <= 1e-4; floats |d| <= 1e-5 * (1 + |ref|) and integer
# reservoir fields equal, each on >= 99.9% of elements; whole renders within
# 1 u8 step on >= 99.5% of pixels. Both sides round every float32 operation
# once (-ffp-contract=off / -fmad=false), so they differ only where the math
# library's cos/sin/atan2/acos differ from PyTorch's by an ulp.
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from forge3d_tpu_torch import _kernels
from forge3d_tpu_torch.ops import restir as rst
from forge3d_tpu_torch.ops import sweep as sw
from forge3d_tpu_torch.ops import traversal as tv
from forge3d_tpu_torch.ops.shading import env_map
from forge3d_tpu_torch.pt import terrain_ref as tr
from forge3d_tpu_torch.pt import terrain_sweep as ts

torch.set_num_threads(1)

FRAC = 0.999

HOST_LAUNCHERS = r"""
#include "common.cuh"
#include "pbr.cuh"
#include "post.cuh"
#include "sweep.cuh"
#include "terrain_shade.cuh"
#include "screen.cuh"
#include "vector.cuh"
#include "pt.cuh"
#include "adjudication.cuh"
#include "ibl.cuh"
#include "smoke.cuh"
#include "leaf.cuh"
#include "codec.cuh"
#include <algorithm>
#include <vector>
extern "C" {
int f3d_trace(const SceneArgs* s, const float* rox, const float* roy, const float* roz,
              const float* rdx, const float* rdy, const float* rdz, int n, float tmin,
              float tmax, unsigned char* hit, float* t, int* cell_x, int* cell_z, void*) {
    for (int i = 0; i < n; ++i) {
        Hit h = trace_ray(*s, rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i], tmin, tmax);
        hit[i] = (unsigned char)h.hit; t[i] = h.t; cell_x[i] = h.cell_x; cell_z[i] = h.cell_z;
    }
    return 0;
}
int f3d_frame_step(const SceneArgs* s, const FrameArgs* f, const MeshArgs* m,
                   const LightArgs* l, const float* accum_in, const float* welford_in,
                   const ResArgs* res_in, float* accum_out, float* welford_out,
                   const ResArgs* res_out, void*) {
    const bool hybrid = m->n_nodes > 0 || l->count > 0;
    for (int i = 0; i < f->width * f->rows; ++i) {
        if (hybrid)
            frame_pixel<true>(*s, *f, *m, *l, i, accum_in, welford_in, *res_in, accum_out,
                              welford_out, *res_out);
        else
            frame_pixel<false>(*s, *f, *m, *l, i, accum_in, welford_in, *res_in, accum_out,
                               welford_out, *res_out);
    }
    return 0;
}
int f3d_spatial_reuse(const ResArgs* res_in, const ResArgs* res_out, const float* gb_nx,
                      const float* gb_ny, const float* gb_nz, int width, int height,
                      unsigned int frame_index, unsigned int seed_hi, int k_neighbors,
                      int radius, int row0, int rows, void*) {
    for (int j = 0; j < width * rows; ++j)
        store_res(*res_out, j, spatial_pixel(*res_in, gb_nx, gb_ny, gb_nz, width, height,
                                             frame_index, seed_hi, k_neighbors, radius,
                                             row0 * width + j));
    return 0;
}
int f3d_center_gbuffer(const SceneArgs* s, const MeshArgs* m, int n, const float* cam_o,
                       const float* alb, const float* dx, const float* dy, const float* dz,
                       const unsigned char* hit, const float* t, const int* cell_x,
                       const int* cell_z, float* albedo_out, float* normal_out,
                       float* depth_out, float* vis_out, float* gb_nx, float* gb_ny,
                       float* gb_nz, void*) {
    for (int i = 0; i < n; ++i)
        gbuffer_pixel(*s, *m, cam_o, alb, i, dx[i], dy[i], dz[i], hit[i], t[i], cell_x[i],
                      cell_z[i], albedo_out, normal_out, depth_out, vis_out, gb_nx, gb_ny,
                      gb_nz);
    return 0;
}
int f3d_trace_mesh(const MeshArgs* m, const float* rox, const float* roy, const float* roz,
                   const float* rdx, const float* rdy, const float* rdz, int n, float tmin,
                   float tmax, unsigned char* hit, float* t, int* prim, float* u, float* v,
                   void*) {
    for (int i = 0; i < n; ++i) {
        MeshHit h = trace_mesh_ray(*m, rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i], tmin, tmax);
        hit[i] = (unsigned char)(h.prim >= 0); t[i] = h.t; prim[i] = h.prim; u[i] = h.u; v[i] = h.v;
    }
    return 0;
}
int f3d_sample_light_nee(const LightArgs* l, int n, const float* px, const float* py,
                         const float* pz, const float* nx, const float* ny, const float* nz,
                         const float* u_pick, const float* u1, const float* u2, float* dx,
                         float* dy, float* dz, float* dist, float* wr, float* wg, float* wb,
                         void*) {
    for (int i = 0; i < n; ++i) {
        LightSample s = sample_light(*l, px[i], py[i], pz[i], nx[i], ny[i], nz[i], u_pick[i],
                                     u1[i], u2[i]);
        dx[i] = s.dx; dy[i] = s.dy; dz[i] = s.dz; dist[i] = s.dist;
        wr[i] = s.wr; wg[i] = s.wg; wb[i] = s.wb;
    }
    return 0;
}
int f3d_render_spheres(const CamArgs* c, const SphereArgs* s, const AovArgs* o, void*) {
    for (int i = 0; i < c->width * c->height; ++i) sphere_pixel(*c, *s, *o, i);
    return 0;
}
int f3d_render_mesh(const CamArgs* c, const MeshArgs* m, const MaterialArgs* mat,
                    const AovArgs* o, void*) {
    for (int i = 0; i < c->width * c->height; ++i) mesh_pixel(*c, *m, *mat, *o, i);
    return 0;
}
const char* f3d_error_string(int) { return "host build"; }
int f3d_rotate_heights(const RotArgs* r, float* h_rot, float* du, float* dv, void*) {
    for (int iv = 0; iv < r->n_v; ++iv)
        for (int iu = 0; iu < r->n_u; ++iu) {
            int i = iv * r->n_u + iu;
            rotate_node(*r, iv, iu, h_rot[i], du[i], dv[i]);
        }
    return 0;
}
// K2 as the clustered kernel decomposes it, run in order: each task's
// bands (its CTAs) step one after another, then the halo exchange (each
// band's edge columns into its neighbours' ghost slots) that the kernel's
// pushes make; a row's last step in its two phases; the partial planes and
// the sun's z rows in their oriented layout, then the reduce's unorient and
// plane-order sum
int f3d_sweep_lighting(const float* h, const float* du, const float* dv, int V, int U,
                       const int* tasks, int, const int* ctas, int n_ctas, int, int,
                       const float* table, int nb_max, int zs, int, int, float* invn, float*,
                       float* partial, float* z_orient, const int* plane_q, int n_planes,
                       int sun_q, float* e_sky, float* z_sun, void*) {
    for (size_t i = 0; i < (size_t)V * U; ++i) invn[i] = sweep_invn(du[i], dv[i]);
    const SweepTask* T = reinterpret_cast<const SweepTask*>(tasks);
    const SweepCta* C = reinterpret_cast<const SweepCta*>(ctas);
    const SweepBin* B = reinterpret_cast<const SweepBin*>(table);
    for (int first = 0; first < n_ctas;) {
        const SweepTask t = T[C[first].task];
        int n = 0;
        while (first + n < n_ctas && C[first + n].task == C[first].task) ++n;
        const SweepCta* band = C + first;
        const int R = sweep_rows(t.q, V, U), Cw = sweep_width(t.q, V, U);
        const SweepBin* bins = B + t.bin0;
        std::vector<float> z((size_t)n * 2 * nb_max * zs, F3D_NEG);
        auto buf = [&](int k, int p) { return z.data() + ((size_t)k * 2 + p) * nb_max * zs; };
        auto at = [&](const float* a, int r, int k, int j) {
            return a[sweep_index(t.q, r, band[k].c0 + j, V, U)];
        };
        auto exchange = [&](int p) {
            for (int k = 0; k < n; ++k)
                for (int b = 0; b < t.nb && band[k].w > 0; ++b) {
                    if (k > 0) buf(k - 1, p)[b * zs + band[k - 1].w + 1] = buf(k, p)[b * zs + 1];
                    if (k + 1 < n) buf(k + 1, p)[b * zs] = buf(k, p)[b * zs + band[k].w];
                }
        };
        int cur = 0;
        for (int r = 0; r < R; ++r) {
            for (int j = 1; j < t.ss; ++j) {
                const float f = (float)((double)j / (double)t.ss);
                for (int k = 0; k < n; ++k)
                    for (int b = 0; b < t.nb; ++b)
                        for (int jj = 0; jj < band[k].w; ++jj)
                            buf(k, 1 - cur)[b * zs + jj + 1] = sweep_substep(
                                at(h, r > 0 ? r - 1 : 0, k, jj), at(h, r, k, jj), f,
                                buf(k, cur) + b * zs, jj + 1, bins[b]);
                exchange(1 - cur);
                cur = 1 - cur;
            }
            // a row's last step: phase A a (bin, column), phase B a column
            for (int k = 0; k < n; ++k) {
                std::vector<float> contrib((size_t)t.nb * band[k].w);
                for (int b = 0; b < t.nb; ++b)
                    for (int jj = 0; jj < band[k].w; ++jj) {
                        float zv, z_in;
                        contrib[(size_t)b * band[k].w + jj] = sweep_bin(
                            at(h, r, k, jj), at(du, r, k, jj), at(dv, r, k, jj),
                            at(invn, r, k, jj), bins[b],
                            buf(k, cur) + b * zs, jj + 1, zv, z_in);
                        buf(k, 1 - cur)[b * zs + jj + 1] = zv;
                        if (b == 0 && t.emit) z_orient[(size_t)r * Cw + band[k].c0 + jj] = z_in;
                    }
                for (int jj = 0; jj < band[k].w && t.plane >= 0; ++jj) {
                    const size_t o = (size_t)r * Cw + band[k].c0 + jj;
                    for (int c = 0; c < 3; ++c)
                        partial[((size_t)t.plane * V * U + o) * 3 + c] =
                            sweep_sum(contrib.data() + jj, band[k].w, t.nb, bins, c);
                }
            }
            exchange(1 - cur);
            cur = 1 - cur;
        }
        first += n;
    }
    for (int v = 0; v < V; ++v)
        for (int u = 0; u < U; ++u) {
            sweep_reduce(partial, plane_q, n_planes, V, U, v, u, e_sky);
            if (sun_q >= 0) z_sun[(size_t)v * U + u] = z_orient[sweep_oriented(sun_q, v, u, V, U)];
        }
    return 0;
}
int f3d_sweep_clusters(int, int, int, int, int, int, int* n) {   // no clusters on the host
    *n = 0;
    return 0;
}
int f3d_polar_frame(const PolarArgs* pa, const float* h_rot, const float* e_sky,
                    const float* z_sun, const float* corners, float* acc, float*, void*) {
    const PolarArgs& p = *pa;
    const int K = p.K;
    std::vector<float> M(K), v((size_t)K * 9), hp(K);
    for (int a = 0; a < p.A; ++a) {
        const float t = azimuth_t(p, a);
        int k_first = K;
        for (int k = 0; k < K; ++k) {
            hp[k] = sample_values(p, h_rot, e_sky, z_sun, corners, k, t, M[k], &v[k * 9]);
            if (hp[k] > -1e20f && k < k_first) k_first = k;
        }
        Edge e = edge_sample(p, h_rot, e_sky, z_sun, corners, k_first, t);
        if (e.can) {
            M[e.slot] = e.q;
            for (int c = 0; c < 7; ++c) v[e.slot * 9 + c] = e.v[c];
        }
        float run = -INFINITY;
        for (int k = 0; k < K; ++k) {
            bool valid = hp[k] > -1e20f, valid_prev = k > 0 && hp[k - 1] > -1e20f;
            v[k * 9 + 8] = e.can ? (k == e.slot ? 1.0f : 0.0f) : (valid && !valid_prev ? 1.0f : 0.0f);
            run = fmaxf(run, M[k]);
            M[k] = run;
        }
        for (int row = 0; row < p.E; ++row)
            polar_row(p, M.data(), v.data(), a, row, t, e.h_ent, e.s_ent, acc);
    }
    return 0;
}
int f3d_resolve(const ResolveArgs* r, const float* acc, unsigned char* out, void*) {
    for (int y = 0; y < r->height; ++y)
        for (int x = 0; x < r->width; ++x) resolve_pixel(*r, acc, x, y, out);
    return 0;
}
int f3d_terrain_render(const SceneArgs* s, const TerrainArgs* a, const TerrainOut* o, void*) {
    for (int i = 0; i < a->width * a->height; ++i) render_pixel(*s, *a, *o, i);
    return 0;
}
int f3d_terrain_step(const SceneArgs* s, const TerrainArgs* a, float* accum,
                     unsigned int sample_idx, float* lum, const TerrainOut* o, float* tiles,
                     void*) {
    for (int i = 0; i < a->width * a->height; ++i) step_pixel(*s, *a, accum, sample_idx, lum, *o, i);
    const int tw = (a->width + F3D_TILE - 1) / F3D_TILE, th = (a->height + F3D_TILE - 1) / F3D_TILE;
    for (int ty = 0; ty < th; ++ty)
        for (int tx = 0; tx < tw; ++tx)
            tiles[ty * tw + tx] = tile_mean_serial(lum, a->width, a->height, ty, tx);
    return 0;
}
int f3d_atrous_pass(const AtrousArgs* a, const float* in, float* out, int step, void*) {
    for (int y = 0; y < a->height; ++y)
        for (int x = 0; x < a->width; ++x) atrous_pixel(*a, in, out, step, x, y);
    return 0;
}
int f3d_hosek_radiance(const HosekArgs* s, const float* dx, const float* dy, const float* dz,
                       int n, float* rgb, void*) {
    for (int i = 0; i < n; ++i) hosek_texel(*s, dx[i], dy[i], dz[i], rgb + 3 * i);
    return 0;
}
int f3d_ibl_env_cube(const float* eq, int eq_h, int eq_w, const float* dirs, int size, float* out,
                     void*) {
    for (int i = 0; i < 6 * size * size; ++i) env_cube_texel(eq, eq_h, eq_w, dirs, i, out);
    return 0;
}
int f3d_ibl_convolve(const float* env, int env_size, const float* dirs, int size,
                     const float* smp, int count, int mode, float* out, void*) {
    for (int i = 0; i < 6 * size * size; ++i)
        convolve_texel(env, env_size, dirs, smp, count, mode, i, out);
    return 0;
}
int f3d_raster_depth(const float* tris, const unsigned char* keep, int n_tris, int res, int wbb,
                     int hbb, float* depth, void*) {
    for (int t = 0; t < n_tris; ++t) raster_triangle(tris, keep, t, res, wbb, hbb, depth);
    return 0;
}
// S8 one 2x2 quad at a time: the four pixels' fronts, the quad's normal
// gradient, the four backs (the kernel exchanges the normals by shuffle)
int f3d_screen_shade(const ScreenArgs* a, const ScreenOut* o, void*) {
    for (int qy = 0; qy < a->height / 2; ++qy)
        for (int qx = 0; qx < a->width / 2; ++qx) {
            ShadeState s[4];
            for (int k = 0; k < 4; ++k) shade_front(*a, 2 * qx + (k & 1), 2 * qy + (k >> 1), s[k]);
            const float g = quad_grad(s[0].sn, s[1].sn, s[2].sn);
            for (int k = 0; k < 4; ++k)
                shade_back(*a, *o, 2 * qx + (k & 1), 2 * qy + (k >> 1), s[k], g);
        }
    return 0;
}
// S9 the same way
int f3d_clipmap_shade(const ScreenArgs* a, const ClipArgs* c, unsigned char* rgba, void*) {
    for (int qy = 0; qy < a->height / 2; ++qy)
        for (int qx = 0; qx < a->width / 2; ++qx) {
            ClipState s[4];
            for (int k = 0; k < 4; ++k) clip_front(*a, *c, 2 * qx + (k & 1), 2 * qy + (k >> 1), s[k]);
            const float g = quad_grad(s[0].n, s[1].n, s[2].n);
            for (int k = 0; k < 4; ++k)
                clip_back(*a, *c, rgba, 2 * qx + (k & 1), 2 * qy + (k >> 1), s[k], g);
        }
    return 0;
}
int f3d_struct_sizes(long long* out, int n) {
    const long long sizes[] = {(long long)sizeof(ScreenArgs), (long long)sizeof(ScreenOut),
                               (long long)sizeof(ClipArgs), (long long)sizeof(SkyArgs),
                               (long long)sizeof(SdfArgs), (long long)sizeof(MeshArgs),
                               (long long)sizeof(TlasArgs), (long long)sizeof(HybridArgs),
                               (long long)sizeof(HybridOut), (long long)sizeof(AdjArgs),
                               (long long)sizeof(TerrainArgs), (long long)sizeof(TerrainOut),
                               (long long)sizeof(SmokeMarchArgs), (long long)sizeof(PreethamArgs),
                               (long long)sizeof(GuideArgs)};
    for (int i = 0; i < n && i < 15; ++i) out[i] = sizes[i];
    return 15;
}
// P6, P5, P3 and P4 one point, ray or pixel at a time
int f3d_sdf_eval(const SdfArgs* s, const float* px, const float* py, const float* pz, int n,
                 float* d, int* mat, void*) {
    for (int i = 0; i < n; ++i) d[i] = sdf_eval(*s, px[i], py[i], pz[i], mat[i]);
    return 0;
}
int f3d_sdf_normal(const SdfArgs* s, const float* px, const float* py, const float* pz, int n,
                   float eps, float* out, void*) {
    for (int i = 0; i < n; ++i)
        sdf_normal(*s, px[i], py[i], pz[i], eps, out[i], out[n + i], out[2 * n + i]);
    return 0;
}
int f3d_sdf_march(const SdfArgs* s, const float* rox, const float* roy, const float* roz,
                  const float* rdx, const float* rdy, const float* rdz, int n, float tmin,
                  float tmax, int max_steps, float hit_eps, unsigned char* hit, float* t,
                  int* mat, void*) {
    for (int i = 0; i < n; ++i) {
        SdfHit h = sdf_march(*s, rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i], tmin, tmax,
                             max_steps, hit_eps);
        hit[i] = (unsigned char)h.hit; t[i] = h.t; mat[i] = h.material;
    }
    return 0;
}
int f3d_trace_tlas(const TlasArgs* a, const float* rox, const float* roy, const float* roz,
                   const float* rdx, const float* rdy, const float* rdz, int n, float tmin,
                   float tmax, unsigned char* hit, float* t, int* inst, int* prim, float* u,
                   float* v, void*) {
    for (int i = 0; i < n; ++i) {
        TlasHit h = tlas_ray(*a, rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i], tmin, tmax);
        hit[i] = (unsigned char)h.hit; t[i] = h.t; inst[i] = h.instance; prim[i] = h.prim;
        u[i] = h.u; v[i] = h.v;
    }
    return 0;
}
int f3d_hybrid_render(const SceneArgs* s, const MeshArgs* m, const SdfArgs* sdf,
                      const HybridArgs* a, const float* rdx, const float* rdy, const float* rdz,
                      const HybridOut* o, void*) {
    for (int i = 0; i < a->width * a->height; ++i) hybrid_pixel(*s, *m, *sdf, *a, rdx, rdy, rdz, *o, i);
    return 0;
}
int f3d_adj_raster(const AdjArgs* a, const float* quad, unsigned char* rgba, float* hdr, void*) {
    for (int i = 0; i < a->width * a->height; ++i) adj_raster_pixel(*a, quad, i, rgba, hdr);
    return 0;
}
int f3d_adj_pt(const AdjArgs* a, const uint32_t* keys, unsigned char* rgba, float* hdr, void*) {
    for (int i = 0; i < a->width * a->height; ++i) adj_pt_pixel(*a, keys, i, rgba, hdr);
    return 0;
}
// E4 one pixel at a time, the primitives in order
int f3d_vector_layer(const float* prims, int n, int kind, int width, int height, float half,
                     int evenodd, const float* color, float opacity, int pick_id, float* cov,
                     float* rgb, float* alpha, int* pick, void*) {
    const VectorArgs a = make_vector_args(n, kind, width, height, half, evenodd, color, opacity,
                                          pick_id);
    for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x) vector_pixel_serial(a, prims, x, y, cov, rgb, alpha, pick);
    return 0;
}
// E2 and E1 one element, pixel or texel at a time
int f3d_blur_axis(const float* in, float* out, const float* taps, int radius, int outer, int n,
                  int inner, void*) {
    for (long long e = 0; e < (long long)outer * n * inner; ++e)
        out[e] = blur_axis_elem(in, taps, radius, n, inner, e);
    return 0;
}
int f3d_post_point(int mode, int height, int width, int channels, const float* a,
                   const float* b, const float* c, const float* d, float* out, float p0,
                   float p1, float p2, float p3, float p4, float p5, void*) {
    PointParams q{p0, p1, p2, p3, p4, p5};
    for (int i = 0; i < width * height; ++i)
        post_point_pixel(mode, height, width, channels, a, b, c, d, out, q, i);
    return 0;
}
int f3d_ssr(const float* color, const float* depth, const float* normal, int nc, float* out,
            int height, int width, int stride, int max_steps, float intensity, float fade_den,
            void*) {
    for (int i = 0; i < width * height; ++i)
        ssr_pixel(color, depth, normal, nc, height, width, stride, max_steps, intensity,
                  fade_den, out, i);
    return 0;
}
int f3d_taa(const float* cur, const float* hist, float* out, int height, int width,
            int channels, float blend, float one_minus_blend, int clamp, void*) {
    for (int i = 0; i < width * height; ++i)
        taa_pixel(cur, hist, out, height, width, channels, blend, one_minus_blend, clamp, i);
    return 0;
}
int f3d_ssao(const float* depth, const float* normal, int nc, const int* offsets, int n_samples,
             float* out, int height, int width, float bias, float rden, float intensity,
             void*) {
    for (int i = 0; i < width * height; ++i)
        out[i] = ssao_pixel(depth, normal, nc, offsets, n_samples, height, width, bias, rden,
                            intensity, i);
    return 0;
}
int f3d_rect_lights(const float* p, const float* n, const float* v, int count,
                    const float* lights, int n_lights, float* out, void*) {
    for (int i = 0; i < count; ++i)
        rect_lights_point(p, n, v, reinterpret_cast<const RectLight*>(lights), n_lights, out, i);
    return 0;
}
int f3d_equirect_accum(const float* env, int env_h, int env_w, const float* dirs,
                       const float* w, int samples, int texels, int mode, float* out, void*) {
    for (int t = 0; t < texels; ++t)
        equirect_accum_texel(env, env_h, env_w, dirs, w, samples, texels, mode, out, t);
    return 0;
}
// E8 one voxel or pixel at a time
int f3d_smoke_forces(const float* vel, const float* temp, float* vf, long long n, float dtb,
                     float amb, float w0, float w1, float w2, float kdamp, void*) {
    for (long long i = 0; i < n; ++i)
        smoke_forces_voxel(vel, temp, vf, n, dtb, amb, w0, w1, w2, kdamp, i);
    return 0;
}
int f3d_smoke_advect_velocity(const float* vf, float* va, int nx, int ny, int nz, float dt,
                              int forms, void*) {
    for (long long i = 0; i < (long long)nx * ny * nz; ++i)
        smoke_advect_velocity_voxel(vf, va, nx, ny, nz, dt, forms, i);
    return 0;
}
int f3d_smoke_divergence(const float* va, float* div, int nx, int ny, int nz, void*) {
    for (long long i = 0; i < (long long)nx * ny * nz; ++i)
        div[i] = smoke_divergence_voxel(va, nx, ny, nz, i);
    return 0;
}
int f3d_smoke_jacobi(const float* p, const float* div, float* p_out, int nx, int ny, int nz,
                     float sixth, void*) {
    for (long long i = 0; i < (long long)nx * ny * nz; ++i)
        p_out[i] = smoke_jacobi_voxel(p, div, nx, ny, nz, sixth, i);
    return 0;
}
int f3d_smoke_project_advect(const float* va, const float* p, const float* div,
                             const float* dens, const float* temp, const float* soot,
                             const float* emis, float* vel_out, float* dens_out, float* temp_out,
                             float* soot_out, float* emis_out, int nx, int ny, int nz, float dt,
                             float keep, float keep2, float sixth, void*) {
    for (long long i = 0; i < (long long)nx * ny * nz; ++i)
        smoke_project_advect_voxel(va, p, div, dens, temp, soot, emis, vel_out, dens_out,
                                   temp_out, soot_out, emis_out, nx, ny, nz, dt, keep, keep2,
                                   sixth, i);
    return 0;
}
int f3d_smoke_march(const SmokeMarchArgs* a, const float* dens, const float* emis,
                    const float* soot, const float* sun_off, unsigned char* rgba, void*) {
    for (long long i = 0; i < (long long)a->width * a->height; ++i)
        smoke_march_pixel(*a, dens, emis, soot, sun_off, rgba, i);
    return 0;
}
// E9, E5 Preetham, E6 and E7 one element, direction, point, record, bin or
// query at a time
int f3d_dd(int op, const float* ahi, const float* alo, const float* bhi, const float* blo,
           long long n, float* hi, float* lo, void*) {
    for (long long i = 0; i < n; ++i)
        dd_op(op, ahi[i], alo[i], op == F3D_DD_SQRT ? 0.0f : bhi[i],
              op == F3D_DD_SQRT ? 0.0f : blo[i], hi[i], lo[i]);
    return 0;
}
int f3d_preetham(const PreethamArgs* s, const float* dx, const float* dy, const float* dz,
                 long long n, float* rgb, void*) {
    for (long long i = 0; i < n; ++i)
        preetham_texel(*s, dx[i], dy[i], dz[i], rgb + i, rgb + n + i, rgb + 2 * n + i);
    return 0;
}
int f3d_eval_lights(const float* lights, int n_lights, const float* p, const float* n,
                    const float* u, long long count, float* out, void*) {
    for (long long i = 0; i < count; ++i) eval_lights_point(lights, n_lights, p, n, u, out, i);
    return 0;
}
int f3d_octa_encode(const float* dx, const float* dy, const float* dz, long long n, int res,
                    int* out, void*) {
    for (long long i = 0; i < n; ++i) out[i] = octa_encode_dir(dx[i], dy[i], dz[i], res);
    return 0;
}
int f3d_octa_decode(const int* bins, long long n, int res, float* out, void*) {
    for (long long i = 0; i < n; ++i) {
        float d[3];
        octa_decode_bin(bins[i], res, d);
        out[i] = d[0]; out[n + i] = d[1]; out[2 * n + i] = d[2];
    }
    return 0;
}
int f3d_guide_keys(const GuideArgs* g, const float* px, const float* pz, const float* dx,
                   const float* dy, const float* dz, long long n, int* keys, void*) {
    for (long long i = 0; i < n; ++i) keys[i] = guide_key(*g, px[i], pz[i], dx[i], dy[i], dz[i]);
    return 0;
}
int f3d_guide_bounds(const int* keys, const long long* perm, const float* lum, long long n,
                     int* seg_start, int* seg_end, float* lum_sorted, void*) {
    for (long long s = 0; s < n; ++s)
        guide_bounds(keys, perm, lum, n, seg_start, seg_end, lum_sorted, s);
    return 0;
}
int f3d_guide_bins(const int* seg_start, const int* seg_end, const float* lum_sorted,
                   const float* hist_in, long long bins, int threshold, int* long_list,
                   float* hist_out, void*) {
    for (long long k = 0; k < bins; ++k) {
        if (guide_is_long(seg_start, seg_end, k, threshold))
            long_list[1 + long_list[0]++] = (int)k;
        else
            hist_out[k] = guide_bin_sum(seg_start, seg_end, lum_sorted, hist_in, k);
    }
    return 0;
}
// a listed bin's run staged chunk by chunk, as the block's ring holds it
int f3d_guide_long(const int* seg_start, const int* seg_end, const float* lum_sorted,
                   const float* hist_in, const int* long_list, int max_long, float* hist_out,
                   void*) {
    std::vector<float> stage(F3D_GUIDE_STAGE);
    for (int b = 0; b < long_list[0] && b < max_long; ++b) {
        const int k = long_list[1 + b], start = seg_start[k], end = seg_end[k];
        float acc = hist_in[k];
        for (int i = 0; i < guide_chunk_count(start, end, F3D_GUIDE_STAGE); ++i) {
            int src, lo, hi;
            const int m = guide_chunk(start, end, F3D_GUIDE_STAGE, i, &src, &lo, &hi);
            if (src % 4 != 0 || m % 4 != 0 || m > F3D_GUIDE_STAGE) return 1;   // not 16-byte copies
            std::fill(stage.begin(), stage.end(), NAN);   // a read outside [lo, hi) shows
            std::copy(lum_sorted + src, lum_sorted + src + m, stage.begin());
            acc = guide_stage_sum(acc, stage.data(), lo, hi);
        }
        hist_out[k] = acc;
    }
    return 0;
}
int f3d_guide_sample(const GuideArgs* g, const float* hist, const float* px, const float* pz,
                     const float* u1, const float* u2, long long n, float* out, void*) {
    for (long long i = 0; i < n; ++i) {
        float o[4];
        guide_sample_query(*g, hist, px[i], pz[i], u1[i], u2[i], o);
        for (int c = 0; c < 4; ++c) out[c * n + i] = o[c];
    }
    return 0;
}
// C1: a tile at a time, the table built as the block builds it; the
// reconstruction in raster order (each value needs only its left, up and
// up-left neighbours, which the kernel's wavefront also has computed)
int f3d_rans_decode(const uint8_t* stream, const uint32_t* lens, int cap, const uint32_t* freq,
                    const uint32_t* extras, int ecap, int n_tiles, int32_t* d, void*) {
    std::vector<uint32_t> tab(F3DZ_PROB_SCALE);
    for (int t = 0; t < n_tiles; ++t) {
        const uint32_t* f = freq + (size_t)t * 256;
        uint32_t c = 0;
        for (int s = 0; s < 256; ++s) {
            rans_fill((uint32_t)s, f[s], c, tab.data());
            c += f[s];
        }
        rans_chain(tab.data(), stream + (size_t)t * cap, lens[t], (uint32_t)cap,
                   extras + (size_t)t * ecap, ecap, F3DZ_TILE_PX, d + (size_t)t * F3DZ_TILE_PX);
    }
    return 0;
}
int f3d_med_reconstruct(const int32_t* d, int n_tiles, int ntx, int width, double step,
                        float* out, void*) {
    std::vector<int32_t> q(F3DZ_TILE_PX);
    for (int t = 0; t < n_tiles; ++t) {
        const int32_t* dt = d + (size_t)t * F3DZ_TILE_PX;
        for (int y = 0; y < F3DZ_TILE; ++y)
            for (int x = 0; x < F3DZ_TILE; ++x) {
                const int32_t left = x > 0 ? q[y * F3DZ_TILE + x - 1] : 0;
                const int32_t up = y > 0 ? q[(y - 1) * F3DZ_TILE + x] : 0;
                const int32_t ul = (x > 0 && y > 0) ? q[(y - 1) * F3DZ_TILE + x - 1] : 0;
                q[y * F3DZ_TILE + x] = wrap_add(med_pred(left, up, ul, x, y), dt[y * F3DZ_TILE + x]);
                out[(size_t)((t / ntx) * F3DZ_TILE + y) * width + (t % ntx) * F3DZ_TILE + x] =
                    f3dz_height(q[y * F3DZ_TILE + x], step);
            }
    }
    return 0;
}
// test entry: synthesize_polar's contraction for one column and row
float f3d_test_crossing(const float* M, const float* v, int K, int C, float Q, float* out) {
    return crossing(M, v, C, C, K, Q, out);
}
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel bodies needs it")
    d = tmp_path_factory.mktemp("kernels_host")
    src = d / "host_launchers.cpp"
    src.write_text(HOST_LAUNCHERS)
    out = d / "libhost_kernels.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(_kernels.CSRC), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True, timeout=300)
    return _kernels.bind(ctypes.CDLL(str(out)))


@pytest.fixture(params=["host", pytest.param("cuda", marks=pytest.mark.cuda)])
def kernels(request, monkeypatch):
    """The device the kernel wrappers run on; for "host", their launches go
    to the host build."""
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernels run only on the card")
        return torch.device("cuda")
    host_lib = request.getfixturevalue("host_lib")
    monkeypatch.setattr(_kernels, "lib", lambda: host_lib)
    monkeypatch.setattr(_kernels, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    return torch.device("cpu")


def close_frac(ref, got):
    ref = ref.double()
    got = got.double()
    ok = (got - ref).abs() <= 1e-5 * (1.0 + ref.abs())
    return float((ok | (torch.isnan(ref) & torch.isnan(got))).double().mean())


def make_ctx(device, **kw):
    n = 65
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (6.0 * np.sin(x * 0.15) * np.cos(y * 0.12)).astype(np.float32)
    em = kw.pop("env", None)
    desc = tr.TerrainRefDesc(heights=dem, cam_origin=(32.0, 22.0, 90.0),
                             cam_look_at=(32.0, 0.0, 32.0), fov_y_deg=42.0, width=96,
                             height=48, env_map=em, **kw)
    scene = tv.scene_from_pyramid(tr.build_pyramid(dem), spacing_xz=desc.spacing,
                                  exaggeration=desc.exaggeration, device=device)
    return tr.make_context(desc, scene, env_map(em, desc.env_intensity, device))


def assert_reservoirs(ref, got):
    for name in rst.Reservoirs.__dataclass_fields__:
        a, b = getattr(ref, name), getattr(got, name)
        frac = float((a == b).double().mean()) if not a.is_floating_point() else close_frac(a, b)
        assert frac >= FRAC, name


def test_trace_and_gbuffer(kernels):
    ctx = make_ctx(kernels)
    o, d = tr._center_rays(ctx)
    rng = np.random.default_rng(0)
    ro = torch.as_tensor(rng.uniform([-10, 8, -10], [74, 30, 74], (4096, 3)).astype(np.float32),
                         device=kernels)
    rd = torch.as_tensor(rng.standard_normal((4096, 3)).astype(np.float32), device=kernels)
    rd[:, 1] = -rd[:, 1].abs() * 0.5
    rd = rd / rd.norm(dim=1, keepdim=True)
    ro_all = tuple(torch.cat([o[i].reshape(-1), ro[:, i]]) for i in range(3))
    rd_all = tuple(torch.cat([d[i].reshape(-1), rd[:, i]]) for i in range(3))
    before = tv.trace.launches
    hk = tv._trace_kernel(ctx.scene, ro_all, rd_all, 1e-3, 1e30)
    assert tv.trace.launches == before + 1
    hp = tv.trace_plain(ctx.scene, ro_all, rd_all)
    assert float((hp.hit == hk.hit).double().mean()) >= FRAC
    both = hp.hit & hk.hit
    assert float(((hk.t[both] - hp.t[both]).abs() / hp.t[both]).max()) <= 1e-4
    # the trace has no transcendental function: both sides run the same
    # float32 operations, so t is bit-equal on (nearly) every ray
    assert float((hk.t[both] == hp.t[both]).double().mean()) >= FRAC
    assert torch.equal(hp.cell_x[both], hk.cell_x[both])

    th = tv.trace_plain(ctx.scene, o, d)
    gp = tr.gbuffer_resolve_plain(ctx, d, th)
    gk = tr._gbuffer_resolve_kernel(ctx, d, th)
    for k in ("albedo", "normal", "depth", "visibility"):
        assert close_frac(gp[k], gk[k]) >= FRAC, k
    for a, b in zip(gp["gb_n"], gk["gb_n"]):
        assert close_frac(a, b) >= FRAC


@pytest.mark.parametrize("kw", [
    dict(spp=2),
    dict(spp=1, restir=False, shadows_enabled=False),
    dict(spp=1, env=np.random.default_rng(1).uniform(0, 2, (8, 16, 3)).astype(np.float32)),
], ids=["restir_spp2", "plain_nee_no_shadows", "env_map"])
def test_frame_and_spatial_reuse(kernels, kw):
    ctx = make_ctx(kernels, **kw)
    H, W = ctx.height, ctx.width
    gb = tr.center_gbuffer_plain(ctx)["gb_n"]
    acc = torch.zeros(H, W, 4, device=kernels)
    wf = torch.zeros(H, W, 2, device=kernels)
    res = rst.Reservoirs.zeros(H * W, kernels)
    for frame in (0, 1, 32):  # 32 restarts the Welford window
        pa, pw, pm = tr.frame_step_plain(ctx, acc, wf, res, frame)
        ka, kw_, km = tr._frame_step_kernel(ctx, acc, wf, res, frame)
        assert close_frac(pa, ka) >= FRAC and close_frac(pw, kw_) >= FRAC
        assert_reservoirs(pm, km)
        rp = rst.spatial_reuse_plain(km, *gb, W, H, frame, ctx.seed_hi)
        rk = rst._spatial_reuse_kernel(km, *gb, W, H, frame, ctx.seed_hi, 8, 3)
        assert_reservoirs(rp, rk)
        acc, wf, res = ka, kw_, rk
    assert int(res.m.sum()) > 0


# K6 band and K7 band (M1): the kernels on a band of rows equal the
# whole-frame launches' rows bit for bit, and the plain versions on the
# band; bands of 16, 2 and 30 rows, the last at the frame's bottom edge
BANDS = [(0, 16), (16, 2), (18, 30)]


@pytest.mark.parametrize("kw", [dict(spp=2), dict(spp=1, restir=False)],
                         ids=["restir_spp2", "plain_nee"])
def test_frame_and_spatial_reuse_bands(kernels, kw):
    ctx = make_ctx(kernels, **kw)
    H, W = ctx.height, ctx.width
    gb = tr.center_gbuffer_plain(ctx)["gb_n"]
    acc = torch.zeros(H, W, 4, device=kernels)
    wf = torch.zeros(H, W, 2, device=kernels)
    res = rst.Reservoirs.zeros(H * W, kernels)
    before = (tr.frame_step_band.launches, rst.spatial_reuse_band.launches)
    for frame in (0, 1):
        ka, kw_, km = tr._frame_step_kernel(ctx, acc, wf, res, frame)
        rk = rst._spatial_reuse_kernel(km, *gb, W, H, frame, ctx.seed_hi, 8, 3)
        for row0, rows in BANDS:
            px = slice(row0 * W, (row0 + rows) * W)
            band = rst.Reservoirs(*(f[px] for f in res.fields()))
            args = (ctx, acc[row0:row0 + rows], wf[row0:row0 + rows], band, frame, row0)
            ba, bw, bm = tr._frame_step_kernel(*args, counter=tr.frame_step_band)
            assert torch.equal(ba, ka[row0:row0 + rows]) and torch.equal(bw, kw_[row0:row0 + rows])
            for f, g in zip(bm.fields(), km.fields()):
                assert torch.equal(f, g[px])
            pa, pw, pm = tr.frame_step_plain(*args)
            assert close_frac(pa, ba) >= FRAC and close_frac(pw, bw) >= FRAC
            assert_reservoirs(pm, bm)
            br = rst._spatial_reuse_kernel(km, *gb, W, H, frame, ctx.seed_hi, 8, 3, row0, rows,
                                           counter=rst.spatial_reuse_band)
            for f, g in zip(br.fields(), rk.fields()):
                assert torch.equal(f, g[px])
            assert_reservoirs(rst.spatial_reuse_plain(km, *gb, W, H, frame, ctx.seed_hi, 8, 3,
                                                      row0, rows), br)
        acc, wf, res = ka, kw_, rk
    assert (tr.frame_step_band.launches, rst.spatial_reuse_band.launches) == (
        before[0] + 2 * len(BANDS), before[1] + 2 * len(BANDS))
    with pytest.raises(ValueError, match="outside"):
        tr._frame_step_kernel(ctx, acc[:4], wf[:4], rst.Reservoirs.zeros(4 * W, kernels), 2, H - 2)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(spp=2, max_frames=4, min_frames=2),
    dict(spp=1, max_frames=35, min_frames=33, sun_elevation_deg=8.0,
         env_map=np.random.default_rng(2).uniform(0, 2, (8, 16, 3)).astype(np.float32)),
], ids=["4_frames", "window_reset_env_map"])
def test_render_on_card_matches_plain_render(kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    y, x = np.mgrid[0:49, 0:49].astype(np.float32)
    dem = (5.0 * np.sin(x * 0.2) * np.cos(y * 0.17)).astype(np.float32)
    cam = {"origin": (24, 20, 70), "look_at": (24, 0, 24), "fov_y": 42.0}
    counters = (tv.trace, tr.frame_step, rst.spatial_reuse, tr.center_gbuffer)
    before = [c.launches for c in counters]
    a = tr.hybrid_render_terrain_reference(dem, 64, 48, cam, variance_threshold=1e9,
                                           device="cpu", **kw)
    b = tr.hybrid_render_terrain_reference(dem, 64, 48, cam, variance_threshold=1e9,
                                           device="cuda", **kw)
    frames = kw["max_frames"]
    assert [c.launches - n for c, n in zip(counters, before)] == [1, frames, frames, 1]
    assert a["frames"] == b["frames"] == frames
    du = np.abs(a["rgba"].astype(np.int32) - b["rgba"].astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= 0.995
    np.testing.assert_array_equal(np.isnan(a["depth"]), np.isnan(b["depth"]))


# ---------------------------------------------------------------------------
# The sweep estimator's kernels K1-K4 (csrc/sweep.cuh) against their plain
# versions, on the 128x96 / 65^2 scene of tests/test_sweep.py.
# Tolerances: K1 and K3 floats |d| <= 1e-5 * (1 + |ref|) on >= 99.9% of
# elements with equal -1e30 masks; K2 z_sun on >= 99.9% and e_sky on
# >= 99.5% (the kernel sums the sky bins per stratum and the plain version
# per quadrant); K4 bytes within one step on >= 99.9% of pixels.
# ---------------------------------------------------------------------------


def sweep_case(device, env=None, sun_elevation_deg=45.0):
    n = 65
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (6.0 * np.sin(x * 0.15) * np.cos(y * 0.12)).astype(np.float32)
    desc = tr.TerrainRefDesc(heights=dem, cam_origin=(32.0, 22.0, 90.0),
                             cam_look_at=(32.0, 0.0, 32.0), fov_y_deg=42.0, width=128,
                             height=96, env_map=env, env_intensity=0.8,
                             sun_elevation_deg=sun_elevation_deg)
    plan = ts.plan_for(desc)
    scene = ts.make_scene(desc, device)
    rot = sw.rotate_heights_plain(scene.heights, plan.rot)
    jit = ts.frame_jitters(5, 2)[1]
    return plan, scene, rot, jit


ENV = np.random.default_rng(4).uniform(0, 2, (8, 16, 3)).astype(np.float32)


def test_rotate_heights_kernel(kernels):
    plan, scene, rot, _ = sweep_case(kernels)
    before = sw.rotate_heights.launches
    got = sw._rotate_kernel(scene.heights, plan.rot)
    assert sw.rotate_heights.launches == before + 1
    for a, b in zip(rot, got):
        assert close_frac(a, b) >= FRAC
    assert torch.equal(rot[0] < -1e20, got[0] < -1e20)


@pytest.mark.parametrize("global_rows", [False, True], ids=["shared_rows", "global_rows"])
def test_sweep_lighting_kernel(kernels, global_rows, monkeypatch):
    plan, scene, rot, jit = sweep_case(kernels, env=ENV)
    bins = ts.frame_bins(plan, scene, jit)
    ref = sw.sweep_lighting_plain(*rot, bins)
    if global_rows:  # a limit of 0 sends the rows to device memory
        monkeypatch.setattr(_kernels, "SMEM_LIMIT", 0)
    got = sw._sweep_kernel(*rot, bins)
    assert close_frac(ref.z_sun, got.z_sun) >= FRAC
    assert close_frac(ref.e_sky, got.e_sky) >= 0.995
    assert float(got.e_sky.max()) > 0.0


def test_sweep_lighting_kernel_sun_only(kernels):
    plan, scene, rot, jit = sweep_case(kernels, sun_elevation_deg=20.0)
    bins = sw.sweep_bins(strata=sw.make_strata(4, 1), key=jit.k_sky, env=scene.env_host,
                         e_u=plan.rg.e_u, e_v=plan.rg.e_v, sun_world=plan.sun_w,
                         spacing=plan.rg.spacing, sun_only=True)
    ref = sw.sweep_lighting_plain(*rot, bins)
    got = sw._sweep_kernel(*rot, bins)
    assert close_frac(ref.z_sun, got.z_sun) >= FRAC
    assert float(got.e_sky.abs().max()) == 0.0


def narrow_last(width, n):
    """Band widths of `width` columns over n CTAs with the last band 2
    columns wide (in place of sw._even_bands)."""
    head = width - 2
    return [head // (n - 1) + (k < head % (n - 1)) for k in range(n - 1)] + [2]


@pytest.mark.parametrize("rows,bands,narrow", [
    ("shared_rows", 1, False), ("shared_rows", 2, False), ("shared_rows", 3, True),
    ("global_rows", 1, False)], ids=["1_band", "2_bands", "3_bands_last_2_wide", "global_rows"])
@pytest.mark.parametrize("ss", [1, 2])
def test_sweep_lighting_bands(kernels, rows, bands, narrow, ss, monkeypatch):
    """K2's decomposition (bands, a halo exchange a step, the oriented
    partial planes and the reduce's unorient) against its sums in plain
    PyTorch, bit for bit: z_sun equal to sweep_lighting_plain's, e_sky to
    sweep_lighting_stratum_order's (the plain version's within tolerance),
    every quadrant at ss substeps a row. The band count is set through
    K2_CLUSTERS, the band widths through _even_bands."""
    plan, scene, rot, jit = sweep_case(kernels, env=ENV)
    bins = sw.sweep_bins(strata=plan.strata, key=jit.k_sky, env=scene.env_host,
                         e_u=plan.rg.e_u, e_v=plan.rg.e_v, sun_world=plan.sun_w,
                         spacing=plan.rg.spacing, substeps=ss, sky_substeps=ss)
    assert sorted(g.q for g in bins.groups) == [0, 1, 2, 3]
    assert all(g.substeps == ss for g in bins.groups)
    monkeypatch.setattr(sw, "_K2_LAUNCHES", {})
    monkeypatch.setattr(sw, "K2_CLUSTERS", (bands,))
    if narrow:
        monkeypatch.setattr(sw, "_even_bands", narrow_last)
    if rows == "global_rows":  # a limit of 0 sends the z rows to device memory
        monkeypatch.setattr(_kernels, "SMEM_LIMIT", 0)
    tasks, _, _ = sw.kernel_tables(bins)
    p = sw.k2_plan(*rot[0].shape, tasks)
    assert p.use_global == (rows == "global_rows") and p.cluster == bands
    if narrow:
        assert int(p.ctas[:, 2].min()) == 2
    got = sw._sweep_kernel(*rot, bins)
    ref = sw.sweep_lighting_stratum_order(*rot, bins)
    plain = sw.sweep_lighting_plain(*rot, bins)
    assert torch.equal(got.z_sun, plain.z_sun) and torch.equal(ref.z_sun, plain.z_sun)
    assert torch.equal(got.e_sky, ref.e_sky)
    assert close_frac(plain.e_sky, got.e_sky) >= 0.995 and float(got.e_sky.max()) > 0.0


def k2_tasks(ss_sun=2):
    """bench.py's K2 task table: the sun (quadrant 1, ss_sun substeps a
    row), then 32 strata of 12 bins, 8 a quadrant."""
    rows = [[1, ss_sun, 0, 1, -1, 1]]
    rows += [[k // 8, ss_sun if k // 8 == 1 else 1, 1 + 12 * k, 12, k, 0] for k in range(32)]
    return torch.tensor(rows, dtype=torch.int32)


@pytest.mark.parametrize("width,cluster,band,rows", [
    (72, 1, 72, "shared"), (148, 1, 148, "shared"), (149, 7, 22, "shared"),
    (1032, 7, 148, "shared"), (1036, 7, 148, "shared"), (1037, 16, 65, "shared"),
    (2064, 16, 129, "shared"), (4256, 16, 266, "shared"), (4257, 1, 4257, "device")])
def test_k2_plan_by_width(width, cluster, band, rows):
    """K2's cluster size follows the grid's width: one CTA a task up to
    K2_BAND columns, then 7, then 16 while a band's threads fit a CTA,
    then one CTA a task with its rows in device memory. Every column is in
    exactly one band of its task, the longest tasks first and the sun
    last."""
    tasks = k2_tasks()
    p = sw.k2_plan(width, width, tasks)
    assert (p.cluster, p.band, "device" if p.use_global else "shared") == (cluster, band, rows)
    assert p.groups == (sw.K2_GLOBAL_GROUPS if p.use_global else 3)
    assert p.threads <= (1024 if p.use_global else sw._SMEM_THREADS)
    ctas = p.ctas.tolist()
    assert len(ctas) == tasks.shape[0] * p.cluster
    for k in range(tasks.shape[0]):
        mine = ctas[k * p.cluster:(k + 1) * p.cluster]
        assert len({t for t, _, _ in mine}) == 1
        assert [c0 for _, c0, _ in mine] == [sum(w for _, _, w in mine[:i]) for i in range(len(mine))]
        assert sum(w for _, _, w in mine) == width
    order = [t for t, _, _ in ctas[::p.cluster]]
    assert order[-1] == 0 and all(int(tasks[t, 1]) == 2 for t in order[:8])


def test_k2_launch_is_built_once(monkeypatch):
    """A grid and task table keep their launch (plan and the tables on the
    device) from frame to frame; a change of either, or of a setting, gives
    another."""
    monkeypatch.setattr(sw, "_K2_LAUNCHES", {})
    tasks = k2_tasks()
    first = sw._k2_launch(90, 92, tasks, 32, "cpu")
    assert sw._k2_launch(90, 92, tasks.clone(), 32, "cpu") is first
    assert sw._k2_launch(92, 92, tasks, 32, "cpu") is not first
    assert sw._k2_launch(90, 92, k2_tasks(ss_sun=1), 32, "cpu") is not first
    monkeypatch.setattr(sw, "K2_CLUSTERS", (7,))
    again = sw._k2_launch(90, 92, tasks, 32, "cpu")
    assert again is not first and again[0].cluster == 7 and first[0].cluster == 1
    p, ints = first
    assert torch.equal(ints[:tasks.numel()], tasks.reshape(-1))
    assert torch.equal(ints[tasks.numel():tasks.numel() + p.ctas.numel()], p.ctas.reshape(-1))
    assert ints[tasks.numel() + p.ctas.numel():].tolist() == [k // 8 for k in range(32)]


@pytest.mark.parametrize("env", [None, ENV], ids=["constant_env", "env_map"])
def test_polar_frame_kernel(kernels, env):
    plan, scene, rot, jit = sweep_case(kernels, env=env)
    maps = sw.sweep_lighting_plain(*rot, ts.frame_bins(plan, scene, jit))
    ps = plan.ps
    acc0 = torch.rand((ps.e_count, ps.a_count, 9), generator=torch.Generator().manual_seed(0))
    acc0 = acc0.to(kernels)
    ref = acc0 + ts.frame_polar_plain(plan, scene, rot[0], maps, jit.xi, jit.ja, jit.je)
    before = ts.polar_frame.launches
    got = ts._polar_kernel(plan, scene, acc0.clone(), rot[0], maps, jit.xi, jit.ja, jit.je)
    assert ts.polar_frame.launches == before + 1
    assert close_frac(ref, got) >= FRAC
    with pytest.MonkeyPatch.context() as mp:  # the column's profile in device memory
        mp.setattr(_kernels, "SMEM_LIMIT", 0)
        got_g = ts._polar_kernel(plan, scene, acc0.clone(), rot[0], maps, jit.xi, jit.ja, jit.je)
    assert torch.equal(got, got_g)


def decode(packed, W, H):
    """(vis, oct, depth, hdr) of a packed buffer, as numpy."""
    desc = tr.TerrainRefDesc(heights=np.zeros((2, 2), np.float32), width=W, height=H)
    out = ts._unpack_render(desc, packed.cpu().numpy(), 1)
    buf = packed.cpu().numpy()
    return buf[:W * H], buf[W * H:3 * W * H], out["depth"], out["hdr"]


def test_resolve_kernel(kernels):
    plan, scene, rot, _ = sweep_case(kernels)
    acc = torch.zeros((plan.ps.e_count, plan.ps.a_count, 9), device=kernels)
    for jit in ts.frame_jitters(3, 2):
        maps = sw.sweep_lighting_plain(*rot, ts.frame_bins(plan, scene, jit))
        acc += ts.frame_polar_plain(plan, scene, rot[0], maps, jit.xi, jit.ja, jit.je)
    ref = ts.resolve_plain(plan, acc, 2)
    got = ts._resolve_kernel(plan, acc, 2)
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    W, H = plan.width, plan.height
    (vr, orf, dr, hr), (vg, og, dg, hg) = decode(ref, W, H), decode(got, W, H)
    assert (np.abs(vr.astype(int) - vg.astype(int)) <= 1).mean() >= FRAC
    assert (np.abs(orf.astype(int) - og.astype(int)) <= 1).mean() >= FRAC
    np.testing.assert_array_equal(np.isnan(dr), np.isnan(dg))
    hit = ~np.isnan(dr)
    assert (np.abs(dr[hit] - dg[hit]) <= 1e-3 * np.abs(dr[hit])).mean() >= FRAC
    assert (np.abs(hr - hg) <= 1.0 / 128 * np.abs(hr).max(-1, keepdims=True)).mean() >= FRAC
    assert (ref == got).double().mean() >= FRAC


def dense_crossing(M, v, Q):
    """synthesize_polar's dense contraction for one column (float32)."""
    f = np.float32
    m_next = np.concatenate([M[1:], M[-1:]])
    rden = (f(1.0) / np.maximum(m_next - M, f(1e-9))).astype(f)
    alpha = np.clip((m_next - f(Q)) * rden, f(0), f(1)).astype(f)
    cross = alpha - np.concatenate([[f(0)], alpha[:-1]]).astype(f)
    return (cross[:, None] * v).sum(0, dtype=np.float64), alpha[-1]


def test_crossing_search_matches_dense_contraction(host_lib):
    """K3's binary-search crossing against the dense soft-indicator
    contraction, on random monotone profiles with plateaus (including
    steps below 1e-9) and row tangents exactly on profile values."""
    lib = host_lib
    lib.f3d_test_crossing.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.f3d_test_crossing.restype = ctypes.c_float
    rng = np.random.default_rng(11)
    worst = 0.0
    for trial in range(300):
        K = int(rng.integers(2, 80))
        steps = rng.exponential(0.05, K).astype(np.float32)
        steps[rng.random(K) < 0.4] = 0.0                       # plateaus
        steps[rng.random(K) < 0.1] = np.float32(3e-10)         # sub-1e-9 steps
        q = (np.float32(-0.4) + np.cumsum(steps, dtype=np.float32)).astype(np.float32)
        q[0] = np.float32(-1e4) if trial % 3 == 0 else q[0]
        M = np.maximum.accumulate(q).astype(np.float32)
        v = rng.standard_normal((K, 3)).astype(np.float32)
        Qs = list(rng.uniform(M[0] - 0.1, M[-1] + 0.1, 6).astype(np.float32)) + [
            M[int(rng.integers(0, K))], M[-1], M[0] - np.float32(1e-3)]
        for Q in Qs:
            out = np.zeros(3, np.float32)
            hit = lib.f3d_test_crossing(M.ctypes.data, v.ctypes.data, K, 3, float(Q),
                                        out.ctypes.data)
            ref, ref_hit = dense_crossing(M, v, Q)
            assert np.float32(hit) == ref_hit
            worst = max(worst, float(np.abs(out - ref).max()))
    assert worst <= 1e-5


@pytest.mark.cuda
def test_sweep_render_on_card_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    y, x = np.mgrid[0:33, 0:33].astype(np.float32)
    dem = (4.0 * np.sin(x * 0.2) * np.cos(y * 0.17)).astype(np.float32)
    cam = {"origin": (16.0, 14.0, 46.0), "look_at": (16.0, 0.0, 16.0), "fov_y": 42.0}
    counters = (sw.rotate_heights, sw.sweep_lighting, ts.polar_frame, ts.resolve)
    before = [c.launches for c in counters]
    kw = dict(spp=1, traversal="sweep", seed=3)
    a = tr.hybrid_render_terrain_reference(dem, 64, 48, cam, device="cpu", **kw)
    b = tr.hybrid_render_terrain_reference(dem, 64, 48, cam, device="cuda", **kw)
    frames = b["frames"]
    assert [c.launches - n for c, n in zip(counters, before)] == [1, frames, frames, 1]
    assert a["frames"] == frames and b["method"] == "sweep"
    du = np.abs(a["rgba"].astype(np.int32) - b["rgba"].astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= 0.995
    assert (np.isnan(a["depth"]) == np.isnan(b["depth"])).mean() >= 0.999


# ---------------------------------------------------------------------------
# Meshes, typed lights and the engines: K9 (csrc/mesh.cuh), K10
# (csrc/lights.cuh), K6 and K8 with both, P1 and P2 (csrc/pbr.cuh) against
# their plain versions. The BVH walk and the engines' shading run the same
# float32 operations on both sides; the light sample's sin/cos and P1/P2's
# powf may differ from PyTorch's by an ulp.
# ---------------------------------------------------------------------------

QUAD_TOWN = (np.array([[10, 8, 20], [38, 8, 20], [38, 22, 20], [10, 22, 20],
                       [20, 2, 40], [30, 2, 40], [30, 14, 36], [20, 14, 36]], np.float32),
             np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.uint32))


def mesh_lights_ctx(device, **kw):
    from forge3d_tpu_torch.lighting import LIGHT_TYPES, Light

    lights = tuple(Light(type=t, position=(24.0 + 6 * i, 18.0, 30.0), intensity=40.0,
                         direction=(0.1, -1.0, 0.2), radius=1.5, extent=(2.0, 1.0))
                   for i, t in enumerate(LIGHT_TYPES))
    return make_ctx(device, mesh=QUAD_TOWN, lights=lights, **kw)


def test_trace_mesh_kernel(kernels):
    from forge3d_tpu_torch.ops import bvh

    ctx = mesh_lights_ctx(kernels)
    ms = ctx.mesh
    rng = np.random.default_rng(5)
    ro = torch.as_tensor(rng.uniform([0, 0, 0], [48, 30, 60], (4096, 3)).astype(np.float32),
                         device=kernels)
    rd = torch.as_tensor(rng.standard_normal((4096, 3)).astype(np.float32), device=kernels)
    rd = rd / rd.norm(dim=1, keepdim=True)
    o, d = tr._center_rays(ctx)
    ro = tuple(torch.cat([o[i].reshape(-1), ro[:, i]]) for i in range(3))
    rd = tuple(torch.cat([d[i].reshape(-1), rd[:, i]]) for i in range(3))
    before = bvh.trace_mesh.launches
    hk = bvh._trace_mesh_kernel(ms.scene, ms.n_nodes, ro, rd, 1e-4, 1e30)
    assert bvh.trace_mesh.launches == before + 1
    hp = bvh.trace_mesh_plain(ms.scene, ms.n_nodes, ro, rd)
    assert 0.05 < float(hp.hit.double().mean()) < 0.95
    for a, b in zip(hp, hk):
        assert torch.equal(a, b)


def test_sample_light_kernel(kernels):
    from forge3d_tpu_torch.ops import lightsample as ls

    ctx = mesh_lights_ctx(kernels)
    rng = np.random.default_rng(6)
    n = 4096
    p = rng.uniform([0, -5, 0], [64, 5, 64], (n, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm[:, 1] = np.abs(nrm[:, 1]) + 0.5
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    u = rng.random((n, 3), dtype=np.float32)
    lanes = [torch.as_tensor(np.ascontiguousarray(a[:, i]), device=kernels)
             for a in (p, nrm, u) for i in range(3)]
    before = ls.sample_light_nee.launches
    sk = ls._sample_light_kernel(*ctx.lights, *lanes)
    assert ls.sample_light_nee.launches == before + 1
    sp = ls.sample_light_nee_plain(*ctx.lights, *lanes)
    for a, b in zip(sp, sk):
        assert close_frac(a, b) == 1.0


@pytest.mark.parametrize("kw", [dict(spp=2), dict(spp=1, restir=False, shadows_enabled=False)],
                         ids=["restir_spp2", "plain_nee_no_shadows"])
def test_frame_and_gbuffer_with_mesh_and_lights(kernels, kw):
    ctx = mesh_lights_ctx(kernels, **kw)
    H, W = ctx.height, ctx.width
    o, d = tr._center_rays(ctx)
    th = tv.trace_plain(ctx.scene, o, d)
    gp = tr.gbuffer_resolve_plain(ctx, d, th)
    gk = tr._gbuffer_resolve_kernel(ctx, d, th)
    for k in ("albedo", "normal", "depth", "visibility"):
        assert close_frac(gp[k], gk[k]) >= FRAC, k
    on_mesh = torch.all(gp["albedo"] == torch.tensor([0.7, 0.7, 0.8]).to(kernels), -1)
    assert 0.01 < float(on_mesh.double().mean()) < 0.9
    acc = torch.zeros(H, W, 4, device=kernels)
    wf = torch.zeros(H, W, 2, device=kernels)
    res = rst.Reservoirs.zeros(H * W, kernels)
    counts = (tr.frame_step.mesh_launches, tr.frame_step.light_launches)
    for frame in (0, 1):
        pa, pw, pm = tr.frame_step_plain(ctx, acc, wf, res, frame)
        ka, kw_, km = tr._frame_step_kernel(ctx, acc, wf, res, frame)
        assert close_frac(pa, ka) >= FRAC and close_frac(pw, kw_) >= FRAC
        assert_reservoirs(pm, km)
        acc, wf = ka, kw_
        res = rst.spatial_reuse_plain(km, *gp["gb_n"], W, H, frame, ctx.seed_hi)
    assert (tr.frame_step.mesh_launches, tr.frame_step.light_launches) == \
        (counts[0] + 2, counts[1] + 2)


def test_engine_kernels(kernels):
    from forge3d_tpu_torch.ops.shading import sun_direction
    from forge3d_tpu_torch.pt import megakernel as mk
    from forge3d_tpu_torch.pt import mesh_render as mr

    spheres = [{"center": (0, 1, 0), "radius": 1.0, "albedo": (0.8, 0.2, 0.2), "roughness": 0.3},
               {"center": (2.2, 0.7, -1), "radius": 0.7, "metallic": 1.0, "roughness": 0.15},
               {"center": (-2.0, 0.5, 0.5), "radius": 0.5, "ax": 0.1, "ay": 0.4,
                "emissive": (0.5, 0.1, 0.0)}]
    cam = mk.EngineCamera.make(64, 48, {"origin": (0, 1.5, 5.5)}, (0.0, 1.2, 3.0),
                               (0.0, 1.0, 0.0))
    sb = mk.spheres_from_dicts(spheres, kernels)
    before = mk.render_spheres.launches
    pk = mk._render_spheres_kernel(cam, sb)
    assert mk.render_spheres.launches == before + 1
    pp = mk.render_spheres_plain(cam, sb)
    for k in pp:
        assert close_frac(pp[k], pk[k]) >= FRAC, k

    mts = mr.MeshTracerScene(*QUAD_TOWN, kernels)
    cam = mk.EngineCamera.make(64, 48, {"origin": (24, 30, 70), "look_at": (24, 8, 24)},
                               (0.0, 1.5, 4.0), (0.0, 0.5, 0.0))
    args = (cam, mts, mr._material_from_dict({"metallic": 0.3, "emissive": (0.1, 0, 0)}),
            sun_direction(135.0, 45.0), 3.0)
    before = mr.render_mesh.launches
    pk = mr._render_mesh_kernel(*args)
    assert mr.render_mesh.launches == before + 1
    pp = mr.render_mesh_plain(*args)
    assert 0.05 < float(pp["vis"].mean()) < 0.95
    for k in pp:
        assert close_frac(pp[k], pk[k]) >= FRAC, k


# ---------------------------------------------------------------------------
# The TerrainRenderer's kernels: R1 render and R1 step (csrc/
# terrain_shade.cuh), E3 a-trous and E5 Hosek (csrc/post.cuh) against their
# plain versions, on a 65^2 DEM at 96x48. Gates: rgba within one u8 step on
# >= 99.5% of pixels, float planes within 1e-5 * (1 + |ref|) on >= 99.9%,
# depth NaN masks equal on >= 99.9% (silhouette flips); E3 and E5 every
# element within 1e-5 * (1 + |ref|). The bodies run the same float32
# operations as the plain versions; powf, expf, acosf and the libm
# cos/sin/atan2 may differ from PyTorch's by an ulp.
# ---------------------------------------------------------------------------

R1_CASES = {
    "defaults": {},
    "print": dict(sampling=dict(aa_samples=2), shadows=dict(softness=1.5, samples=2),
                  height_ao=dict(enabled=True, samples=2, radius=12.0),
                  water=dict(enabled=True, level=0.0), reflection=dict(enabled=True),
                  fog=dict(enabled=True, density=0.02), clouds=dict(enabled=True, scale=0.05),
                  material_layers=dict(enabled=True), detail=dict(enabled=True),
                  triplanar=dict(enabled=True), pom=dict(enabled=True, scale=0.5),
                  lambert_contrast=0.3, height_curve_mode="smoothstep",
                  height_curve_strength=0.5, ibl=dict(enabled=True),
                  tonemap=dict(mode="aces"), output_srgb_eotf=True),
    "constant_filmic_normals": dict(albedo_mode="constant", tonemap=dict(mode="filmic"),
                                    debug_mode="normals", height_curve_mode="pow",
                                    height_curve_power=1.7),
}


def r1_setup(device, **kw):
    """(scene, ShadeArgs) of a TerrainRenderer render."""
    from forge3d_tpu_torch.terrain import renderer as rr
    from forge3d_tpu_torch.terrain.params import make_terrain_params

    n = 65
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (6.0 * np.sin(x * 0.15) * np.cos(y * 0.12) + 3.0 * np.sin(x * 0.4 + y * 0.3)
           ).astype(np.float32)
    p = make_terrain_params(size_px=(96, 48), cam_radius=75.0, cam_theta_deg=30.0, **kw)
    _, scene, args, _ = rr.TerrainRenderer(device=device).render_inputs(p, dem,
                                                                        time_seconds=1.5)
    return scene, args


def assert_planes(ref, got, keys):
    for k in keys:
        assert close_frac(ref[k], got[k]) >= FRAC, k


@pytest.mark.parametrize("case", list(R1_CASES))
def test_terrain_render_kernel(kernels, case):
    from forge3d_tpu_torch.terrain import renderer as rr

    scene, a = r1_setup(kernels, **R1_CASES[case])
    before = rr.render_program.launches
    got = rr._render_kernel(scene, a, want_aov=True)
    assert rr.render_program.launches == before + 1
    ref = rr.render_plain(scene, a)
    du = (ref["rgba"].int() - got["rgba"].int()).abs().amax(-1)
    assert float((du <= 1).double().mean()) >= 0.995
    assert torch.equal(got["rgba"][..., 3], torch.full_like(got["rgba"][..., 3], 255))
    assert float((ref["depth"].isnan() == got["depth"].isnan()).double().mean()) >= FRAC
    assert_planes(ref, got, ("hdr", "albedo", "normal", "depth", "visibility"))
    beauty = rr._render_kernel(scene, a, want_aov=False)
    assert set(beauty) == {"rgba"} and torch.equal(beauty["rgba"], got["rgba"])


def test_terrain_step_kernel(kernels):
    from forge3d_tpu_torch.terrain import renderer as rr

    scene, a = r1_setup(kernels, **R1_CASES["print"])
    acc = torch.zeros((a.height, a.width, 4), device=kernels)
    before = rr.offline_step.launches
    for idx in range(3):
        pa, pt, paov = rr.step_plain(scene, a, acc, idx)
        ka, kt, kaov = rr._step_kernel(scene, a, acc.clone(), idx)
        assert close_frac(pa, ka) >= FRAC
        assert close_frac(pt, kt) == 1.0 and tuple(kt.shape) == (2, 3)
        assert_planes(paov, kaov, ("albedo", "normal", "depth", "visibility"))
        acc = ka
    assert rr.offline_step.launches == before + 3
    assert float(acc[..., 3].min()) == 3.0


@pytest.mark.parametrize("guides", ["none", "all", "depth_only"])
def test_atrous_kernel(kernels, guides):
    from forge3d_tpu_torch.ops import denoise as dn

    rng = np.random.default_rng(8)
    H, W = 40, 52
    color = rng.gamma(2.0, 0.3, (H, W, 3)).astype(np.float32)
    depth = rng.uniform(5, 50, (H, W)).astype(np.float32)
    depth[:4] = np.nan
    g = {"albedo": rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
         "normal": rng.standard_normal((H, W, 3)).astype(np.float32), "depth": depth}
    g = {"none": {}, "all": g, "depth_only": {"depth": depth}}[guides]
    g = {k: torch.as_tensor(v, device=kernels) for k, v in g.items()}
    c = torch.as_tensor(color, device=kernels)
    ref = dn.atrous_denoise_plain(c, iterations=4, **g)
    prep = dn._prepare(c, g.get("albedo"), g.get("normal"), g.get("depth"))
    before = dn.atrous_denoise.launches
    got = dn._atrous_kernel(*prep, 4, *map(dn._sigma_k, (0.3, 0.3, 0.6, 0.8)))
    assert dn.atrous_denoise.launches == before + 4
    assert close_frac(ref, got) == 1.0
    assert float((got - c).abs().max()) > 1e-3   # it filtered


def test_hosek_kernel(kernels):
    from forge3d_tpu_torch import sky

    s = sky.make_hosek_sky(120.0, 20.0, turbidity=4.5, ground_albedo=0.2)
    d = [torch.as_tensor(v, device=kernels) for v in sky.bake_directions(64, 32)]
    before = sky.hosek_radiance.launches
    got = sky._hosek_kernel(s, *d)
    assert sky.hosek_radiance.launches == before + 1
    for a, b in zip(sky.hosek_radiance_plain(s, *d), got):
        assert close_frac(a, b) == 1.0


# ---------------------------------------------------------------------------
# E2, the post-processing suite (csrc/post.cuh), and E1, the IBL bake
# (csrc/ibl.cuh), against their plain versions in ops/post.py and ops/ibl.py
# on seeded 40x52 planes and a 16x32 equirect. Gates: every element equal,
# except where a transcendental call decides (the rect light's powf, the
# equirect's atan2f and acosf: the host's libm and PyTorch's may differ by
# an ulp), there every element within 1e-5 * (1 + |ref|).
# ---------------------------------------------------------------------------


def e2_planes(device):
    rng = np.random.default_rng(31)
    H, W = 40, 52
    n = rng.standard_normal((H, W, 3)).astype(np.float32)
    v = rng.standard_normal((H, W, 3)).astype(np.float32)
    planes = dict(color=rng.uniform(0, 2, (H, W, 3)), hist=rng.uniform(0, 2, (H, W, 3)),
                  depth=rng.uniform(1, 50, (H, W)), b1=rng.uniform(0, 1, (H, W, 3)),
                  b2=rng.uniform(0, 1, (H, W, 3)), normal=n / np.linalg.norm(n, axis=-1,
                                                                             keepdims=True),
                  points=rng.uniform(-20, 20, (H, W, 3)),
                  view=v / np.linalg.norm(v, axis=-1, keepdims=True))
    return {k: torch.as_tensor(x.astype(np.float32), device=device) for k, x in planes.items()}


def test_post_kernels(kernels):
    from forge3d_tpu_torch.ops import post as P

    q = e2_planes(kernels)
    c, dep, nrm = q["color"], q["depth"], q["normal"]
    before = (P.blur_axis.launches, P.post_point.launches, P.ssr.launches,
              P.taa_resolve.launches, P.ssao.launches, P.rect_area_light_sum.launches)
    for sigma, r in ((6.0, 18), (1.5, 5), (1.0, 2)):
        taps = P._gauss_kernel(sigma, r)
        for x in (c, dep):
            for axis in (0, 1):
                assert torch.equal(P._blur_axis_kernel(x, taps.to(kernels), r, axis),
                                   P._blur_axis_plain(x, [float(t) for t in taps], r, axis))
    modes = [(P.PP_BRIGHT, (c,), (0.8, 0.8)), (P.PP_BLOOM, (c, q["b1"], q["b2"]), (0.5,)),
             (P.PP_DOF, (c, dep, q["b1"], q["b2"]), (20.0, 5.0, 6.0, 6.0, 1.0)),
             (P.PP_DOF, (c, dep, q["b1"], q["b2"]), (20.0, 5.0, 6.0, 6.0, 0.0)),
             (P.PP_VIGNETTE, (c,), (0.35, 0.85, float(np.float32(0.15)),
                                    float(np.float32(np.sqrt(2))))),
             (P.PP_SHARPEN, (c, q["b1"]), (0.3,))]
    for mode, planes, params in modes:
        args = list(planes) + [None] * (4 - len(planes))
        assert torch.equal(P._point_kernel(mode, *args, params),
                           P._point_plain(mode, *args, list(params))), mode
    for n_ in (nrm, nrm[..., 1].contiguous()):
        assert torch.equal(P._ssr_kernel(c, dep, n_, 2, 24, 0.5, 4.0),
                           P._ssr_plain(c, dep, n_, 2, 24, 0.5, 4.0))
    for clamp in (True, False):
        assert torch.equal(P._taa_kernel(c, q["hist"], 0.1, 0.9, clamp),
                           P._taa_plain(c, q["hist"], 0.1, 0.9, clamp))
    taps = P.ssao_offsets(16.0, 8)
    for n_ in (nrm, nrm[..., 2].contiguous()):
        assert torch.equal(P._ssao_kernel(dep, n_, taps, 0.025, 4.0001, 1.0),
                           P._ssao_plain(dep, n_, taps, 0.025, 4.0001, 1.0))
    lights = [P.rect_light_record((1.0, 15.0, 2.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (4, 3),
                                  intensity=4.0),
              P.rect_light_record((-6.0, 9.0, -3.0), (0.6, 0.0, 0.8), (0.0, 1.0, 0.0), (2, 5),
                                  color=(1.0, 0.8, 0.6), roughness=0.6)]
    pts, view = q["points"], q["view"]
    assert close_frac(P._rect_plain(pts, nrm, view, lights),
                      P._rect_kernel(pts, nrm, view, lights)) == 1.0
    assert (P.blur_axis.launches, P.post_point.launches, P.ssr.launches,
            P.taa_resolve.launches, P.ssao.launches, P.rect_area_light_sum.launches) == \
        (before[0] + 12, before[1] + 6, before[2] + 2, before[3] + 2, before[4] + 2,
         before[5] + 1)


def test_ibl_kernel(kernels):
    from forge3d_tpu_torch.ops import ibl

    env = torch.as_tensor(np.random.default_rng(4).uniform(0, 3, (16, 32, 3)).astype(np.float32),
                          device=kernels)
    before = ibl.equirect_accum.launches
    faces = np.stack([ibl._face_dirs(f, 8) for f in range(6)])[None]
    (d0, _), (d1, w1) = ibl.prefilter_tables(8, 2, 16)
    for dirs, w, mode in ((faces, None, ibl.ONE), (d0, None, ibl.ONE), (d1, w1, ibl.WEIGHTED),
                          (ibl.irradiance_tables(4, 32), None, ibl.MEAN)):
        d = torch.as_tensor(dirs, device=kernels)
        wt = None if w is None else torch.as_tensor(w, device=kernels)
        got = ibl._accum_kernel(env, d, wt, mode)
        assert got.shape == dirs.shape[1:]
        assert close_frac(ibl._accum_plain(env, d, wt, mode), got) == 1.0
    assert ibl.equirect_accum.launches == before + 4


def vt_args(device, scene_args, budget_pages):
    """ShadeArgs with a VT atlas: a two-level store of 4x4 and 2x2 pages
    whose tiles alternate between resident and not."""
    import dataclasses

    from forge3d_tpu_torch.terrain.vt import PAGE_SIZE

    rng = np.random.default_rng(12)
    table = np.full(16 + 4, -1, np.int32)
    slots = rng.permutation(20)[:budget_pages]
    table[slots] = np.arange(budget_pages, dtype=np.int32)
    atlas = rng.uniform(0, 1, (budget_pages * PAGE_SIZE * PAGE_SIZE, 3)).astype(np.float32)
    return dataclasses.replace(
        scene_args, vt_atlas=torch.as_tensor(atlas, device=device),
        vt_table=torch.as_tensor(table, device=device), vt_levels=(0, 1), vt_tiles=(4, 2),
        vt_offs=(0, 16), vt_page=PAGE_SIZE, vt_pix_angle=float(np.float32(0.02)),
        vt_tpw0=float(np.float32(8.0)), vt_inv_span=float(np.float32(1.0 / 64.0)))


@pytest.mark.parametrize("aa", [1, 3])
def test_terrain_render_kernel_with_vt(kernels, aa):
    from forge3d_tpu_torch.terrain import renderer as rr

    scene, a = r1_setup(kernels, sampling=dict(aa_samples=aa, aa_seed=5))
    a = vt_args(kernels, a, 9)
    got = rr._render_kernel(scene, a, want_aov=True)
    ref = rr.render_plain(scene, a)
    du = (ref["rgba"].int() - got["rgba"].int()).abs().amax(-1)
    assert float((du <= 1).double().mean()) >= 0.995
    assert_planes(ref, got, ("hdr", "albedo", "normal", "depth", "visibility"))
    # the fallback texels are an exact count of sample 0's terrain pixels
    assert int(got["vt_fallback"]) == int(ref["vt_fallback"]) > 0
    hit = ~ref["depth"].isnan()
    assert int(ref["vt_fallback"]) < int(hit.sum())   # some pages were resident


# ---------------------------------------------------------------------------
# The screen-mode kernels (csrc/screen.cuh): S1 env cube, S2/S3 cube
# convolution, S4 depth raster, S8 shade with S5, S6 and S7 inside and the
# clipmap shade S9, against their plain versions in terrain/screen.py, on a
# 32^2 env cube, a 512^2 shadow map of a 128^2 grid, and 64x48 renders.
# Gates: the f16 cubes equal on
# >= 99.9% of texels and within one f16 step elsewhere; depth maps equal on
# >= 99.9% of texels; S8's and S9's rgba within one u8 step on >= 99.5% of
# pixels and S8's float planes within 1e-5 * (1 + |ref|) on >= 99.9%. Both
# sides run the same float32 operations; atan2/acos/sin/exp/pow may differ
# by an ulp.
# ---------------------------------------------------------------------------


def f16_agree(ref, got):
    """(fraction of equal elements, whether all lie within one f16 step)."""
    eq = float((ref == got).double().mean())
    step = torch.clamp(ref.abs(), min=2.0 ** -14) * 2.0 ** -10
    return eq, bool(((got - ref).abs() <= step * 1.0001).all())


def screen_dem(n=33):
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    return (4.0 * np.sin(x * 0.21 * 33 / n) * np.cos(y * 0.17 * 33 / n)).astype(np.float32)


def test_env_cube_and_convolve_kernels(kernels):
    from forge3d_tpu_torch.terrain import screen as scr

    eq = torch.as_tensor(np.random.default_rng(9).uniform(0, 3, (8, 16, 3)).astype(np.float32),
                         device=kernels)
    before = (scr.env_cube.launches, scr.cube_convolve.launches)
    env_k = scr._env_cube_kernel(eq, 32)
    env_p = scr.env_cube_plain(eq, 32)
    eq_frac, one_step = f16_agree(env_p, env_k)
    assert eq_frac >= FRAC and one_step
    for mip in (1, 2, 5):
        got = scr._cube_convolve_kernel(env_p, mip)
        ref = scr.cube_convolve_plain(env_p, mip)
        eq_frac, one_step = f16_agree(ref, got)
        assert got.shape == (6, 32 >> mip, 32 >> mip, 3)
        assert eq_frac >= FRAC and one_step, mip
    assert (scr.env_cube.launches, scr.cube_convolve.launches) == (before[0] + 1, before[1] + 3)


def test_irradiance_kernel(kernels, monkeypatch):
    from forge3d_tpu_torch.terrain import screen as scr

    monkeypatch.setattr(scr, "IRR_SIZE", 16)   # the cosine lobe on a 16^2 output
    eq = torch.as_tensor(scr.decode_test_hdr(), device=kernels)
    env = scr.env_cube_plain(eq, 32)
    eq_frac, one_step = f16_agree(scr.cube_convolve_plain(env, 0),
                                  scr._cube_convolve_kernel(env, 0))
    assert eq_frac >= FRAC and one_step


def test_raster_depth_kernel(kernels):
    from forge3d_tpu_torch.terrain import screen as scr

    dem = screen_dem()
    for sun in ((-0.6, -0.5, -0.62), (0.1, 0.05, -0.99)):
        lvp, _, tris, keep, wbb, hbb = scr.shadow_geometry(
            dem, terrain_span=2.8, z_scale=1.45, sun_dir=np.array(sun, np.float32),
            resolution=512, grid_res=128, domain=(float(dem.min()), float(dem.max())))
        t = torch.as_tensor(tris, device=kernels)
        k = torch.as_tensor(keep, device=kernels)
        before = scr.raster_depth.launches
        got = scr._raster_depth_kernel(t, k, 512, wbb, hbb)
        assert scr.raster_depth.launches == before + 1
        ref = scr.raster_depth_plain(t, k, 512, wbb, hbb)
        assert float((ref == got).double().mean()) >= FRAC
        assert 0.05 < float((got < 1.0).double().mean()) < 1.0


SKY = dict(enabled=True, model="hosek-wilkie", turbidity=3.0, ground_albedo=0.3,
           sun_intensity=1.0, sun_size=1.0, sky_exposure=1.0, aerial_density=1.0,
           aerial_perspective=True)
POM = dict(enabled=True, height_scale=0.04, min_steps=12, max_steps=40, refine_steps=4)

SCREEN_CASES = {
    "defaults": {},
    "pom_hosek_sky": dict(pom=POM, sky=SKY, ibl_intensity=1.0, hue_variation_strength=0.1),
    "pom_preetham_sky_filterable": dict(pom=dict(POM, refine_steps=0, min_steps=4, max_steps=9),
                                        sky=dict(SKY, model="preetham", turbidity=6.0),
                                        height_filterable=True, generation="recipe"),
    "pom_sky_water_reflection": dict(water=True, pom=POM, sky=dict(SKY, aerial_density=3.0),
                                     reflection=dict(enabled=True, wave_strength=0.04,
                                                     shore_atten_width=0.3)),
    "water_reflection_mix": dict(water=True, albedo_mode="mix", colormap_strength=0.5,
                                 reflection=dict(enabled=True, wave_strength=0.04,
                                                 shore_atten_width=0.3)),
    "layers_sss_srgb": dict(materials=dict(snow_enabled=True, snow_altitude_min=0.2,
                                           snow_altitude_blend=0.4, snow_subsurface_strength=0.5,
                                           rock_enabled=True, rock_slope_min=-20.0,
                                           rock_subsurface_strength=0.3, wetness_enabled=True,
                                           wetness_subsurface_strength=0.2),
                            encode="srgb", height_filterable=True, ibl_intensity=1.0),
    "maps_constant": dict(material_maps="all", albedo_mode="material",
                          material_albedo_rgb=np.array([[[0.5, 0.4, 0.3]]], np.float32),
                          generation="consistent"),
}


def small_ibl(device):
    """A random f16 pyramid at a tenth of the size: S8 samples what it is given."""
    rng = np.random.default_rng(13)
    cube = lambda s: torch.as_tensor(  # noqa: E731
        rng.uniform(0, 1, (6, s, s, 3)).astype(np.float16).astype(np.float32), device=device)
    return {"irradiance": cube(8), "spec_mips": [cube(32 >> m) for m in range(6)],
            "brdf": torch.as_tensor(rng.uniform(0, 1, (16, 16, 2)).astype(np.float32),
                                    device=device)}


def screen_inputs(device, monkeypatch, W=64, H=48, **kw):
    from forge3d_tpu_torch import colormaps
    from forge3d_tpu_torch.terrain import screen as scr

    monkeypatch.setattr(scr, "build_ibl", lambda hdr, device: small_ibl(device))
    orig = scr.build_shadow_map
    monkeypatch.setattr(scr, "build_shadow_map",
                        lambda *a, **k: orig(*a, **k, resolution=512, grid_res=128))
    dem = screen_dem()
    lo, hi = float(dem.min()), float(dem.max())
    if kw.pop("water", False):
        kw["water_mask"] = np.clip((lo + 0.3 * (hi - lo) - dem) / (0.1 * (hi - lo)), 0, 1
                                   ).astype(np.float32)
    if kw.get("material_maps") == "all":
        rng = np.random.default_rng(14)
        kw["material_maps"] = {"normal": rng.uniform(0, 1, (8, 8, 3)).astype(np.float32),
                               "roughness": rng.uniform(0, 1, (8, 8)).astype(np.float32),
                               "mask": rng.uniform(0, 1, (8, 8)).astype(np.float32)}
    lut = np.asarray(colormaps.get_lut("viridis"), np.float32)[:, :3]
    kw.setdefault("ibl_intensity", 0.0)
    return scr.prepare_shade(dem, lut, size_px=(W, H), device=device, domain=(lo, hi), **kw)


@pytest.mark.parametrize("case", list(SCREEN_CASES))
def test_screen_shade_kernel(kernels, monkeypatch, case):
    from forge3d_tpu_torch.terrain import screen as scr

    cfg, u = screen_inputs(kernels, monkeypatch, **SCREEN_CASES[case])
    before = scr.shade.launches
    got = scr._shade_kernel(cfg, u)
    assert scr.shade.launches == before + 1
    ref = scr.shade_plain(cfg, u)
    du = (ref["rgba"].int() - got["rgba"].int()).abs().amax(-1)
    assert float((du <= 1).double().mean()) >= 0.995
    assert torch.equal(got["rgba"][..., 3], torch.full_like(got["rgba"][..., 3], 255))
    for k in ("albedo", "normal", "height"):
        assert close_frac(ref[k], got[k]) >= FRAC, k
    assert float(ref["rgba"][..., :3].float().std()) > 5.0


def clipmap_inputs(device, monkeypatch, W=64, H=48, **kw):
    from forge3d_tpu_torch.terrain import screen as scr

    monkeypatch.setattr(scr, "build_ibl", lambda hdr, device: small_ibl(device))
    orig = scr.build_shadow_map
    monkeypatch.setattr(scr, "build_shadow_map",
                        lambda *a, **k: orig(*a, **k, resolution=512, grid_res=128))
    dem = screen_dem()
    lut = scr.build_lut_from_stops(((0.0, "#00aa00"), (0.5, "#ffff00"), (1.0, "#800000")))
    return scr.prepare_clipmap(dem, lut, size_px=(W, H), camera_mode="clipmap:4:16:16:10:0.3",
                               device=device, domain=(float(dem.min()), float(dem.max())),
                               z_scale=1.2, cam_radius=1.2, ibl_intensity=0.3, **kw)


@pytest.mark.parametrize("kw", [dict(pom=POM), dict(pom=POM, generation="family", encode="srgb",
                                                   albedo_mode="colormap")],
                         ids=["pom_recipe", "pom_family_srgb"])
def test_clipmap_shade_kernel(kernels, monkeypatch, kw):
    from forge3d_tpu_torch.terrain import screen as scr

    cfg, u = clipmap_inputs(kernels, monkeypatch, **kw)
    before = scr.clipmap_shade.launches
    got = scr._clipmap_kernel(cfg, u)
    assert scr.clipmap_shade.launches == before + 1
    ref = scr.clipmap_shade_plain(cfg, u)
    du = (ref.int() - got.int()).abs().amax(-1)
    assert float((du <= 1).double().mean()) >= 0.995
    assert torch.equal(got[..., 3], torch.full_like(got[..., 3], 255))
    valid = u["gb_valid"].bool()
    assert 0.2 < float(valid.double().mean()) and float(ref[..., :3][valid].float().std()) > 5.0


def test_struct_layout_guard(host_lib, monkeypatch):
    """The argument structs' ctypes mirrors have the sizes the sources give
    them, and a mirror out of step is refused when the library is bound."""
    n = len(_kernels.STRUCTS)
    sizes = (ctypes.c_longlong * n)()
    assert host_lib.f3d_struct_sizes(sizes, n) == n == 15
    assert list(sizes) == [ctypes.sizeof(s) for s in _kernels.STRUCTS]
    short = type("ShortSky", (ctypes.Structure,), {"_fields_": _kernels.SkyArgs._fields_[:-1]})
    monkeypatch.setattr(_kernels, "STRUCTS", (*_kernels.STRUCTS[:3], short,
                                              *_kernels.STRUCTS[4:]))
    with pytest.raises(RuntimeError, match="ctypes mirrors"):
        _kernels.bind(host_lib)


# E4: one layer of vector coverage with the composite fused in, per kind
def e4_cases():
    from forge3d_tpu_torch.vector import _dash_segments
    from forge3d_tpu_torch.vector import coverage as vc

    rng = np.random.default_rng(11)
    t = np.linspace(0.0, 2.0 * np.pi, 25)[:-1]
    outer = np.stack([40 + 30 * np.cos(t), 24 + 20 * np.sin(t)], 1)
    hole = np.stack([40 + 10 * np.cos(-t), 24 + 7 * np.sin(-t)], 1)
    # vertices on pixel centres: its horizontal edges lie on rows of centres
    on_centres = np.array([[10.5, 8.5], [60.5, 8.5], [60.5, 40.5], [30.5, 20.5], [10.5, 40.5]])
    line = np.stack([np.linspace(4, 76, 40), 24 + 14 * np.sin(np.linspace(0, 9, 40))], 1)
    return {
        "stroke": (vc.STROKE, rng.uniform(-8, 88, (37, 4)), dict(stroke_width=3.0)),
        "stroke_dashed": (vc.STROKE, _dash_segments(line.astype(np.float32), [6.0, 3.0]),
                          dict(stroke_width=2.5)),
        "stroke_empty": (vc.STROKE, np.zeros((0, 4)), dict(stroke_width=3.0)),
        "disc": (vc.DISC, vc.disc_prims(rng.uniform(0, 80, (50, 2)), rng.uniform(1, 5, 50)), {}),
        "polygon_nonzero_hole": (vc.POLYGON, vc.ring_edges([outer, hole]), dict(rule="nonzero")),
        "polygon_evenodd": (vc.POLYGON, vc.ring_edges([outer, outer * 0.5 + 10]),
                            dict(rule="evenodd")),
        "polygon_on_centres": (vc.POLYGON, vc.ring_edges([on_centres]), dict(rule="nonzero")),
    }


E4_CASES = ("stroke", "stroke_dashed", "stroke_empty", "disc", "polygon_nonzero_hole",
            "polygon_evenodd", "polygon_on_centres")


@pytest.mark.parametrize("case", E4_CASES)
def test_vector_layer_kernel(kernels, case):
    """E4's kernel (its squared-distance minimum, one square root at the
    end) against the plain version (JAX's square root per primitive):
    coverage, rgb, alpha and pick bit-identical."""
    from forge3d_tpu_torch.vector import coverage as vc

    W, H = 80, 48
    kind, prims, kw = e4_cases()[case]
    p = torch.as_tensor(np.asarray(prims, np.float32).reshape(-1, 4), device=kernels)
    base = np.random.default_rng(5).uniform(0, 1, (H, W, 3)).astype(np.float32)

    def planes():
        return (torch.zeros((H, W), device=kernels), torch.as_tensor(base, device=kernels),
                torch.full((H, W), 0.25, device=kernels),
                torch.full((H, W), 3, dtype=torch.int32, device=kernels))

    style = dict(color=(0.9, 0.2, 0.1), opacity=0.7, pick_id=7)
    got, ref = planes(), planes()
    before = vc.vector_layer.launches
    vc._vector_layer_kernel(kind, p, W, H, **kw, **style, cov=got[0], rgb=got[1], alpha=got[2],
                            pick=got[3])
    assert vc.vector_layer.launches == before + 1
    vc.vector_layer_plain(kind, p, W, H, **kw, **style, cov=ref[0], rgb=ref[1], alpha=ref[2],
                          pick=ref[3])
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    cov = ref[0]
    if case == "stroke_empty":
        assert float(cov.abs().max()) == 0.0 and torch.equal(got[1].cpu(), torch.as_tensor(base))
    else:
        assert float(cov.max()) == 1.0 and float(cov.min()) == 0.0
        assert bool(((cov > 0) & (cov < 1)).any()) and bool((got[3] == 7).any())


# P6, P5, P3, P4: the SDF tape, the TLAS walk, the hybrid tracer and the
# adjudication lanes. Both sides round XLA's fused sums once (fmaf on the
# kernel side, ops.shading.fma32 on the plain side), so P6, P5 and P3 are
# bit-identical to their plain versions; P4 calls cos, sin and pow, where
# the C library and PyTorch may differ by an ulp: its HDR is held to the
# float rule and its rgba to one u8 step on >= 99.5% of pixels.
def sdf_all_kinds(device):
    """Every primitive and operation kind, smooth ones included."""
    from forge3d_tpu_torch.ops.sdf import SdfSceneBuilder

    b = SdfSceneBuilder()
    s = b.add_sphere((0.3, 0.2, 0.1), 1.1, 1)
    bx = b.add_box((1.0, 0.1, -0.3), (0.8, 0.6, 1.0), 2)
    c = b.add_cylinder((-1.2, 0.0, 0.4), 0.5, 1.2, 3)
    p = b.add_plane((0.1, 1.0, -0.2), -1.0, 4)
    t = b.add_torus((0.0, 0.6, -1.0), 1.0, 0.25, 5)
    k = b.add_capsule((-1.5, -0.5, -1.0), (1.5, 0.8, 1.2), 0.3, 6)
    u = b.smooth_union(s, bx, 0.4, 7)
    i = b.intersect(u, b.add_sphere((0.4, 0.0, 0.0), 2.0), 8)
    d = b.subtract(i, c, 9)
    si = b.smooth_intersect(t, b.add_box((0.0, 0.6, -1.0), (1.2, 0.5, 1.2)), 0.3, 10)
    ss = b.smooth_subtract(b.union(d, si, 11), k, 0.2, 12)
    b.union(ss, p, 13)
    return b.build(device=device)


def sdf_rays(n, device, seed=5):
    rng = np.random.default_rng(seed)
    ro = rng.uniform([-3, 1, 5], [3, 3, 7], (n, 3)).astype(np.float32)
    tgt = rng.uniform([-2, -1.5, -2], [2, 1.5, 2], (n, 3)).astype(np.float32)
    rd = tgt - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (tuple(torch.as_tensor(ro[:, k].copy(), device=device) for k in range(3)),
            tuple(torch.as_tensor(rd[:, k].copy(), device=device) for k in range(3)))


def test_sdf_kernels(kernels):
    from forge3d_tpu_torch.ops import sdf as sd

    scene = sdf_all_kinds(kernels)
    rng = np.random.default_rng(4)
    pts = [torch.as_tensor(c, device=kernels)
           for c in rng.uniform(-3, 3, (3, 4096)).astype(np.float32)]
    before = (sd.sdf_eval.launches, sd.sdf_march.launches)
    dk, mk = sd._sdf_eval_kernel(scene, *pts)
    dp, mp = sd.sdf_eval_plain(scene, *pts)
    assert torch.equal(dk, dp) and torch.equal(mk, mp)
    assert len(set(mp.tolist())) >= 3            # several leaves and operations win
    nk = sd._sdf_normal_kernel(scene, *pts, 1e-4)
    np_ = sd.sdf_normal_plain(scene, *pts, 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(nk, np_))
    ro, rd = sdf_rays(2048, kernels)
    hk = sd._sdf_march_kernel(scene, ro, rd, 1e-3, 20.0, 128, 1e-3)
    hp = sd.sdf_march_plain(scene, ro, rd, 1e-3, 20.0, 128, 1e-3)
    assert all(torch.equal(a, b) for a, b in zip(hk, hp))
    assert 0.2 < float(hp.hit.double().mean()) < 0.95
    assert (sd.sdf_eval.launches, sd.sdf_march.launches) == (before[0] + 2, before[1] + 1)


def tlas_case(device):
    from forge3d_tpu_torch.ops import tlas as tl

    rng = np.random.default_rng(3)
    soup = rng.uniform(-1, 1, (60, 3)).astype(np.float32)

    def rot(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]])

    def tr(x, y, z, sc=(1, 1, 1)):
        m = np.diag([*sc, 1.0])
        m[:3, 3] = (x, y, z)
        return m

    insts = [tl.Instance(0, tr(0, 0, 0)), tl.Instance(1, tr(2, 0.5, 0) @ rot(0.7)),
             tl.Instance(0, tr(-2, 0, 1, (1.5, 0.7, 1.2)) @ rot(-0.4))]
    blases = [(_BOX_V, _BOX_F), (soup, np.arange(60, dtype=np.uint32).reshape(20, 3))]
    return tl.build_tlas(blases, insts, device=device)


_BOX_V = np.array([[0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1], [0, 1, 0], [1, 1, 0], [1, 1, 1],
                   [0, 1, 1]], np.float32)
_BOX_F = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4], [1, 2, 6],
                   [1, 6, 5], [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]], np.uint32)


def test_tlas_kernel(kernels):
    from forge3d_tpu_torch.ops import tlas as tl

    tlas = tlas_case(kernels)
    ro, rd = sdf_rays(4096, kernels, seed=6)
    before = tl.trace_tlas.launches
    hk = tl._trace_tlas_kernel(tlas, ro, rd, 1e-4, 1e30)
    hp = tl.trace_tlas_plain(tlas, ro, rd, 1e-4, 1e30)
    assert tl.trace_tlas.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(hk, hp))
    assert set(hp.instance.unique().tolist()) == {-1, 0, 1, 2}


def hybrid_case(device):
    from forge3d_tpu_torch.ops.sdf import SdfSceneBuilder
    from forge3d_tpu_torch.pt import hybrid as hy

    n = 33
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (2.0 * np.sin(x * 0.3) * np.cos(y * 0.3)).astype(np.float32)
    b = SdfSceneBuilder()
    b.add_sphere((24.0, 6.0, 10.0), 3.0)
    return hy.build_hybrid_scene(heightmap=dem, mesh_vertices=_BOX_V * 6 + [13, 5, 13],
                                 mesh_indices=_BOX_F, sdf_scene=b.build(device=device),
                                 device=device)


@pytest.mark.parametrize("mode", ["hybrid", "terrain_only", "mesh_only", "sdf_only"])
def test_hybrid_kernel(kernels, mode):
    from forge3d_tpu_torch.pt import hybrid as hy

    hs = hybrid_case(kernels)
    origin, rd = hy.camera_rays(64, 48, {"origin": (16.0, 18.0, 52.0),
                                         "look_at": (16.0, 2.0, 16.0)}, kernels)
    sun = {"azimuth": 120.0, "elevation": 35.0, "intensity": 3.0}
    alb = ((0.55, 0.52, 0.48), (0.7, 0.7, 0.72), (0.8, 0.3, 0.25))
    before = hy.hybrid_pixels.launches
    rk, pk = hy._shade_kernel(hs, mode, origin, rd, sun, alb, 0.35, 1.0)
    rp, pp = hy._shade_plain(hs, mode, origin, rd, sun, alb, 0.35, 1.0)
    assert hy.hybrid_pixels.launches == before + 1
    assert torch.equal(rk, rp)
    for k in pp:
        assert torch.equal(pk[k], pp[k]), k
    assert int((pp["kind"] >= 0).sum()) > 0


def test_adjudication_kernels(kernels):
    from forge3d_tpu_torch.pt import adjudication as adj

    before = (adj.raster_lane.launches, adj.pt_lane.launches)
    rk, hk = adj._raster_lane_kernel(24, 16, kernels)
    rp, hp = adj.raster_lane_plain(24, 16, kernels)
    assert close_frac(hp, hk) >= 0.995
    assert float(((rk.int() - rp.int()).abs() <= 1).all(-1).double().mean()) >= 0.995
    pk, qk = adj._pt_lane_kernel(16, 16, 2, 7, kernels)
    pp, qp = adj.pt_lane_plain(16, 16, 2, 7, kernels)
    assert close_frac(qp, qk) >= 0.99
    assert float(((pk.int() - pp.int()).abs() <= 1).all(-1).double().mean()) >= 0.99
    assert (adj.raster_lane.launches, adj.pt_lane.launches) == (before[0] + 1, before[1] + 1)


# E8: each stage of the step and the march against its plain version
def smoke_case(device, jacobi):
    from forge3d_tpu_torch.ops import smoke as O

    shape = (12, 10, 14)
    rng = np.random.default_rng(41)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)  # noqa: E731
    grids = dict(density=t(rng.uniform(0.0, 1.0, shape)),
                 velocity=t(rng.normal(0.0, 1.5, (3, *shape))),
                 temperature=t(rng.uniform(0.0, 2.0, shape)), soot=t(rng.uniform(0.0, 0.5, shape)),
                 emission=t(rng.uniform(0.0, 1.0, shape)))
    from forge3d_tpu_torch.smoke import SmokeStepSettings

    k = O.step_consts(SmokeStepSettings(dt=0.4, buoyancy=1.3, ambient_temperature=0.1,
                                        wind=(0.2, 0.0, -0.3), jacobi_iters=jacobi))
    return O, grids, k


@pytest.mark.parametrize("jacobi", [0, 1, 6])
def test_smoke_step_kernels(kernels, jacobi):
    O, g, k = smoke_case(kernels, jacobi)
    before = [f.launches for f in (O.smoke_forces, O.smoke_advect_velocity, O.smoke_divergence,
                                   O.smoke_jacobi, O.smoke_project_advect)]
    vf = O._forces_kernel(g["velocity"], g["temperature"], k)
    assert torch.equal(vf, O._forces_plain(g["velocity"], g["temperature"], k))
    va = O._advect_velocity_kernel(vf, k)
    assert torch.equal(va, O._advect_velocity_plain(vf, k))
    div = O._divergence_kernel(va)
    assert torch.equal(div, O._divergence_plain(va))
    p = None
    for _ in range(jacobi):
        got = O._jacobi_kernel(p, div, k)
        assert torch.equal(got, O._jacobi_plain(p, div, k))
        p = got
    args = (va, p, g["density"], g["temperature"], g["soot"], g["emission"], k)
    for a, b in zip(O._project_advect_kernel(*args), O._project_advect_plain(*args)):
        assert torch.equal(a, b)
    if jacobi == 1:   # the step's form: the one sweep inside the projection
        args = (va, None, *args[2:], div)
        for a, b in zip(O._project_advect_kernel(*args), O._project_advect_plain(*args)):
            assert torch.equal(a, b)
    # the whole step through the wrappers on the kernels' device
    out = O.smoke_step(g["density"], g["velocity"], g["temperature"], g["soot"], g["emission"], k)
    ref = O.smoke_step_plain(g["density"], g["velocity"], g["temperature"], g["soot"],
                             g["emission"], k)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    after = [f.launches for f in (O.smoke_forces, O.smoke_advect_velocity, O.smoke_divergence,
                                  O.smoke_jacobi, O.smoke_project_advect)]
    # the stages' launches above, and the step's on the card (CPU tensors run
    # the plain versions)
    step = ([1, 1, int(jacobi > 0), jacobi * (jacobi > 1), 1] if kernels.type == "cuda"
            else [0] * 5)
    assert [a - b for a, b in zip(after, before)] == [
        1 + step[0], 1 + step[1], 1 + step[2], jacobi + step[3],
        1 + int(jacobi == 1) + step[4]]


def test_smoke_march_kernel(kernels):
    O, g, _ = smoke_case(kernels, 0)
    from forge3d_tpu_torch.smoke import SmokeRenderSettings

    m = O.march_setup((12, 10, 14), (2.0, 1.5, 3.0), (-1.0, 0.5, 2.0), 40, 30,
                      SmokeRenderSettings(step_count=24, sun_steps=5), (14.0, 12.0, 90.0),
                      (13.0, 7.0, 20.0), 45.0)
    before = O.smoke_march.launches
    got = O._march_kernel(g["density"], g["emission"], g["soot"], m)
    ref = O.smoke_march_plain(g["density"], g["emission"], g["soot"], m)
    assert O.smoke_march.launches == before + 1
    assert got.dtype == torch.uint8 and got.shape == ref.shape == (30, 40, 4)
    d = (got.int() - ref.int()).abs().amax(-1)
    # the host build's expf is glibc's, the plain version's torch.exp SLEEF's
    assert int(d.max()) <= 1 and float((d == 0).double().mean()) >= 0.999
    assert float((ref[..., 3] > 0).double().mean()) > 0.1   # the box covers part of the frame


# E9, E5 Preetham, E6 and E7: the leaf kernels (csrc/leaf.cuh) against their
# plain versions. On the card every output is bit-equal; the host build
# differs only where glibc's expf, acosf, cosf and sinf differ from torch's.
def leaf_exact(kernels, ref, got):
    """bits on the card and for the host build's arithmetic-only outputs"""
    assert got.shape == ref.shape and torch.equal(got, ref)


def leaf_close(kernels, ref, got):
    assert got.shape == ref.shape
    if kernels.type == "cuda":
        assert torch.equal(got, ref)
    else:
        assert close_frac(ref, got) == 1.0


def test_dd_kernel(kernels):
    from forge3d_tpu_torch import precision as pr

    rng = np.random.default_rng(23)
    a64 = rng.uniform(-1e3, 1e3, 20_000) * 10.0 ** rng.integers(-5, 5, 20_000)
    b64 = rng.uniform(-1e3, 1e3, 20_000) * 10.0 ** rng.integers(-5, 5, 20_000)
    a64[:4] = (1.0 + 2.0 ** -30, 0.0, -4.0, 2.0 ** -31)   # exact DD, sqrt of 0, of a negative
    a, b = pr.dd_from_f64(a64, "cpu"), pr.dd_from_f64(b64, "cpu")
    a, b = (pr.DD(x.hi.to(kernels), x.lo.to(kernels)) for x in (a, b))
    for op in ("add", "mul", "div", "sqrt"):
        fn = getattr(pr, f"dd_{op}")
        before = fn.launches
        got = pr._dd_kernel(op, a) if op == "sqrt" else pr._dd_kernel(op, a, b)
        ref = pr.PLAIN[op](a) if op == "sqrt" else pr.PLAIN[op](a, b)
        assert fn.launches == before + 1
        leaf_exact(kernels, ref.hi, got.hi)
        leaf_exact(kernels, ref.lo, got.lo)
        if op == "sqrt":
            assert float(got.hi[1]) == float(got.lo[1]) == 0.0
            assert float(got.hi[2]) == float(got.lo[2]) == 0.0


def test_preetham_kernel(kernels):
    from forge3d_tpu_torch import sky

    rng = np.random.default_rng(29)
    d = [torch.as_tensor(v, device=kernels)
         for v in rng.normal(size=(3, 48, 64)).astype(np.float32)]   # below the horizon too
    for args in ((135.0, 35.0, 3.0), (300.0, 80.0, 2.0), (20.0, 4.0, 8.0)):
        s = sky.make_sky(args[0], args[1], turbidity=args[2])
        before = sky.sky_radiance.launches
        got = sky._preetham_kernel(s, *d)
        ref = sky.sky_radiance_plain(s, *d)
        assert sky.sky_radiance.launches == before + 1
        for r, g in zip(ref, got):
            leaf_close(kernels, r, g)


def leaf_lights(kernels):
    from forge3d_tpu_torch.lighting import Light, LightBuffer

    return LightBuffer.from_lights([
        Light(type="directional", direction=(0.3, -1.0, 0.2), intensity=2.0),
        Light(type="point", position=(1.0, 5.0, 2.0), intensity=25.0),
        Light(type="spot", position=(10.0, 5.0, 0.0), direction=(0.1, -1.0, 0.0),
              intensity=25.0, inner_cone_deg=15, outer_cone_deg=25),
        Light(type="rect", position=(0.0, 4.0, 0.0), extent=(2.0, 1.5), intensity=16.0),
        Light(type="disk", position=(3.0, 6.0, -2.0), radius=1.5, intensity=9.0),
        Light(type="sphere", position=(-3.0, 3.0, 2.0), radius=2.0, intensity=12.0)],
        device="cpu")


def test_eval_lights_kernel(kernels):
    from forge3d_tpu_torch import lighting

    rng = np.random.default_rng(31)
    p = rng.uniform(-10.0, 10.0, (30, 40, 3)).astype(np.float32)
    n = rng.normal(size=(30, 40, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    u = lighting.r2_sequence(1200).reshape(30, 40, 2)
    p, n, u = (torch.as_tensor(v, device=kernels) for v in (p, n, u))
    rows = leaf_lights(kernels).leaf_rows()
    for uu in (None, u):
        before = lighting.eval_lights.launches
        got = lighting._eval_lights_kernel(rows, p, n, uu)
        ref = lighting.eval_lights_plain(rows, p, n, uu)
        assert lighting.eval_lights.launches == before + 1
        leaf_close(kernels, ref, got)


@pytest.mark.parametrize("res", [8, 16, 24, 64])   # 24, 64: more than 16 blocks of 16 bins
def test_guiding_kernels(kernels, res):
    from forge3d_tpu_torch import guiding as gd

    rng = np.random.default_rng(37 + res)
    n = 6000
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=kernels)  # noqa: E731
    px, pz = t(rng.uniform(-20.0, 110.0, n)), t(rng.uniform(-5.0, 90.0, n))
    d = [t(v) for v in rng.normal(size=(3, n))]
    d[0][:5] = 0.0                                  # zero directions: bin 0
    d[1][:5] = 0.0
    d[2][:5] = 0.0
    lum = t(rng.uniform(0.0, 1.0, n) * rng.choice([1e-3, 1.0, 1e3, 1e5], n))
    cache = gd.GuidingCache.create((-5.0, 3.0), (100.0, 80.0), cells=6, octa_res=res,
                                   device="cpu")
    cache = cache._replace(hist=cache.hist.to(kernels))
    # octa_encode / octa_decode
    before = (gd.octa_encode.launches, gd.octa_decode.launches)
    bins = gd._octa_encode_kernel(*d, res)
    leaf_exact(kernels, gd._octa_encode_plain(*d, res), bins)
    assert int(bins[:5].abs().sum()) == 0
    all_bins = torch.arange(res * res, device=kernels)
    leaf_exact(kernels, gd._octa_decode_plain(all_bins, res), gd._octa_decode_kernel(all_bins, res))
    assert (gd.octa_encode.launches, gd.octa_decode.launches) == (before[0] + 1, before[1] + 1)
    # record: bits, and the old histogram untouched
    before = gd.GuidingCache.record.launches
    hist0 = cache.hist.clone()
    got = gd._record_kernel(cache, px, pz, *d, lum)
    flat = cache._cell_of(px, pz) * res * res + gd._octa_encode_plain(*d, res)
    ref = gd.record_plain(cache.hist, flat, lum)
    assert gd.GuidingCache.record.launches == before + 1
    leaf_exact(kernels, ref, got)
    assert torch.equal(cache.hist, hist0)
    cache = cache._replace(hist=got)
    # sample: bins and pdf bit-equal, the jittered directions through cos/sin
    u1, u2 = t(rng.uniform(0.0, 1.0, n)), t(rng.uniform(0.0, 1.0, n))
    before = gd.GuidingCache.sample.launches
    got = gd._sample_kernel(cache, px, pz, u1, u2)
    ref = gd.sample_plain(cache, px, pz, u1, u2)
    assert gd.GuidingCache.sample.launches == before + 1
    leaf_exact(kernels, ref[1], got[1])
    leaf_exact(kernels, ref[3], got[3])
    leaf_close(kernels, ref[0], got[0])
    leaf_close(kernels, ref[2], got[2])


# E7 record's split: short runs one thread a bin, long runs (more than
# RECORD_LONG_RUN records) staged chunk by chunk (F3D_GUIDE_STAGE floats from
# a 16-byte boundary; 1500 and 2600 straddle chunks); bit-equal to
# record_plain whatever the split
RUN_LENGTHS = (1, 63, 64, 65, 1023, 1024, 1025, 1500, 2600)


def record_case(device, lengths, seed):
    """A 6x6-cell, octa_res 8 cache and records whose keys make one run of
    each length (the other bins empty), in shuffled record order."""
    from forge3d_tpu_torch import guiding as gd

    res, cells = 8, 6
    cache = gd.GuidingCache.create((-5.0, 3.0), (100.0, 80.0), cells=cells, octa_res=res,
                                   device="cpu")
    rng = np.random.default_rng(seed)
    keys = rng.choice(cells * cells * res * res, len(lengths), replace=False)
    flat = np.repeat(keys, lengths)
    rng.shuffle(flat)
    cell, b = flat // (res * res), flat % (res * res)
    px = -5.0 + (cell % cells + 0.5) * (100.0 / cells)
    pz = 3.0 + (cell // cells + 0.5) * (80.0 / cells)
    d = gd._octa_decode_plain(torch.as_tensor(b), res)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    lum = rng.uniform(0.0, 1.0, flat.size) * rng.choice([1e-3, 1.0, 1e3, 1e5], flat.size)
    ins = [t(px), t(pz)] + [t(d[:, c].numpy()) for c in range(3)] + [t(lum)]
    got_flat = cache._cell_of(ins[0].cpu(), ins[1].cpu()) * res * res + gd._octa_encode_plain(
        *(c.cpu() for c in ins[2:5]), res)
    assert np.array_equal(got_flat.numpy(), flat)
    return cache._replace(hist=cache.hist.to(device)), ins, torch.as_tensor(flat)


@pytest.mark.parametrize("lengths", [RUN_LENGTHS, (5000,)], ids=["runs", "one_run_of_5000"])
def test_record_long_runs(kernels, lengths):
    from forge3d_tpu_torch import guiding as gd

    assert gd.RECORD_LONG_RUN == 1024   # RUN_LENGTHS holds its ±1
    cache, ins, flat = record_case(kernels, lengths, seed=len(lengths))
    steps = []
    got = gd._record_kernel(cache, *ins, mark=steps.append)
    ref = gd.record_plain(cache.hist, flat, ins[5])
    assert steps == ["keys", "sort", "bounds", "short runs", "long runs"]
    leaf_exact(kernels, ref, got)


# C1: the rANS chain and the MED reconstruction against their plain
# versions, bit for bit, on one- and two-tile pages, escapes included
# (the extreme page's 9,278 m step)
def codec_page(name, shape, eps):
    from forge3d_tpu_torch.codec import f3dz, f3dz_device

    h, w = shape
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    dem = (np.where(x > 128, 8848.0, -430.5) + y * 0.01 if name == "extreme"
           else 1500 + np.random.default_rng(3).normal(0, 40, (h, w)))
    blob = f3dz.compress_dem(np.asarray(dem, np.float32), eps)
    return blob, f3dz_device.parse_page(blob)


@pytest.mark.parametrize("case", [("extreme", (256, 512), 0.05), ("noisy", (512, 256), 0.5)],
                         ids=["extreme_256x512", "noisy_512x256"])
def test_codec_kernels(kernels, case):
    from forge3d_tpu_torch.codec import f3dz, f3dz_device as fd

    blob, page = codec_page(*case)
    t = page.tensors(kernels)
    assert int(t[3].ne(0).sum()) > 0 or case[0] != "extreme"    # escapes were taken
    before = (fd.rans_decode.launches, fd.med_reconstruct.launches)
    d = fd._rans_kernel(*t)
    assert torch.equal(d.cpu(), fd.rans_decode_plain(*(a.cpu() for a in t)))
    out = fd._med_kernel(d, page.ntx, page.nty, page.step)
    ref = fd.med_reconstruct_plain(d.cpu(), page.ntx, page.nty, page.step)
    assert torch.equal(out.cpu().view(torch.int32), ref.view(torch.int32))
    assert np.array_equal(out.cpu().numpy().view(np.uint32),
                          f3dz.decompress_dem(blob).view(np.uint32))
    assert (fd.rans_decode.launches, fd.med_reconstruct.launches) == (before[0] + 1, before[1] + 1)
