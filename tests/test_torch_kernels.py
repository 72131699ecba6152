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
import dataclasses
import hashlib
import os
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
// K5 as kernels.cu launches it: an image of rows of `width` rays in the
// blocks' 16x16 tiles and their threads' order (tile_pixel), a flat set in
// order; the instantiation by the spacings; each ray traced once (the
// counts `visits`, when given, show it)
extern "C++" template <bool kPow2>
void trace_launch(const SceneArgs& s, const float* rox, const float* roy, const float* roz,
                  const float* rdx, const float* rdy, const float* rdz, int n, int width,
                  float tmin, float tmax, unsigned char* hit, float* t, int* cell_x,
                  int* cell_z, int* visits) {
    const int blocks = width > 0 ? tile_blocks(width, n / width) : (n + 255) / 256;
    for (int b = 0; b < blocks; ++b)
        for (int th = 0; th < 256; ++th) {
            int i = b * 256 + th;
            if (width > 0) {
                const TilePixel p = tile_pixel(width, n / width, b, th);
                if (!p.inside) continue;
                i = p.y * width + p.x;
            } else if (i >= n) {
                continue;
            }
            Hit h = trace_ray_t<true, kPow2>(s, rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i],
                                             tmin, tmax);
            hit[i] = (unsigned char)h.hit; t[i] = h.t; cell_x[i] = h.cell_x; cell_z[i] = h.cell_z;
            if (visits) ++visits[i];
        }
}
int f3d_trace(const SceneArgs* s, const float* rox, const float* roy, const float* roz,
              const float* rdx, const float* rdy, const float* rdz, int n, int width,
              float tmin, float tmax, unsigned char* hit, float* t, int* cell_x, int* cell_z,
              void*) {
    if (pow2_spacing(s->sx) && pow2_spacing(s->sz))
        trace_launch<true>(*s, rox, roy, roz, rdx, rdy, rdz, n, width, tmin, tmax, hit, t,
                           cell_x, cell_z, nullptr);
    else
        trace_launch<false>(*s, rox, roy, roz, rdx, rdy, rdz, n, width, tmin, tmax, hit, t,
                            cell_x, cell_z, nullptr);
    return 0;
}
// test entry: each ray's count of traces under K5's layout for n rays of
// rows of `width` (0: flat)
void f3d_test_trace_visits(const SceneArgs* s, const float* rox, const float* roy,
                           const float* roz, const float* rdx, const float* rdy,
                           const float* rdz, int n, int width, unsigned char* hit, float* t,
                           int* cell_x, int* cell_z, int* visits) {
    trace_launch<false>(*s, rox, roy, roz, rdx, rdy, rdz, n, width, 1e-3f, 1e30f, hit, t,
                        cell_x, cell_z, visits);
}
// test entry: K5's register level cursor walked from the top level to 0
// and back, the node index of (nx, nz) at each visit: levels[v], index[v]
int f3d_test_level_cursor(int cell_w, int cell_h, int nx, int nz, int* levels, int* index) {
    LevelCursor lc(cell_w, cell_h);
    const int top = imax(lc.wlog, lc.hlog);
    int v = 0, level = top;
    for (; level > 0; --level) {
        levels[v] = level; index[v++] = lc.node(level, nx >> level, nz >> level);
        lc.down(level);
    }
    for (; level < top; ++level) {
        levels[v] = level; index[v++] = lc.node(level, nx >> level, nz >> level);
        lc.up(level);
    }
    levels[v] = level; index[v++] = lc.node(level, nx >> level, nz >> level);
    return v;
}
// test entry: K5's body with the level table read from device memory and
// the cell divisions (the parent design's body), one ray at a time
int f3d_test_trace_table(const SceneArgs* s, const float* rox, const float* roy,
                         const float* roz, const float* rdx, const float* rdy, const float* rdz,
                         int n, float tmin, float tmax, unsigned char* hit, float* t,
                         int* cell_x, int* cell_z) {
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
int f3d_frame_kernel_attrs(int, int* out) {
    out[0] = out[1] = out[2] = 0;   // no device function on the host
    return 0;
}
int f3d_trace_attrs(int, int* out) {
    out[0] = out[1] = out[2] = 0;
    return 0;
}
int f3d_mesh_kernel_attrs(int, int* out) {
    out[0] = out[1] = out[2] = 0;
    return 0;
}
int f3d_render_mesh_attrs(int* out) {
    out[0] = out[1] = out[2] = 0;
    return 0;
}
int f3d_tlas_attrs(int* out) {
    out[0] = out[1] = out[2] = 0;   // no device function on the host
    const float limits[2] = {F3D_MESH_INV_MIN, F3D_MESH_INV_CLAMP};
    out[3] = (int)(F3D_TLAS_CHUNK * sizeof(TlasInst));
    out[4] = F3D_TLAS_CHUNK;
    memcpy(out + 5, limits, sizeof(limits));
    return 0;
}
// K7 as kernels.cu maps it: the blocks of 16x16 band pixels in order; with
// a staged window (shared) each block first stages its tile and halo, then
// its threads read their taps from it
int f3d_spatial_reuse(const ResArgs* res_in, const ResArgs* res_out, const float* gb_nx,
                      const float* gb_ny, const float* gb_nz, int width, int height,
                      unsigned int frame_index, unsigned int seed_hi, int k_neighbors,
                      int radius, int row0, int rows, int shared, void*) {
    if (width <= 0 || rows <= 0) return 0;
    std::vector<float> buf(TileWindow::floats(radius));
    for (int b = 0; b < tile_blocks(width, rows); ++b) {
        const TilePixel corner = tile_pixel(width, rows, b, 0);
        const TileWindow win(buf.data(), radius, corner.x0 - radius, row0 + corner.y0 - radius);
        if (shared)
            for (int e = 0; e < win.entries(); ++e) win.stage(*res_in, width, height, e);
        for (int t = 0; t < 256; ++t) {
            const TilePixel p = tile_pixel(width, rows, b, t);
            if (!p.inside) continue;
            const FrameWindow frame{res_in, width, height};
            const Res out = shared
                ? spatial_pixel(win, *res_in, gb_nx, gb_ny, gb_nz, width, height, frame_index,
                                seed_hi, k_neighbors, radius, p.x, row0 + p.y)
                : spatial_pixel(frame, *res_in, gb_nx, gb_ny, gb_nz, width, height,
                                frame_index, seed_hi, k_neighbors, radius, p.x, row0 + p.y);
            store_res(*res_out, p.y * width + p.x, out);
        }
    }
    return 0;
}
int f3d_spatial_attrs(int, int, int* out) {
    out[0] = out[1] = out[2] = out[3] = 0;   // no device function on the host
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
// K10 as kernels.cu launches it, over the packed table (LightTable)
int f3d_sample_light_nee(const LightArgs* l, int n, const float* px, const float* py,
                         const float* pz, const float* nx, const float* ny, const float* nz,
                         const float* u_pick, const float* u1, const float* u2, float* dx,
                         float* dy, float* dz, float* dist, float* wr, float* wg, float* wb,
                         void*) {
    for (int i = 0; i < n; ++i) {
        LightSample s = sample_light(LightTable{l->table}, l->count, l->u_hi, px[i], py[i],
                                     pz[i], nx[i], ny[i], nz[i], u_pick[i], u1[i], u2[i]);
        dx[i] = s.dx; dy[i] = s.dy; dz[i] = s.dz; dist[i] = s.dist;
        wr[i] = s.wr; wg[i] = s.wg; wb[i] = s.wb;
    }
    return 0;
}
int f3d_render_spheres(const CamArgs* c, const SphereArgs* s, const AovArgs* o, void*) {
    for (int i = 0; i < c->width * c->height; ++i) sphere_pixel(*c, *s, *o, i);
    return 0;
}
// P2 as engines.cu launches it: the blocks' 16x16 tiles and their threads'
// order (tile_pixel)
int f3d_render_mesh(const CamArgs* c, const MeshArgs* m, const MaterialArgs* mat,
                    const AovArgs* o, void*) {
    if (c->width <= 0 || c->height <= 0) return 0;
    for (int b = 0; b < tile_blocks(c->width, c->height); ++b)
        for (int t = 0; t < 256; ++t) {
            const TilePixel p = tile_pixel(c->width, c->height, b, t);
            if (p.inside) mesh_pixel(*c, *m, *mat, *o, p.y * c->width + p.x);
        }
    return 0;
}
// test entry: P2's pixels in row order with the shadow walk skipped where
// it cannot change the pixel (skip) or walked on every hit; the walks made
int f3d_test_mesh_pixels(const CamArgs* c, const MeshArgs* m, const MaterialArgs* mat,
                         const AovArgs* o, int skip) {
    int walks = 0;
    for (int i = 0; i < c->width * c->height; ++i)
        walks += skip ? mesh_pixel_t<true>(*c, *m, *mat, *o, i)
                      : mesh_pixel_t<false>(*c, *m, *mat, *o, i);
    return walks;
}
// test entry: each pixel's count of threads under tile_pixel's layout of a
// width x rows image, and the threads that fell outside it
int f3d_test_tile_cover(int width, int rows, int* counts) {
    int outside = 0;
    for (int b = 0; b < tile_blocks(width, rows); ++b)
        for (int t = 0; t < 256; ++t) {
            const TilePixel p = tile_pixel(width, rows, b, t);
            if (p.inside) ++counts[p.y * width + p.x];
            else ++outside;
        }
    return outside;
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
// K3 as sweep.cu maps it, a CTA of 256 threads over F3D_K3_COLUMNS columns
// at a time, its steps in the kernel's order: each thread's profile samples and
// first valid row, the first valid row of each column, the edges, the scan
// (each thread's chunk, then the maxima of the chunks before it, in the
// order of the lanes and warps), then the passes of rows into the stage and
// the stage's floats into acc
int f3d_polar_frame(const PolarArgs* pa, const float* h_rot, const float* e_sky,
                    const float* z_sun, const float* corners, float* acc, float* scratch,
                    void*) {
    const PolarArgs& p = *pa;
    const int K = p.K, G = F3D_K3_COLUMNS, per = 256 / G, pf = PolarColumn::floats(K);
    if (p.A <= 0 || K <= 0) return 0;
    std::vector<float> smem((size_t)G * pf), stage(256 * 9);
    std::vector<Edge> edges(G);
    for (int b = 0; b < (p.A + G - 1) / G; ++b) {
        const int a0 = b * G;
        float* base = scratch ? scratch + (size_t)b * G * pf : smem.data();
        std::vector<int> k_first(G, K);
        for (int tid = 0; tid < 256; ++tid) {
            const int g = tid % G;
            if (a0 + g >= p.A) continue;
            const PolarColumn col(base + g * pf, K);
            const float t = azimuth_t(p, a0 + g);
            int first = K;
            for (int k = tid / G; k < K; k += per)
                if (polar_sample(p, h_rot, e_sky, z_sun, corners, col, k, t) && first == K)
                    first = k;
            k_first[g] = std::min(k_first[g], first);
        }
        for (int g = 0; g < G && a0 + g < p.A; ++g) {
            edges[g] = edge_sample(p, h_rot, e_sky, z_sun, corners, k_first[g],
                                   azimuth_t(p, a0 + g));
            polar_apply_edge(PolarColumn(base + g * pf, K), edges[g]);
        }
        const int chunk = (K + per - 1) / per;
        std::vector<float> chunk_max(256);
        for (int tid = 0; tid < 256; ++tid) {
            const int g = tid / per, k0 = std::min(K, (tid % per) * chunk);
            chunk_max[tid] = a0 + g < p.A
                ? polar_scan_chunk(base + g * pf, k0, std::min(K, k0 + chunk)) : -INFINITY;
        }
        for (int tid = 0; tid < 256; ++tid) {
            const int g = tid / per, k0 = std::min(K, (tid % per) * chunk);
            if (a0 + g >= p.A) continue;
            float before = -INFINITY;
            for (int u = g * per; u < tid; ++u) before = fmaxf(before, chunk_max[u]);
            float* M = base + g * pf;
            for (int k = k0; k < std::min(K, k0 + chunk); ++k) M[k] = fmaxf(before, M[k]);
        }
        for (int e0 = 0; e0 < p.E; e0 += per) {
            for (int tid = 0; tid < 256; ++tid) {
                const int g = tid % G, e = e0 + tid / G;
                if (a0 + g < p.A && e < p.E)
                    polar_texel(p, PolarColumn(base + g * pf, K), edges[g], e,
                                azimuth_t(p, a0 + g), stage.data() + tid * 9);
            }
            const int n = std::min(per, p.E - e0) * G * 9;
            float* rows = acc + ((size_t)e0 * p.A + a0) * 9;
            for (int f = 0; f < n; ++f) {
                const int o = polar_acc_offset(p, a0, f);
                if (o >= 0) rows[o] += stage[f];
            }
        }
    }
    return 0;
}
int f3d_polar_attrs(int, int, int* out) {
    out[0] = out[1] = out[2] = out[3] = 0;   // no device function on the host
    out[4] = F3D_K3_COLUMNS;
    return 0;
}
// test entry: each column's first valid profile row (K if none) and
// whether its edge sample replaces a slot
void f3d_test_polar_columns(const PolarArgs* pa, const float* h_rot, const float* e_sky,
                            const float* z_sun, const float* corners, int* k_first, int* can) {
    const PolarArgs& p = *pa;
    for (int a = 0; a < p.A; ++a) {
        const float t = azimuth_t(p, a);
        k_first[a] = p.K;
        for (int k = 0; k < p.K && k_first[a] == p.K; ++k) {
            float q, v[7];
            if (sample_values(p, h_rot, e_sky, z_sun, corners, k, t, q, v) > -1e20f)
                k_first[a] = k;
        }
        can[a] = edge_sample(p, h_rot, e_sky, z_sun, corners, k_first[a], t).can;
    }
}
// frame_one's nine channels of a profile held as K rows of `stride` floats
struct StridedRows {
    const float* v;
    int stride;
    float operator()(int k, int c) const { return v[(size_t)k * stride + c]; }
};
// test entry: K3 as its row-by-row design ran it, a column at a time: the
// profile with nine channels a row (7 the constant 1, 8 the entry flag),
// the edge, the running max, then every row's texel added into acc
void f3d_test_polar_serial(const PolarArgs* pa, const float* h_rot, const float* e_sky,
                           const float* z_sun, const float* corners, float* acc) {
    const PolarArgs& p = *pa;
    const int K = p.K;
    std::vector<float> M(K), v((size_t)K * 9), hp(K);
    for (int a = 0; a < p.A; ++a) {
        const float t = azimuth_t(p, a);
        int k_first = K;
        for (int k = 0; k < K; ++k) {
            hp[k] = sample_values(p, h_rot, e_sky, z_sun, corners, k, t, M[k], &v[k * 9]);
            v[k * 9 + 7] = 1.0f;
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
        for (int row = 0; row < p.E; ++row) {
            float Q = q_row(p, row);
            float out[9];
            float hit = crossing(M.data(), StridedRows{v.data(), 9}, 9, K, Q, out);
            float omh = 1.0f - hit;
            float z_ray = p.cam_y + Q * e.s_ent;
            bool phantom = out[8] > 0.98f && z_ray < e.h_ent - p.eps;
            float miss[3] = {0.0f, 0.0f, 0.0f};
            if (omh != 0.0f || phantom) miss_radiance(p, t, Q, miss);
            float* dst = acc + ((size_t)row * p.A + a) * 9;
            for (int c = 0; c < 9; ++c) {
                float m = c < 3 ? miss[c] : 0.0f;
                dst[c] += phantom ? m : out[c] + omh * m;
            }
        }
    }
}
int f3d_resolve(const ResolveArgs* r, const float* acc, unsigned char* out, void*) {
    for (int y = 0; y < r->height; ++y)
        for (int x = 0; x < r->width; ++x) resolve_pixel(*r, acc, x, y, out);
    return 0;
}
// R1 render as renderer.cu maps it: at aa 4 a lane per AA sample, each from
// the skipped-ahead state, summed in sample order as the pixel's lane 0
// sums; otherwise the blocks of 16x16 pixels in r1_tile_pixel's order
int f3d_terrain_render(const SceneArgs* s, const TerrainArgs* a, const TerrainOut* o, void*) {
    if (a->aa == 4) {
        for (int i = 0; i < a->width * a->height; ++i) {
            const int x = i % a->width, y = i / a->width;
            float r[4], g[4], b[4];
            ShadeAux aux[4];
            for (int k = 0; k < 4; ++k) {
                uint32_t st = xorshift_skip(r1_seed(*a, x, y), k * r1_sample_draws(*a));
                r1_sample(*s, *a, x, y, st, r[k], g[k], b[k], aux[k]);
            }
            float rs = 0.0f, gs = 0.0f, bs = 0.0f;
            for (int k = 0; k < 4; ++k) {
                rs = rs + r[k];
                gs = gs + g[k];
                bs = bs + b[k];
            }
            if (aux[0].vt_miss && o->vt_fallback != nullptr) count_fallback(o->vt_fallback);
            r1_write(*a, *o, i, rs, gs, bs, aux[0]);
        }
        return 0;
    }
    const int blocks = ((a->width + 15) / 16) * ((a->height + 15) / 16);
    for (int blk = 0; blk < blocks; ++blk)
        for (int t = 0; t < 256; ++t) {
            int x, y;
            if (r1_tile_pixel(*a, blk, t, x, y)) render_pixel(*s, *a, *o, y * a->width + x);
        }
    return 0;
}
int f3d_terrain_render_attrs(int, int* out) {
    out[0] = out[1] = out[2] = 0;   // no device function on the host
    return 0;
}
// test entry: pixel (x, y)'s stream state at the start of each AA sample,
// as render_pixel's serial loop leaves it and as xorshift_skip forms it
void f3d_test_r1_states(const SceneArgs* s, const TerrainArgs* a, int x, int y,
                        unsigned int* serial, unsigned int* skipped) {
    uint32_t st = r1_seed(*a, x, y);
    for (int k = 0; k < a->aa; ++k) {
        serial[k] = st;
        skipped[k] = xorshift_skip(r1_seed(*a, x, y), k * r1_sample_draws(*a));
        float r, g, b;
        ShadeAux aux;
        r1_sample(*s, *a, x, y, st, r, g, b, aux);
    }
}
// R1 step as renderer.cu maps it: the blocks of 16x16 pixels in
// r1_tile_pixel's order, then each 32x32 metric tile's mean
int f3d_terrain_step(const SceneArgs* s, const TerrainArgs* a, float* accum,
                     unsigned int sample_idx, float* lum, const TerrainOut* o, float* tiles,
                     void*) {
    const int blocks = ((a->width + 15) / 16) * ((a->height + 15) / 16);
    for (int blk = 0; blk < blocks; ++blk)
        for (int t = 0; t < 256; ++t) {
            int x, y;
            if (r1_tile_pixel(*a, blk, t, x, y)) {
                const int i = y * a->width + x;
                lum[i] = step_pixel(*s, *a, accum, sample_idx, *o, i);
            }
        }
    const int tw = (a->width + F3D_TILE - 1) / F3D_TILE, th = (a->height + F3D_TILE - 1) / F3D_TILE;
    for (int ty = 0; ty < th; ++ty)
        for (int tx = 0; tx < tw; ++tx)
            tiles[ty * tw + tx] = tile_mean_serial(
                lum + (ty * a->width + tx) * F3D_TILE, a->width,
                std::min(F3D_TILE, a->height - ty * F3D_TILE), std::min(F3D_TILE, a->width - tx * F3D_TILE));
    return 0;
}
// E3 as post.cu:atrous_kernel maps it: the tiles in order; in each, every
// slot staged, then every weight, then every pixel
int f3d_atrous_pass(const AtrousArgs* a, const float* in, float* out, int step, void*) {
    if (a->width <= 0 || a->height <= 0) return 0;
    if (step < 1) return 1;
    std::vector<AtrousQuad> sm((size_t)(atrous_shared_bytes(atrous_quads(*a)) / sizeof(AtrousQuad)) + 1);
    for (long long b = 0; b < atrous_tiles(*a, step); ++b) {
        const AtrousTile t = atrous_tile(*a, sm.data(), step, b);
        if (t.empty()) continue;
        for (int e = 0; e < kAtrousSlots; ++e) atrous_stage(*a, t, in, e);
        atrous_weights(*a, t, 0, 1);
        for (int e = 0; e < F3D_ATROUS_TX * F3D_ATROUS_TY; ++e) atrous_output(*a, t, out, e);
    }
    return 0;
}
int f3d_atrous_attrs(int* out) {
    out[0] = out[1] = out[2] = 0;   // no device function on the host
    out[3] = (int)atrous_shared_bytes(3);
    out[4] = F3D_ATROUS_TX;
    out[5] = F3D_ATROUS_TY;
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
// S2/S3: texel i's sums with its group of g lanes run one after the other:
// after each round the group's terms are added in lane order (reverse:
// backwards, which the scan's order rules out), as every lane of the group
// adds the __shfl_sync values in the kernel
void group_sums(const float* env4, int env_size, const float* dirs, const float* smp, int count,
                int mode, int g, int i, bool reverse, float* acc) {
    float nn[3], t[3], b[3];
    convolve_frame(dirs, i, nn, t, b);
    for (int c = 0; c < 4; ++c) acc[c] = 0.0f;
    for (int k0 = 0; k0 < count; k0 += g) {
        float x[32][4] = {};
        for (int lane = 0; lane < g && k0 + lane < count; ++lane)
            convolve_sample(env4, env_size, nn, t, b, smp, k0 + lane, mode, x[lane]);
        for (int j = 0; j < g; ++j) {
            const int q = reverse ? g - 1 - j : j;
            if (k0 + q < count)
                for (int c = 0; c < 4; ++c) acc[c] = acc[c] + x[q][c];
        }
    }
}
int f3d_ibl_convolve(const float* env4, int env_size, const long long* jobs, int n_jobs, void*) {
    for (int j = 0; j < n_jobs; ++j) {
        const long long* w = jobs + 7 * j;
        const float* dirs = (const float*)w[0];
        const float* smp = (const float*)w[1];
        float* out = (float*)w[2];
        const int n = (int)w[3], count = (int)w[4], mode = (int)w[5], g = (int)w[6];
        if (g < 1 || g > 32 || (g & (g - 1)) != 0) return 1;
        for (int i = 0; i < n; ++i) {
            float acc[4];
            group_sums(env4, env_size, dirs, smp, count, mode, g, i, false, acc);
            convolve_finish(acc, mode, i, out);
        }
    }
    return 0;
}
// test entry: the float32 sums (before the f16 output) of texels 0 .. n - 1
// of a convolution, out (3, n, 4): the scan's order, group_sums' for g lanes
// (ibl_convolve's), and group_sums' in reverse lane order
void f3d_test_convolve_sums(const float* env4, int env_size, const float* dirs,
                            const float* smp, int count, int mode, int g, int n, float* out) {
    for (int i = 0; i < n; ++i) {
        float nn[3], t[3], b[3];
        convolve_frame(dirs, i, nn, t, b);
        float* scan = out + 4 * i;
        for (int c = 0; c < 4; ++c) scan[c] = 0.0f;
        for (int k = 0; k < count; ++k) {
            float x[4];
            convolve_sample(env4, env_size, nn, t, b, smp, k, mode, x);
            for (int c = 0; c < 4; ++c) scan[c] = scan[c] + x[c];
        }
        group_sums(env4, env_size, dirs, smp, count, mode, g, i, false, out + 4 * (n + i));
        group_sums(env4, env_size, dirs, smp, count, mode, g, i, true, out + 4 * (2 * n + i));
    }
}
int f3d_ibl_convolve_attrs(int* out) {
    out[0] = out[1] = out[2] = 0;   // no device function on the host
    return 0;
}
int f3d_raster_depth(const float* tris, const unsigned char* keep, int n_tris, int res, int wbb,
                     int hbb, float* depth, void*) {
    for (int t = 0; t < n_tris; ++t) raster_triangle(tris, keep, t, res, wbb, hbb, depth);
    return 0;
}
// S8 as screen.cu maps it: the blocks' 16x16 tiles in order, each block's
// threads a 2x2 quad (four lanes) at a time: the four pixels' fronts (a
// lane past the image shades pixel (0, 0)), the quad's normal gradient,
// the four backs of the pixels inside the image (the kernel exchanges the
// normals by shuffle). The PCSS taps go through ShadowTex, whose host
// fetches emulate the texture unit over the pointer the handle holds.
int f3d_screen_shade(const ScreenArgs* a, const ScreenOut* o, void*) {
    if (a->width <= 0 || a->height <= 0) return 0;
    for (long long b = 0; b < s8_blocks(a->width, a->height); ++b)
        for (int t0 = 0; t0 < 256; t0 += 4) {
            ShadeState s[4];
            int x[4], y[4];
            bool live[4];
            for (int k = 0; k < 4; ++k) {
                live[k] = s8_pixel(a->width, a->height, b, t0 + k, x[k], y[k]);
                shade_front(*a, x[k], y[k], s[k]);
            }
            const float g = quad_grad(s[0].sn, s[1].sn, s[2].sn);
            for (int k = 0; k < 4; ++k)
                if (live[k]) shade_back(*a, *o, x[k], y[k], s[k], g);
        }
    return 0;
}
int f3d_screen_shade_attrs(int* out) {
    out[0] = out[1] = out[2] = 0;   // no device function on the host
    return 0;
}
int f3d_clipmap_shade_attrs(int* out) {
    out[0] = out[1] = out[2] = 0;
    return 0;
}
int f3d_sample_light_attrs(int* out) {
    out[0] = out[1] = out[2] = 0;
    return 0;
}
// the host's texture object over a shadow map is the map's pointer, which
// ShadowTex's host fetches read as the texture unit would
int f3d_shadow_texture_create(const float* depth, int res, unsigned long long* tex) {
    *tex = (unsigned long long)(uintptr_t)depth;
    return res > 0 ? 0 : 1;
}
int f3d_shadow_texture_destroy(unsigned long long) { return 0; }
int f3d_pcss_points(const ScreenArgs* a, const float* sp, const float* nrm, int n, int tex,
                    float* out, void*) {
    for (int i = 0; i < n; ++i)
        out[i] = tex ? pcss_visibility(ShadowTex{a->shadow_tex, a->shadow_res}, a->lvp,
                                       a->pcss_ld, sp + 3 * i, nrm + 3 * i)
                     : pcss_visibility(ShadowPtr{a->shadow, a->shadow_res}, a->lvp, a->pcss_ld,
                                       sp + 3 * i, nrm + 3 * i);
    return 0;
}
// S9 the same way, its PCSS taps through ShadowTex
int f3d_clipmap_shade(const ScreenArgs* a, const ClipArgs* c, unsigned char* rgba, void*) {
    if (a->width <= 0 || a->height <= 0) return 0;
    const ShadowTex map{a->shadow_tex, a->shadow_res};
    for (long long b = 0; b < s8_blocks(a->width, a->height); ++b)
        for (int t0 = 0; t0 < 256; t0 += 4) {
            ClipState s[4];
            int x[4], y[4];
            bool live[4];
            for (int k = 0; k < 4; ++k) {
                live[k] = s8_pixel(a->width, a->height, b, t0 + k, x[k], y[k]);
                clip_front(*a, *c, x[k], y[k], s[k]);
            }
            const float g = quad_grad(s[0].n, s[1].n, s[2].n);
            for (int k = 0; k < 4; ++k)
                if (live[k]) clip_back(map, *a, *c, rgba, x[k], y[k], s[k], g);
        }
    return 0;
}
// S9 as its earlier design ran it: quads along the image's rows, the PCSS
// taps through the pointer (ShadowPtr)
void f3d_test_parent_clipmap(const ScreenArgs* a, const ClipArgs* c, unsigned char* rgba) {
    const ShadowPtr map{a->shadow, a->shadow_res};
    for (int qy = 0; qy < a->height / 2; ++qy)
        for (int qx = 0; qx < a->width / 2; ++qx) {
            ClipState s[4];
            for (int k = 0; k < 4; ++k) clip_front(*a, *c, 2 * qx + (k & 1), 2 * qy + (k >> 1), s[k]);
            const float g = quad_grad(s[0].n, s[1].n, s[2].n);
            for (int k = 0; k < 4; ++k)
                clip_back(map, *a, *c, rgba, 2 * qx + (k & 1), 2 * qy + (k >> 1), s[k], g);
        }
}
// K10 as its earlier design read the light set: ten (L,)-arrays, the
// pick's prob -> alias -> pdf chain, then the type and the scattered fields.
// ptrs: type_id, color, direction, position, radius, extent, cones, prob,
// alias, pdf; lanes: px, py, pz, nx, ny, nz, u_pick, u1, u2; outs: dx, dy,
// dz, dist, wr, wg, wb.
void f3d_test_parent_sample_light(const long long* ptrs, int count, float u_hi, int n,
                                  const long long* lanes, const long long* outs) {
    const int* type_id = (const int*)ptrs[0];
    const float* color = (const float*)ptrs[1];
    const float* direction = (const float*)ptrs[2];
    const float* position = (const float*)ptrs[3];
    const float* radius = (const float*)ptrs[4];
    const float* extent = (const float*)ptrs[5];
    const float* cones = (const float*)ptrs[6];
    const float* prob = (const float*)ptrs[7];
    const int* alias = (const int*)ptrs[8];
    const float* pdf = (const float*)ptrs[9];
    const float* in[9];
    float* out[7];
    for (int k = 0; k < 9; ++k) in[k] = (const float*)lanes[k];
    for (int k = 0; k < 7; ++k) out[k] = (float*)outs[k];
    for (int j = 0; j < n; ++j) {
        const float px = in[0][j], py = in[1][j], pz = in[2][j];
        const float nx = in[3][j], ny = in[4][j], nz = in[5][j];
        const float u1 = in[7][j], u2 = in[8][j];
        float x = fminf(fmaxf(in[6][j] * (float)count, 0.0f), u_hi);
        int col = (int)x;
        float frac = x - (float)col;
        const int i = frac < prob[col] ? col : alias[col];
        const float p_pick = pdf[i];
        const int type = type_id[i];
        const float rad = radius[i];
        const float* ldir = direction + 3 * i;
        const float* lpos = position + 3 * i;
        float off_x = 0.0f, off_y = 0.0f, off_z = 0.0f;
        if (type == F3D_RECT) {
            off_x = (u1 * 2.0f - 1.0f) * extent[2 * i];
            off_z = (u2 * 2.0f - 1.0f) * extent[2 * i + 1];
        } else if (type == F3D_DISK) {
            float dr = sqrtf(u1) * rad;
            float dphi = F3D_TWO_PI_LS * u2;
            off_x = dr * cosf(dphi);
            off_z = dr * sinf(dphi);
        } else if (type == F3D_SPHERE) {
            float sz = u1 * 2.0f - 1.0f;
            float sphi = F3D_TWO_PI_LS * u2;
            float sr = sqrtf(fmaxf(1.0f - sz * sz, 0.0f));
            off_x = rad * sr * cosf(sphi);
            off_y = rad * sz;
            off_z = rad * sr * sinf(sphi);
        }
        float vx = (lpos[0] + off_x) - px;
        float vy = (lpos[1] + off_y) - py;
        float vz = (lpos[2] + off_z) - pz;
        float d2 = vx * vx + vy * vy + vz * vz;
        LightSample s;
        if (type == F3D_DIRECTIONAL) {
            s.dx = -ldir[0]; s.dy = -ldir[1]; s.dz = -ldir[2]; s.dist = 1e30f;
        } else {
            float dist = sqrtf(fmaxf(d2, 1e-12f));
            float inv = 1.0f / dist;
            s.dx = vx * inv; s.dy = vy * inv; s.dz = vz * inv; s.dist = dist;
        }
        float ndl = fmaxf(nx * s.dx + ny * s.dy + nz * s.dz, 0.0f);
        float inv_d2 = 1.0f / fmaxf(d2, 1e-6f);
        float geom;
        if (type == F3D_DIRECTIONAL) {
            geom = 1.0f;
        } else if (type == F3D_RECT) {
            float area = 4.0f * extent[2 * i] * extent[2 * i + 1];
            geom = area * fabsf(s.dy) * inv_d2;
        } else if (type == F3D_DISK) {
            float area = F3D_PI_F * rad * rad;
            geom = area * fabsf(s.dy) * inv_d2;
        } else if (type == F3D_SPHERE) {
            float rs = fmaxf(rad, 1e-9f);
            float snx = rad > 0.0f ? off_x / rs : 0.0f;
            float sny = rad > 0.0f ? off_y / rs : 0.0f;
            float snz = rad > 0.0f ? off_z / rs : 0.0f;
            float cos_s = fmaxf(-(snx * s.dx + sny * s.dy + snz * s.dz), 0.0f);
            float area = F3D_FOUR_PI_F * rad * rad;
            geom = area * cos_s * inv_d2;
        } else {
            geom = inv_d2;
        }
        if (type == F3D_SPOT) {
            float cd = -(s.dx * ldir[0] + s.dy * ldir[1] + s.dz * ldir[2]);
            float c_in = cones[2 * i], c_out = cones[2 * i + 1];
            float spot = fminf(fmaxf((cd - c_out) / fmaxf(c_in - c_out, 1e-6f), 0.0f), 1.0f);
            geom = geom * spot * spot;
        }
        float scale = ndl * geom / fmaxf(p_pick, 1e-12f);
        out[0][j] = s.dx; out[1][j] = s.dy; out[2][j] = s.dz; out[3][j] = s.dist;
        out[4][j] = color[3 * i] * scale;
        out[5][j] = color[3 * i + 1] * scale;
        out[6][j] = color[3 * i + 2] * scale;
    }
}
// s8_pixel over every block and thread of a width x height launch: each
// lane's (x, y, live), 3 ints a lane in launch order
void f3d_test_s8_pixels(int width, int height, int* out) {
    for (long long b = 0; b < s8_blocks(width, height); ++b)
        for (int t = 0; t < 256; ++t) {
            int x, y;
            const bool live = s8_pixel(width, height, b, t, x, y);
            int* o = out + 3 * (b * 256 + t);
            o[0] = x, o[1] = y, o[2] = live;
        }
}
int f3d_struct_sizes(long long* out, int n) {
    const long long sizes[] = {(long long)sizeof(ScreenArgs), (long long)sizeof(ScreenOut),
                               (long long)sizeof(ClipArgs), (long long)sizeof(SkyArgs),
                               (long long)sizeof(SdfArgs), (long long)sizeof(MeshArgs),
                               (long long)sizeof(TlasArgs), (long long)sizeof(HybridArgs),
                               (long long)sizeof(HybridOut), (long long)sizeof(AdjArgs),
                               (long long)sizeof(TerrainArgs), (long long)sizeof(TerrainOut),
                               (long long)sizeof(SmokeMarchArgs), (long long)sizeof(PreethamArgs),
                               (long long)sizeof(GuideArgs), (long long)sizeof(TlasInst),
                               (long long)sizeof(LightArgs)};
    for (int i = 0; i < n && i < 17; ++i) out[i] = sizes[i];
    return 17;
}
// P6, P5, P3 and P4 one point, ray or pixel at a time; P6 in the
// instantiation pt.cu's launchers pick for the tape
int f3d_sdf_eval(const SdfArgs* s, const float* px, const float* py, const float* pz, int n,
                 float* d, int* mat, void*) {
    const bool g = !sdf_in_shared(*s);
    for (int i = 0; i < n; ++i)
        d[i] = g ? sdf_eval_t<true>(s->tape, s->tape_len, px[i], py[i], pz[i], mat[i])
                 : sdf_eval_t<false>(s->tape, s->tape_len, px[i], py[i], pz[i], mat[i]);
    return 0;
}
int f3d_sdf_normal(const SdfArgs* s, const float* px, const float* py, const float* pz, int n,
                   float eps, float* out, void*) {
    const bool g = !sdf_in_shared(*s);
    for (int i = 0; i < n; ++i) {
        float* o = out + i;
        if (g)
            sdf_normal_t<true>(s->tape, s->tape_len, px[i], py[i], pz[i], eps, o[0], o[n], o[2 * n]);
        else
            sdf_normal_t<false>(s->tape, s->tape_len, px[i], py[i], pz[i], eps, o[0], o[n],
                                o[2 * n]);
    }
    return 0;
}
int f3d_sdf_march(const SdfArgs* s, const float* rox, const float* roy, const float* roz,
                  const float* rdx, const float* rdy, const float* rdz, int n, float tmin,
                  float tmax, int max_steps, float hit_eps, unsigned char* hit, float* t,
                  int* mat, void*) {
    const bool g = !sdf_in_shared(*s);
    for (int i = 0; i < n; ++i) {
        SdfHit h = g ? sdf_march_t<true>(s->tape, s->tape_len, rox[i], roy[i], roz[i], rdx[i],
                                         rdy[i], rdz[i], tmin, tmax, max_steps, hit_eps)
                     : sdf_march_t<false>(s->tape, s->tape_len, rox[i], roy[i], roz[i], rdx[i],
                                          rdy[i], rdz[i], tmin, tmax, max_steps, hit_eps);
        hit[i] = (unsigned char)h.hit; t[i] = h.t; mat[i] = h.material;
    }
    return 0;
}
int f3d_sdf_march_attrs(const SdfArgs* s, int* out) {
    out[0] = out[1] = out[2] = 0;   // no device function on the host
    out[3] = sdf_in_shared(*s);
    return 0;
}
// test entry: P6's body with the tape read as from global or shared memory
// (`global`) whatever its length: the distance and material at each point,
// then the march of each ray
void f3d_test_sdf_variant(const SdfArgs* s, int global, const float* px, const float* py,
                          const float* pz, int n, float* d, int* mat, const float* ro,
                          const float* rd, int n_rays, float tmin, float tmax, int max_steps,
                          float hit_eps, unsigned char* hit, float* t, int* hmat) {
    const float* tp = s->tape;
    const int T = s->tape_len;
    for (int i = 0; i < n; ++i)
        d[i] = global ? sdf_eval_t<true>(tp, T, px[i], py[i], pz[i], mat[i])
                      : sdf_eval_t<false>(tp, T, px[i], py[i], pz[i], mat[i]);
    for (int i = 0; i < n_rays; ++i) {
        const float* o = ro + 3 * i;
        const float* q = rd + 3 * i;
        SdfHit h = global ? sdf_march_t<true>(tp, T, o[0], o[1], o[2], q[0], q[1], q[2], tmin,
                                              tmax, max_steps, hit_eps)
                          : sdf_march_t<false>(tp, T, o[0], o[1], o[2], q[0], q[1], q[2], tmin,
                                               tmax, max_steps, hit_eps);
        hit[i] = (unsigned char)h.hit; t[i] = h.t; hmat[i] = h.material;
    }
}
// P5 as pt.cu runs it: blocks of 128 rays, the table staged a chunk of
// F3D_TLAS_CHUNK instances at a time (a copy), each ray's visits of the
// chunk in order
int f3d_trace_tlas(const TlasArgs* a, const float* rox, const float* roy, const float* roz,
                   const float* rdx, const float* rdy, const float* rdz, int n, float tmin,
                   float tmax, unsigned char* hit, float* t, int* inst, int* prim, float* u,
                   float* v, void*) {
    std::vector<TlasInst> st(F3D_TLAS_CHUNK);
    for (int b0 = 0; b0 < n; b0 += 128) {
        const int nb = std::min(128, n - b0);
        std::vector<TlasRay> r(nb);
        std::vector<TlasHit> h(nb);
        for (int i = 0; i < nb; ++i) {
            r[i] = tlas_ray_of(rox[b0 + i], roy[b0 + i], roz[b0 + i], rdx[b0 + i], rdy[b0 + i],
                               rdz[b0 + i]);
            h[i] = tlas_miss(tmax);
        }
        for (int c0 = 0; c0 < a->n_inst; c0 += F3D_TLAS_CHUNK) {
            const int m = std::min(F3D_TLAS_CHUNK, a->n_inst - c0);
            memcpy(st.data(), a->inst + c0, m * sizeof(TlasInst));
            for (int i = 0; i < nb; ++i)
                for (int q = 0; q < m; ++q)
                    if (tlas_cull(st[q], r[i], tmin, tmax))
                        tlas_walk(st[q], c0 + q, r[i], tmin, tmax, h[i]);
        }
        for (int i = 0; i < nb; ++i) {
            const int k = b0 + i;
            hit[k] = (unsigned char)h[i].hit; t[k] = h[i].t; inst[k] = h[i].instance;
            prim[k] = h[i].prim; u[k] = h[i].u; v[k] = h[i].v;
        }
    }
    return 0;
}
// test entry: P5's cull over n rays and every instance: out = {(ray,
// instance) pairs it rejects where the walk's root test accepts, pairs it
// rejects}
void f3d_test_tlas_cull(const TlasArgs* a, const float* rox, const float* roy, const float* roz,
                        const float* rdx, const float* rdy, const float* rdz, int n, float tmin,
                        float tmax, long long* out) {
    out[0] = out[1] = 0;
    for (int i = 0; i < n; ++i) {
        const TlasRay r = tlas_ray_of(rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i]);
        for (int q = 0; q < a->n_inst; ++q)
            if (!tlas_cull(a->inst[q], r, tmin, tmax)) {
                out[1] += 1;
                out[0] += tlas_root_accepts(a->inst[q], r, tmin, tmax);
            }
    }
}
// P3 as pt.cu maps it: blocks of 16x16 pixels, a warp 8x4
int f3d_hybrid_render(const SceneArgs* s, const MeshArgs* m, const SdfArgs* sdf,
                      const HybridArgs* a, const float* rdx, const float* rdy, const float* rdz,
                      const HybridOut* o, void*) {
    const int tiles_x = (a->width + 15) / 16;
    for (int blk = 0; blk < tiles_x * ((a->height + 15) / 16); ++blk)
        for (int t = 0; t < 256; ++t) {
            const int x = (blk % tiles_x) * 16 + ((t >> 5) & 1) * 8 + (t & 7);
            const int y = (blk / tiles_x) * 16 + (t >> 6) * 4 + ((t & 31) >> 3);
            if (x < a->width && y < a->height)
                hybrid_pixel(*s, *m, *sdf, *a, rdx, rdy, rdz, *o, y * a->width + x);
        }
    return 0;
}
int f3d_hybrid_attrs(int* out) {
    out[0] = out[1] = out[2] = 0;   // no device function on the host
    return 0;
}
// P4 raster: 16x16 tiles in the kernel's lane order, ragged edges skipped
int f3d_adj_raster(const AdjArgs* a, const float* quad, unsigned char* rgba, float* hdr, void*) {
    const int tiles_x = (a->width + 15) / 16, tiles = tiles_x * ((a->height + 15) / 16);
    for (int blk = 0; blk < tiles; ++blk)
        for (int t = 0; t < 256; ++t) {
            const int x = (blk % tiles_x) * 16 + ((t >> 5) & 1) * 8 + (t & 7);
            const int y = (blk / tiles_x) * 16 + (t >> 6) * 4 + ((t & 31) >> 3);
            if (x < a->width && y < a->height)
                adj_raster_pixel(*a, quad, y * a->width + x, rgba, hdr);
        }
    return 0;
}
int f3d_adj_raster_attrs(int* out) {
    out[0] = out[1] = out[2] = 0;   // no device function on the host
    return 0;
}
// P4 pt as adjudication.cu maps it: a lane a pixel in 8x4 tiles, each lane
// run to its end in turn
int f3d_adj_pt(const AdjArgs* a, const uint32_t* keys, unsigned char* rgba, float* hdr, void*) {
    for (int k = 0; k < adj_pt_lanes(a->width, a->height); ++k) {
        const int p = adj_pt_pixel_of(a->width, a->height, k);
        AdjNoQueue none;
        if (p >= 0) adj_pt_lane(*a, keys, p, none, rgba, hdr);
    }
    return 0;
}
int f3d_adj_pt_attrs(int* out) {
    for (int k = 0; k < 4; ++k) out[k] = 0;   // no device function on the host
    return 0;
}
// test entry: a pixel queue on the host, the pixels in row-major order or
// the kernel's tile order (`tiles`), handed out from the last back with
// `reverse`
struct HostQueue {
    int k, len, width, height;
    bool reverse, tiles;
    int operator()() {
        for (;;) {
            if (k >= len) return -1;
            const int j = reverse ? len - 1 - k : k;
            ++k;
            const int p = tiles ? adj_pt_pixel_of(width, height, j) : j;
            if (p >= 0) return p;
        }
    }
};
// test entry: P4 pt as a thread a pixel ran it before the hit loop: each
// sample's depth loop in turn, the sun NEE's BSDF and shadow ray and the
// environment sample's BSDF, pdfs and shadow ray formed at every vertex
void f3d_test_adj_pt_serial(const AdjArgs* a, const uint32_t* keys, unsigned char* rgba,
                            float* hdr) {
    for (int i = 0; i < a->width * a->height; ++i) {
        const uint32_t idx = (uint32_t)i;
        V3 sum = v3(0.0f, 0.0f, 0.0f);
        for (int s = 0; s < a->spp; ++s) {
            const uint32_t* ks = keys + 2 * F3D_ADJ_KEYS * s;
            float jx = adj_uniform(ks, idx), jy = adj_uniform(ks + 2, idx);
            V3 ro = vld(a->cam_o);
            V3 rd = adj_camera_ray(*a, i % a->width, i / a->width, jx, jy);
            V3 thr = v3(1.0f, 1.0f, 1.0f), acc = v3(0.0f, 0.0f, 0.0f);
            for (int depth = 0; depth < F3D_ADJ_DEPTH; ++depth) {
                const uint32_t* kd = ks + 4 + 12 * depth;
                float t;
                int kind = adj_nearest(*a, ro, rd, t);
                if (kind < 0) {
                    acc = vadd(acc, vmul(thr, vld(a->sky)));
                    break;
                }
                V3 pos = vadd(ro, vscale(rd, t));
                V3 n = adj_normal(*a, pos, kind);
                V3 alb = vld(a->alb + 3 * kind);
                float rough = a->rough[kind];
                V3 wo = vscale(rd, -1.0f);
                acc = vadd(acc, vmul(thr, adj_sun_nee(*a, pos, n, wo, alb, rough)));
                float u[6];
                for (int j = 0; j < 6; ++j) u[j] = adj_uniform(kd + 2 * j, idx);
                float cos_t = powf(1.0f - u[1], 1.0f / 17.0f);
                float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
                float phi = 2.0f * F3D_ADJ_PI * u[2];
                V3 wi_l;
                if (u[0] < 0.5f) {
                    wi_l = v3(sin_t * cosf(phi), cos_t, sin_t * sinf(phi));
                } else {
                    float r = sqrtf(u[1]), ph = 2.0f * F3D_ADJ_PI * u[2];
                    wi_l = adj_to_world(n, r * cosf(ph), r * sinf(ph),
                                        sqrtf(fmaxf(1.0f - u[1], 0.0f)));
                }
                float cos_surf = fmaxf(adj_dot(n, wi_l), 0.0f);
                float pdf_l = adj_env_pdf(n, wi_l);
                float pdf_b;
                V3 f = adj_bsdf(wo, wi_l, n, alb, rough, pdf_b);
                float w_mis = pdf_l / fmaxf(pdf_l + pdf_b, 1e-8f);
                bool vis = !adj_occluded(*a, vadd(pos, vscale(n, 1e-3f)), wi_l);
                if (cos_surf > 0.0f) {
                    float w = cos_surf / fmaxf(pdf_l, 1e-8f) * w_mis * (vis ? 1.0f : 0.0f);
                    acc = vadd(acc, vmul(thr, vscale(vmul(f, vld(a->amb)), w)));
                }
                float r4 = sqrtf(u[3]), ph4 = 2.0f * F3D_ADJ_PI * u[4];
                V3 d = adj_to_world(n, r4 * cosf(ph4), r4 * sinf(ph4),
                                    sqrtf(fmaxf(1.0f - u[3], 0.0f)));
                V3 thr_new = vmul(thr, alb);
                float max_c = fmaxf(fmaxf(thr_new.x, thr_new.y), thr_new.z);
                float q = depth >= F3D_ADJ_RR ? fminf(fmaxf(1.0f - max_c, 0.0f), 0.95f) : 0.0f;
                if (!(u[5] >= q) || depth + 1 >= F3D_ADJ_DEPTH) break;
                float inv = fmaxf(1.0f - q, 1e-6f);
                thr = v3(thr_new.x / inv, thr_new.y / inv, thr_new.z / inv);
                ro = vadd(pos, vscale(n, 1e-3f));
                rd = d;
            }
            sum = vadd(sum, acc);
        }
        const float spp = (float)a->spp;
        adj_store(*a, v3(sum.x / spp, sum.y / spp, sum.z / spp), i, rgba, hdr);
    }
}
// test entry: P4 pt as `lanes` lanes taking pixels from one queue, in
// passes: each lane in turn (from the last back with `reverse`) runs its
// cheap steps, taking the queue's next pixel when its own is done, then
// shades its held vertex
void f3d_test_adj_pt_queue(const AdjArgs* a, const uint32_t* keys, unsigned char* rgba,
                           float* hdr, int lanes, int reverse, int tiles) {
    const int len = tiles ? adj_pt_lanes(a->width, a->height) : a->width * a->height;
    HostQueue q{0, len, a->width, a->height, reverse != 0, tiles != 0};
    std::vector<AdjLane> L(lanes);
    std::vector<int> live(lanes, 1);
    for (int l = 0; l < lanes; ++l) adj_pt_begin(L[l], q());
    for (int busy = lanes; busy > 0;) {
        busy = 0;
        for (int j = 0; j < lanes; ++j) {
            const int l = reverse ? lanes - 1 - j : j;
            float t;
            int kind;
            if (!live[l]) continue;
            live[l] = adj_pt_advance(*a, keys, L[l], q, rgba, hdr, t, kind);
            if (live[l]) adj_pt_vertex(*a, keys, L[l], t, kind);
            busy += live[l];
        }
    }
}
// E4: the binning one primitive (and backdrop row) at a time, then each
// tile's pixels in order
int f3d_vector_count(const void* table, int n_layers, const float* prims, int n_prims, int width,
                     int height, int* counts, int* backdrop, void*) {
    if (width <= 0 || height <= 0) return 0;
    for (int i = 0; i < n_prims; ++i)
        vec_count_prim((const VecLayer*)table, n_layers, prims, i, width, height, counts,
                       backdrop);
    return 0;
}
int f3d_vector_compose(const void* table, int n_layers, const float* prims, int n_prims,
                       int n_poly, int width, int height, int* counts, const int* offs,
                       float* entries, int* backdrop, float* cov, float* rgb, float* alpha,
                       int* pick, void*) {
    if (width <= 0 || height <= 0 || n_layers <= 0) return 0;
    const VecLayer* t = (const VecLayer*)table;
    for (int i = 0; i < n_prims; ++i)
        vec_scatter_prim(t, n_layers, prims, i, width, height, counts, offs, entries);
    const int tiles_x = vec_tiles(width);
    for (int j = 0; j < n_poly * height; ++j) vec_backdrop_row(backdrop, j, tiles_x);
    for (int tile = 0; tile < tiles_x * vec_tiles(height); ++tile)
        for (int k = 0; k < F3D_VEC_TILE * F3D_VEC_TILE; ++k) {
            const int x = (tile % tiles_x) * F3D_VEC_TILE + k % F3D_VEC_TILE;
            const int y = (tile / tiles_x) * F3D_VEC_TILE + k / F3D_VEC_TILE;
            if (x < width && y < height)
                vec_pixel_binned(t, n_layers, width, height, offs, entries, backdrop, tile, x,
                                 y, cov, rgb, alpha, pick);
        }
    return 0;
}
// E2 blur as post.cu maps it: the tiles in order; with a shared window
// each tile first stages its columns' span and halo, then its threads run
// their F3D_BLUR_M outputs at a time, in thread order; E1 and the rest of
// E2 one element, pixel or texel at a time
int f3d_blur_axis(const float* in, float* out, const float* taps, int radius, int outer, int n,
                  int inner, int shared, void*) {
    const BlurGeom g{in, out, (long long)outer * inner, n, inner, radius};
    if (g.cols <= 0 || n <= 0) return 0;
    if (radius < 0) return 1;
    std::vector<float> sm(shared ? blur_staged_rows(radius) * F3D_BLUR_COLS : 0);
    for (long long b = 0; b < blur_tiles(g); ++b) {
        long long col0;
        int pos0;
        blur_tile(g, b, col0, pos0);
        if (shared)
            for (int k = 0; k < F3D_BLUR_COLS; ++k)
                blur_stage_column(g, blur_col_base(g, col0 + k), pos0, k, 0, 1, sm.data());
        for (int t = 0; t < F3D_BLUR_THREADS; ++t) {
            const long long base = blur_col_base(g, col0 + t % F3D_BLUR_COLS);
            for (int m = 0; m < kBlurRuns; ++m) {
                float acc[F3D_BLUR_M];
                const bool ok = shared
                    ? blur_thread_acc<true>(g, base, sm.data(), taps, pos0, t, m, acc)
                    : blur_thread_acc<false>(g, base, nullptr, taps, pos0, t, m, acc);
                if (ok) blur_store_run(g, base, col0, pos0, t, m, acc);
            }
        }
    }
    return 0;
}
int f3d_blur_attrs(int, int, int* out) {
    out[0] = out[1] = out[2] = out[3] = 0;   // no device function on the host
    out[4] = F3D_BLUR_M;
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
// E1 as ibl.cu launches it: a texel's samples on g lanes, lane j computing
// samples j, j + g, ..., each round's g terms added in lane order (reverse:
// in reverse lane order, which the kernel must not do)
void bake_sums(const float* env4, int env_h, int env_w, const float* rec, int count, int mode,
               int g, bool reverse, float* acc) {
    for (int c = 0; c < 4; ++c) acc[c] = 0.0f;
    for (int k0 = 0; k0 < count; k0 += g) {
        float x[32][4] = {};
        for (int lane = 0; lane < g && k0 + lane < count; ++lane)
            ibl_term(env4, env_h, env_w, rec + 4 * (k0 + lane), mode, x[lane]);
        for (int j = 0; j < g; ++j) {
            const int q = reverse ? g - 1 - j : j;
            if (k0 + q < count) ibl_add(acc, x[q], mode);
        }
    }
}
int f3d_ibl_bake(const float* env4, int env_h, int env_w, const long long* jobs, int n_jobs,
                 void*) {
    if (n_jobs < 0 || n_jobs > kIblBakeJobs) return 1;
    for (int j = 0; j < n_jobs; ++j) {
        const long long* w = jobs + 6 * j;
        const float* tab = (const float*)w[0];
        float* out = (float*)w[1];
        const int n = (int)w[2], count = (int)w[3], mode = (int)w[4], g = (int)w[5];
        if (g < 1 || g > 32 || (g & (g - 1)) != 0 || n < 0 || count < 1) return 1;
        for (int t = 0; t < n; ++t) {
            float acc[4];
            bake_sums(env4, env_h, env_w, tab + 4 * (long long)t * count, count, mode, g, false,
                      acc);
            ibl_finish(acc, mode, count, t, out);
        }
    }
    return 0;
}
int f3d_ibl_bake_attrs(int* out) {
    out[0] = out[1] = out[2] = 0;   // no device function on the host
    return 0;
}
// test entry: the host's atan2f(a, b) and acosf(a) element by element, the
// twin's transcendental calls, for the plain versions
void f3d_test_libm(const float* a, const float* b, int n, float* at, float* ac) {
    for (int i = 0; i < n; ++i) {
        at[i] = atan2f(a[i], b[i]);
        ac[i] = acosf(a[i]);
    }
}
// test entry: the float32 sums of texels 0 .. n - 1 of a stage, out (3, n,
// 4): the serial loop's (the parent design's, a texel's samples in order),
// bake_sums' for g lanes and bake_sums' in reverse lane order
void f3d_test_bake_sums(const float* env4, int env_h, int env_w, const float* tab, int count,
                        int mode, int g, int n, float* out) {
    for (int t = 0; t < n; ++t) {
        const float* rec = tab + 4 * (long long)t * count;
        float* scan = out + 4 * t;
        for (int c = 0; c < 4; ++c) scan[c] = 0.0f;
        for (int k = 0; k < count; ++k) {
            float x[4];
            ibl_term(env4, env_h, env_w, rec + 4 * k, mode, x);
            ibl_add(scan, x, mode);
        }
        bake_sums(env4, env_h, env_w, rec, count, mode, g, false, out + 4 * (n + t));
        bake_sums(env4, env_h, env_w, rec, count, mode, g, true, out + 4 * (2 * n + t));
    }
}
// E8 one voxel or pixel at a time; the Jacobi sweeps brick by brick, each
// brick's columns loaded, then each level published by every column before
// any column forms the next (smoke.cu:jacobi_kernel's barriers)
int f3d_smoke_advect_velocity(const float* vel, const float* temp, float* va, int nx, int ny,
                              int nz, float dt, float dtb, float amb, float w0, float w1,
                              float w2, float kdamp, int forms, void*) {
    const long long n = (long long)nx * ny * nz;
    const SmokeForced f{vel, temp, n, dtb, amb, kdamp, {w0, w1, w2}};
    for (long long i = 0; i < n; ++i) smoke_advect_velocity_voxel(f, va, nx, ny, nz, dt, forms, i);
    return 0;
}
int f3d_smoke_divergence(const float* va, float* div, float* p1, int nx, int ny, int nz,
                         float sixth, void*) {
    for (long long i = 0; i < (long long)nx * ny * nz; ++i)
        smoke_divergence_voxel(va, div, p1, nx, ny, nz, sixth, i);
    return 0;
}
int f3d_smoke_jacobi(const float* p, const float* div, float* p_out, int nx, int ny, int nz,
                     float sixth, int levels, void*) {
    if (levels < 1 || levels > F3D_JAC_LEVELS) return 1;
    const int threads = F3D_JAC_THREADS;
    std::vector<float> sm(2 * F3D_JAC_PLANES), cp(F3D_JAC_SZ * threads);
    for (long long b = 0; b < jac_bricks(nx, ny, nz); ++b) {
        const JacBrick k = jac_brick(nx, ny, nz, b);
        for (int t = 0; t < threads; ++t)
            jac_load(k, t, p, div, &cp[t * F3D_JAC_SZ], sm.data() + F3D_JAC_PLANES);
        for (int l = 0; l < levels; ++l) {
            for (int t = 0; t < threads; ++t) jac_publish(&cp[t * F3D_JAC_SZ], sm.data(), t);
            for (int t = 0; t < threads; ++t)
                jac_level(jac_column(k, t), &cp[t * F3D_JAC_SZ], sm.data(),
                          sm.data() + F3D_JAC_PLANES, sixth);
        }
        for (int t = 0; t < threads; ++t) jac_store(k, t, &cp[t * F3D_JAC_SZ], p_out);
    }
    return 0;
}
int f3d_jacobi_attrs(int* out) {
    out[0] = out[1] = out[2] = 0;   // no device function on the host
    out[3] = (int)(2 * sizeof(float) * F3D_JAC_PLANES);
    out[4] = F3D_JAC_LEVELS;
    out[5] = F3D_JAC_SX;
    out[6] = F3D_JAC_SY;
    out[7] = F3D_JAC_SZ;
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
int f3d_smoke_march_check(const float* dens, const float* emis, const float* soot,
                          long long n, int* bad, void*) {
    for (long long i = 0; i < n; ++i)
        if (!smoke_skip_voxel_ok(dens[i], emis[i], soot[i])) *bad = 1;
    return 0;
}
int f3d_smoke_march(const SmokeMarchArgs* a, const float* dens, const float* emis,
                    const float* soot, const float* sun_off, const int* bad, unsigned char* rgba,
                    void*) {
    for (long long i = 0; i < (long long)a->width * a->height; ++i)
        smoke_march_pixel(*a, dens, emis, soot, sun_off, bad && *bad == 0, rgba, i);
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
// C1: a tile at a time, as the block runs it: the tables (a helper a
// symbol), the ring's first fill, then the general chain, or each iteration
// k of the staged loop with its three parts one after the other: the ring
// filled for chunk k + 1, chunk k - 1 drained (the helpers' scan a serial
// prefix), and the chain's chunk k. `chain_first` runs the chain's chunk
// first: the block's barrier allows either order, so both must decode alike.
// The reconstruction in raster order (each value needs only its left, up
// and up-left neighbours, which the kernel's wavefront also has computed).
static void rans_tile_host(const uint8_t* row, uint32_t len, uint32_t cap, const uint32_t* f,
                           const uint32_t* ex, uint32_t ecap, int32_t* dt, bool chain_first) {
    std::vector<uint2> tab(F3DZ_PROB_SCALE);
    std::vector<uint8_t> sym(F3DZ_PROB_SCALE);
    std::vector<uint2> ring(F3DZ_RING_WORDS);
    std::vector<uint32_t> syms(2 * F3DZ_CHUNK / 4);
    const unsigned char* tabb = reinterpret_cast<const unsigned char*>(tab.data());
    uint32_t cum = 0;
    for (uint32_t s = 0; s < 256; ++s) {
        rans_fill_fast(s, f[s], cum, tab.data(), sym.data());
        cum += f[s];
    }
    uint32_t fill = rans_fill_end(4u);
    for (uint32_t w = 0; w < fill; ++w)
        ring[w & (F3DZ_RING_WORDS - 1u)] = rans_ring_entry(row, len, cap, w);
    if (ring[0].x < F3DZ_RANS_LO) {
        rans_chain(tab.data(), sym.data(), row, len, cap, ex, (int)ecap, F3DZ_TILE_PX, dt);
        return;
    }
    RansFast c = rans_fast_start(ring.data());
    uint32_t pos[2] = {4u, 0u}, carry = 0;
    const uint32_t chunks = F3DZ_TILE_PX / F3DZ_CHUNK, words = F3DZ_CHUNK / 4u;
    for (uint32_t k = 0; k <= chunks; ++k) {
        const bool run = k < chunks;
        if (run && chain_first) {
            rans_fast_chunk(tabb, sym.data(), ring.data(), c, syms.data() + (k & 1u) * words,
                            words);
            pos[(k + 1u) & 1u] = c.pb >> 3;
        }
        if (run) {
            const uint32_t end = rans_fill_end(pos[k & 1u]);
            for (uint32_t w = fill; w < end; ++w)
                ring[w & (F3DZ_RING_WORDS - 1u)] = rans_ring_entry(row, len, cap, w);
            fill = end > fill ? end : fill;
        }
        if (k > 0)
            for (uint32_t g = 0; g < words; ++g) {
                const uint32_t v = syms[((k - 1u) & 1u) * words + g];
                rans_drain_word(v, carry, ex, ecap, dt + (size_t)(k - 1u) * F3DZ_CHUNK + 4u * g);
                carry += rans_escapes(v);
            }
        if (run && !chain_first) {
            rans_fast_chunk(tabb, sym.data(), ring.data(), c, syms.data() + (k & 1u) * words,
                            words);
            pos[(k + 1u) & 1u] = c.pb >> 3;
        }
    }
}
static void rans_decode_host(const uint8_t* stream, const uint32_t* lens, int cap,
                             const uint32_t* freq, const uint32_t* extras, int ecap, int n_tiles,
                             int32_t* d, bool chain_first) {
    for (int t = 0; t < n_tiles; ++t)
        rans_tile_host(stream + (size_t)t * cap, lens[t], (uint32_t)cap, freq + (size_t)t * 256,
                       extras + (size_t)t * ecap, (uint32_t)ecap, d + (size_t)t * F3DZ_TILE_PX,
                       chain_first);
}
int f3d_rans_decode(const uint8_t* stream, const uint32_t* lens, int cap, const uint32_t* freq,
                    const uint32_t* extras, int ecap, int n_tiles, int32_t* d, void*) {
    rans_decode_host(stream, lens, cap, freq, extras, ecap, n_tiles, d, false);
    return 0;
}
int f3d_rans_attrs(int* out) {
    out[0] = out[1] = out[2] = out[3] = 0;   // no device function on the host
    return 0;
}
int f3d_med_attrs(int* out) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return 0;
}
// test entry: C1 entropy with each iteration's chain chunk run first
void f3d_test_rans_chain_first(const uint8_t* stream, const uint32_t* lens, int cap,
                               const uint32_t* freq, const uint32_t* extras, int ecap,
                               int n_tiles, int32_t* d) {
    rans_decode_host(stream, lens, cap, freq, extras, ecap, n_tiles, d, true);
}
// C1 reconstruction as codec.cu:med_kernel runs a tile: its eight warps as
// state machines, interleaved by `order` % 3 (0: a step of each runnable
// warp in turn; 1: the lowest runnable warp first, so each runs as far as
// it can; 2: the highest first, so each warp takes a handoff as soon as it
// is published), a warp blocked at a handoff its upper neighbour has not
// published; a step's lanes in order, each with the shuffle's value from
// the step before; a chunk's copies landing only at the wait that covers
// them (order < 3) or as soon as they are issued (order >= 3), the two
// ends of what cp.async allows; the rings and the edge rows filled with a
// poison first
extern "C++" {
struct MedTwinWarp {
    int c = 0, s = -1;                      // the period and its step (-1: its set-up next)
    int32_t q[32] = {}, upleft[32] = {};
    int32_t out[F3DZ_MED_HAND] = {}, held = 0;   // lane 31's q held for its next handoff
    int32_t ev[F3DZ_MED_HAND] = {};              // the group's edge values from above
    std::vector<std::vector<int>> groups;   // committed copy groups not yet landed: chunks
    std::vector<int> open;                  // the copies issued since the last commit
};

static void med_tile_twin(const int32_t* dt, float* ot, int width, double step, int order) {
    const bool early = order >= 3;
    order %= 3;
    const int32_t poison = 0x5A5A5A5A;
    std::vector<int32_t> ring(F3DZ_MED_WARPS * F3DZ_MED_RING_WORDS, poison);
    std::vector<int32_t> edge((F3DZ_MED_WARPS - 1) * F3DZ_TILE, poison);
    std::vector<uint32_t> published(F3DZ_MED_WARPS, 0u);   // handoffs a warp has released
    MedTwinWarp warps[F3DZ_MED_WARPS];
    auto land = [&](int w, int chunk) {    // cp.async of the warp's pieces of `chunk`
        for (int lane = 0; lane < 32; ++lane)
            for (int i = 0; i < 8; ++i) {
                int row, col;
                med_piece(lane, i, row, col);
                for (int j = 0; j < 4; ++j)
                    ring[w * F3DZ_MED_RING_WORDS + med_slot(chunk, row, col) + j] =
                        dt[(32 * w + row) * F3DZ_TILE + chunk * F3DZ_MED_CHUNK + col + j];
            }
    };
    auto commit_wait = [&](MedTwinWarp& W, int w) {   // commit, then land all but the newest
        W.groups.push_back(W.open);
        W.open.clear();
        while (W.groups.size() > 1) {
            for (int chunk : W.groups.front()) land(w, chunk);
            W.groups.erase(W.groups.begin());
        }
    };
    auto drain = [&](int w, int chunk) {
        for (int lane = 0; lane < 32; ++lane)
            for (int i = 0; i < 8; ++i) {
                int row, col;
                med_piece(lane, i, row, col);
                for (int j = 0; j < 4; ++j)
                    ot[(size_t)(32 * w + row) * width + chunk * F3DZ_MED_CHUNK + col + j] =
                        f3dz_height(ring[w * F3DZ_MED_RING_WORDS + med_slot(chunk, row, col) + j],
                                    step);
            }
    };
    // one unit of warp w's work: a period's set-up or a step; false if it is
    // done or blocked at a handoff
    auto advance = [&](int w) {
        MedTwinWarp& W = warps[w];
        if (W.c > F3DZ_MED_CHUNKS) return false;
        if (W.s < 0) {
            auto fill = [&](int chunk) {
                if (early) land(w, chunk);
                else W.open.push_back(chunk);
            };
            if (W.c == 0) {
                fill(0);
                W.groups.push_back(W.open);
                W.open.clear();
                fill(1);
            }
            if (W.c >= 2) drain(w, W.c - 2);
            if (W.c >= 1 && W.c + 1 < F3DZ_MED_CHUNKS) fill(W.c + 1);
            commit_wait(W, w);
            W.s = 0;
            return true;
        }
        const int k = F3DZ_MED_CHUNK * W.c + W.s;
        if (med_waits(w, k) && published[w - 1] < (uint32_t)(k / F3DZ_MED_HAND + 1)) return false;
        if (W.s % F3DZ_MED_HAND == 0)   // the group's edge values, read once its wait passed
            for (int i = 0; i < F3DZ_MED_HAND; ++i)
                W.ev[i] = w > 0 ? edge[(w - 1) * F3DZ_TILE + ((k + i) & (F3DZ_TILE - 1))] : 0;
        const int32_t e = W.ev[W.s % F3DZ_MED_HAND];
        int32_t prev[32];
        memcpy(prev, W.q, sizeof(prev));
        for (int lane = 0; lane < 32; ++lane) {
            const int x = k - lane;
            if (x < 0 || x >= F3DZ_TILE) continue;
            int32_t* slot = &ring[w * F3DZ_MED_RING_WORDS
                                  + med_slot(x / F3DZ_MED_CHUNK, lane, x % F3DZ_MED_CHUNK)];
            const int32_t from = lane ? prev[lane - 1] : W.q[0];
            if (W.c == 0 || W.c == F3DZ_MED_CHUNKS)   // the edge periods: med_pred whole
                med_lane_step<false>(W.q[lane], W.upleft[lane], from, e, slot, lane, x,
                                     32 * w + lane);
            else
                med_lane_step<true>(W.q[lane], W.upleft[lane], from, e, slot, lane, x,
                                    32 * w + lane);
        }
        // lane 31's q held as the kernel holds it, stored when a handoff ends
        const int j = W.s % F3DZ_MED_HAND, x31 = k - 31;
        if (j == 0) W.out[0] = W.held;
        if (j + 1 < F3DZ_MED_HAND) W.out[j + 1] = W.q[31];
        else W.held = W.q[31];
        if (j == F3DZ_MED_HAND - 2 && w < F3DZ_MED_WARPS - 1 && x31 >= 0 && x31 < F3DZ_TILE) {
            for (int i = 0; i < F3DZ_MED_HAND; ++i)
                edge[w * F3DZ_TILE + x31 - (F3DZ_MED_HAND - 1) + i] = W.out[i];
            published[w] = (uint32_t)(x31 / F3DZ_MED_HAND + 1);
        }
        if (++W.s == F3DZ_MED_CHUNK) {
            W.s = -1;
            if (++W.c > F3DZ_MED_CHUNKS) drain(w, F3DZ_MED_CHUNKS - 1);
        }
        return true;
    };
    for (bool moved = true; moved;) {
        moved = false;
        if (order == 0) {
            for (int w = 0; w < F3DZ_MED_WARPS; ++w) moved |= advance(w);
        } else {
            for (int i = 0; i < F3DZ_MED_WARPS && !moved; ++i)
                moved = advance(order == 1 ? i : F3DZ_MED_WARPS - 1 - i);
        }
    }
}
}
int f3d_med_reconstruct(const int32_t* d, int n_tiles, int ntx, int width, double step,
                        float* out, void*) {
    for (int t = 0; t < n_tiles; ++t)
        med_tile_twin(d + (size_t)t * F3DZ_TILE_PX,
                      out + (size_t)(t / ntx) * F3DZ_TILE * width + (t % ntx) * F3DZ_TILE, width,
                      step, 0);
    return 0;
}
// test entry: C1 reconstruction's twin with the warps interleaved, and the
// copies landing, by `order`
void f3d_test_med_order(const int32_t* d, int n_tiles, int ntx, int width, double step,
                        float* out, int order) {
    for (int t = 0; t < n_tiles; ++t)
        med_tile_twin(d + (size_t)t * F3DZ_TILE_PX,
                      out + (size_t)(t / ntx) * F3DZ_TILE * width + (t % ntx) * F3DZ_TILE, width,
                      step, order);
}
// test entry: the parent design's order, one tile's rows serially (the
// serial twin of the recurrence)
void f3d_test_med_serial(const int32_t* d, int n_tiles, int ntx, int width, double step,
                         float* out) {
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
}
// test entry: the kernel's ring column, stepped from med_ring_col through
// a period, against med_slot of the lane's column, and its handoffs (lane
// 31's column ending one at step j of a group) against the handoffs'
// ends; the count of (c, s, lane) where they differ
int f3d_test_med_period_slots() {
    int bad = 0;
    for (int c = 0; c <= F3DZ_MED_CHUNKS; ++c)
        for (int lane = 0; lane < 32; ++lane) {
            int col = med_ring_col(c, lane);
            for (int s = 0; s < F3DZ_MED_CHUNK; ++s) {
                const int x = F3DZ_MED_CHUNK * c + s - lane, x31 = x + lane - 31;
                if (x >= 0 && x < F3DZ_TILE)
                    bad += lane * F3DZ_MED_RING_COLS + col
                           != med_slot(x / F3DZ_MED_CHUNK, lane, x % F3DZ_MED_CHUNK);
                if (x31 >= 0 && x31 < F3DZ_TILE)
                    bad += (s % F3DZ_MED_HAND == (F3DZ_MED_HAND + 30) % F3DZ_MED_HAND)
                           != (x31 % F3DZ_MED_HAND == F3DZ_MED_HAND - 1);
                col = med_next_col(col);
            }
        }
    return bad;
}
// test entry: R1 step as one serial loop over the pixels, then each
// metric tile's mean in the fixed order
void f3d_test_step_serial(const SceneArgs* s, const TerrainArgs* a, float* accum,
                          unsigned int sample_idx, const TerrainOut* o, float* lum, float* tiles) {
    for (int i = 0; i < a->width * a->height; ++i) lum[i] = step_pixel(*s, *a, accum, sample_idx, *o, i);
    const int tw = (a->width + F3D_TILE - 1) / F3D_TILE, th = (a->height + F3D_TILE - 1) / F3D_TILE;
    for (int t = 0; t < tw * th; ++t) {
        const int ty = t / tw, tx = t % tw;
        tiles[t] = tile_mean_serial(lum + (ty * a->width + tx) * F3D_TILE, a->width,
                                    std::min(F3D_TILE, a->height - ty * F3D_TILE),
                                    std::min(F3D_TILE, a->width - tx * F3D_TILE));
    }
}
// test entry: P3's cull of n marches (sdf_cull_span) at threshold hit_eps:
// march[i], tmax[i] in and out
void f3d_test_sdf_span(const SdfArgs* s, const float* o, const float* d, int n, float hit_eps,
                       float tmin, unsigned char* march, float* tmax) {
    for (int i = 0; i < n; ++i)
        march[i] = sdf_cull_span(*s, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
                                 d[3 * i + 2], hit_eps, tmin, tmax[i]);
}
// test entry: the mesh walk of each ray that hits, again with tmax `ulps`
// float32 steps above its hit: how many of those walks lose the hit
int f3d_test_mesh_cut(const MeshArgs* m, const float* o, const float* d, int n, int ulps,
                      int* hits) {
    int lost = 0;
    *hits = 0;
    for (int i = 0; i < n; ++i) {
        const float* p = o + 3 * i;
        const float* q = d + 3 * i;
        MeshHit a = trace_mesh_ray(*m, p[0], p[1], p[2], q[0], q[1], q[2], 1e-3f, 1e6f);
        if (a.prim < 0) continue;
        ++*hits;
        float tmax = a.t;
        for (int k = 0; k < ulps; ++k) tmax = nextafterf(tmax, HUGE_VALF);
        MeshHit b = trace_mesh_ray(*m, p[0], p[1], p[2], q[0], q[1], q[2], 1e-3f, tmax);
        lost += !(b.prim == a.prim && b.t == a.t);
    }
    return lost;
}
// test entry: K9's any-hit walk stopping below `stop` on rays (n, 3): out
// (4, n), its prim (as a float), t, u and v
void f3d_test_mesh_any(const MeshArgs* m, const float* o, const float* d, int n, float tmin,
                       float tmax, float stop, float* out) {
    for (int i = 0; i < n; ++i) {
        const float* p = o + 3 * i;
        const float* q = d + 3 * i;
        MeshHit h = trace_mesh_ray<true>(*m, p[0], p[1], p[2], q[0], q[1], q[2], tmin, tmax, stop);
        out[i] = (float)h.prim;
        out[n + i] = h.t;
        out[2 * n + i] = h.u;
        out[3 * n + i] = h.v;
    }
}
// The parent's per-voxel and per-pixel bodies of E8 step and E3 (a sweep a
// launch, the forces stored, atrous_pixel's 25 taps read from memory), the
// references of the fused stages, the Jacobi bricks and E3's lattice tiles
static float parent_trilinear(const float* g, int nx, int ny, int nz, float px, float py,
                              float pz, int form) {
    const float x = fminf(fmaxf(px, 0.0f), (float)((double)nx - 1.000001));
    const float y = fminf(fmaxf(py, 0.0f), (float)((double)ny - 1.000001));
    const float z = fminf(fmaxf(pz, 0.0f), (float)((double)nz - 1.000001));
    const int x0 = (int)floorf(x), y0 = (int)floorf(y), z0 = (int)floorf(z);
    const float fx = x - (float)x0, fy = y - (float)y0, fz = z - (float)z0;
    const int x1 = x0 + 1 < nx ? x0 + 1 : nx - 1;
    const int y1 = y0 + 1 < ny ? y0 + 1 : ny - 1;
    const int z1 = z0 + 1 < nz ? z0 + 1 : nz - 1;
    const long long r00 = ((long long)z0 * ny + y0) * nx, r01 = ((long long)z0 * ny + y1) * nx;
    const long long r10 = ((long long)z1 * ny + y0) * nx, r11 = ((long long)z1 * ny + y1) * nx;
    const float c00 = smoke_lerp(g[r00 + x0], g[r00 + x1], fx, form);
    const float c01 = smoke_lerp(g[r01 + x0], g[r01 + x1], fx, form);
    const float c10 = smoke_lerp(g[r10 + x0], g[r10 + x1], fx, form);
    const float c11 = smoke_lerp(g[r11 + x0], g[r11 + x1], fx, form);
    return smoke_lerp(smoke_lerp(c00, c01, fy, form), smoke_lerp(c10, c11, fy, form), fz, form);
}
static void parent_neighbours(const float* p, int nx, int ny, int nz, long long i, float nb[6]) {
    const int x = (int)(i % nx), y = (int)((i / nx) % ny), z = (int)(i / ((long long)nx * ny));
    const long long row = ((long long)z * ny + y) * nx, plane = (long long)nx * ny;
    nb[0] = p[row + (x > 0 ? x - 1 : 0)];
    nb[1] = p[row + (x < nx - 1 ? x + 1 : nx - 1)];
    nb[2] = p[row + x + (y > 0 ? -nx : 0)];
    nb[3] = p[row + x + (y < ny - 1 ? nx : 0)];
    nb[4] = p[row + x + (z > 0 ? -plane : 0)];
    nb[5] = p[row + x + (z < nz - 1 ? plane : 0)];
}
// the forces stored (forces_kernel), then the self-advection of the stored
// field (advect_velocity_kernel); vf (3, n) is the caller's scratch
void f3d_test_parent_forces_advect(const float* vel, const float* temp, float* vf, float* va,
                                   int nx, int ny, int nz, float dt, float dtb, float amb,
                                   float w0, float w1, float w2, float kdamp, int forms) {
    const long long n = (long long)nx * ny * nz;
    for (long long i = 0; i < n; ++i) {
        vf[i] = (vel[i] + w0) * kdamp;
        vf[n + i] = (fmaf(temp[i] - amb, dtb, vel[n + i]) + w1) * kdamp;
        vf[2 * n + i] = (vel[2 * n + i] + w2) * kdamp;
    }
    for (long long i = 0; i < n; ++i) {
        const int x = (int)(i % nx), y = (int)((i / nx) % ny), z = (int)(i / ((long long)nx * ny));
        const float bx = fmaf(-dt, vf[i], (float)x);
        const float by = fmaf(-dt, vf[n + i], (float)y);
        const float bz = fmaf(-dt, vf[2 * n + i], (float)z);
        for (int c = 0; c < 3; ++c)
            va[c * n + i] = parent_trilinear(vf + c * n, nx, ny, nz, bx, by, bz,
                                             (forms >> (2 * c)) & 3);
    }
}
// divergence_kernel
void f3d_test_parent_divergence(const float* va, float* div, int nx, int ny, int nz) {
    const long long n = (long long)nx * ny * nz;
    for (long long i = 0; i < n; ++i) {
        float a[6], b[6], c[6];
        parent_neighbours(va, nx, ny, nz, i, a);
        parent_neighbours(va + n, nx, ny, nz, i, b);
        parent_neighbours(va + 2 * n, nx, ny, nz, i, c);
        div[i] = 0.5f * (((a[1] - a[0]) + (b[3] - b[2])) + (c[5] - c[4]));
    }
}
// one sweep of jacobi_kernel (p null: from zeros)
void f3d_test_parent_jacobi(const float* p, const float* div, float* out, int nx, int ny, int nz,
                            float sixth) {
    for (long long i = 0; i < (long long)nx * ny * nz; ++i) {
        float s = 0.0f;
        if (p) {
            float nb[6];
            parent_neighbours(p, nx, ny, nz, i, nb);
            s = ((((nb[0] + nb[1]) + nb[2]) + nb[3]) + nb[4]) + nb[5];
        }
        out[i] = (s - div[i]) * sixth;
    }
}
// one pass of atrous_kernel: each pixel's 25 taps from memory
static float parent_sq_dist3(const float* p, long long i, long long j) {
    float d0 = p[3 * j + 0] - p[3 * i + 0];
    float d1 = p[3 * j + 1] - p[3 * i + 1];
    float d2 = p[3 * j + 2] - p[3 * i + 2];
    return d0 * d0 + d1 * d1 + d2 * d2;
}
void f3d_test_parent_atrous(const AtrousArgs* ap, const float* in, float* out, int step) {
    const AtrousArgs& a = *ap;
    const float k1[5] = {1.0f / 16.0f, 1.0f / 4.0f, 3.0f / 8.0f, 1.0f / 4.0f, 1.0f / 16.0f};
    for (int y = 0; y < a.height; ++y)
        for (int x = 0; x < a.width; ++x) {
            const long long i = (long long)y * a.width + x;
            float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, wacc = 0.0f;
            for (int ky = -2; ky <= 2; ++ky) {
                const int sy = clampi(y - ky * step, 0, a.height - 1);
                for (int kx = -2; kx <= 2; ++kx) {
                    const long long j = (long long)sy * a.width + clampi(x - kx * step, 0, a.width - 1);
                    float w = k1[ky + 2] * k1[kx + 2];
                    w = w * expf(-parent_sq_dist3(in, i, j) / a.k_color);
                    if (a.albedo != nullptr) w = w * expf(-parent_sq_dist3(a.albedo, i, j) / a.k_albedo);
                    if (a.normal != nullptr) w = w * expf(-parent_sq_dist3(a.normal, i, j) / a.k_normal);
                    if (a.depth != nullptr) {
                        float dd = a.depth[j] - a.depth[i];
                        w = w * expf(-(dd * dd) / a.k_depth);
                    }
                    acc0 = acc0 + in[3 * j + 0] * w;
                    acc1 = acc1 + in[3 * j + 1] * w;
                    acc2 = acc2 + in[3 * j + 2] * w;
                    wacc = wacc + w;
                }
            }
            const float den = fmaxf(wacc, 1e-8f);
            out[3 * i + 0] = acc0 / den;
            out[3 * i + 1] = acc1 / den;
            out[3 * i + 2] = acc2 / den;
        }
}
// test entry: synthesize_polar's contraction for one column and row
float f3d_test_crossing(const float* M, const float* v, int K, int C, float Q, float* out) {
    return crossing(M, StridedRows{v, C}, C, K, Q, out);
}
}
"""


@pytest.fixture(scope="module")
def host_lib():
    """The host build of the kernel bodies, made once into build/host_kernels/
    (listed in .gitignore), keyed by a hash of the launchers and csrc's
    headers, and shared by every test module and worker that loads it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel bodies needs it")
    h = hashlib.sha256(HOST_LAUNCHERS.encode())
    for p in sorted(_kernels.CSRC.glob("*.cuh")):
        h.update(p.name.encode() + p.read_bytes())
    d = _kernels.BUILD_DIR.parent / "host_kernels"
    d.mkdir(parents=True, exist_ok=True)
    out = d / f"libhost_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        src = d / f"host_launchers.{os.getpid()}.cpp"
        tmp = d / f"libhost_kernels.{os.getpid()}.tmp"
        src.write_text(HOST_LAUNCHERS)
        try:
            subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                            "-I", str(_kernels.CSRC), "-o", str(tmp), str(src)],
                           check=True, capture_output=True, text=True, timeout=300)
            os.replace(tmp, out)   # atomic: a concurrent worker never loads a partial file
        finally:
            src.unlink(missing_ok=True)
            tmp.unlink(missing_ok=True)
    return _kernels.bind(ctypes.CDLL(str(out)))


@pytest.fixture
def host_twin(host_lib, monkeypatch):
    """The host build, with the kernel wrappers' launches going to it."""
    monkeypatch.setattr(_kernels, "lib", lambda: host_lib)
    monkeypatch.setattr(_kernels, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    return host_lib


def host_transcendentals(host_lib, monkeypatch):
    """torch.atan2 and torch.acos on float32 CPU tensors through the host
    build's atan2f and acosf, so that a plain version makes the twin's
    calls (the libm and PyTorch's may differ by an ulp)."""
    def both(a, b):
        a = a.contiguous()
        b = b.expand_as(a).contiguous()
        at, ac = torch.empty_like(a), torch.empty_like(a)
        host_lib.f3d_test_libm(_kernels.ptr(a), _kernels.ptr(b), a.numel(), _kernels.ptr(at),
                               _kernels.ptr(ac))
        return at, ac

    monkeypatch.setattr(torch, "atan2", lambda a, b: both(a, b)[0])
    monkeypatch.setattr(torch, "acos", lambda a: both(a, a)[1])


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


def make_ctx(device, n=65, width=96, height=48, **kw):
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (6.0 * np.sin(x * 0.15) * np.cos(y * 0.12)).astype(np.float32)
    em = kw.pop("env", None)
    desc = tr.TerrainRefDesc(heights=dem, cam_origin=(32.0, 22.0, 90.0),
                             cam_look_at=(32.0, 0.0, 32.0), fov_y_deg=42.0, width=width,
                             height=height, env_map=em, **kw)
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


def random_reservoirs(n, device, seed):
    """Reservoirs over n pixels with every kind of candidate K7 weighs:
    directional and other lights, target pdfs of 0, below 1e-6 and
    negative, zero directions, large m."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((3, n)).astype(np.float32)
    d[:, rng.random(n) < 0.05] = 0.0
    tp = rng.uniform(-0.1, 2.0, n).astype(np.float32)
    tp[rng.random(n) < 0.1] = 0.0
    tp[rng.random(n) < 0.05] = np.float32(3e-7)
    f = {"dir_x": d[0], "dir_y": d[1], "dir_z": d[2],
         "intensity": rng.uniform(0, 5, n).astype(np.float32),
         "light_type": (rng.random(n) < 0.85).astype(np.int32),
         "light_index": rng.integers(0, 7, n).astype(np.int32),
         "w_sum": rng.exponential(1.0, n).astype(np.float32),
         "m": rng.integers(0, 600, n).astype(np.int32),
         "weight": rng.exponential(1.0, n).astype(np.float32), "target_pdf": tp}
    return rst.Reservoirs(**{k: torch.as_tensor(v, device=device) for k, v in f.items()})


def random_normals(n, device, seed):
    g = np.random.default_rng(seed).standard_normal((3, n)).astype(np.float32)
    g /= np.linalg.norm(g, axis=0, keepdims=True)
    return tuple(torch.as_tensor(c, device=device) for c in g)


# K7's window cases: (width, height, radius, k_neighbors, row0, rows); rows
# None is the whole frame
K7_CASES = {
    "smaller_than_a_tile": (5, 3, 3, 8, 0, None),
    "ragged": (33, 17, 3, 8, 0, None),
    "radius_0": (33, 17, 0, 8, 0, None),
    "radius_1": (33, 17, 1, 8, 0, None),
    "widest_shared": (33, 17, rst.SHARED_RADIUS, 8, 0, None),
    "past_the_shared": (33, 17, rst.SHARED_RADIUS + 1, 8, 0, None),
    "k_0": (33, 17, 3, 0, 0, None),
    "band_at_the_top": (33, 17, 3, 8, 0, 5),
    "band_at_the_bottom": (33, 17, 3, 8, 12, 5),
    "band_thinner_than_radius": (33, 17, 3, 8, 7, 2),
    "band_past_the_shared": (33, 17, rst.SHARED_RADIUS + 1, 8, 6, 9),
    "clamped_at_all_edges": (7, 6, 5, 8, 0, None),
}


@pytest.mark.parametrize("case", list(K7_CASES))
def test_spatial_reuse_window(kernels, case):
    """K7 (a 16x16 tile a block; the tile's window staged, or each tap from
    device memory past SHARED_RADIUS) bit for bit to spatial_reuse_plain on
    all ten fields, through the instantiation kernel_instance names."""
    W, H, radius, k, row0, rows = K7_CASES[case]
    res = random_reservoirs(W * H, kernels, seed=len(case))
    gb = random_normals(W * H, kernels, seed=7)
    band = rows is not None
    counter = rst.spatial_reuse_band if band else rst.spatial_reuse
    before = dict(counter.instances)
    got = rst._spatial_reuse_kernel(res, *gb, W, H, 3, 0x9E3779B9, k, radius, row0,
                                    rows if band else None,
                                    counter=counter if band else None)
    ref = rst.spatial_reuse_plain(res, *gb, W, H, 3, 0x9E3779B9, k, radius, row0,
                                  rows if band else None)
    for name, a, b in zip(rst.Reservoirs.__dataclass_fields__, ref.fields(), got.fields()):
        assert torch.equal(a, b), name
    inst = rst.kernel_instance(radius)
    assert inst == ("shared window" if radius <= rst.SHARED_RADIUS else "global window")
    assert counter.instances[inst] == before.get(inst, 0) + 1
    if case != "k_0" and radius > 0:   # some taps chose a neighbour
        assert int((got.m != res.m[row0 * W:row0 * W + got.m.numel()]).sum()) > 0


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


def sweep_case(device, env=None, sun_elevation_deg=45.0, cam_origin=(32.0, 22.0, 90.0)):
    n = 65
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (6.0 * np.sin(x * 0.15) * np.cos(y * 0.12)).astype(np.float32)
    desc = tr.TerrainRefDesc(heights=dem, cam_origin=cam_origin,
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


def polar_reference(host_lib, args, rot, maps, scene, acc):
    """acc plus one frame of K3 as its row-by-row design ran it (the host
    build's f3d_test_polar_serial), on the CPU."""
    lib = host_lib
    lib.f3d_test_polar_serial.argtypes = [ctypes.POINTER(_kernels.PolarArgs)] + [ctypes.c_void_p] * 5
    lib.f3d_test_polar_serial.restype = None
    out = acc.cpu().clone()
    ins = [t.cpu().contiguous() for t in (rot[0], maps.e_sky, maps.z_sun, scene.corners)]
    lib.f3d_test_polar_serial(args, *(t.data_ptr() for t in ins), out.data_ptr())
    return out


def polar_columns(host_lib, args, rot, maps, scene):
    """(first valid profile row, edge replaces a slot) of each column."""
    lib = host_lib
    lib.f3d_test_polar_columns.argtypes = ([ctypes.POINTER(_kernels.PolarArgs)]
                                           + [ctypes.c_void_p] * 6)
    lib.f3d_test_polar_columns.restype = None
    k_first = np.zeros(args.A, np.int32)
    can = np.zeros(args.A, np.int32)
    ins = [t.cpu().contiguous() for t in (rot[0], maps.e_sky, maps.z_sun, scene.corners)]
    lib.f3d_test_polar_columns(args, *(t.data_ptr() for t in ins), k_first.ctypes.data,
                               can.ctypes.data)
    return k_first, can.astype(bool)


@pytest.mark.parametrize("case", ["edges", "off_grid_columns", "camera_over_the_grid",
                                  "device_scratch"])
@pytest.mark.parametrize("azimuths,frames", [(253, 1), (254, 1), (253, 2)],
                         ids=["odd_A", "even_A", "odd_A_two_frames"])
def test_polar_frame_columns(kernels, host_lib, monkeypatch, azimuths, frames, case):
    """K3 (POLAR_COLUMNS columns a CTA, as the build reports) over 253
    azimuth columns (the last CTA's second column idle), over 254, and over
    253 for two frames added into one accumulator, bit for bit to its
    row-by-row design, on columns whose edge sample replaces a slot, on
    columns with no valid sample (the camera shifted off the grid's side),
    on columns whose profile starts on the grid (the camera over it: no
    edge, the entry flags from the valid rows) and with the profiles in the
    device scratch. The env is constant, so both sides run only IEEE
    operations."""
    attrs = (ctypes.c_int * 5)()
    _kernels.check(_kernels.lib().f3d_polar_attrs(1029, 0, attrs), "f3d_polar_attrs")
    assert attrs[4] == ts.POLAR_COLUMNS == 2
    origin = (32.0, 22.0, 50.0) if case == "camera_over_the_grid" else (32.0, 22.0, 90.0)
    plan, scene, rot, _ = sweep_case(kernels, cam_origin=origin)
    plan = dataclasses.replace(plan, ps=dataclasses.replace(plan.ps, a_count=azimuths))
    if case == "off_grid_columns":
        real = ts.polar_args

        def shifted(*a):
            args = real(*a)
            args.cam_iu += 40.0
            return args
        monkeypatch.setattr(ts, "polar_args", shifted)
    if case == "device_scratch":
        monkeypatch.setattr(_kernels, "SMEM_LIMIT", 0)
        assert ts.polar_uses_scratch(plan.ps.k_count)
    acc0 = torch.rand((plan.ps.e_count, azimuths, 9), generator=torch.Generator().manual_seed(3))
    ref, got = acc0, acc0.to(kernels)
    for jit in ts.frame_jitters(5, 2)[2 - frames:]:
        maps = sw.sweep_lighting_plain(*rot, ts.frame_bins(plan, scene, jit))
        args = ts.polar_args(plan, scene, jit.xi, jit.ja, jit.je)
        k_first, can = polar_columns(host_lib, args, rot, maps, scene)
        if case == "off_grid_columns":
            assert (k_first == plan.ps.k_count).any() and (k_first < plan.ps.k_count).any()
        elif case == "camera_over_the_grid":
            assert (~can & (k_first < plan.ps.k_count)).sum() > 100
        else:
            assert can.any() and (k_first < plan.ps.k_count).all()
        ref = polar_reference(host_lib, args, rot, maps, scene, ref)
        before = ts.polar_frame.launches
        got = ts._polar_kernel(plan, scene, got, rot[0], maps, jit.xi, jit.ja, jit.je)
        assert ts.polar_frame.launches == before + 1
    assert torch.equal(got.cpu(), ref)


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


# K9's walk over the packed records (csrc/mesh.cuh) bit for bit against
# trace_mesh_plain (hit, t, prim, u, v) on meshes and rays chosen for the
# walk's edges: ties between duplicated triangles, walls on their boxes'
# faces, directions with zero components, origins inside boxes, cuts by tmin
# and tmax, a refitted tree, a binding max_iters; and its any-hit form.

def k9_box_grid(n_side=5, seed=3):
    """An n_side^2 grid of boxes of random footprint and height (walls on
    their leaf boxes' faces)."""
    rng = np.random.default_rng(seed)
    verts, tris = [], []
    for a in range(n_side):
        for b in range(n_side):
            fx, fz = rng.uniform(2.0, 6.0, 2)
            h = rng.uniform(3.0, 12.0)
            tris.append(_BOX_F + 8 * len(verts))
            verts.append(_BOX_V * np.array([fx, h, fz], np.float32)
                         + np.array([8.0 * a, 0.0, 8.0 * b], np.float32))
    return np.concatenate(verts).astype(np.float32), np.concatenate(tris).astype(np.uint32)


def k9_soup(n=300, seed=11):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 40.0, (n, 1, 3))
    v = (c + rng.normal(0.0, 2.0, (n, 3, 3))).reshape(-1, 3).astype(np.float32)
    return v, np.arange(3 * n, dtype=np.uint32).reshape(n, 3)


def k9_ties():
    """The box grid with every triangle twice: equal hits, the first in BVH
    order wins."""
    v, i = k9_box_grid(3)
    return v, np.concatenate([i, i[::-1]]).astype(np.uint32)


def k9_rays(v, n, seed, kind="mixed"):
    """(ro, rd) as (n, 3) float32: "mixed" half aimed at the mesh from
    around it, half random from inside its box; "axis" directions with one
    or two zero components; "inside" origins inside the mesh's box near
    its vertices."""
    rng = np.random.default_rng(seed)
    lo, hi = v.min(0), v.max(0)
    pad = 0.2 * (hi - lo) + 1.0
    if kind == "inside":
        ro = v[rng.integers(0, len(v), n)] + rng.uniform(-0.5, 0.5, (n, 3))
        rd = rng.normal(size=(n, 3))
    else:
        ro = rng.uniform(lo - pad, hi + pad, (n, 3))
        target = v[rng.integers(0, len(v), n)] + rng.normal(0, 0.3, (n, 3))
        rd = np.where(np.arange(n)[:, None] < n // 2, target - ro, rng.normal(size=(n, 3)))
    if kind == "axis":
        keep = rng.integers(0, 3, (n, 1)) == np.arange(3)
        two = rng.random((n, 1)) < 0.5
        keep |= two & (rng.integers(0, 3, (n, 1)) == np.arange(3))
        rd = np.where(keep, rd, 0.0)
        ro[:, 1] = np.where(rng.random(n) < 0.3, v[0, 1], ro[:, 1])   # on a face's plane
    return ro.astype(np.float32), rd.astype(np.float32)


K9_CASES = {
    "quad_town": (lambda: QUAD_TOWN, "mixed", 1e-4, 1e30),
    "box_grid": (k9_box_grid, "mixed", 1e-4, 1e30),
    "soup": (k9_soup, "mixed", 1e-4, 1e30),
    "ties": (k9_ties, "mixed", 1e-4, 1e30),
    "zero_components": (k9_box_grid, "axis", 1e-4, 1e30),
    "inside_boxes": (k9_soup, "inside", 1e-4, 1e30),
    "tmin_tmax_cut": (k9_box_grid, "mixed", 5.0, 30.0),
    "refit": (k9_box_grid, "mixed", 1e-3, 1e6),
}


def k9_case(name, device):
    from forge3d_tpu_torch.ops import bvh

    make, kind, tmin, tmax = K9_CASES[name]
    v, i = make()
    b = bvh.build_sah_bvh(v, i)
    if name == "refit":
        v = v + np.random.default_rng(8).normal(0, 0.4, v.shape).astype(np.float32)
        b = bvh.refit_bvh(b, v, i)
    scene, n_nodes = bvh.mesh_scene(b, device="cpu")
    ro, rd = k9_rays(v, 3000, seed=len(name), kind=kind)
    ro = tuple(torch.as_tensor(ro[:, k].copy(), device=device) for k in range(3))
    rd = tuple(torch.as_tensor(rd[:, k].copy(), device=device) for k in range(3))
    return scene.to(device), n_nodes, ro, rd, tmin, tmax


def same_bits(a, b):
    """Equal tensors, floats compared by their bits."""
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("case", list(K9_CASES))
def test_mesh_walk_bit_for_bit(kernels, case):
    from forge3d_tpu_torch.ops import bvh

    scene, n, ro, rd, tmin, tmax = k9_case(case, kernels)
    hk = bvh._trace_mesh_kernel(scene, n, ro, rd, tmin, tmax)
    hp = bvh.trace_mesh_plain(scene, n, ro, rd, tmin, tmax)
    assert 0.02 < float(hp.hit.double().mean()) < 0.98
    for name, a, b in zip(hp._fields, hp, hk):
        assert same_bits(a, b), name


@pytest.mark.parametrize("max_iters", [1, 7, 40])
def test_mesh_walk_keeps_the_cap(kernels, max_iters):
    """A cap below 4 n_nodes + 64 binds, as JAX's does: the walk stops each
    ray where the plain walk stops it."""
    from forge3d_tpu_torch.ops import bvh

    scene, n, ro, rd, tmin, tmax = k9_case("box_grid", kernels)
    hk = bvh._trace_mesh_kernel(scene, n, ro, rd, tmin, tmax, max_iters=max_iters)
    hp = bvh.trace_mesh_plain(scene, n, ro, rd, tmin, tmax, max_iters=max_iters)
    full = bvh.trace_mesh_plain(scene, n, ro, rd, tmin, tmax)
    for name, a, b in zip(hp._fields, hp, hk):
        assert same_bits(a, b), name
    if max_iters < 40:
        assert not torch.equal(hp.hit, full.hit)     # the cap cut some walks short


@pytest.mark.parametrize("case", ["box_grid", "ties", "soup", "refit"])
def test_mesh_walk_any_hit(host_lib, monkeypatch, case):
    """kAny (the shadow rays of K6, P2 and P3): the walk stops at the first
    triangle accepted below `stop` and blocks (below `stop`) exactly the
    rays whose whole walk hits (below `stop`); a ray it does not block it
    walks to the end. On the card, the shadow rays of K6, P2 and P3 take it
    (test_frame_kernel_ragged_tiles, test_engine_kernels, test_hybrid_kernel)."""
    from forge3d_tpu_torch.ops import bvh

    scene, n, ro, rd, tmin, tmax = k9_case(case, "cpu")
    hp = bvh.trace_mesh_plain(scene, n, ro, rd, tmin, tmax)
    m = len(ro[0])
    o = torch.stack(ro, 1).contiguous()
    d = torch.stack(rd, 1).contiguous()
    monkeypatch.setattr(_kernels, "require_cuda", lambda name, *t: None)
    margs = scene.kernel_args()
    for stop in (float("inf"), float(hp.t[hp.hit].median())):
        out = torch.zeros((4, m), dtype=torch.float32)
        host_lib.f3d_test_mesh_any(ctypes.byref(margs), _kernels.ptr(o), _kernels.ptr(d), m,
                                   ctypes.c_float(tmin), ctypes.c_float(tmax),
                                   ctypes.c_float(stop), _kernels.ptr(out))
        blocked = (out[0] >= 0) & (out[1] < stop)
        assert torch.equal(blocked, hp.hit & (hp.t < stop)), stop
        rest = ~blocked
        assert torch.equal(out[0][rest].int(), hp.prim[rest])       # walked to the end
        assert same_bits(out[1][rest], hp.t[rest])
        if stop == float("inf"):
            assert bool((out[0][blocked] >= 0).all())


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


# K10's packed light table (ops/lightsample.py:pack_lights, csrc/lights.cuh):
# a record for each light type, and the sample from the table at L = 1, 6
# and 257 (alias columns past a byte's range), held bit for bit against the
# parent design's body (the ten arrays, built in the twin) and the plain
# version (on the host the disk and sphere lanes' sin/cos come from the
# host's libm, within the file's tolerance of PyTorch's).
LIGHT_SETS = {"L1": 1, "L6": 6, "L257": 257}


def light_set(count, device, seed=21):
    """`count` lights, their types in LIGHT_TYPES' order round the set,
    seeded positions, directions, colours, sizes and cones, with the alias
    table of their power."""
    from forge3d_tpu_torch.lighting import LIGHT_TYPES, Light, LightBuffer
    from forge3d_tpu_torch.ops import lightsample as ls

    rng = np.random.default_rng(seed)
    lights = [Light(type=LIGHT_TYPES[i % 6], position=tuple(rng.uniform(-20, 20, 3)),
                    direction=tuple(rng.normal(size=3) + [0.0, -2.0, 0.0]),
                    intensity=float(rng.uniform(0.5, 40.0)), color=tuple(rng.uniform(0.2, 1, 3)),
                    radius=float(rng.uniform(0.2, 3.0)), extent=tuple(rng.uniform(0.3, 4.0, 2)),
                    inner_cone_deg=float(rng.uniform(5, 30)), outer_cone_deg=float(rng.uniform(31, 80)))
              for i in range(count)]
    buf = LightBuffer.from_lights(lights, device)
    return buf, ls.alias_table_build(ls.light_power_weights(buf), device)


def light_lanes(count, device, seed=22):
    """Lanes that pick every column at the start of its interval and just
    below its end (u_pick at (c + 0) / L and (c + 1) / L less an ulp, and u
    at 0 and just below 1), with u1, u2 at 0, 0.5 and just below 1, then
    seeded lanes; the 9 input planes."""
    rng = np.random.default_rng(seed)
    below1 = np.nextafter(np.float32(1.0), np.float32(0.0))
    c = np.arange(count, dtype=np.float64)
    picks = np.concatenate([c / count, np.nextafter(((c + 1) / count).astype(np.float32),
                                                     np.float32(0.0)), [0.0, below1]])
    edges = np.array([0.0, 0.5, below1], np.float32)
    u1, u2, up = np.meshgrid(edges, edges, picks.astype(np.float32), indexing="ij")
    m = rng.random((3, 256), dtype=np.float32)
    u = np.stack([np.concatenate([up.ravel(), m[0]]), np.concatenate([u1.ravel(), m[1]]),
                  np.concatenate([u2.ravel(), m[2]])], 1).astype(np.float32)
    n = u.shape[0]
    p = rng.uniform([-30, -10, -30], [30, 10, 30], (n, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return [torch.as_tensor(np.ascontiguousarray(a[:, i]), device=device)
            for a in (p, nrm, u) for i in range(3)]


def parent_sample_light(lib, lights, table, lanes):
    """K10's parent design (f3d_test_parent_sample_light) on the host."""
    arrays = [t.contiguous() for t in (lights.type_id, lights.color, lights.direction,
                                       lights.position, lights.radius, lights.extent,
                                       lights.cones, table.prob, table.alias, table.pdf)]
    out = [torch.empty_like(lanes[0]) for _ in range(7)]
    LL = ctypes.c_longlong
    lib.f3d_test_parent_sample_light(
        (LL * 10)(*(a.data_ptr() for a in arrays)), ctypes.c_int(table.count),
        ctypes.c_float(table.u_hi), ctypes.c_int(lanes[0].numel()),
        (LL * 9)(*(c.data_ptr() for c in lanes)), (LL * 7)(*(o.data_ptr() for o in out)))
    return out


@pytest.mark.parametrize("light_type", range(6), ids=lambda i: f"type{i}")
def test_light_table_record(kernels, light_type):
    from forge3d_tpu_torch.ops import lightsample as ls

    lights, table = light_set(6, kernels)
    rec = ls.pack_lights(lights, table)
    assert rec.shape == (6, ls.LIGHT_WORDS) and rec.dtype == torch.float32
    assert rec.is_contiguous() and rec.data_ptr() % 16 == 0
    i = int(torch.nonzero(lights.type_id == light_type)[0])
    r = rec[i].cpu()
    bits = r.view(torch.int32)
    a = int(table.alias[i])
    f = lambda t: t.detach().cpu().reshape(-1)  # noqa: E731
    assert bits[1] == a and bits[7] == light_type
    want = [(r[0:1], f(table.prob[i])), (r[2:3], f(table.pdf[i])), (r[3:4], f(table.pdf[a])),
            (r[4:7], f(lights.position[i])), (r[8:11], f(lights.direction[i])),
            (r[11:12], f(lights.radius[i])), (r[12:15], f(lights.color[i])),
            (r[15:16], torch.zeros(1)), (r[16:18], f(lights.extent[i])),
            (r[18:20], f(lights.cones[i]))]
    for got, ref in want:
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("count", list(LIGHT_SETS.values()), ids=list(LIGHT_SETS))
def test_sample_light_from_table(kernels, count):
    from forge3d_tpu_torch.ops import lightsample as ls

    lights, table = light_set(count, kernels)
    lanes = light_lanes(count, kernels)
    idx, _ = ls.alias_sample(table, lanes[6])
    types = lights.type_id[idx.long()]
    assert set(types.tolist()) == set(range(min(count, 6)))     # every type picked
    got = ls._sample_light_kernel(lights, table, *lanes)
    ref = ls.sample_light_nee_plain(lights, table, *lanes)
    if kernels.type == "cpu":
        parent = parent_sample_light(_kernels.lib(), lights, table, lanes)
        for a, b in zip(parent, got):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        trig = (types == 4) | (types == 5)     # disk, sphere: the host's sinf/cosf
        for a, b in zip(ref, got):
            assert torch.equal(a[~trig], b[~trig])
            assert not bool(trig.any()) or close_frac(a[trig], b[trig]) == 1.0
    else:
        for a, b in zip(ref, got):
            assert torch.equal(a, b)


def test_light_table_formed_once(kernels):
    # K6's frames and sample_light_nee calls read the table packed when the
    # light set first met the kernels; another light set gets its own
    from forge3d_tpu_torch.ops import lightsample as ls

    ctx = mesh_lights_ctx(kernels, spp=1)
    H, W = ctx.height, ctx.width
    packs = ls.light_table.packs
    acc = torch.zeros(H, W, 4, device=kernels)
    wf = torch.zeros(H, W, 2, device=kernels)
    res = rst.Reservoirs.zeros(H * W, kernels)
    for frame in (0, 1):
        acc, wf, res = tr._frame_step_kernel(ctx, acc, wf, res, frame)
    lanes = light_lanes(6, kernels)
    ls._sample_light_kernel(*ctx.lights, *lanes)
    ls.sample_light_nee(*ctx.lights, *lanes)
    assert ls.light_table.packs == packs + 1
    args = ctx.light_args()
    assert args.table == ls.light_table(*ctx.lights).data_ptr() and args.count == 6
    other = light_set(6, kernels, seed=3)
    ls._sample_light_kernel(*other, *lanes)
    assert ls.light_table.packs == packs + 2


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


# K6's 16x16 tiles (a warp 8x4 pixels): a 37x23 frame, no multiple of the
# tile, terrain-only and hybrid, over a 65^2 and a 513^2 DEM; the whole
# frame against the plain version, and a band of rows 5-15 against the
# whole frame's rows bit for bit
@pytest.mark.parametrize("n", [65, 513], ids=["dem65", "dem513"])
@pytest.mark.parametrize("hybrid", [False, True], ids=["terrain", "hybrid"])
def test_frame_kernel_ragged_tiles(kernels, n, hybrid):
    H, W = 23, 37
    ctx = (mesh_lights_ctx if hybrid else make_ctx)(kernels, n=n, width=W, height=H, spp=2)
    acc = torch.zeros(H, W, 4, device=kernels)
    wf = torch.zeros(H, W, 2, device=kernels)
    res = rst.Reservoirs.zeros(H * W, kernels)
    before = (tr.frame_step.launches, tr.frame_step.mesh_launches, tr.frame_step.light_launches)
    for frame in (0, 1):
        pa, pw, pm = tr.frame_step_plain(ctx, acc, wf, res, frame)
        ka, kw_, km = tr._frame_step_kernel(ctx, acc, wf, res, frame)
        assert close_frac(pa, ka) >= FRAC and close_frac(pw, kw_) >= FRAC
        assert_reservoirs(pm, km)
        if kernels.type == "cuda":   # the card's math library is the plain version's
            assert torch.equal(pa, ka) and torch.equal(pw, kw_)
            assert all(torch.equal(f, g) for f, g in zip(pm.fields(), km.fields()))
        px = slice(5 * W, 16 * W)
        band = rst.Reservoirs(*(f[px] for f in res.fields()))
        ba, bw, bm = tr._frame_step_kernel(ctx, acc[5:16], wf[5:16], band, frame, 5,
                                           counter=tr.frame_step_band)
        assert torch.equal(ba, ka[5:16]) and torch.equal(bw, kw_[5:16])
        assert all(torch.equal(f, g[px]) for f, g in zip(bm.fields(), km.fields()))
        acc, wf, res = ka, kw_, km
    assert (tr.frame_step.launches, tr.frame_step.mesh_launches,
            tr.frame_step.light_launches) == (before[0] + 2, before[1] + 2 * hybrid,
                                              before[2] + 2 * hybrid)


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
        if kernels.type == "cuda":     # on the card every plane bit for bit
            assert same_bits(pp[k], pk[k]), k


@pytest.mark.parametrize("shape", [(1920, 1080), (37, 23), (8, 4), (16, 16)])
def test_mesh_tiles_cover_every_pixel_once(host_lib, shape):
    """P2's layout (common.cuh:tile_pixel): 16x16 blocks of 8x4 warps cover
    every pixel exactly once, and the threads past the image are the rest."""
    w, h = shape
    counts = np.zeros(w * h, np.int32)
    outside = host_lib.f3d_test_tile_cover(w, h, counts.ctypes.data_as(ctypes.c_void_p))
    assert (counts == 1).all()
    assert outside == 256 * (-(-w // 16)) * (-(-h // 16)) - w * h


def mesh_planes(host_lib, cam, mts, mat, sd, si, entry="skip"):
    """P2's planes from the twin: `entry` "skip" or "walk" (row order, the
    shadow walk skipped where it cannot change the pixel or walked on every
    hit), or "kernel" (engines.cu's tile order); (planes, walks or None)."""
    from forge3d_tpu_torch.pt import megakernel as mk

    planes = mk._empty_planes(cam, "cpu")
    args = (cam.kernel_args(), mts.kernel_args(), mat.kernel_args(sd, si), mk.aov_args(planes))
    if entry == "kernel":
        assert host_lib.f3d_render_mesh(*args, ctypes.c_void_p(0)) == 0
        return planes, None
    return planes, host_lib.f3d_test_mesh_pixels(*map(ctypes.byref, args), int(entry == "skip"))


@pytest.mark.parametrize("sun", ["3", "0", "-0", "inf", "nan", "below"])
def test_mesh_shadow_skip_keeps_the_bits(host_twin, sun):
    """P2's shadow walk skipped exactly where sun_intensity * n.l is zero:
    every plane equal bit for bit to the walk on every hit (NaN where NaN),
    in the kernel's tile order too; no walk at intensity +-0 or with the sun
    below every face, every hit walked at inf and NaN."""
    from forge3d_tpu_torch.pt import megakernel as mk
    from forge3d_tpu_torch.pt import mesh_render as mr

    host_lib = host_twin
    mts = mr.MeshTracerScene(*QUAD_TOWN, "cpu")
    cam = mk.EngineCamera.make(64, 48, {"origin": (24, 30, 70), "look_at": (24, 8, 24)},
                               (0.0, 1.5, 4.0), (0.0, 0.5, 0.0))
    mat = mr._material_from_dict({"metallic": 0.3, "emissive": (0.1, 0, 0)})
    # a sun that lights the tilted quad and not the upright one (z = 20), or
    # one below both
    sd = (0.0, 0.98, -0.196) if sun != "below" else (0.0, -0.6, -0.8)
    sd = tuple(float(c) for c in np.float32(sd) / np.linalg.norm(np.float32(sd)))
    si = 3.0 if sun in ("3", "below") else float(sun)
    walked, n_walk = mesh_planes(host_lib, cam, mts, mat, sd, si, "walk")
    skipped, n_skip = mesh_planes(host_lib, cam, mts, mat, sd, si, "skip")
    tiled, _ = mesh_planes(host_lib, cam, mts, mat, sd, si, "kernel")
    for k in walked:
        assert same_bits(walked[k], skipped[k]), k
        assert same_bits(walked[k], tiled[k]), k
    hits = int(walked["vis"].sum())
    assert n_walk == hits and 0 < hits < 64 * 48
    if sun in ("0", "-0", "below"):
        assert n_skip == 0
    elif sun in ("inf", "nan"):
        assert n_skip == hits
    else:
        assert 0 < n_skip < hits


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


def r1_setup(device, size=(96, 48), **kw):
    """(scene, ShadeArgs) of a TerrainRenderer render."""
    from forge3d_tpu_torch.terrain import renderer as rr
    from forge3d_tpu_torch.terrain.params import make_terrain_params

    n = 65
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (6.0 * np.sin(x * 0.15) * np.cos(y * 0.12) + 3.0 * np.sin(x * 0.4 + y * 0.3)
           ).astype(np.float32)
    p = make_terrain_params(size_px=size, cam_radius=75.0, cam_theta_deg=30.0, **kw)
    _, scene, args, _ = rr.TerrainRenderer(device=device).render_inputs(p, dem,
                                                                        time_seconds=1.5)
    return scene, args


def assert_planes(ref, got, keys):
    for k in keys:
        assert close_frac(ref[k], got[k]) >= FRAC, k


def check_r1_render(kernels, kw):
    from forge3d_tpu_torch.terrain import renderer as rr

    scene, a = r1_setup(kernels, **kw)
    before = rr.render_program.launches
    got = rr._render_kernel(scene, a, want_aov=True)
    assert rr.render_program.launches == before + 1
    ref = rr.render_plain(scene, a)
    du = (ref["rgba"].int() - got["rgba"].int()).abs().amax(-1)
    assert float((du <= 1).double().mean()) >= 0.995
    assert torch.equal(got["rgba"][..., 3], torch.full_like(got["rgba"][..., 3], 255))
    assert float((ref["depth"].isnan() == got["depth"].isnan()).double().mean()) >= FRAC
    assert_planes(ref, got, ("hdr", "albedo", "normal", "depth", "visibility"))
    if kernels.type == "cuda":   # the card's math library is the plain version's
        assert torch.equal(ref["rgba"], got["rgba"])
        assert all(same_bits(ref[k], got[k]) for k in ("hdr", "albedo", "normal", "depth",
                                                          "visibility"))
    return scene, a, got


# R1 render in 16x16 tiles (96x48 is 6x3 of them) at each case's aa
@pytest.mark.parametrize("case", list(R1_CASES))
def test_terrain_render_kernel(kernels, case):
    from forge3d_tpu_torch.terrain import renderer as rr

    scene, a, got = check_r1_render(kernels, R1_CASES[case])
    beauty = rr._render_kernel(scene, a, want_aov=False)
    assert set(beauty) == {"rgba"} and torch.equal(beauty["rgba"], got["rgba"])


# R1 render at aa 4: a lane per AA sample, each from the state skipped ahead
# (8x8 blocks: 96x48 is 12x6 of them)
@pytest.mark.parametrize("case", list(R1_CASES))
def test_terrain_render_kernel_lanes(kernels, case):
    check_r1_render(kernels, dict(R1_CASES[case], sampling=dict(aa_samples=4, aa_seed=7)))


@pytest.mark.parametrize("case", list(R1_CASES))
def test_r1_skipped_state_is_the_serial_state(host_lib, monkeypatch, case):
    """Each AA sample of a pixel starts from its seed advanced by k times the
    draws a sample takes, whatever its rays hit: the state render_pixel's
    serial loop reaches, at every sample of pixels on the terrain, the
    water, the sky and the frame's corners."""
    import ctypes

    monkeypatch.setattr(_kernels, "require_cuda", lambda name, *t: None)
    scene, a = r1_setup("cpu", **dict(R1_CASES[case], sampling=dict(aa_samples=4, aa_seed=3)))
    sa, ta = scene.kernel_args(), a.kernel_args()
    host_lib.f3d_test_r1_states.restype = None
    for x, y in ((0, 0), (95, 47), (48, 24), (10, 40), (90, 3), (33, 30)):
        ser, skp = (ctypes.c_uint * a.aa)(), (ctypes.c_uint * a.aa)()
        host_lib.f3d_test_r1_states(ctypes.byref(sa), ctypes.byref(ta), x, y, ser, skp)
        assert list(ser) == list(skp) and len(set(ser)) == a.aa


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


# R1 step in 16x16 blocks at ragged sizes: every pixel once, the tile means
# in the fixed order (edge tiles read their own last row and column)
@pytest.mark.parametrize("size", [(1, 1), (17, 15), (33, 31), (96, 48)])
def test_terrain_step_kernel_ragged(kernels, size, request):
    from forge3d_tpu_torch.terrain import renderer as rr

    W, H = size
    scene, a = r1_setup(kernels, size=size, **R1_CASES["print"])
    assert (a.width, a.height) == size
    acc = torch.zeros((H, W, 4), device=kernels)
    if kernels.type == "cpu":
        lib = request.getfixturevalue("host_lib")
        lib.f3d_test_step_serial.restype = None
    for idx in range(2):
        ka, kt, kaov = rr._step_kernel(scene, a, acc.clone(), idx)
        if kernels.type == "cpu":
            sa, lum = acc.clone(), torch.empty((H, W))
            st = torch.empty_like(kt)
            aov = {k: torch.empty_like(v) for k, v in kaov.items()}
            planes = _kernels.TerrainOut(None, None, *(aov[k].data_ptr() for k in aov))
            lib.f3d_test_step_serial(ctypes.byref(scene.kernel_args()), ctypes.byref(a.kernel_args()),
                                     _kernels.ptr(sa), idx, ctypes.byref(planes), _kernels.ptr(lum),
                                     _kernels.ptr(st))
        else:
            sa, st, aov = rr.step_plain(scene, a, acc, idx)
            lum = rr.luminance(*(sa[..., c] / sa[..., 3] for c in range(3)))
            st = rr.tile_means_ordered(lum)
        assert same_bits(sa, ka) and same_bits(st, kt)
        assert all(same_bits(aov[k], kaov[k]) for k in aov)
        assert same_bits(rr.tile_means_ordered(lum), kt)
        acc = ka
    assert float(acc[..., 3].min()) == 2.0


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
    before = ibl._launch.launches
    faces = np.stack([ibl._face_dirs(f, 8) for f in range(6)])[None]
    (d0, _), (d1, w1) = ibl.prefilter_tables(8, 2, 16)
    for dirs, w, mode in ((faces, None, ibl.ONE), (d0, None, ibl.ONE), (d1, w1, ibl.WEIGHTED),
                          (ibl.irradiance_tables(4, 32), None, ibl.MEAN)):
        d = torch.as_tensor(dirs, device=kernels)
        wt = None if w is None else torch.as_tensor(w, device=kernels)
        got = ibl._accum_kernel(env, d, wt, mode)
        assert got.shape == dirs.shape[1:]
        assert close_frac(ibl._accum_plain(env, d, wt, mode), got) == 1.0
    assert ibl._launch.launches == before + 4


# E1's one launch a bake (csrc/ibl.cu:bake_kernel): the host twin's lane
# groups against the serial loop and the plain version, on
# tests/test_torch_ibl.py's seeded 64x32 equirect. Gates: every element
# bit for bit, NaN where NaN.
IBL_ENV = np.random.default_rng(23).uniform(0.0, 4.0, (32, 64, 3)).astype(np.float32)
IBL_TIERS = {"low": (16, 3, 16, 16), "high": (64, 5, 64, 32)}   # cube, mips, samples, irradiance


def ibl_sets(tier):
    cube, mips, smp, isz = IBL_TIERS[tier]
    return [("cube", (cube,)), ("prefilter", (cube, mips, smp)), ("irradiance", (isz, smp * 2))]


def ibl_stages(tier):
    from forge3d_tpu_torch.ops import ibl

    return [t for kind, key in ibl_sets(tier) for t in ibl._tables(kind, *key)]


def test_bake_is_one_launch(kernels, request, monkeypatch):
    """bake_ibl's seven stages in one E1 launch, each map equal to its
    stage's one-job launch and to the plain version (on the host given the
    twin's atan2f and acosf)."""
    from forge3d_tpu_torch.ops import ibl

    if kernels.type == "cpu":
        host_transcendentals(request.getfixturevalue("host_lib"), monkeypatch)
    env = torch.as_tensor(IBL_ENV, device=kernels)
    before = ibl._launch.launches
    if kernels.type == "cuda":
        m = ibl.bake_ibl(env, quality="high")
        baked = [m.cubemap, *m.specular_mips, m.irradiance]
    else:
        baked = ibl._launch(env, [j for kind, key in ibl_sets("high")
                                  for j in ibl._jobs(kind, key, kernels)])
    assert ibl._launch.launches == before + 1
    stages = ibl_stages("high")
    assert len(baked) == len(stages) == 7
    for (d, w, mode), got in zip(stages, baked):
        d = torch.as_tensor(d, device=kernels)
        w = None if w is None else torch.as_tensor(w, device=kernels)
        assert got.shape == d.shape[1:]
        assert torch.equal(ibl._accum_kernel(env, d, w, mode), got), mode
        assert same_bits(ibl._accum_plain(env, d, w, mode), got), mode
    assert ibl._launch.launches == before + 8


@pytest.mark.parametrize("mips", [7, 10, 17])
def test_bake_splits_past_the_job_table(kernels, request, monkeypatch, mips):
    """A prefilter chain of 7, 10 or 17 mips runs in launches of BAKE_JOBS
    stages (one, two, three), each map the plain version's bit for bit (on
    the host given the twin's atan2f and acosf)."""
    from forge3d_tpu_torch.ops import ibl

    if kernels.type == "cpu":
        host_transcendentals(request.getfixturevalue("host_lib"), monkeypatch)
    env = torch.as_tensor(np.ascontiguousarray(IBL_ENV[:16, :32]), device=kernels)
    before = ibl._launch.launches
    if kernels.type == "cuda":
        got = ibl.prefilter_environment(env, base_size=8, mips=mips, samples=8)
    else:
        got = ibl._launch(env, ibl._jobs("prefilter", (8, mips, 8), kernels))
    assert ibl._launch.launches == before + -(-mips // ibl.BAKE_JOBS)
    tables = ibl.prefilter_tables(8, mips, 8)
    assert len(got) == len(tables) == mips
    for (d, w), m in zip(tables, got):
        d = torch.as_tensor(d, device=kernels)
        w = None if w is None else torch.as_tensor(w, device=kernels)
        assert same_bits(ibl._accum_plain(env, d, w, ibl.ONE if w is None else ibl.WEIGHTED), m)


def test_bake_job_table_size(host_lib):
    """The launcher takes BAKE_JOBS stages a launch and refuses one more
    (csrc/ibl.cuh kIblBakeJobs, which the host twin's launcher shares)."""
    from forge3d_tpu_torch.ops import ibl

    env4 = torch.zeros((4, 8, 4))
    tab = torch.zeros((1, 1, 4))
    out = torch.zeros((ibl.BAKE_JOBS + 1, 3))
    words = [w for j in range(ibl.BAKE_JOBS + 1)
             for w in (tab.data_ptr(), out[j].data_ptr(), 1, 1, ibl.ONE, 1)]
    for n, ok in ((ibl.BAKE_JOBS, True), (ibl.BAKE_JOBS + 1, False)):
        arr = (ctypes.c_longlong * (6 * n))(*words[:6 * n])
        assert (host_lib.f3d_ibl_bake(_kernels.ptr(env4), 4, 8, arr, n, None) == 0) == ok


@pytest.mark.parametrize("tier", ["low", "high"])
def test_bake_lane_groups_keep_the_sample_order(host_twin, monkeypatch, tier):
    """Every stage of a bake on G lanes a texel, G = 1 ... 32: the twin's
    group sums are the serial loop's bit for bit, and the stage's outputs the
    plain version's given the twin's atan2f and acosf; adding a round's terms
    in reverse lane order is not."""
    from forge3d_tpu_torch.ops import ibl

    host_lib = host_twin
    host_transcendentals(host_lib, monkeypatch)
    env = torch.as_tensor(IBL_ENV)
    env4 = ibl._rgbx(env)
    reordered = set()
    for d, w, mode in ibl_stages(tier):
        d = torch.as_tensor(d)
        w = None if w is None else torch.as_tensor(w)
        tab = ibl._records(d, w)
        n, count = int(tab.shape[0]), int(tab.shape[1])
        ref = ibl._accum_plain(env, d, w, mode)
        for g in (1, 2, 4, 8, 16, 32):
            out = torch.zeros((3, n, 4), dtype=torch.float32)
            host_lib.f3d_test_bake_sums(_kernels.ptr(env4), 32, 64, _kernels.ptr(tab), count,
                                        mode, g, n, _kernels.ptr(out))
            assert same_bits(out[0], out[1]), (mode, count, g)
            if not same_bits(out[0], out[2]):
                reordered.add(g)
        job = ibl._Job(tab, tuple(d.shape[1:]), mode)
        assert same_bits(ref, ibl._launch(env, [job])[0]), (mode, count)
    assert reordered == {2, 4, 8, 16, 32}    # for every G > 1 some stage's bits move


def test_bake_tables_are_packed_once(monkeypatch):
    """The packed records are the host tables transposed, texel-major, the
    weight in the fourth word (0 without one); a second bake packs nothing."""
    from forge3d_tpu_torch.ops import ibl

    (d0, w0), (d1, w1) = ibl.prefilter_tables(8, 2, 16)
    irr = ibl.irradiance_tables(4, 32)
    for d, w in ((d0, w0), (d1, w1), (irr, None)):
        tab = ibl._records(torch.as_tensor(d), None if w is None else torch.as_tensor(w))
        S = d.shape[0]
        assert tab.shape == (d[0].size // 3, S, 4) and tab.is_contiguous()
        assert np.array_equal(tab[..., :3].numpy(), d.reshape(S, -1, 3).transpose(1, 0, 2))
        ref_w = np.zeros((S, d[0].size // 3), np.float32) if w is None else w.reshape(S, -1)
        assert np.array_equal(tab[..., 3].numpy(), ref_w.T)
    monkeypatch.setattr(ibl, "_JOBS", {})
    calls = []
    tables = ibl._tables
    monkeypatch.setattr(ibl, "_tables", lambda *a: calls.append(a) or tables(*a))
    first = [ibl._jobs(kind, key, "cpu") for kind, key in ibl_sets("low")]
    assert len(calls) == 3
    again = [ibl._jobs(kind, key, "cpu") for kind, key in ibl_sets("low")]
    assert len(calls) == 3
    assert all(a.tab is b.tab for x, y in zip(first, again) for a, b in zip(x, y))
    assert [j.mode for x in first for j in x] == [ibl.ONE, ibl.ONE, ibl.WEIGHTED, ibl.WEIGHTED,
                                                  ibl.MEAN]


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


@pytest.mark.parametrize("aa", [1, 3, 4])
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


# S2/S3's lane groups (screen.cu:convolve_kernel): on the host the launcher
# runs a texel's lanes one after the other and adds the group's terms in
# lane order, as every lane adds the shuffled terms on the card; each group
# size, and the pyramid's one launch, bit for bit against
# cube_convolve_plain (NaN where it is NaN).

def s23_cube(kind, device, size=32):
    """A (6, size, size, 3) cube of f16 values from a seed; "special" sets
    texels to 0, 65504 and inf (an inf beside an inf makes the bilinear
    weights NaN)."""
    rng = np.random.default_rng(19)
    cube = rng.uniform(0.0, 3.0, (6, size, size, 3)).astype(np.float16).astype(np.float32)
    if kind == "special":
        flat = cube.reshape(-1, 3)
        pick = rng.permutation(len(flat))
        flat[pick[:600]] = 0.0
        flat[pick[600:700]] = 65504.0
        flat[pick[700:704]] = np.inf
        flat[pick[704:706], 1] = np.inf
    return torch.as_tensor(cube, device=device)


def same_or_nan(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("groups", [(1, 2, 4, 8, 16, 32), (1, 1, 1, 1, 1, 1),
                                    (32, 32, 32, 32, 32, 32), (2, 8, 16, 4, 32, 1)],
                         ids=["default", "g1", "g32", "mixed"])
@pytest.mark.parametrize("cube", ["uniform", "special"])
def test_cube_pyramid_lane_groups(kernels, monkeypatch, cube, groups):
    from forge3d_tpu_torch.terrain import screen as scr

    monkeypatch.setattr(scr, "IRR_SIZE", 16)   # the cosine lobe on a 16^2 output
    env = s23_cube(cube, kernels)
    before = scr.cube_convolve.launches
    got = scr._cube_pyramid_kernel(env, groups)
    assert scr.cube_convolve.launches == before + 1
    for mip in range(scr.N_MIPS):
        ref = scr.cube_convolve_plain(env, mip)
        assert got[mip].shape == ref.shape
        assert same_or_nan(ref, got[mip]), mip
    if cube == "special":
        assert bool(torch.isnan(got[0]).any()) and bool((got[0] == 1.0).any())


@pytest.mark.parametrize("mip", [0, 1, 3])
def test_lane_group_sums_keep_the_scan_order(host_lib, mip):
    """The float32 sums under the f16 output (which hides most orders): the
    lane groups' order, for every group size, is the scan's bit for bit;
    adding a round's terms in reverse lane order is not."""
    from forge3d_tpu_torch.terrain import screen as scr

    env = s23_cube("uniform", "cpu")
    env4 = scr._rgbx(env)
    size = 8
    dirs = scr._table("dirs", size, "cpu")
    smp = scr._table("lobe", mip, "cpu")
    n = 6 * size * size
    for g in (1, 2, 4, 8, 16, 32):
        out = torch.zeros((3, n, 4), dtype=torch.float32)
        host_lib.f3d_test_convolve_sums(_kernels.ptr(env4), 32, _kernels.ptr(dirs),
                                        _kernels.ptr(smp), int(smp.shape[0]), int(mip > 0), g, n,
                                        _kernels.ptr(out))
        assert same_bits(out[0], out[1]), g
        if g > 1:
            assert not same_bits(out[0], out[2]), g


def test_cube_pyramid_entry_is_the_six_launches(kernels, monkeypatch):
    """build_ibl's one launch equals the six per-mip launches; the RGBx
    copy the launch reads is the cube with a zero fourth channel; a group
    that is not a power of two up to 32 is refused."""
    from forge3d_tpu_torch.terrain import screen as scr

    monkeypatch.setattr(scr, "IRR_SIZE", 16)
    eq = torch.as_tensor(scr.decode_test_hdr(), device=kernels)
    env = scr._env_cube_kernel(eq, 32)
    env4 = scr._rgbx(env)
    assert env4.shape == (6, 32, 32, 4) and env4.is_contiguous()
    assert torch.equal(env4[..., :3], env) and not env4[..., 3].any()
    whole = scr.cube_pyramid(env) if kernels.type == "cuda" else scr._cube_pyramid_kernel(env)
    for mip in range(scr.N_MIPS):
        assert torch.equal(whole[mip], scr._cube_convolve_kernel(env, mip)), mip
    with pytest.raises(RuntimeError):
        scr._cube_pyramid_kernel(env, (4, 4, 3, 8, 16, 32))


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
        assert torch.equal(ref, got)
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


# S9 in S8's layout (screen.cuh:s8_pixel: a block a 16x16 tile, a warp 8x4
# pixels in 2x2 quads) with its PCSS taps through the texture: the layout
# at sizes whose tile edge falls inside the image, and the kernel's bytes
# against the parent design's (quads along the rows, the map through the
# pointer), built in the twin
S9_SIZES = {"96x40": (96, 40), "70x38": (70, 38), "16x16": (16, 16), "2x2": (2, 2),
            "34x18": (34, 18)}


@pytest.mark.parametrize("size", list(S9_SIZES))
def test_s9_tile_layout(host_lib, size):
    W, H = S9_SIZES[size]
    blocks = -(-W // 16) * -(-H // 16)
    lanes = np.zeros((blocks * 256, 3), np.int32)
    host_lib.f3d_test_s8_pixels(W, H, lanes.ctypes.data_as(ctypes.c_void_p))
    live = lanes[:, 2] == 1
    seen = np.zeros((H, W), np.int64)
    np.add.at(seen, (lanes[live, 1], lanes[live, 0]), 1)
    assert (seen == 1).all()                          # every pixel shaded and written once
    assert (lanes[~live, :2] == 0).all()              # the rest shade (0, 0)
    quads = lanes.reshape(-1, 4, 3)
    assert ((quads[:, :, 2] == quads[:, :1, 2]).all())    # whole quads live or not
    q = quads[quads[:, 0, 2] == 1]
    x0, y0 = q[:, 0, 0], q[:, 0, 1]
    assert (x0 % 2 == 0).all() and (y0 % 2 == 0).all()
    for k, (dx, dy) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):   # tl, tr, bl, br
        assert (q[:, k, 0] == x0 + dx).all() and (q[:, k, 1] == y0 + dy).all()


@pytest.mark.parametrize("size", [(96, 40), (64, 48)], ids=["96x40", "64x48"])
@pytest.mark.parametrize("kw", [dict(pom=POM), dict(pom=POM, generation="family", encode="srgb",
                                                   albedo_mode="colormap")],
                         ids=["pom_recipe", "pom_family_srgb"])
def test_s9_tiles_through_the_texture(kernels, monkeypatch, size, kw):
    from forge3d_tpu_torch.terrain import screen as scr

    cfg, u = clipmap_inputs(kernels, monkeypatch, W=size[0], H=size[1], **kw)
    got = scr._clipmap_kernel(cfg, u)
    if kernels.type == "cpu":
        a, keep = scr.screen_args(cfg, u)
        g, keep_g = scr._clip_args(u)
        ref = torch.empty_like(got)
        lib = _kernels.lib()
        lib.f3d_test_parent_clipmap.argtypes = [ctypes.POINTER(_kernels.ScreenArgs),
                                                ctypes.POINTER(_kernels.ClipArgs), ctypes.c_void_p]
        lib.f3d_test_parent_clipmap(a, g, _kernels.ptr(ref))
    else:
        ref = scr.clipmap_shade_plain(cfg, u)
    assert torch.equal(got, ref)
    assert 0.2 < float(u["gb_valid"].double().mean())


def test_struct_layout_guard(host_lib, monkeypatch):
    """The argument structs' ctypes mirrors have the sizes the sources give
    them, and a mirror out of step is refused when the library is bound."""
    n = len(_kernels.STRUCTS)
    sizes = (ctypes.c_longlong * n)()
    assert host_lib.f3d_struct_sizes(sizes, n) == n == 17
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


# E4 over whole layer lists (vector_layers: the binning, then every layer of
# a tile in one pass) against the loop of vector_layer_plain, bit for bit,
# on sets chosen against the cull: primitives with NaN and infinite
# coordinates and coordinates near +-1e20 (they go to every tile); strokes,
# discs and an edge exactly at the cull's reach from a tile's pixel centres
# and just beyond it; segments on tile borders and horizontal edges on rows
# of pixel centres; a stroke 40 px wide, a disc larger than the frame and a
# polygon that covers it; layers without primitives; opacities 2.0 and
# -0.5 over a base holding -0.0 and NaN (and an alpha with NaN and inf);
# ragged frames of 1x1 and 17x15.
def e4_mixed():
    from forge3d_tpu_torch.vector import coverage as vc

    rng = np.random.default_rng(17)
    t = np.linspace(0.0, 2.0 * np.pi, 25)[:-1]
    outer = np.stack([40 + 30 * np.cos(t), 24 + 20 * np.sin(t)], 1)
    hole = np.stack([40 + 10 * np.cos(-t), 24 + 7 * np.sin(-t)], 1)
    return [
        (vc.STROKE, rng.uniform(-8, 88, (37, 4)), dict(stroke_width=3.0, opacity=0.8,
                                                     pick_id=1, color=(0.9, 0.2, 0.1))),
        (vc.POLYGON, vc.ring_edges([outer, hole]), dict(opacity=0.6, pick_id=2)),
        (vc.STROKE, np.zeros((0, 4)), dict(stroke_width=3.0, pick_id=3)),
        (vc.DISC, vc.disc_prims(rng.uniform(0, 80, (50, 2)), rng.uniform(1, 5, 50)),
         dict(opacity=0.9, pick_id=4, color=(0.1, 0.2, 0.95))),
        (vc.POLYGON, vc.ring_edges([outer, outer * 0.5 + 10]), dict(rule="evenodd",
                                                                     pick_id=5)),
        (vc.POLYGON, np.zeros((0, 4)), dict(pick_id=6)),
        (vc.DISC, np.zeros((0, 4)), dict(pick_id=7)),
    ]


def e4_adversarial():
    from forge3d_tpu_torch.vector import coverage as vc

    nan, inf, big = np.nan, np.inf, 1e20
    # the cull's reach for a stroke of width 3 in an 80x48 frame: half +
    # 0.5 + 1 + (80 + 16) / 2^16, exact in float32
    reach = 1.5 + 0.5 + 1.0 + 96.0 / 65536.0
    y_at = 15.5 + reach                    # tile row 0's last centres at exactly the reach
    y_beyond = float(np.nextafter(np.float32(y_at), np.float32(100)))
    d_at = 15.5 + 0.5 + 1.0 + 96.0 / 65536.0 + 2.0   # a disc of radius 2 at its reach
    return {
        "nonfinite": [
            (vc.STROKE, [[5, 5, 30, 9], [nan, 20, 40, 20], [10, 40, 70, 30]],
             dict(stroke_width=2.0, pick_id=1)),
            (vc.STROKE, [[20, 10, inf, 10], [4, 30, 9, 44]], dict(stroke_width=3.0, pick_id=2)),
            (vc.DISC, [[30, 20, nan, 0], [60, 30, 4, 0]], dict(pick_id=3)),
            (vc.POLYGON, vc.ring_edges([[[10, 10], [70, 12], [-inf, 40]]]), dict(pick_id=4)),
            (vc.STROKE, [[-big, 20, big, 30], [-1e19, -1e19, 1e19, 1e19]],
             dict(stroke_width=4.0, pick_id=5, opacity=0.5)),
            (vc.POLYGON, vc.ring_edges([[[-big, -big], [big, -big], [big, big], [-big, big]]]),
             dict(pick_id=6, opacity=0.3)),
        ],
        "at_reach": [
            (vc.STROKE, [[0, y_at, 80, y_at], [0.5, 33.5, 79.5, 33.5]],
             dict(stroke_width=3.0, pick_id=1)),
            (vc.STROKE, [[0, y_beyond, 80, y_beyond], [15.5 + reach, 0, 15.5 + reach, 48]],
             dict(stroke_width=3.0, pick_id=2)),
            (vc.DISC, [[40, d_at, 2, 0], [d_at, 40, 2, 0], [40, 15.5 + 2.5, 2, 0]],
             dict(pick_id=3)),
            (vc.POLYGON, vc.ring_edges([[[16.0, 2.0], [47.5 + 2.0 + 96.0 / 65536.0, 6.5],
                                         [32.0, 44.0]]]), dict(pick_id=4)),
        ],
        "borders": [
            (vc.STROKE, [[16, 0, 16, 48], [0, 16, 80, 16], [15.5, 3, 15.5, 45],
                         [32, 32, 48, 32]], dict(stroke_width=1.0, pick_id=1)),
            (vc.POLYGON, vc.ring_edges([[[10.5, 8.5], [60.5, 8.5], [60.5, 40.5], [30.5, 20.5],
                                         [10.5, 40.5]]]), dict(pick_id=2, opacity=0.7)),
            (vc.POLYGON, vc.ring_edges([[[16, 16], [64, 16], [64, 32], [16, 32]]]),
             dict(rule="evenodd", pick_id=3)),
        ],
        "wide": [
            (vc.STROKE, [[-30, 60, 100, -20], [40, 24, 41, 25]], dict(stroke_width=40.0,
                                                                       pick_id=1, opacity=0.4)),
            (vc.DISC, [[40, 24, 200, 0], [10, 10, -3, 0]], dict(pick_id=2, opacity=0.3)),
            (vc.POLYGON, vc.ring_edges([[[-1000, -1000], [1000, -1000], [1000, 1000],
                                         [-1000, 1000]], [[20, 10], [20, 30], [60, 30],
                                                          [60, 10]]]), dict(pick_id=3)),
            (vc.POLYGON, vc.ring_edges([[[-500, -500], [900, -500], [900, 900]]]),
             dict(pick_id=4, rule="evenodd", opacity=0.5)),
        ],
        "opacity": [
            (vc.STROKE, [[5, 5, 70, 40]], dict(stroke_width=6.0, opacity=2.0, pick_id=1)),
            (vc.DISC, [[40, 24, 9, 0], [70, 5, 3, 0]], dict(opacity=-0.5, pick_id=2)),
            (vc.STROKE, np.zeros((0, 4)), dict(stroke_width=2.0, opacity=-0.5, pick_id=3)),
            (vc.POLYGON, vc.ring_edges([[[60, 20], [75, 45], [45, 45]]]),
             dict(opacity=2.0, pick_id=4)),
        ],
    }


def e4_planes(W, H, device, special: bool):
    rng = np.random.default_rng(5)
    rgb = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    alpha = np.full((H, W), 0.25, np.float32)
    if special:
        rgb[::3, ::2, 0] = -0.0
        rgb[1::5, 1::3, 1] = np.nan
        alpha[::7, ::5] = np.nan
        alpha[2::7, ::4] = np.inf
    return (torch.as_tensor(rgb, device=device), torch.as_tensor(alpha, device=device),
            torch.full((H, W), 9, dtype=torch.int32, device=device))


def same_bits(a, b):
    """Equal element for element, -0.0 apart from +0.0, NaN where NaN (its
    sign and payload are not compared)."""
    a, b = a.cpu(), b.cpu()
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


def e4_layers_through_kernel(layers, W, H, planes, device):
    from forge3d_tpu_torch.vector import coverage as vc

    table, prims, n_poly = vc.pack_layers(layers)
    before = vc.vector_layer.launches
    vc._vector_layers_kernel(torch.as_tensor(table.ravel(), device=device),
                             torch.as_tensor(prims, device=device), n_poly, W, H,
                             rgb=planes[0], alpha=planes[1], pick=planes[2])
    assert vc.vector_layer.launches == before + 1
    return planes


E4_LISTS = ("mixed", "nonfinite", "at_reach", "borders", "wide", "opacity")


@pytest.mark.parametrize("size", [(80, 48), (17, 15), (1, 1)], ids=["80x48", "17x15", "1x1"])
@pytest.mark.parametrize("case", E4_LISTS)
def test_vector_layers_kernel(kernels, case, size):
    """Every layer of a list in one E4 launch, bit for bit the loop of
    vector_layer_plain over the same planes: rgb, alpha and pick."""
    from forge3d_tpu_torch.vector import coverage as vc

    W, H = size
    layers = e4_mixed() if case == "mixed" else e4_adversarial()[case]
    layers = [(k, np.asarray(p, np.float32).reshape(-1, 4), st) for k, p, st in layers]
    special = case in ("opacity", "mixed")
    got = e4_layers_through_kernel(layers, W, H, e4_planes(W, H, kernels, special), kernels)
    ref = e4_planes(W, H, kernels, special)
    vc.vector_layers_plain(layers, W, H, rgb=ref[0], alpha=ref[1], pick=ref[2])
    for a, b in zip(ref, got):
        assert same_bits(a, b)
    if kernels.type == "cuda":   # the public entry point: one upload, one launch
        pub = e4_planes(W, H, kernels, special)
        before = vc.vector_layer.launches
        vc.vector_layers(layers, W, H, rgb=pub[0], alpha=pub[1], pick=pub[2])
        assert vc.vector_layer.launches == before + 1
        assert all(same_bits(a, b) for a, b in zip(ref, pub))
    if size == (80, 48) and case != "nonfinite":   # there NaN reaches every pixel
        assert len(set(ref[2].unique().tolist()) - {9}) >= 2   # layers reached the pick map
    for kind, prims, style in layers:   # each layer's coverage plane alone
        kw = {k: v for k, v in style.items() if k in ("stroke_width", "rule")}
        cov_k, cov_p = torch.zeros((H, W), device=kernels), torch.zeros((H, W), device=kernels)
        vc._vector_layer_kernel(kind, torch.as_tensor(prims, device=kernels), W, H, **kw,
                                cov=cov_k)
        vc.vector_layer_plain(kind, torch.as_tensor(prims, device=kernels), W, H, **kw,
                              cov=cov_p)
        assert same_bits(cov_p, cov_k)


def test_vector_binning_culls(host_lib):
    """The binning keeps a primitive in the tiles it can change and counts a
    polygon's far edges into the backdrop of the tiles left of them: at
    80x48 (5x3 tiles), a short segment inside tile (1, 1) lands in it alone;
    of the triangle (20, 4), (75, 40), (70, 4), the long edge is in tile
    columns 1-4, the short one in column 4 and the top one in row 0, and on
    rows 4-39 the long edge (upward) adds +1 left of column 1 and the short
    one (downward) -1 left of column 4."""
    import ctypes

    from forge3d_tpu_torch.vector import coverage as vc

    W, H = 80, 48
    tri = vc.ring_edges([[[20, 4], [75, 40], [70, 4]]])
    table, prims, n_poly = vc.pack_layers([(vc.STROKE, [[22, 22, 26, 25]],
                                            dict(stroke_width=2.0)),
                                           (vc.POLYGON, tri, {})])
    counts = np.zeros(5 * 3 * 2, np.int32)
    backdrop = np.zeros(n_poly * H * 5, np.int32)
    p = lambda a: ctypes.c_void_p(a.ctypes.data)  # noqa: E731
    table = np.ascontiguousarray(table)
    assert host_lib.f3d_vector_count(p(table), 2, p(prims), len(prims), W, H, p(counts),
                                     p(backdrop), None) == 0
    stroke, poly = counts[0::2].reshape(3, 5), counts[1::2].reshape(3, 5)
    assert stroke.tolist() == [[0, 0, 0, 0, 0], [0, 1, 0, 0, 0], [0, 0, 0, 0, 0]]
    assert poly.tolist() == [[0, 2, 2, 2, 3], [0, 1, 1, 1, 2], [0, 1, 1, 1, 2]]
    bd = backdrop.reshape(H, 5)
    want = np.zeros((H, 5), np.int32)
    want[4:40, 0], want[4:40, 3] = 1, -1
    np.testing.assert_array_equal(bd, want)


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


# P6's packed tape. A right-deep chain of primitives under operations
# needs a stack as deep as its primitives; the chains cycle through every
# primitive and operation kind. Both instantiations of the body (the tape
# read as from global or from shared memory) are held bit for bit to the
# plain versions at every stack depth from 1 to 8, on every kind and on a
# deep tape, the t and material of the rays that miss included.
def sdf_chain(depth, device, kinds=None):
    from forge3d_tpu_torch.ops.sdf import SdfSceneBuilder

    b = SdfSceneBuilder()
    rng = np.random.default_rng(depth)
    prims = []
    for i in range(depth):
        c = tuple(float(v) for v in rng.uniform(-1.2, 1.2, 3))
        kind = (i if kinds is None else kinds[i]) % 6
        if kind == 0:
            prims.append(b.add_sphere(c, 0.5 + 0.1 * i, i + 1))
        elif kind == 1:
            prims.append(b.add_box(c, (0.6, 0.4, 0.5), i + 1))
        elif kind == 2:
            prims.append(b.add_cylinder(c, 0.4, 0.6, i + 1))
        elif kind == 3:
            prims.append(b.add_plane((0.1, 1.0, 0.2), -1.5, i + 1))
        elif kind == 4:
            prims.append(b.add_torus(c, 0.6, 0.2, i + 1))
        else:
            prims.append(b.add_capsule(c, (c[0] + 0.8, c[1] + 0.5, c[2] - 0.3), 0.25, i + 1))
    ops = ["union", "smooth_union", "intersect", "smooth_intersect", "subtract",
           "smooth_subtract"]
    node = prims[-1]
    for i in range(depth - 2, -1, -1):
        op = ops[i % 6] if kinds is None else "union"
        args = (prims[i], node) + ((0.3,) if op.startswith("smooth") else ())
        node = getattr(b, op)(*args, material_id=100 + i)
    return b.build(device=device)


def host_sdf_args(scene):
    """The kernels' SdfArgs of a scene on the CPU (the host twin's)."""
    return _kernels.SdfArgs(_kernels.ptr(scene.packed), scene.tape_len, scene.stack_depth,
                            scene.cull[0], _kernels._F3(*scene.cull[1]),
                            _kernels._F3(*scene.cull[2]), 1e-3)


def sdf_variant(host_lib, scene, pts, ro, rd, shared, tmax=20.0):
    n, m = pts[0].numel(), ro[0].numel()
    d = torch.empty(n, dtype=torch.float32)
    mat = torch.empty(n, dtype=torch.int32)
    hit = torch.empty(m, dtype=torch.bool)
    t = torch.empty(m, dtype=torch.float32)
    hm = torch.empty(m, dtype=torch.int32)
    o = torch.stack(ro, 1).contiguous()
    q = torch.stack(rd, 1).contiguous()
    host_lib.f3d_test_sdf_variant(
        ctypes.byref(host_sdf_args(scene)), int(not shared), *(_kernels.ptr(c) for c in pts), n,
        _kernels.ptr(d), _kernels.ptr(mat), _kernels.ptr(o), _kernels.ptr(q), m,
        ctypes.c_float(1e-3), ctypes.c_float(tmax), 128, ctypes.c_float(1e-3),
        _kernels.ptr(hit), _kernels.ptr(t), _kernels.ptr(hm))
    return (d, mat), (hit, t, hm)


@pytest.mark.parametrize("depth", list(range(1, 9)) + ["all_kinds", "deep_13"])
def test_sdf_packed_tape_and_stacks(host_lib, kernels, depth):
    from forge3d_tpu_torch.ops import sdf as sd

    if depth == "all_kinds":
        scene = sdf_all_kinds("cpu")
    elif depth == "deep_13":          # a right-deep chain of 12 unions
        scene = sdf_chain(13, "cpu", kinds=[0, 1, 2, 4, 5] * 3)
    else:
        scene = sdf_chain(depth, "cpu")
    want = depth if isinstance(depth, int) else (13 if depth == "deep_13" else None)
    if want is not None:
        assert scene.stack_depth == want
    packed = scene.packed.view(torch.int32)
    assert packed.shape == (scene.tape_len, 12)
    assert torch.equal(packed[:, 0], scene.tape.is_op.to(torch.int32))
    assert torch.equal(packed[:, 1], scene.tape.kind)
    assert torch.equal(packed[:, 2], scene.tape.material)
    assert torch.equal(scene.packed[:, 4:], scene.tape.params)
    rng = np.random.default_rng(8)
    pts = [torch.as_tensor(c) for c in rng.uniform(-3, 3, (3, 2048)).astype(np.float32)]
    ro, rd = sdf_rays(1024, "cpu", seed=9)
    dp = sd.sdf_eval_plain(scene, *pts)
    hp = sd.sdf_march_plain(scene, ro, rd, 1e-3, 20.0, 128, 1e-3)
    for shared in (False, True):
        (d, m), h = sdf_variant(host_lib, scene, pts, ro, rd, shared)
        assert torch.equal(d, dp[0]) and torch.equal(m, dp[1]), shared
        assert all(torch.equal(a, b) for a, b in zip(h, hp)), shared
    assert bool((~hp.hit).any()) and bool((hp.material[~hp.hit] == -1).all())
    # the launchers' choice, and the wrappers through it
    attrs = (ctypes.c_int * 4)()
    host_lib.f3d_sdf_march_attrs(ctypes.byref(host_sdf_args(scene)), attrs)
    assert attrs[3] == 1 and sd.kernel_instance(scene) == "shared tape"
    sc = scene.to(kernels)
    dk = sd._sdf_eval_kernel(sc, *(c.to(kernels) for c in pts))
    hk = sd._sdf_march_kernel(sc, [c.to(kernels) for c in ro], [c.to(kernels) for c in rd],
                              1e-3, 20.0, 128, 1e-3)
    nk = sd._sdf_normal_kernel(sc, *(c.to(kernels) for c in pts), 1e-4)
    np_ = sd.sdf_normal_plain(scene, *pts, 1e-4)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(dk, dp))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(hk, hp))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(nk, np_))


def sdf_long_tape(device, spine=20, branch=30, seed=3):
    """A tape longer than the kernels' shared-memory copy holds, with a
    shallow stack: a left-deep spine of `spine` unions, each taking a
    left-deep union of `branch` spheres (stack depth 3, tree depth 50)."""
    from forge3d_tpu_torch.ops.sdf import SdfSceneBuilder

    b = SdfSceneBuilder()
    rng = np.random.default_rng(seed)
    ids = [b.add_sphere(tuple(float(v) for v in rng.uniform(-2, 2, 3)),
                        float(rng.uniform(0.05, 0.2)), k + 1) for k in range(spine * branch)]
    node = None
    for j in range(spine):
        sub = ids[j * branch]
        for k in range(1, branch):
            sub = b.union(sub, ids[j * branch + k], material_id=1000 + k)
        node = sub if node is None else b.smooth_union(node, sub, 0.1, material_id=2000 + j)
    return b.build(device=device)


def test_sdf_long_tape_is_read_from_global_memory(host_lib, kernels):
    """A tape longer than the shared-memory copy holds takes the
    global-memory instantiation."""
    from forge3d_tpu_torch.ops import sdf as sd

    scene = sdf_long_tape("cpu")
    assert scene.tape_len > sd.SHARED_TAPE and scene.stack_depth == 3
    attrs = (ctypes.c_int * 4)()
    host_lib.f3d_sdf_march_attrs(ctypes.byref(host_sdf_args(scene)), attrs)
    assert attrs[3] == 0 and sd.kernel_instance(scene) == "global tape"
    rng = np.random.default_rng(4)
    pts = [torch.as_tensor(c, device=kernels)
           for c in rng.uniform(-3, 3, (3, 256)).astype(np.float32)]
    ro, rd = sdf_rays(64, kernels, seed=5)
    sc = scene.to(kernels)
    dk = sd._sdf_eval_kernel(sc, *pts)
    dp = sd.sdf_eval_plain(scene, *(c.cpu() for c in pts))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(dk, dp))
    hk = sd._sdf_march_kernel(sc, ro, rd, 1e-3, 20.0, 64, 1e-3)
    hp = sd.sdf_march_plain(scene, [c.cpu() for c in ro], [c.cpu() for c in rd], 1e-3, 20.0,
                            64, 1e-3)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(hk, hp))
    assert bool(hp.hit.any()) and bool((~hp.hit).any())


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


def random_tape(rng, n_sites=6, kmax=10.0):
    """A seeded CSG tree over every primitive kind (a plane only under an
    intersection, so the root stays bounded) and every operation kind,
    smooth ones with k up to kmax."""
    from forge3d_tpu_torch.ops.sdf import SdfSceneBuilder

    b = SdfSceneBuilder()
    kinds = ["sphere", "box", "cylinder", "torus", "capsule", "plane"]
    ops = ["union", "intersect", "subtract", "smooth_union", "smooth_intersect",
           "smooth_subtract"]
    nodes = []
    for i in range(n_sites):
        c = rng.uniform(-20, 20, 3)
        r = float(rng.uniform(0.5, 4.0))
        kind = kinds[i % len(kinds)]
        if kind == "sphere":
            n = b.add_sphere(c, r)
        elif kind == "box":
            n = b.add_box(c, rng.uniform(0.3, 3.0, 3))
        elif kind == "cylinder":
            n = b.add_cylinder(c, r, float(rng.uniform(0.5, 3.0)))
        elif kind == "torus":
            n = b.add_torus(c, r, 0.3 * r)
        elif kind == "capsule":
            n = b.add_capsule(c, c + rng.uniform(-4, 4, 3), 0.4 * r)
        else:
            n = b.intersect(b.add_box(c, (r, r, r)),
                            b.add_plane(rng.uniform(-1, 1, 3) + [0, 2, 0], float(c[1])))
        nodes.append(n)
    while len(nodes) > 1:
        l, r = nodes.pop(0), nodes.pop(0)
        op = ops[len(nodes) % len(ops)]
        args = (l, r, float(rng.uniform(0.5, kmax))) if op.startswith("smooth") else (l, r)
        nodes.append(getattr(b, op)(*args))
    return b.build(device="cpu")


def landmark_recipe():
    """chip_smoke.py's landmark CSG scene over bench.py's DEM."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_recipes", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.landmark_sdf(cs.bench_dem(), "cpu")


def box_probe_points(lo, hi, rng, n=64):
    """Points on and just outside each face, edge and corner of the box (0-4
    float32 ulps out), and far outside it."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    out = []
    for ulps in range(5):
        lo_o, hi_o = lo.copy(), hi.copy()
        for _ in range(ulps):
            lo_o, hi_o = np.nextafter(lo_o, -np.inf), np.nextafter(hi_o, np.inf)
        for mask in range(1, 27):     # which axes sit at a face: 26 faces, edges, corners
            sides = [(mask // 3 ** a) % 3 for a in range(3)]
            p = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
            for a, sd_ in enumerate(sides):
                if sd_ == 1:
                    p[:, a] = lo_o[a]
                elif sd_ == 2:
                    p[:, a] = hi_o[a]
            out.append(p)
    span = float(np.max(hi - lo)) + 1.0
    far = rng.normal(size=(4096, 3))
    far /= np.abs(far).max(1, keepdims=True)
    far = (lo + hi) / 2 + far * ((hi - lo) / 2 + span * rng.uniform(1e-3, 1e3, (4096, 1)))
    out.append(far.astype(np.float32))
    return np.concatenate(out)


def test_sdf_cull_box_is_conservative():
    """Outside the cull box (on its float32 faces, a few ulps out, and far
    away) every tape is at or above the march's threshold; a tape whose root
    is a union with a plane has no box."""
    from forge3d_tpu_torch.ops import sdf as sd

    rng = np.random.default_rng(21)
    scenes = [random_tape(np.random.default_rng(s), kmax=10.0) for s in range(6)]
    scenes += [random_tape(np.random.default_rng(9), n_sites=12, kmax=50.0), landmark_recipe()]
    for k in (0.5, 10.0):    # side by side: the blend bulges k/4 out of the boxes' faces
        b = sd.SdfSceneBuilder()
        b.smooth_union(b.add_box((0.0, 0.0, 0.0), (2.0, 1.0, 2.0)),
                       b.add_box((4.0, 0.0, 0.0), (2.0, 1.0, 2.0)), k)
        scenes.append(b.build(device="cpu"))
    thr = np.float32(sd.CULL_THRESHOLD)
    for scene in scenes:
        flag, lo, hi = scene.cull
        assert flag == 1
        pts = torch.as_tensor(box_probe_points(lo, hi, rng))
        d, _ = sd.sdf_eval_plain(scene, pts[:, 0], pts[:, 1], pts[:, 2])
        assert float(d.min()) >= thr, float(d.min())
        inside = torch.as_tensor(rng.uniform(lo, hi, (4096, 3)).astype(np.float32))
        di, _ = sd.sdf_eval_plain(scene, inside[:, 0], inside[:, 1], inside[:, 2])
        assert float(di.min()) < thr     # the box is not empty of the surface
    b = sd.SdfSceneBuilder()
    b.union(b.add_sphere((0, 0, 0), 1.0), b.add_plane((0, 1, 0), -2.0))
    assert b.build(device="cpu").cull[0] == 0
    b = sd.SdfSceneBuilder()
    b.intersect(b.add_sphere((0, 0, 0), 1.0), b.add_sphere((5, 0, 0), 1.0))
    assert b.build(device="cpu").cull[0] == 2      # no point below the threshold


def test_sdf_cull_span_matches_plain(host_lib, monkeypatch):
    """The kernel's cull of a march (sdf_cull_span, host build) equals its
    plain version on rays through, past and along the box, from inside it,
    with zero direction components, NaN, and origins beyond 2^40; a march
    whose threshold exceeds the box's is not culled by either."""
    from forge3d_tpu_torch.ops import sdf as sd

    scene = random_tape(np.random.default_rng(3))
    lo, hi = (np.asarray(v, np.float32) for v in scene.cull[1:])
    rng = np.random.default_rng(8)
    n = 6000
    o = rng.uniform(lo - 30, hi + 30, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[800:4000] = rng.uniform(lo, hi, (3200, 3)) - o[800:4000]   # toward the box
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:500, rng.integers(0, 3, 500)] = 0.0
    d[500:600] = 0.0
    o[600:700, 1] = hi[1]
    d[600:700, 1] = 0.0
    o[700:710] = np.nan
    o[710:720, 0] = 3e12
    d[720:730, 2] = 1e3
    o[730:800] = rng.uniform(lo, hi, (70, 3))
    tmax = rng.choice([1e6, 5.0, 40.0], n).astype(np.float32)
    ro = tuple(torch.as_tensor(np.ascontiguousarray(o[:, k])) for k in range(3))
    rd = tuple(torch.as_tensor(np.ascontiguousarray(d[:, k])) for k in range(3))
    monkeypatch.setattr(_kernels, "require_cuda", lambda name, *t: None)
    host_lib.f3d_test_sdf_span.restype = None
    for eps in (1e-3, 2e-3):
        march, tm = sd.sdf_cull_span_plain(scene, ro, rd, 1e-3, torch.as_tensor(tmax), eps)
        km = np.zeros(n, np.uint8)
        kt = tmax.copy()
        host_lib.f3d_test_sdf_span(ctypes.byref(scene.kernel_args()),
                                   o.ctypes.data_as(ctypes.c_void_p),
                                   d.ctypes.data_as(ctypes.c_void_p), n, ctypes.c_float(eps),
                                   ctypes.c_float(1e-3), km.ctypes.data_as(ctypes.c_void_p),
                                   kt.ctypes.data_as(ctypes.c_void_p))
        assert np.array_equal(km.astype(bool), march.numpy())
        assert np.array_equal(kt.view(np.int32), tm.numpy().view(np.int32))
        if eps == sd.CULL_THRESHOLD:
            assert 0.2 < float(march.double().mean()) < 0.9
            assert bool((tm < torch.as_tensor(tmax)).any())
        else:
            assert bool(march.all()) and np.array_equal(kt, tmax)


def test_mesh_walk_cut_at_a_nearer_t_loses_hits(host_lib, monkeypatch):
    """Why P3's primary mesh walk is not given the terrain's t as its tmax:
    a walk started with tmax one or two float32 steps above the whole
    walk's hit loses that hit on some rays (the walk prunes a box whose
    computed entry lies above tmax while its wall triangle's computed t lies
    below), so a terrain t between the two would hand the pixel to the
    terrain."""
    from forge3d_tpu_torch.ops.bvh import build_sah_bvh, mesh_scene

    monkeypatch.setattr(_kernels, "require_cuda", lambda name, *t: None)
    rng = np.random.default_rng(0)
    vs, fs = [], []
    for i in range(16):
        size = rng.uniform([5, 5, 5], [20, 40, 20]).astype(np.float32)
        vs.append(_BOX_V * size + [(i % 4) * 40.0 + 300, 0.0, (i // 4) * 40.0 + 300])
        fs.append(_BOX_F + 8 * i)
    bvh = build_sah_bvh(np.concatenate(vs).astype(np.float32), np.concatenate(fs))
    scene, _ = mesh_scene(bvh, device="cpu")
    n = 100000
    o = np.tile(np.array([512.0, 260.0, 1400.0], np.float32), (n, 1))
    d = rng.uniform([300, 0, 300], [460, 40, 460], (n, 3)).astype(np.float32) - o
    d = np.ascontiguousarray(d / np.linalg.norm(d, axis=1, keepdims=True), np.float32)
    hits, lost = ctypes.c_int(), []
    for ulps in (1, 2, 8):
        lost.append(host_lib.f3d_test_mesh_cut(
            ctypes.byref(scene.kernel_args()), o.ctypes.data_as(ctypes.c_void_p),
            d.ctypes.data_as(ctypes.c_void_p), n, ulps, ctypes.byref(hits)))
    assert hits.value > n // 4
    assert lost[0] > 0 and lost[1] > 0 and lost[2] == 0, lost


def cull_scene(device, k=50.0, plane=False):
    """A small terrain, a mesh box and an SDF of smooth operations with k
    (and, with `plane`, a union with a plane, so no cull box)."""
    from forge3d_tpu_torch.ops.sdf import SdfSceneBuilder
    from forge3d_tpu_torch.pt import hybrid as hy

    n = 33
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (2.0 * np.sin(x * 0.3) * np.cos(y * 0.3)).astype(np.float32)
    b = SdfSceneBuilder()
    u = b.smooth_union(b.add_sphere((22.0, 5.0, 10.0), 2.5, 1), b.add_box((25.0, 4.0, 12.0),
                                                                         (1.5, 3.0, 1.0), 2), k)
    i = b.smooth_intersect(b.add_torus((20.0, 3.0, 18.0), 3.0, 1.0, 3),
                           b.add_cylinder((21.0, 3.0, 18.0), 2.5, 2.0, 4), k)
    sub = b.smooth_subtract(b.add_capsule((8.0, 2.0, 8.0), (12.0, 7.0, 10.0), 1.5, 5),
                            b.add_sphere((10.0, 5.0, 9.0), 1.0), k)
    root = b.union(b.union(u, i), sub)
    if plane:
        b.union(root, b.add_plane((0.0, 1.0, 0.0), -1.5, 6))
    return hy.build_hybrid_scene(heightmap=dem, mesh_vertices=_BOX_V * 4 + [13, 3, 14],
                                 mesh_indices=_BOX_F, sdf_scene=b.build(device=device),
                                 device=device)


def cull_rays(case, lo, hi, device):
    """(origin, (rdx, rdy, rdz) (H, W)) of a cull case: `inside`, a camera
    in the box; `graze`, rays along the box's faces from a corner (zero
    components); `miss`, a camera beside the box looking away from it;
    `view`, a camera that sees all of the scene."""
    from forge3d_tpu_torch.pt import hybrid as hy

    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    if case == "view":
        return hy.camera_rays(48, 32, {"origin": (16.0, 18.0, 52.0), "look_at": (16.0, 2.0, 16.0)},
                              device)
    if case == "inside":
        c = (lo + hi) / 2
        return hy.camera_rays(48, 32, {"origin": tuple(c + [0.0, 1.0, 0.3]),
                                       "look_at": (float(c[0]) + 3.0, 0.0, float(c[2]) - 5.0),
                                       "fov_y": 100.0}, device)
    if case == "miss":
        return hy.camera_rays(48, 32, {"origin": (float(lo[0]) - 2.0, 9.0, float(hi[2]) + 2.0),
                                       "look_at": (float(lo[0]) - 30.0, 12.0, 60.0)}, device)
    rng = np.random.default_rng(2)
    d = rng.normal(size=(32, 48, 3)).astype(np.float32)
    for k, col in enumerate(range(0, 48, 3)):
        d[:, col, k % 3] = 0.0           # along a face: one component exactly zero
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tuple(float(v) for v in hi), tuple(torch.as_tensor(np.ascontiguousarray(d[..., k]),
                                                              device=device) for k in range(3))


@pytest.mark.parametrize("case", ["view", "inside", "graze", "miss", "unbounded"])
@pytest.mark.parametrize("mode", ["hybrid", "terrain_only", "mesh_only", "sdf_only"])
def test_hybrid_kernel_cull_cases(kernels, case, mode):
    """P3 with the SDF march culled by the tape's box, bit for bit against
    _trace_all and the plain shading: rays that miss the box, graze its
    faces or start inside it, shadow rays that leave the SDF's surface,
    smooth operations with k = 50, and a tape with no box."""
    from forge3d_tpu_torch.pt import hybrid as hy

    hs = cull_scene(kernels, plane=case == "unbounded")
    flag, lo, hi = hs.sdf_scene.cull
    assert flag == (0 if case == "unbounded" else 1)
    if case == "unbounded":
        lo, hi = cull_scene("cpu").sdf_scene.cull[1:]
    origin, rd = cull_rays("inside" if case == "unbounded" else case, lo, hi, kernels)
    sun = {"azimuth": 120.0, "elevation": 35.0, "intensity": 3.0}
    alb = ((0.55, 0.52, 0.48), (0.7, 0.7, 0.72), (0.8, 0.3, 0.25))
    rk, pk = hy._shade_kernel(hs, mode, origin, rd, sun, alb, 0.35, 1.0)
    rp, pp = hy._shade_plain(hs, mode, origin, rd, sun, alb, 0.35, 1.0)
    assert torch.equal(rk, rp)
    for k in pp:
        assert torch.equal(pk[k], pp[k]), k
    if mode in ("hybrid", "sdf_only") and case in ("view", "inside", "unbounded"):
        assert int((pp["kind"] == 2).sum()) > 0 and int((pp["visibility"] > 0).sum()) > 0


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


# P4 raster in 16x16 tiles at a ragged size and at a whole-tile one, both
# with ground hits, back-facing secondaries (whose sun NEE the kernel skips)
# and unlit primaries: the same gates as test_adjudication_kernels
@pytest.mark.parametrize("size", [(33, 17), (32, 16)], ids=["33x17", "32x16"])
def test_adjudication_raster_tiles(kernels, size):
    from forge3d_tpu_torch.pt import adjudication as adj

    w, h = size
    work = adj.raster_work(w, h, kernels)
    assert work["blocked_ground"] > 0 and work["plane_exit"] > 0
    assert work["blocked"] > work["sun_lit"] > 0 and work["hits"] > work["primary_lit"] > 0
    before = adj.raster_lane.launches
    rk, hk = adj._raster_lane_kernel(w, h, kernels)
    rp, hp = adj.raster_lane_plain(w, h, kernels)
    assert close_frac(hp, hk) >= 0.995
    assert float(((rk.int() - rp.int()).abs() <= 1).all(-1).double().mean()) >= 0.995
    assert adj.raster_lane.launches == before + 1


def test_adjudication_raster_work_counts():
    """raster_work counts the plain frame's own hits, escaped and blocked
    directions, and splits the blocked ones into ground and plane-exit."""
    from forge3d_tpu_torch.pt import adjudication as adj

    fn = adj._raster_frame
    fn.hits = fn.escaped = fn.blocked = 0
    adj._raster_frame(24, 16)
    work = adj.raster_work(24, 16, weights=(180, 520, 230, 130, 160))
    assert (work["hits"], work["escaped"], work["blocked"]) == (fn.hits, fn.escaped, fn.blocked)
    assert work["blocked_ground"] + work["plane_exit"] == work["blocked"]
    for k in ("lanes_parent_row", "lanes_parent_8x4", "lanes_kernel_row", "lanes_kernel_8x4"):
        assert 0.0 < work[k] <= 1.0


# P4 pt's hit loop. On the host the twin calls the C library's cosf, sinf
# and powf, which may differ from PyTorch's by an ulp, so it is held bit for
# bit to the serial loop it replaces (the same library, the skipped work
# formed) and to the plain lane by test_adjudication_kernels' gates; on the
# card, bit for bit to the plain lane.
def pt_twin_out(width, height):
    return (torch.empty(height, width, 4, dtype=torch.uint8),
            torch.empty(height, width, 3, dtype=torch.float32))


@pytest.mark.parametrize("spp", [4, 7])
def test_adjudication_pt_hit_loop(host_lib, kernels, spp):
    from forge3d_tpu_torch.pt import adjudication as adj

    w, h = 32, 24
    keys = torch.as_tensor(adj.key_table(7, spp).view(np.int32).copy())
    rgba_s, hdr_s = pt_twin_out(w, h)
    host_lib.f3d_test_adj_pt_serial(ctypes.byref(adj.adj_args(w, h, spp)), _kernels.ptr(keys),
                                    _kernels.ptr(rgba_s), _kernels.ptr(hdr_s))
    before = adj.pt_lane.launches
    rk, hk = adj._pt_lane_kernel(w, h, spp, 7, kernels)
    assert adj.pt_lane.launches == before + 1
    rp, hp = adj.pt_lane_plain(w, h, spp, 7, kernels)
    if kernels.type == "cuda":
        # pt_lane_plain's mean, hdr / float(spp), is a product by the
        # reciprocal in PyTorch's CUDA division by a scalar (one ulp off the
        # quotient at spp 7); the kernel divides, as JAX does. The reference
        # is the plain samples summed in order, divided element by element.
        keys_np = adj.key_table(7, spp)
        acc = torch.zeros(h, w, 3, dtype=torch.float32, device=kernels)
        for i in range(spp):
            acc = acc + adj._pt_sample(keys_np[i], w, h, kernels)
        ref = acc / torch.full_like(acc, float(spp))
        assert torch.equal(hk, ref) and torch.equal(rk, adj._tonemap(ref))
        if spp == 4:
            assert torch.equal(hk, hp) and torch.equal(rk, rp)
    else:
        assert torch.equal(rk, rgba_s) and torch.equal(hk, hdr_s)
        assert close_frac(hp, hk) >= 0.995
        assert float(((rk.int() - rp.int()).abs() <= 1).all(-1).double().mean()) >= 0.995


@pytest.mark.parametrize("tiles", [False, True], ids=["rows", "tiles"])
def test_adjudication_pt_queue_order(host_lib, tiles):
    """P4 pt's lanes under another schedule: a pixel queue handed out from
    its last index back, to lanes run pass by pass from the last back, a
    lane for every 3.5 pixels of 64x48 (in 8x4 tiles: with the ragged
    tiles' holes at 60x45), and 96 lanes in order: the same bits as the
    kernel's lane a pixel."""
    from forge3d_tpu_torch.pt import adjudication as adj

    w, h, spp = (60, 45, 3) if tiles else (64, 48, 3)
    a = adj.adj_args(w, h, spp)
    keys = torch.as_tensor(adj.key_table(7, spp).view(np.int32).copy())
    ref = pt_twin_out(w, h)
    host_lib.f3d_adj_pt(ctypes.byref(a), _kernels.ptr(keys), _kernels.ptr(ref[0]),
                        _kernels.ptr(ref[1]), None)
    for lanes, reverse in ((w * h * 2 // 7, 1), (96, 0)):
        got = pt_twin_out(w, h)
        host_lib.f3d_test_adj_pt_queue(ctypes.byref(a), _kernels.ptr(keys), _kernels.ptr(got[0]),
                                       _kernels.ptr(got[1]), lanes, reverse, int(tiles))
        assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1]), (lanes, reverse)


def pt_work_brute(iters, verts, layout, lanes):
    """pt_work's four designs counted lane by lane in plain Python."""
    spp, h, w = iters.shape
    wy, wx = (1, 32) if layout == "row" else (4, 8)
    order = [(y, x) for ty in range(-(-h // wy)) for tx in range(-(-w // wx))
             for y in range(ty * wy, ty * wy + wy) for x in range(tx * wx, tx * wx + wx)]
    seq = []   # each lane's steps in order: True where it shades a vertex
    for y, x in order:
        if y < h and x < w:
            seq.append([k < int(verts[s, y, x]) for s in range(spp)
                        for k in range(int(iters[s, y, x]))])
        else:
            seq.append(None)
    warps = [seq[i:i + 32] for i in range(0, len(seq), 32)]
    live = [[l for l in wp if l is not None] for wp in warps]
    n_v = sum(sum(l) for l in seq if l)
    n_i = sum(len(l) for l in seq if l)
    out = {}

    def per_sample(y, x, s):
        return (int(iters[s, y, x]), int(verts[s, y, x])) if y < h and x < w else (0, 0)

    sv = si = 0
    for i in range(len(warps)):
        px = order[32 * i:32 * i + 32]
        for s in range(spp):
            sv += max(per_sample(y, x, s)[1] for y, x in px)
            si += max(per_sample(y, x, s)[0] for y, x in px)
    out["serial"] = (sv, si)
    rv = ri = 0
    for wp in live:
        k_max = max(len(l) for l in wp)
        ri += k_max
        rv += sum(any(k < len(l) and l[k] for l in wp) for k in range(k_max))
    out["regen"] = (rv, ri)

    def passes(l):
        """a lane's cheap steps in each pass (the last: trailing misses)"""
        c, out_ = 0, []
        for v in l:
            c += 1
            if v:
                out_.append(c)
                c = 0
        return out_ + ([c] if c else [])

    hv = hi = 0
    for wp in live:
        ps = [passes(l) for l in wp]
        hv += max(sum(l) for l in wp)
        n_p = max(len(p) for p in ps)
        hi += sum(max((p[j] if j < len(p) else 0) for p in ps) for j in range(n_p))
    out["hit_loop"] = (hv, hi)
    # the queue: pixels in the layout's order, `lanes` lanes in warps of 32
    pix = [l for l in seq if l is not None]
    lanes = -(-lanes // 32) * 32
    cur = [None] * lanes     # [passes of the pixel, next pass]
    done = [False] * lanes
    nxt = qv = qi = 0
    while not all(done):
        cost = [0] * lanes
        shade = [False] * lanes
        ask = []
        for l in range(lanes):
            if done[l] or (cur[l] is not None and cur[l][1] < sum(cur[l][2])):
                continue
            if cur[l] is not None:
                cost[l] += cur[l][0][-1] if len(cur[l][0]) > sum(cur[l][2]) else 0
            ask.append(l)
        while ask:           # the asking lanes take a pixel each in lane order, again
            again = []       # for those whose pixel shades nothing
            for l in ask:
                if nxt >= len(pix):
                    done[l] = True
                    continue
                p = pix[nxt]
                nxt += 1
                cur[l] = [passes(p), 0, p]
                if not sum(p):
                    cost[l] += len(p)
                    again.append(l)
            ask = again
        for l in range(lanes):
            if not done[l]:
                cost[l] += cur[l][0][cur[l][1]]
                cur[l][1] += 1
                shade[l] = True
        qv += sum(any(shade[i:i + 32]) for i in range(0, lanes, 32))
        qi += sum(max(cost[i:i + 32]) for i in range(0, lanes, 32))
    out["queue"] = (qv, qi)
    return n_v, n_i, out


@pytest.mark.parametrize("layout", ["row", "8x4"])
def test_pt_work_counts(layout):
    """pt_work's counts at 32x32 (rows of 32 and 8x4 warps, and a queue of
    64 lanes) equal a lane-by-lane count, and its vertices those the plain
    lane shades."""
    from forge3d_tpu_torch.pt import adjudication as adj

    w = h = 32
    spp = 3
    work = adj.pt_work(w, h, spp, 7, layout, lanes=64)
    iters, verts = adj.pt_paths(w, h, spp, 7)
    adj._pt_sample.vertices = 0
    adj.pt_lane_plain(w, h, spp, 7)
    assert work["vertices"] == int(verts.sum()) == adj._pt_sample.vertices
    n_v, n_i, brute = pt_work_brute(iters, verts, layout, 64)
    assert (work["vertices"], work["iterations"]) == (n_v, n_i)
    for name, (v, i) in brute.items():
        assert work[f"{name}_vertex"] == pytest.approx(n_v / (32.0 * v), rel=1e-12), name
        assert work[f"{name}_iter"] == pytest.approx(n_i / (32.0 * i), rel=1e-12), name
        assert work[f"{name}_steps"] == pytest.approx(v / brute["serial"][0], rel=1e-12), name
    assert work["pixels_sky"] > 0 and work["serial_vertex"] < work["hit_loop_vertex"]


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
    """Each launch of the step against its plain stages (the forces with the
    self-advection, the divergence alone and with the first sweep, a sweep
    a launch), then the step's own launches."""
    O, g, k = smoke_case(kernels, jacobi)
    stages = (O.smoke_advect_velocity, O.smoke_divergence, O.smoke_jacobi, O.smoke_project_advect)
    before = [f.launches for f in stages]
    va = O._advect_velocity_kernel(g["velocity"], g["temperature"], k)
    assert torch.equal(va, O._forces_advect_plain(g["velocity"], g["temperature"], k))
    div = O._divergence_kernel(va)
    assert torch.equal(div, O._divergence_plain(va))
    div1, p = O._divergence_kernel(va, k)
    assert torch.equal(div1, div) and torch.equal(p, O._jacobi_plain(None, div, k))
    for _ in range(jacobi - 1):
        got = O._jacobi_kernel(p, div, k)
        assert torch.equal(got, O._jacobi_plain(p, div, k))
        p = got
    p = p if jacobi > 1 else None
    args = (va, p, g["density"], g["temperature"], g["soot"], g["emission"], k)
    for a, b in zip(O._project_advect_kernel(*args), O._project_advect_plain(*args)):
        assert torch.equal(a, b)
    if jacobi == 1:   # the step's form: the one sweep inside the projection
        args = (va, None, *args[2:], div)
        for a, b in zip(O._project_advect_kernel(*args), O._project_advect_plain(*args)):
            assert torch.equal(a, b)
    # the whole step's launches on the kernels' device
    grids = [g[n] for n in ("density", "velocity", "temperature", "soot", "emission")]
    mid = [f.launches for f in stages]
    out = O._step_kernel(*grids, k)
    ref = O.smoke_step_plain(*grids, k)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    after = [f.launches for f in stages]
    levels = O.jacobi_attrs()["levels"]
    assert [m - b for m, b in zip(mid, before)] == [
        1, 2, max(jacobi - 1, 0), 1 + int(jacobi == 1)]
    assert [a - m for a, m in zip(after, mid)] == [
        1, int(jacobi > 0), -(-(jacobi - 1) // levels) if jacobi > 1 else 0, 1]
    assert sum(after) - sum(mid) == O.step_launches(jacobi, levels)


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


def march_gate(O, g, m):
    """E8 march through the kernel wrapper against the plain march (which
    marches every pixel): within one u8 step on >= 99.9% of pixels equal,
    and every pixel whose ray misses the box equal. Returns the flag of the
    skip's check (0: the misses were skipped)."""
    got = O._march_kernel(g["density"], g["emission"], g["soot"], m)
    ref = O.smoke_march_plain(g["density"], g["emission"], g["soot"], m)
    d = (got.int() - ref.int()).abs().amax(-1)
    assert got.shape == ref.shape == (m.args["height"], m.args["width"], 4)
    assert int(d.max()) <= 1 and float((d == 0).double().mean()) >= 0.999
    miss = ~O.march_entered(m, got.device)
    assert torch.equal(got[miss], ref[miss])
    return int(O.smoke_march.last_bad)


def march_settings():
    from forge3d_tpu_torch.smoke import SmokeRenderSettings

    return SmokeRenderSettings(step_count=24, sun_steps=5)


def test_smoke_march_kernel_skips_the_misses(kernels):
    """A frame that mostly misses the box: the misses take the skip."""
    O, g, _ = smoke_case(kernels, 0)
    m = O.march_setup((12, 10, 14), (2.0, 1.5, 3.0), (-1.0, 0.5, 2.0), 48, 32, march_settings(),
                      (13.0, 8.0, 110.0), (13.0, 8.0, 20.0), 45.0)
    entered = float(O.march_entered(m, kernels).double().mean())
    assert 0.02 < entered < 0.5
    assert march_gate(O, g, m) == 0


@pytest.mark.parametrize("grid,value", [("density", -0.5), ("emission", float("inf")),
                                        ("soot", float("nan"))],
                         ids=["negative_density", "infinite_emission", "nan_soot"])
def test_smoke_march_kernel_marches_every_pixel_on_bad_values(kernels, grid, value):
    """One voxel outside the skip's bounds: every pixel marches, and the
    result still agrees with the plain march (NaN soot keeps jnp.clip's NaN)."""
    O, g, _ = smoke_case(kernels, 0)
    g[grid][6, 5, 7] = value
    m = O.march_setup((12, 10, 14), (2.0, 1.5, 3.0), (-1.0, 0.5, 2.0), 40, 30, march_settings(),
                      (14.0, 12.0, 90.0), (13.0, 7.0, 20.0), 45.0)
    assert march_gate(O, g, m) == 1


def test_smoke_march_kernel_ragged_tiles(kernels):
    """A frame of 37x23 pixels, no multiple of the 8x4 warp or 16x16 block tile."""
    O, g, _ = smoke_case(kernels, 0)
    m = O.march_setup((12, 10, 14), (2.0, 1.5, 3.0), (-1.0, 0.5, 2.0), 37, 23, march_settings(),
                      (14.0, 12.0, 90.0), (13.0, 7.0, 20.0), 45.0)
    assert march_gate(O, g, m) == 0
    with pytest.raises(ValueError, match="grids must be"):
        O._march_kernel(g["density"], g["emission"][:-1], g["soot"], m)


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


# C1 entropy on synthetic pages, bit for bit against the plain chain: the
# staged chain's ring wraps several times a tile (up to ~100 KB of stream,
# 1- and 2-pull steps from symbols of frequency 1), rows hold bytes past
# `len`, and the escapes' extras (1,000 or more) decode to residuals no
# symbol gives, so |d| >= 500 marks an escape
def rans_freq(rng, esc):
    w = rng.gamma(0.3, size=255)
    f = np.floor(w / w.sum() * (4096 - esc - 255)).astype(np.int64) + 1
    f[np.argmax(f)] += 4096 - esc - int(f.sum())
    return np.concatenate([f, [esc]]).astype(np.int32)


RANS_CASES = {   # per tile: (stream length, escape frequency, first two bytes), ecap
    "general": ([(90000, 40, (0x00, 0x3F))], 8),         # first state under 2^23
    "short": ([(3, 100, (0x91, 0x07))], 4),               # len 3, bytes past it
    "clamped": ([(100000, 1500, None)], 3),               # far more escapes than ecap
    "last_escape": ([(100000, 3000, None)], 64),          # the last token an escape
    "two_tiles": ([(90000, 200, None), (20000, 600, None)], 16),
}


def rans_case(name):
    tiles, ecap = RANS_CASES[name]
    rng = np.random.default_rng(sorted(RANS_CASES).index(name) + 17)
    cap = -(-max(n for n, _, _ in tiles) // 4) * 4 + 8
    stream = rng.integers(0, 256, (len(tiles), cap), dtype=np.uint8)
    lens = np.array([n for n, _, _ in tiles], np.int32)
    freq = np.stack([rans_freq(rng, esc) for _, esc, _ in tiles])
    for t, (_, _, first) in enumerate(tiles):
        if first is not None:
            stream[t, :2] = first
        else:
            stream[t, 0] |= 0x80
    extras = rng.integers(1000, 2 ** 31, (len(tiles), ecap), dtype=np.int64).astype(np.int32)
    return tuple(torch.as_tensor(a) for a in (stream, lens, freq, extras))


def rans_first_state(stream, lens, t):
    row = stream[t].tolist()
    return sum((row[i] if i < int(lens[t]) else 0) << (24 - 8 * i) for i in range(4))


@pytest.mark.parametrize("name", sorted(RANS_CASES))
def test_rans_kernel_cases(kernels, name):
    from forge3d_tpu_torch.codec import f3dz_device as fd

    args = rans_case(name)
    ref = fd.rans_decode_plain(*args)
    first = rans_first_state(args[0], args[1], 0)
    assert (first < 1 << 23) == (name == "general")
    esc = ref.abs() >= 500
    if name in ("clamped", "last_escape"):
        assert int(esc[0].sum()) > args[3].shape[1]
    if name == "last_escape":
        assert bool(esc[0, -1])
    before = fd.rans_decode.launches
    got = fd._rans_kernel(*(a.to(kernels) for a in args))
    assert torch.equal(got.cpu(), ref)
    assert fd.rans_decode.launches == before + 1


@pytest.mark.parametrize("name", sorted(RANS_CASES))
def test_rans_chain_first_order(host_lib, name):
    """The staged loop with each iteration's chain chunk run before the
    helpers' fill and drain decodes as the other order does: the ring's
    fill is ready a chunk ahead and never overwrites a word the chain reads."""
    from forge3d_tpu_torch.codec import f3dz_device as fd

    stream, lens, freq, extras = rans_case(name)
    out = torch.empty((stream.shape[0], fd.TILE * fd.TILE), dtype=torch.int32)
    fn = host_lib.f3d_test_rans_chain_first
    fn.restype = None
    fn(*(ctypes.c_void_p(a.data_ptr()) for a in (stream, lens)), ctypes.c_int(stream.shape[1]),
       ctypes.c_void_p(freq.data_ptr()), ctypes.c_void_p(extras.data_ptr()),
       ctypes.c_int(extras.shape[1]), ctypes.c_int(stream.shape[0]),
       ctypes.c_void_p(out.data_ptr()))
    assert torch.equal(out, fd.rans_decode_plain(stream, lens, freq, extras))


# K5: rays given as an image in 8x4 warp tiles, flat sets in order, every
# ray traced once; the level table in registers (LevelCursor) equal to the
# pyramid's on every level; the cell divisions as exact multiplies where
# the spacings are powers of two. The host twin runs the kernel's body in
# the blocks' and threads' order; against the parent design's body (the
# table from memory, the divisions) bit for bit, and the plain trace.
def k5_case(device, shape, spacing=1.0, n=65, seed=4):
    """(scene, ro, rd) over a sine DEM of n^2: an image's camera rays for a
    2-D shape, random rays for any other."""
    y, x = np.mgrid[0:n[0], 0:n[1]].astype(np.float32) if isinstance(n, tuple) else \
        np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (6.0 * np.sin(x * 0.15) * np.cos(y * 0.12)).astype(np.float32)
    scene = tv.scene_from_pyramid(tr.build_pyramid(dem), spacing_xz=(spacing, spacing),
                                  device=device)
    w, h = dem.shape[1] * spacing, dem.shape[0] * spacing
    rng = np.random.default_rng(seed)
    if len(shape) == 2:
        H, W = shape
        u, v = np.meshgrid(np.linspace(-0.5, 0.5, W), np.linspace(-0.25, 0.25, H))
        o = np.broadcast_to(np.float32([w * 0.5, 25.0, -h * 0.2]), (H, W, 3))
        look = np.float32([0.0, -25.0, h * 0.7])
        d = (look / np.linalg.norm(look) + np.stack([u, v, 0 * u], -1)).astype(np.float32)
    else:
        o = rng.uniform([-5, 7, -5], [w + 5, 16, h + 5], (*shape, 3)).astype(np.float32)
        d = rng.standard_normal((*shape, 3)).astype(np.float32)
        d[..., 1] = -np.abs(d[..., 1])
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
    ro = tuple(torch.as_tensor(np.array(o[..., k]), device=device) for k in range(3))
    rd = tuple(torch.as_tensor(np.array(d[..., k]), device=device) for k in range(3))
    return scene, ro, rd


def hit_bits(h):
    return [h.hit.cpu(), h.t.cpu().view(torch.int32), h.cell_x.cpu(), h.cell_z.cpu()]


def same_hits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(hit_bits(a), hit_bits(b)))


K5_SHAPES = [(21, 37), (4, 8), (16, 16), (33, 200), (3, 40), (40, 7), (97,), (2, 3, 5), (0,),
             (0, 12)]


@pytest.mark.parametrize("shape", K5_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_trace_layouts(kernels, shape):
    """K5 through its wrapper on images whose edges fall inside a tile, on
    shapes too small for a warp's tile (traced in order), on flat and empty
    sets: every output the plain trace's, bit for bit."""
    scene, ro, rd = k5_case(kernels, shape)
    tiles = tv.ray_image_width(shape)
    assert bool(tiles) == (len(shape) == 2 and shape[0] >= 4 and shape[1] >= 8)
    got = tv._trace_kernel(scene, ro, rd, 1e-3, 1e30)
    ref = tv.trace_plain(scene.to("cpu"), tuple(c.cpu() for c in ro), tuple(c.cpu() for c in rd))
    assert got.hit.shape == tuple(shape)
    assert same_hits(got, ref)
    if ro[0].numel():
        assert int(ref.hit.sum()) > 0


@pytest.mark.parametrize("spacing", [1.0, 0.5, 2.0, 0.7])
def test_trace_spacings(kernels, spacing):
    """K5 through its wrapper at power-of-two spacings (the multiplies) and
    at 0.7 (the divisions): the plain trace's outputs, bit for bit."""
    scene, ro, rd = k5_case(kernels, (24, 40), spacing=spacing, n=(40, 57))
    got = tv._trace_kernel(scene, ro, rd, 1e-3, 1e30)
    ref = tv.trace_plain(scene.to("cpu"), tuple(c.cpu() for c in ro), tuple(c.cpu() for c in rd))
    assert same_hits(got, ref)
    assert int(ref.hit.sum()) > 0


@pytest.mark.parametrize("shape", [(21, 37), (4, 8), (33, 200), (97,), (0,)],
                         ids=lambda s: "x".join(map(str, s)))
def test_trace_tiles_visit_every_ray_once(host_lib, monkeypatch, shape):
    monkeypatch.setattr(_kernels, "require_cuda", lambda name, *t: None)
    scene, ro, rd = k5_case("cpu", shape)
    n = ro[0].numel()
    out = [torch.zeros(n, dtype=torch.uint8), torch.zeros(n), torch.zeros(n, dtype=torch.int32),
           torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)]
    fn = host_lib.f3d_test_trace_visits
    fn.restype = None
    fn(ctypes.byref(scene.kernel_args()), *(_kernels.ptr(c.reshape(-1)) for c in (*ro, *rd)),
       ctypes.c_int(n), ctypes.c_int(tv.ray_image_width(shape)), *(_kernels.ptr(o) for o in out))
    assert torch.equal(out[4], torch.ones(n, dtype=torch.int32))


@pytest.mark.parametrize("dem", [(1025, 1025), (77, 300), (300, 77), (2, 2), (2, 9), (65, 33)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
def test_level_cursor_is_the_level_table(host_lib, dem):
    """The register cursor's node index equals level_offset[L] +
    nz * level_w[L] + nx on every level, walked down to 0 and back up."""
    pyr = tr.build_pyramid(np.zeros(dem, np.float32))
    rng = np.random.default_rng(dem[0] * 7 + dem[1])
    levels = (ctypes.c_int * 64)()
    index = (ctypes.c_int * 64)()
    fn = host_lib.f3d_test_level_cursor
    fn.restype = ctypes.c_int
    for nx, nz in [(0, 0), (pyr.cell_w - 1, pyr.cell_h - 1),
                   *rng.integers(0, [pyr.cell_w, pyr.cell_h], (6, 2)).tolist()]:
        v = fn(pyr.cell_w, pyr.cell_h, int(nx), int(nz), levels, index)
        assert v == 2 * pyr.mip_count - 1
        for lv, got in zip(levels[:v], index[:v]):
            assert got == pyr.level_offset[lv] + (nz >> lv) * pyr.level_w[lv] + (nx >> lv)


def test_scene_refuses_another_level_table():
    pyr = tr.build_pyramid(np.zeros((77, 300), np.float32))
    bad = dataclasses.replace(pyr, level_w=pyr.level_w + 1)
    with pytest.raises(ValueError, match="level table"):
        tv.scene_from_pyramid(bad, device="cpu")


@pytest.mark.parametrize("spacing", [1.0, 0.5, 2.0, 0.7])
@pytest.mark.parametrize("shape", [(24, 40), (500,)], ids=["image", "flat"])
def test_trace_spacings_bit_for_bit(host_lib, monkeypatch, spacing, shape):
    """K5 on the host twin at power-of-two spacings (the multiplies) and at
    0.7 (the divisions), against the parent design's body (the level table
    from memory, the divisions) and the plain trace, bit for bit."""
    monkeypatch.setattr(_kernels, "lib", lambda: host_lib)
    monkeypatch.setattr(_kernels, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    scene, ro, rd = k5_case("cpu", shape, spacing=spacing, n=(40, 57))
    got = tv._trace_kernel(scene, ro, rd, 1e-3, 1e30)
    n = ro[0].numel()
    parent = tv.HitResult(torch.zeros(n, dtype=torch.bool), torch.zeros(n),
                          torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32))
    host_lib.f3d_test_trace_table(ctypes.byref(scene.kernel_args()),
                                  *(_kernels.ptr(c.reshape(-1)) for c in (*ro, *rd)),
                                  ctypes.c_int(n), ctypes.c_float(1e-3), ctypes.c_float(1e30),
                                  *(_kernels.ptr(o) for o in (parent.hit, parent.t, parent.cell_x,
                                                              parent.cell_z)))
    flat = tv.HitResult(*(a.reshape(-1) for a in (got.hit, got.t, got.cell_x, got.cell_z)))
    assert same_hits(flat, parent)
    assert same_hits(got, tv.trace_plain(scene, ro, rd))
    assert int(got.hit.sum()) > n // 10


# C1 reconstruction: the wavefront's twin (codec.cu:med_kernel's warps as
# state machines, their steps interleaved three ways, the copies landing
# late, the rings and edge rows poisoned) against the serial twin and the
# plain version, bit for bit, on random residuals: int32 wrap-around, one
# tile, and pages of several rows and columns of tiles
def med_residuals(kind, ntx, nty, seed=5):
    rng = np.random.default_rng(seed)
    n = (ntx * nty, 256 * 256)
    if kind == "wrap":
        d = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
    elif kind == "small":
        d = rng.integers(-40, 41, n)
    else:   # "mixed": mostly small, a few near the int32 limits
        d = rng.integers(-3, 4, n)
        big = rng.random(n) < 0.01
        d[big] = rng.choice([2 ** 31 - 1, -2 ** 31, 2 ** 30], int(big.sum()))
    return torch.as_tensor(d.astype(np.int32))


MED_CASES = {"wrap_1x1": ("wrap", 1, 1), "mixed_3x2": ("mixed", 3, 2),
             "small_2x3": ("small", 2, 3)}


def med_host(host_lib, name, d, ntx, nty, step, *extra):
    out = torch.full((nty * 256, ntx * 256), float("nan"))
    fn = getattr(host_lib, name)
    fn.restype = None
    fn(_kernels.ptr(d), ctypes.c_int(ntx * nty), ctypes.c_int(ntx), ctypes.c_int(ntx * 256),
       ctypes.c_double(step), _kernels.ptr(out), *(ctypes.c_int(e) for e in extra))
    return out


@pytest.mark.parametrize("case", list(MED_CASES))
def test_med_wavefront_twin(host_lib, case):
    """The wavefront in each of three interleavings of its warps, with its
    copies landing late and early, equals the serial recurrence and the
    plain version, bit for bit."""
    from forge3d_tpu_torch.codec import f3dz_device as fd

    kind, ntx, nty = MED_CASES[case]
    d, step = med_residuals(kind, ntx, nty), 0.037
    ref = fd.med_reconstruct_plain(d, ntx, nty, step)
    assert torch.equal(med_host(host_lib, "f3d_test_med_serial", d, ntx, nty, step).view(
        torch.int32), ref.view(torch.int32))
    for order in range(6):
        got = med_host(host_lib, "f3d_test_med_order", d, ntx, nty, step, order)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), order


def test_med_period_slots(host_lib):
    """The kernel's ring column at step s of period c is the lane's
    column's med_slot, and its handoffs fall at their last columns, for
    every live (c, s, lane)."""
    host_lib.f3d_test_med_period_slots.restype = ctypes.c_int
    assert host_lib.f3d_test_med_period_slots() == 0


@pytest.mark.parametrize("case", list(MED_CASES))
def test_med_reconstruct_kernel(kernels, case):
    """C1 reconstruction through its wrapper (the twin on the host, the
    kernel on the card) against the plain version, bit for bit."""
    from forge3d_tpu_torch.codec import f3dz_device as fd

    kind, ntx, nty = MED_CASES[case]
    d, step = med_residuals(kind, ntx, nty, seed=6), 0.25
    before = fd.med_reconstruct.launches
    got = fd._med_kernel(d.to(kernels), ntx, nty, step)
    assert fd.med_reconstruct.launches == before + 1
    ref = fd.med_reconstruct_plain(d, ntx, nty, step)
    assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))
