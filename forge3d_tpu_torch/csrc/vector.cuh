// forge3d_tpu_torch/csrc/vector.cuh
// Per-pixel device code of the vector coverage kernel E4
// (forge3d_tpu/vector/coverage.py: stroke_coverage 53, disc_coverage 73,
// polygon_coverage 90), of VectorScene.render's composite
// (forge3d_tpu/vector/__init__.py:140-156), and of the cull that bins each
// primitive to the 16x16 pixel tiles it can change. Float32, in the JAX
// functions' operation order, so that vector.cu's kernels agree bit for bit
// with the plain PyTorch versions in vector/coverage.py. XLA compiles each
// coverage function's scan body with every a*b + c contracted into one fused
// multiply-add; the same sums are written here as explicit fmaf (kept under
// -fmad=false), so the coverage is also bit for bit the JAX package's on the
// CPU. The composite runs in JAX as separate eager operations, unfused.
//
// One pixel keeps the least distance over a layer's primitives and, for a
// polygon, its winding count. Strokes and polygon edges keep the least
// SQUARED distance and take one square root at the end: sqrtf is correctly
// rounded, so it is monotone, and the square root of the least square is the
// least square root, bit for bit. Minimum and maximum propagate NaN as
// jnp.minimum, jnp.maximum and torch.minimum do. No distance is ever -0
// (a sum of squares is +0 at least, and x - x is +0), so the minimum, like
// the int32 winding sum, is exact in any order: a pixel may take its
// primitives in any order, and only those that can change its result.
//
// THE CULL, AND WHY IT IS EXACT. A tile's pixel centres are px = 16 tx + 0.5
// .. 16 tx + 15.5 and likewise py (the ragged last tile counts its whole 16
// columns and rows: more pixels than it has, which only keeps more). A layer's
// reach R is the distance from which a primitive leaves the coverage where
// the empty state leaves it: R = half + 0.5 for a stroke (then 0.5 - (d -
// half) <= 0), 0.5 for a disc beyond its radius r (0.5 - (d - r) <= 0) and
// for a polygon edge (0.5 -/+ d is <= 0 or >= 1). Every step is a correctly
// rounded float32 operation, so monotone: an exact d >= R gives coverage +0
// (or, inside a polygon, 1) after rounding too.
//   Let M bound the magnitudes of the primitive's coordinates (and r), and
// of the tile's pixel centres (width + 16, height + 16). For a segment the
// kernel forms dx = (px - x1) - t (x2 - x1) for some t in [0, 1] (t is
// clipped, and finite: the denominator is >= 1e-12 and nothing overflows
// below 2^24), which is the offset to a point ON the segment, so its exact
// length is at least the true distance D; the rounding of px - x1, x2 - x1,
// the fma, the squares and the square root moves the float32 distance by
// less than 32 u M (u = 2^-24); a disc's |p - c| - r by less than 8 u M. The
// cull gives every primitive the reach E = R (+ max(r, 0) for a disc) + m,
// m = 1 + M / 2^16 > 256 u M + 1, and drops a primitive from a tile only
// when the box of its coordinates lies more than E from the box of the
// tile's centres in x or in y; then D > R + 1 + 32 u M at every centre, the
// float32 distance is > R, and so: if the pixel's least distance came from a
// dropped primitive, it and the least over the kept ones are both >= R and
// give the same coverage (+0, or 1 inside); if it came from a kept one, the
// two are the same number. The predicate is written "far" (a > b); NaN fails
// it, so nothing with a NaN is dropped by it.
//   A polygon's winding needs the edges that cross the pixel's row to its
// right. An edge crosses row y (py = y + 0.5, exact) iff min(y1, y2) <= py <
// max(y1, y2), decided exactly, so an edge that crosses no row of the tile
// adds 0 there. One that does cannot be far in y, so it is far in x: wholly
// left of the tile (its crossing xint = fma(t, x2 - x1, x1), t in [0, 1],
// is within 4 u M of [min x, max x], so px < xint fails: 0), or wholly right
// of it (px < xint holds at every centre: +1 for an upward edge, -1 for a
// downward one, on each row it crosses). That is the tile's backdrop: a
// count per row, the same for every pixel of the row.
//   What the argument does not cover goes to every tile and is tested at
// every pixel, as before: a primitive with a coordinate (or radius) that is
// not finite, one above 2^24 in magnitude (1e20 squared overflows float32;
// near it fma(t, x2 - x1, x1) rounds by more than a pixel), and every
// primitive of a layer whose reach is not finite or above 2^24. The tile
// ranges are formed in double from float32 values: their error is below
// 2^-26 px, inside m's slack of 1 px.

#pragma once

#include <math.h>

#ifndef F3D_HD
#ifdef __CUDACC__
#define F3D_HD __host__ __device__ __forceinline__
#else
#define F3D_HD inline
#endif
#endif

enum { F3D_VEC_STROKE = 0, F3D_VEC_DISC = 1, F3D_VEC_POLYGON = 2 };

#define F3D_VEC_TILE 16
#define F3D_VEC_WILD 16777216.0  // 2^24: larger coordinates go to every tile

// One layer of a vector_layers call; mirrored by `pack_layers` in
// vector/coverage.py (12 four-byte words).
struct VecLayer {
    int kind;      // F3D_VEC_*
    int offset;    // first primitive in the concatenated array
    int count;     // primitives: segments, discs or ring edges
    int evenodd;   // polygon fill rule: 1 even-odd, 0 non-zero
    int pick_id;
    int bd_slot;   // polygon: its plane of backdrop counts; otherwise -1
    float half;    // stroke half width, float32(stroke_width * 0.5)
    float opacity;
    float color[3];
    float pad;
};

F3D_HD float vec_min(float a, float b) { return (a < b || a != a) ? a : b; }
F3D_HD float vec_max(float a, float b) { return (a > b || a != a) ? a : b; }
F3D_HD float vec_clip01(float x) { return vec_min(vec_max(x, 0.0f), 1.0f); }

// Squared distance from the pixel centre (px, py) to the segment
// (x1, y1)-(x2, y2): coverage.py:_seg_distance without its square root.
F3D_HD float seg_dist2(float px, float py, float x1, float y1, float x2, float y2) {
    const float vx = x2 - x1;
    const float vy = y2 - y1;
    const float wx = px - x1;
    const float wy = py - y1;
    const float denom = vec_max(fmaf(vx, vx, vy * vy), 1e-12f);
    const float t = vec_clip01(fmaf(wx, vx, wy * vy) / denom);
    const float dx = fmaf(-t, vx, wx);
    const float dy = fmaf(-t, vy, wy);
    return fmaf(dx, dx, dy * dy);
}

// The edge's winding contribution at the pixel centre: the half-open
// crossing test of polygon_coverage (+1 upward, -1 downward, left of the
// crossing only).
F3D_HD int edge_crossing(float px, float py, float x1, float y1, float x2, float y2) {
    const bool up = (y1 <= py) && (y2 > py);
    const bool dn = (y2 <= py) && (y1 > py);
    const float dy = y2 - y1;
    const float t = (py - y1) / (fabsf(dy) > 1e-12f ? dy : 1.0f);
    const float xint = fmaf(t, x2 - x1, x1);
    const bool left = px < xint;
    return ((up && left) ? 1 : 0) - ((dn && left) ? 1 : 0);
}

struct CoverState {
    float d;      // stroke, polygon: least squared distance; disc: least |p-c| - r
    int winding;  // polygon only
};

F3D_HD void cover_init(int kind, CoverState& s) {
    s.d = kind == F3D_VEC_DISC ? 1e30f : INFINITY;
    s.winding = 0;
}

// One primitive (p0, p1, p2, p3): a segment or edge (x1, y1, x2, y2), or a
// disc (cx, cy, r, unused).
F3D_HD void cover_step(int kind, float px, float py, float p0, float p1, float p2, float p3,
                       CoverState& s) {
    if (kind == F3D_VEC_DISC) {
        const float dx = px - p0;
        const float dy = py - p1;
        s.d = vec_min(s.d, sqrtf(fmaf(dx, dx, dy * dy)) - p2);
    } else {
        s.d = vec_min(s.d, seg_dist2(px, py, p0, p1, p2, p3));
        if (kind == F3D_VEC_POLYGON) s.winding += edge_crossing(px, py, p0, p1, p2, p3);
    }
}

// Whether a winding count is inside the polygon under the layer's rule.
F3D_HD int vec_inside(const VecLayer& l, int winding) {
    return l.evenodd ? (winding & 1) != 0 : winding != 0;
}

// Coverage in [0, 1] from the pixel's state: the signed distance to the
// shape's boundary through a one-pixel ramp.
F3D_HD float cover_final(const VecLayer& l, const CoverState& s) {
    if (l.kind == F3D_VEC_DISC) return vec_clip01(0.5f - s.d);
    const float dmin = vec_min(1e30f, sqrtf(s.d));
    if (l.kind == F3D_VEC_STROKE) return vec_clip01(0.5f - (dmin - l.half));
    return vec_clip01(0.5f - (vec_inside(l, s.winding) ? -dmin : dmin));
}

// The coverage of a pixel that no primitive of the layer reaches: the empty
// state's, outside (inside = 0) or inside (1) a polygon; a stroke's and a
// disc's are the same either way. The tiles kernel forms both once a layer.
F3D_HD float cover_empty(const VecLayer& l, int inside) {
    CoverState s;
    cover_init(l.kind, s);
    s.winding = inside;
    return cover_final(l, s);
}

// VectorScene.render's composite of one layer into one pixel's rgb, alpha
// and pick (held by the caller), applied at every coverage, 0 included: it
// is not the identity for -0.0 in rgb, an alpha that is not finite, or an
// opacity outside [0, 1].
F3D_HD void composite_px(const VecLayer& l, float cov, float* rgb, float& alpha, int& pick) {
    const float al = cov * l.opacity;
    const float keep = 1.0f - al;
    for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] * keep + l.color[c] * al;
    alpha = alpha + al * (1.0f - alpha);
    if (cov > 0.5f) pick = l.pick_id;
}

F3D_HD int vec_tiles(int n) { return (n + F3D_VEC_TILE - 1) / F3D_VEC_TILE; }

// The tiles a primitive can change: columns x0..x1 and rows y0..y1 (empty
// when x0 > x1 or y0 > y1), clamped to the grid; x0 unclamped below at
// tiles_x, so that every column left of x0 lies wholly left of the
// primitive (a polygon edge's backdrop). `wild`: every tile.
struct VecRect {
    int x0, x1, y0, y1;
    int wild;
};

F3D_HD double vec_clampd(double v, double lo, double hi) { return v < lo ? lo : (v > hi ? hi : v); }

F3D_HD VecRect vec_prim_rect(const VecLayer& l, float p0, float p1, float p2, float p3, int width,
                             int height) {
    const int tx = vec_tiles(width), ty = vec_tiles(height);
    const bool disc = l.kind == F3D_VEC_DISC;
    const double reach = l.kind == F3D_VEC_STROKE ? (double)l.half + 0.5 : 0.5;
    // the largest magnitude, NaN if any coordinate is NaN (fmax would drop it)
    double mag = (double)(width > height ? width : height) + F3D_VEC_TILE;
    const float q[4] = {p0, p1, p2, disc ? 0.0f : p3};
    for (int k = 0; k < 4; ++k) {
        const double a = fabs((double)q[k]);
        mag = (a > mag || a != a) ? a : mag;
    }
    VecRect r = {0, tx - 1, 0, ty - 1, 1};
    // written so that NaN (a coordinate, r or half) keeps the primitive wild
    if (!(mag <= F3D_VEC_WILD) || !(fabs(reach) <= F3D_VEC_WILD)) return r;
    r.wild = 0;
    const double ext = reach + (disc ? fmax((double)p2, 0.0) : 0.0) + 1.0 + mag / 65536.0;
    const double xlo = disc ? p0 : fmin((double)p0, (double)p2);
    const double xhi = disc ? p0 : fmax((double)p0, (double)p2);
    const double ylo = disc ? p1 : fmin((double)p1, (double)p3);
    const double yhi = disc ? p1 : fmax((double)p1, (double)p3);
    // tile t is far when lo - ext > 16 t + 15.5 (t < q0) or hi + ext < 16 t + 0.5 (t > q1)
    const double tile = (double)F3D_VEC_TILE;
    r.x0 = (int)vec_clampd(ceil((xlo - ext - (tile - 0.5)) / tile), 0.0, tx);
    r.x1 = (int)vec_clampd(floor((xhi + ext - 0.5) / tile), -1.0, tx - 1);
    r.y0 = (int)vec_clampd(ceil((ylo - ext - (tile - 0.5)) / tile), 0.0, ty);
    r.y1 = (int)vec_clampd(floor((yhi + ext - 0.5) / tile), -1.0, ty - 1);
    return r;
}

// The rows lo..hi of the frame that the edge crosses (min y <= y + 0.5 <
// max y, exactly) and its sign w: +1 upward (y1 < y2), -1 downward. False
// when it crosses none.
F3D_HD bool vec_edge_rows(float y1, float y2, int height, int& lo, int& hi, int& w) {
    if (!(y1 != y2)) return false;
    const double ymin = fmin((double)y1, (double)y2), ymax = fmax((double)y1, (double)y2);
    lo = (int)vec_clampd(ceil(ymin - 0.5), 0.0, height);
    hi = (int)vec_clampd(ceil(ymax - 0.5) - 1.0, -1.0, height - 1);
    w = y1 < y2 ? 1 : -1;
    return lo <= hi;
}

// The layer that primitive i belongs to: the last one whose offset is <= i
// (an empty layer shares its offset with the next one).
F3D_HD int vec_layer_of(const VecLayer* table, int n_layers, int i) {
    int lo = 0, hi = n_layers - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (table[mid].offset <= i) lo = mid;
        else hi = mid - 1;
    }
    return lo;
}

// An atomic add on the card; the host build's launchers run one thread at
// a time. Returns the old value.
F3D_HD int vec_atomic_add(int* p, int v) {
#ifdef __CUDA_ARCH__
    return atomicAdd(p, v);
#else
    const int old = *p;
    *p = old + v;
    return old;
#endif
}

// The binning's first pass for primitive i: one count for each (tile,
// layer) pair it can change, and, for a polygon edge, its winding on each
// row it crosses at the tile next left of its tiles (vector_backdrop_row
// sums these from the right).
F3D_HD void vec_count_prim(const VecLayer* table, int n_layers, const float* prims, int i,
                           int width, int height, int* counts, int* backdrop) {
    const int L = vec_layer_of(table, n_layers, i);
    const VecLayer& l = table[L];
    const float* p = prims + 4 * (long long)i;
    const VecRect r = vec_prim_rect(l, p[0], p[1], p[2], p[3], width, height);
    const int tiles_x = vec_tiles(width);
    for (int ty = r.y0; ty <= r.y1; ++ty)
        for (int tx = r.x0; tx <= r.x1; ++tx)
            vec_atomic_add(&counts[(ty * tiles_x + tx) * n_layers + L], 1);
    int lo, hi, w;
    if (l.bd_slot >= 0 && !r.wild && r.x0 > 0 && vec_edge_rows(p[1], p[3], height, lo, hi, w)) {
        int* plane = backdrop + (long long)l.bd_slot * height * tiles_x;
        for (int y = lo; y <= hi; ++y) vec_atomic_add(&plane[y * tiles_x + r.x0 - 1], w);
    }
}

// The scatter for primitive i: itself into each of its tiles' lists, at a
// slot taken by counting the pair's count down (so the counts end at 0; the
// order in a list is free).
F3D_HD void vec_scatter_prim(const VecLayer* table, int n_layers, const float* prims, int i,
                             int width, int height, int* counts, const int* offs,
                             float* entries) {
    const int L = vec_layer_of(table, n_layers, i);
    const float* p = prims + 4 * (long long)i;
    const VecRect r = vec_prim_rect(table[L], p[0], p[1], p[2], p[3], width, height);
    const int tiles_x = vec_tiles(width);
    for (int ty = r.y0; ty <= r.y1; ++ty)
        for (int tx = r.x0; tx <= r.x1; ++tx) {
            const int q = (ty * tiles_x + tx) * n_layers + L;
            float* e = entries + 4 * (long long)(offs[q] + vec_atomic_add(&counts[q], -1) - 1);
            for (int k = 0; k < 4; ++k) e[k] = p[k];
        }
}

// Row j of the backdrop planes: the differences summed from the right, in
// place, so that each tile holds the winding of the edges right of it.
F3D_HD void vec_backdrop_row(int* backdrop, int j, int tiles_x) {
    int* row = backdrop + (long long)j * tiles_x;
    int acc = 0;
    for (int tx = tiles_x - 1; tx >= 0; --tx) {
        acc += row[tx];
        row[tx] = acc;
    }
}

// The binning's entries: (tile, layer) pair p = tile * n_layers + layer
// holds offs[p] .. offs[p + 1] - 1 of `entries` (its primitives, 4 floats
// each, in any order); backdrop[(bd_slot * height + y) * tiles_x + tx] is
// the winding that the edges right of tile tx add on row y.
//
// Pixel (x, y) of tile `tile` over every layer in order: the serial form
// of vector.cu's vector_tiles_kernel (the g++ twin runs it); rgb, alpha and
// pick where rgb is not null, the coverage into `cov` where it is not null
// (one layer).
F3D_HD void vec_pixel_binned(const VecLayer* table, int n_layers, int width, int height,
                             const int* offs, const float* entries, const int* backdrop,
                             int tile, int x, int y, float* cov, float* rgb, float* alpha,
                             int* pick) {
    const int tiles_x = vec_tiles(width);
    const float px = (float)x + 0.5f;
    const float py = (float)y + 0.5f;
    const int i = y * width + x;
    float c3[3] = {0.0f, 0.0f, 0.0f};
    float al = 0.0f;
    int pk = 0;
    if (rgb != nullptr) {
        for (int c = 0; c < 3; ++c) c3[c] = rgb[3 * i + c];
        al = alpha[i];
        pk = pick[i];
    }
    for (int L = 0; L < n_layers; ++L) {
        const VecLayer& l = table[L];
        const int p = tile * n_layers + L;
        const int bd = l.bd_slot < 0 ? 0
                       : backdrop[((long long)l.bd_slot * height + y) * tiles_x + tile % tiles_x];
        float c;
        if (offs[p] == offs[p + 1]) {   // no primitive of the layer reaches the tile
            c = cover_empty(l, vec_inside(l, bd));
        } else {
            CoverState s;
            cover_init(l.kind, s);
            for (int k = offs[p]; k < offs[p + 1]; ++k) {
                const float* e = entries + 4 * (long long)k;
                cover_step(l.kind, px, py, e[0], e[1], e[2], e[3], s);
            }
            s.winding += bd;
            c = cover_final(l, s);
        }
        if (cov != nullptr) cov[i] = c;
        if (rgb != nullptr) composite_px(l, c, c3, al, pk);
    }
    if (rgb != nullptr) {
        for (int c = 0; c < 3; ++c) rgb[3 * i + c] = c3[c];
        alpha[i] = al;
        pick[i] = pk;
    }
}
