// forge3d_tpu_torch/csrc/vector.cuh
// Per-pixel device code of the vector coverage kernel E4
// (forge3d_tpu/vector/coverage.py: stroke_coverage 53, disc_coverage 73,
// polygon_coverage 90) and of VectorScene.render's composite
// (forge3d_tpu/vector/__init__.py:140-156). Float32, in the JAX functions'
// operation order, so that vector.cu's kernel agrees bit for bit with the
// plain PyTorch versions in vector/coverage.py. XLA compiles each coverage
// function's scan body with every a*b + c contracted into one fused
// multiply-add; the same sums are written here as explicit fmaf (kept under
// -fmad=false), so the coverage is also bit for bit the JAX package's on the
// CPU. The composite runs in JAX as separate eager operations, unfused.
//
// One pixel keeps the least distance over a layer's primitives and, for a
// polygon, its winding count. Strokes and polygon edges keep the least
// SQUARED distance and take one square root at the end: sqrtf is correctly
// rounded, so it is monotone, and the square root of the least square is the
// least square root, bit for bit. Minimum and maximum propagate NaN as
// jnp.minimum, jnp.maximum and torch.minimum do.

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

// One layer's constants; built by the launcher from its scalar arguments.
struct VectorArgs {
    int width, height;
    int n;         // primitives: segments, discs or ring edges
    int kind;      // F3D_VEC_*
    int evenodd;   // polygon fill rule: 1 even-odd, 0 non-zero
    int pick_id;
    float half;    // stroke half width, float32(stroke_width * 0.5)
    float opacity;
    float color[3];
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

template <int KIND>
F3D_HD void cover_init(CoverState& s) {
    s.d = KIND == F3D_VEC_DISC ? 1e30f : INFINITY;
    s.winding = 0;
}

// One primitive (p0, p1, p2, p3): a segment or edge (x1, y1, x2, y2), or a
// disc (cx, cy, r, unused).
template <int KIND>
F3D_HD void cover_step(float px, float py, float p0, float p1, float p2, float p3,
                       CoverState& s) {
    if (KIND == F3D_VEC_DISC) {
        const float dx = px - p0;
        const float dy = py - p1;
        s.d = vec_min(s.d, sqrtf(fmaf(dx, dx, dy * dy)) - p2);
    } else {
        s.d = vec_min(s.d, seg_dist2(px, py, p0, p1, p2, p3));
        if (KIND == F3D_VEC_POLYGON) s.winding += edge_crossing(px, py, p0, p1, p2, p3);
    }
}

// Coverage in [0, 1] from the pixel's state: the signed distance to the
// shape's boundary through a one-pixel ramp.
template <int KIND>
F3D_HD float cover_final(const VectorArgs& a, const CoverState& s) {
    if (KIND == F3D_VEC_DISC) return vec_clip01(0.5f - s.d);
    const float dmin = vec_min(1e30f, sqrtf(s.d));
    if (KIND == F3D_VEC_STROKE) return vec_clip01(0.5f - (dmin - a.half));
    const bool inside = a.evenodd ? (s.winding & 1) != 0 : s.winding != 0;
    return vec_clip01(0.5f - (inside ? -dmin : dmin));
}

// VectorScene.render's composite of one layer at pixel i, in place.
F3D_HD void composite_pixel(const VectorArgs& a, float cov, int i, float* rgb, float* alpha,
                            int* pick) {
    const float al = cov * a.opacity;
    const float keep = 1.0f - al;
    for (int c = 0; c < 3; ++c) rgb[3 * i + c] = rgb[3 * i + c] * keep + a.color[c] * al;
    alpha[i] = alpha[i] + al * (1.0f - alpha[i]);
    if (cov > 0.5f) pick[i] = a.pick_id;
}

template <int KIND>
F3D_HD float cover_pixel_serial(const VectorArgs& a, const float* prims, int x, int y) {
    const float px = (float)x + 0.5f;
    const float py = (float)y + 0.5f;
    CoverState s;
    cover_init<KIND>(s);
    for (int j = 0; j < a.n; ++j) {
        const float* p = prims + 4 * j;
        cover_step<KIND>(px, py, p[0], p[1], p[2], p[3], s);
    }
    return cover_final<KIND>(a, s);
}

// Pixel (x, y) of one layer, the primitives in order: the serial form of
// vector.cu's kernel (the g++ twin runs it). Writes the coverage to `cov`
// and composites into rgb/alpha/pick, each where not null.
F3D_HD void vector_pixel_serial(const VectorArgs& a, const float* prims, int x, int y,
                                float* cov, float* rgb, float* alpha, int* pick) {
    float c = a.kind == F3D_VEC_DISC      ? cover_pixel_serial<F3D_VEC_DISC>(a, prims, x, y)
              : a.kind == F3D_VEC_POLYGON ? cover_pixel_serial<F3D_VEC_POLYGON>(a, prims, x, y)
                                          : cover_pixel_serial<F3D_VEC_STROKE>(a, prims, x, y);
    const int i = y * a.width + x;
    if (cov != nullptr) cov[i] = c;
    if (rgb != nullptr) composite_pixel(a, c, i, rgb, alpha, pick);
}

F3D_HD VectorArgs make_vector_args(int n, int kind, int width, int height, float half,
                                   int evenodd, const float* color, float opacity,
                                   int pick_id) {
    VectorArgs a;
    a.width = width;
    a.height = height;
    a.n = n;
    a.kind = kind;
    a.evenodd = evenodd;
    a.pick_id = pick_id;
    a.half = half;
    a.opacity = opacity;
    for (int c = 0; c < 3; ++c) a.color[c] = color[c];
    return a;
}
