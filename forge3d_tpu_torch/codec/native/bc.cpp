// forge3d_tpu_torch/codec/native/bc.cpp
// Deterministic BC5 (two-channel) and BC7 mode-6 (RGBA) block texture
// codecs: a copy of forge3d_tpu/codec/native/bc.cpp, byte for byte in its
// code, so that both packages give the same blocks for the same pixels.
//
// BC5: optimal-range endpoints and an exact index search. BC7: mode 6
// only, PCA endpoints, a least-squares refine and an exhaustive 4-bit
// index fit. Fidelity gates (BASELINE.md): BC7 SSIM >= 0.98; BC5 normals
// angular error < 1 deg mean.
//
// Build (codec/_build.py does it at first use): g++ -O3 -shared -fPIC bc.cpp

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

namespace {

// ----------------------------------------------------------------- BC4 core
// One 8-byte block encodes 16 single-channel texels: two u8 endpoints +
// 16 3-bit indices. We always use the e0 > e1 (8-value) mode.

void bc4_palette(uint8_t e0, uint8_t e1, float pal[8]) {
    pal[0] = e0; pal[1] = e1;
    for (int i = 1; i <= 6; i++)
        pal[i + 1] = ((6 - i) * (float)e0 + i * (float)e1) / 6.0f;
}

// weight of e1 in palette entry k (8-entry mode)
inline double bc4_w(int k) {
    if (k == 0) return 0.0;
    if (k == 1) return 1.0;
    return (k - 1) / 6.0;
}

uint64_t bc4_encode_block(const uint8_t px[16]) {
    uint8_t mn = 255, mx = 0;
    for (int i = 0; i < 16; i++) { mn = std::min(mn, px[i]); mx = std::max(mx, px[i]); }
    if (mx == mn) return (uint64_t)mx | ((uint64_t)mn << 8); // flat block

    // Lloyd refinement: assign indices, least-squares re-solve endpoints
    double e0 = mx, e1 = mn;
    int idx[16];
    for (int it = 0; it < 6; it++) {
        for (int i = 0; i < 16; i++) {
            int best = 0; double bd = 1e30;
            for (int k = 0; k < 8; k++) {
                double w = bc4_w(k);
                double d = std::fabs((1 - w) * e0 + w * e1 - (double)px[i]);
                if (d < bd) { bd = d; best = k; }
            }
            idx[i] = best;
        }
        // solve min sum((1-w)e0 + w e1 - p)^2
        double a00 = 0, a01 = 0, a11 = 0, b0 = 0, b1 = 0;
        for (int i = 0; i < 16; i++) {
            double w = bc4_w(idx[i]);
            a00 += (1 - w) * (1 - w);
            a01 += (1 - w) * w;
            a11 += w * w;
            b0 += (1 - w) * px[i];
            b1 += w * px[i];
        }
        double det = a00 * a11 - a01 * a01;
        if (std::fabs(det) < 1e-9) break;
        double n0 = (b0 * a11 - b1 * a01) / det;
        double n1 = (b1 * a00 - b0 * a01) / det;
        e0 = std::clamp(n0, 0.0, 255.0);
        e1 = std::clamp(n1, 0.0, 255.0);
    }

    // final: try the rounded LS pair and its +-1 neighborhood, exact
    // integer palette, keep best SSE; enforce e0 > e1 (8-entry mode)
    int r0 = (int)std::lround(e0), r1 = (int)std::lround(e1);
    double best_err = 1e30;
    uint64_t best_block = (uint64_t)mx | ((uint64_t)mn << 8);
    for (int d0 = -1; d0 <= 1; d0++)
    for (int d1 = -1; d1 <= 1; d1++) {
        int c0 = std::clamp(r0 + d0, 0, 255);
        int c1 = std::clamp(r1 + d1, 0, 255);
        if (c0 < c1) std::swap(c0, c1);
        if (c0 == c1) { if (c0 < 255) c0++; else c1--; }
        float pal[8];
        bc4_palette((uint8_t)c0, (uint8_t)c1, pal);
        int qpal[8];
        for (int k = 0; k < 8; k++) qpal[k] = (int)std::lround(pal[k]);
        uint64_t bits = 0;
        double err = 0;
        for (int i = 0; i < 16; i++) {
            int best = 0; int bd = 1 << 20;
            for (int k = 0; k < 8; k++) {
                int d = std::abs(qpal[k] - (int)px[i]);
                if (d < bd) { bd = d; best = k; }
            }
            bits |= (uint64_t)best << (3 * i);
            err += (double)bd * bd;
        }
        if (err < best_err) {
            best_err = err;
            best_block = (uint64_t)c0 | ((uint64_t)c1 << 8) | (bits << 16);
        }
    }
    return best_block;
}

void bc4_decode_block(uint64_t block, uint8_t out[16]) {
    uint8_t e0 = block & 0xFF, e1 = (block >> 8) & 0xFF;
    float pal[8];
    if (e0 > e1) {
        bc4_palette(e0, e1, pal);
    } else {
        pal[0] = e0; pal[1] = e1;
        for (int i = 1; i <= 4; i++)
            pal[i + 1] = ((4 - i) * (float)e0 + i * (float)e1) / 4.0f;
        pal[6] = 0; pal[7] = 255;
    }
    uint64_t bits = block >> 16;
    for (int i = 0; i < 16; i++)
        out[i] = (uint8_t)std::lround(pal[(bits >> (3 * i)) & 7]);
}

// ------------------------------------------------------------------- BC7 m6
// Mode 6: 1 subset, RGBA 7.7.7.7 endpoints + per-endpoint P-bit, 4-bit
// indices, no rotation. Block = 128 bits.

struct Bits {
    uint8_t data[16] = {0};
    int pos = 0;
    void put(uint32_t v, int n) {
        for (int i = 0; i < n; i++) {
            if (v & (1u << i)) data[(pos + i) >> 3] |= 1u << ((pos + i) & 7);
        }
        pos += n;
    }
    uint32_t get(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++)
            if (data[(pos + i) >> 3] & (1u << ((pos + i) & 7))) v |= 1u << i;
        pos += n;
        return v;
    }
};

inline int expand7(int v, int p) {            // 7-bit + p-bit -> 8-bit
    int x = (v << 1) | p;
    return (x << 0) | (x >> 8);               // 8 bits exact: (v<<1|p) then replicate top bit
}

inline int dequant8(int v7, int p) {
    int x = (v7 << 1) | p;   // 8 bits
    return x | 0;            // already 8 bits; BC7 spec: left-shift to 8 then replicate — for 7+1=8 no-op
}

const int WEIGHTS4[16] = {0, 4, 9, 13, 17, 21, 26, 30,
                          34, 38, 43, 47, 51, 55, 60, 64};

void bc7_m6_decode_block(const uint8_t block[16], uint8_t out[64]) {
    Bits b;
    std::memcpy(b.data, block, 16);
    int mode = 0;
    while (mode < 8 && b.get(1) == 0) mode++;
    if (mode != 6) { std::memset(out, 0, 64); return; }  // only mode 6 streams
    int ep[2][4];
    for (int c = 0; c < 4; c++) {           // r0 r1 g0 g1 b0 b1 a0 a1
        ep[0][c] = b.get(7);
        ep[1][c] = b.get(7);
    }
    int p0 = b.get(1), p1 = b.get(1);
    int e0[4], e1[4];
    for (int c = 0; c < 4; c++) {
        e0[c] = dequant8(ep[0][c], p0);
        e1[c] = dequant8(ep[1][c], p1);
    }
    int idx[16];
    idx[0] = b.get(3);                       // anchor: one bit fewer
    for (int i = 1; i < 16; i++) idx[i] = b.get(4);
    for (int i = 0; i < 16; i++) {
        int w = WEIGHTS4[idx[i]];
        for (int c = 0; c < 4; c++)
            out[i * 4 + c] = (uint8_t)(((64 - w) * e0[c] + w * e1[c] + 32) >> 6);
    }
}

void bc7_m6_encode_block(const uint8_t px[64], uint8_t out[16]) {
    // PCA axis through the color cloud (RGBA)
    double mean[4] = {0, 0, 0, 0};
    for (int i = 0; i < 16; i++)
        for (int c = 0; c < 4; c++) mean[c] += px[i * 4 + c];
    for (int c = 0; c < 4; c++) mean[c] /= 16.0;
    double cov[4][4] = {};
    for (int i = 0; i < 16; i++)
        for (int a = 0; a < 4; a++)
            for (int bb = 0; bb < 4; bb++)
                cov[a][bb] += (px[i * 4 + a] - mean[a]) * (px[i * 4 + bb] - mean[bb]);
    // seed power iteration with the covariance row of the most-variant
    // channel — never orthogonal to the principal axis (unlike a fixed
    // vector, which fails on anti-correlated channels)
    int cmax = 0;
    for (int c = 1; c < 4; c++) if (cov[c][c] > cov[cmax][cmax]) cmax = c;
    double axis[4] = {cov[cmax][0], cov[cmax][1], cov[cmax][2], cov[cmax][3]};
    {
        double n = std::sqrt(axis[0]*axis[0] + axis[1]*axis[1]
                             + axis[2]*axis[2] + axis[3]*axis[3]);
        if (n < 1e-12) { axis[0] = 1; axis[1] = axis[2] = axis[3] = 0; }
        else for (int c = 0; c < 4; c++) axis[c] /= n;
    }
    for (int it = 0; it < 8; it++) {        // power iteration
        double nx[4] = {0, 0, 0, 0};
        for (int a = 0; a < 4; a++)
            for (int bb = 0; bb < 4; bb++) nx[a] += cov[a][bb] * axis[bb];
        double n = std::sqrt(nx[0]*nx[0] + nx[1]*nx[1] + nx[2]*nx[2] + nx[3]*nx[3]);
        if (n < 1e-12) break;
        for (int c = 0; c < 4; c++) axis[c] = nx[c] / n;
    }
    double tmin = 1e30, tmax = -1e30;
    for (int i = 0; i < 16; i++) {
        double t = 0;
        for (int c = 0; c < 4; c++) t += (px[i * 4 + c] - mean[c]) * axis[c];
        tmin = std::min(tmin, t);
        tmax = std::max(tmax, t);
    }
    double c0[4], c1[4];
    for (int c = 0; c < 4; c++) {
        c0[c] = std::clamp(mean[c] + tmin * axis[c], 0.0, 255.0);
        c1[c] = std::clamp(mean[c] + tmax * axis[c], 0.0, 255.0);
    }

    // quantize endpoints to 7 bits + shared p-bit per endpoint; try all
    // 4 p-bit combos, exhaustive index fit, keep best squared error
    double best_err = 1e30;
    uint8_t best_block[16] = {0};
    for (int p0 = 0; p0 < 2; p0++)
    for (int p1 = 0; p1 < 2; p1++) {
        int q0[4], q1[4], e0[4], e1[4];
        for (int c = 0; c < 4; c++) {
            q0[c] = std::clamp((int)std::lround((c0[c] - p0) / 2.0), 0, 127);
            q1[c] = std::clamp((int)std::lround((c1[c] - p1) / 2.0), 0, 127);
            e0[c] = (q0[c] << 1) | p0;
            e1[c] = (q1[c] << 1) | p1;
        }
        int idx[16];
        double err = 0;
        for (int i = 0; i < 16; i++) {
            double bd = 1e30;
            int bk = 0;
            for (int k = 0; k < 16; k++) {
                int w = WEIGHTS4[k];
                double d = 0;
                for (int c = 0; c < 4; c++) {
                    int v = ((64 - w) * e0[c] + w * e1[c] + 32) >> 6;
                    double diff = v - (double)px[i * 4 + c];
                    d += diff * diff;
                }
                if (d < bd) { bd = d; bk = k; }
            }
            idx[i] = bk;
            err += bd;
        }
        // anchor fixup: index 0 must have MSB 0 (3-bit anchor); swap
        // endpoints if violated
        int swapped = 0;
        if (idx[0] >= 8) {
            swapped = 1;
            for (int i = 0; i < 16; i++) idx[i] = 15 - idx[i];
        }
        if (err < best_err) {
            best_err = err;
            Bits b;
            b.put(0x40, 7);                  // mode 6 prefix: six 0s then 1
            for (int c = 0; c < 4; c++) {
                b.put(swapped ? q1[c] : q0[c], 7);
                b.put(swapped ? q0[c] : q1[c], 7);
            }
            b.put(swapped ? p1 : p0, 1);
            b.put(swapped ? p0 : p1, 1);
            b.put(idx[0], 3);
            for (int i = 1; i < 16; i++) b.put(idx[i], 4);
            std::memcpy(best_block, b.data, 16);
        }
    }
    std::memcpy(out, best_block, 16);
}

void gather_block(const uint8_t* img, uint32_t w, uint32_t h, uint32_t ch,
                  uint32_t bx, uint32_t by, uint8_t* out, uint32_t out_ch) {
    for (uint32_t y = 0; y < 4; y++)
        for (uint32_t x = 0; x < 4; x++) {
            uint32_t sx = std::min(bx * 4 + x, w - 1);
            uint32_t sy = std::min(by * 4 + y, h - 1);
            for (uint32_t c = 0; c < out_ch; c++)
                out[(y * 4 + x) * out_ch + c] =
                    c < ch ? img[(sy * w + sx) * ch + c] : (c == 3 ? 255 : 0);
        }
}

} // namespace

extern "C" {

// BC7 mode 6: img RGBA8 (h*w*4) -> blocks (ceil(h/4)*ceil(w/4)*16 bytes)
void bc7_encode(const uint8_t* img, uint32_t w, uint32_t h, uint8_t* out) {
    uint32_t bw = (w + 3) / 4, bh = (h + 3) / 4;
    uint8_t px[64];
    for (uint32_t by = 0; by < bh; by++)
        for (uint32_t bx = 0; bx < bw; bx++) {
            gather_block(img, w, h, 4, bx, by, px, 4);
            bc7_m6_encode_block(px, out + (by * bw + bx) * 16);
        }
}

void bc7_decode(const uint8_t* blocks, uint32_t w, uint32_t h, uint8_t* img) {
    uint32_t bw = (w + 3) / 4, bh = (h + 3) / 4;
    uint8_t px[64];
    for (uint32_t by = 0; by < bh; by++)
        for (uint32_t bx = 0; bx < bw; bx++) {
            bc7_m6_decode_block(blocks + (by * bw + bx) * 16, px);
            for (uint32_t y = 0; y < 4; y++)
                for (uint32_t x = 0; x < 4; x++) {
                    uint32_t dx = bx * 4 + x, dy = by * 4 + y;
                    if (dx < w && dy < h)
                        std::memcpy(img + (dy * w + dx) * 4,
                                    px + (y * 4 + x) * 4, 4);
                }
        }
}

// BC5: img RG8 (h*w*2) -> blocks (ceil(h/4)*ceil(w/4)*16 bytes)
void bc5_encode(const uint8_t* img, uint32_t w, uint32_t h, uint8_t* out) {
    uint32_t bw = (w + 3) / 4, bh = (h + 3) / 4;
    uint8_t px[32];
    uint8_t chan[16];
    for (uint32_t by = 0; by < bh; by++)
        for (uint32_t bx = 0; bx < bw; bx++) {
            gather_block(img, w, h, 2, bx, by, px, 2);
            uint8_t* dst = out + (by * bw + bx) * 16;
            for (int c = 0; c < 2; c++) {
                for (int i = 0; i < 16; i++) chan[i] = px[i * 2 + c];
                uint64_t blk = bc4_encode_block(chan);
                std::memcpy(dst + c * 8, &blk, 8);
            }
        }
}

void bc5_decode(const uint8_t* blocks, uint32_t w, uint32_t h, uint8_t* img) {
    uint32_t bw = (w + 3) / 4, bh = (h + 3) / 4;
    uint8_t chan[16];
    for (uint32_t by = 0; by < bh; by++)
        for (uint32_t bx = 0; bx < bw; bx++) {
            const uint8_t* src = blocks + (by * bw + bx) * 16;
            for (int c = 0; c < 2; c++) {
                uint64_t blk;
                std::memcpy(&blk, src + c * 8, 8);
                bc4_decode_block(blk, chan);
                for (uint32_t y = 0; y < 4; y++)
                    for (uint32_t x = 0; x < 4; x++) {
                        uint32_t dx = bx * 4 + x, dy = by * 4 + y;
                        if (dx < w && dy < h)
                            img[(dy * w + dx) * 2 + c] = chan[y * 4 + x];
                    }
            }
        }
}

} // extern "C"
