// forge3d_tpu_torch/codec/native/f3dz.cpp
// F3DZ: deterministic error-bounded DEM compression, a copy of
// forge3d_tpu/codec/native/f3dz.cpp, byte for byte in its code, so that both
// packages write the same stream for the same heights and decode it alike.
//
// The contract: quantize heights to a caller-set error bound, MED (LOCO-I)
// prediction, zig-zag residuals, order-0 rANS with per-tile frequency
// tables, CRC32 per tile; decode refuses corrupt pages.
//
// Determinism: encode(heights, max_error) is a pure function of its inputs;
// the byte stream embeds no timestamps or platform state.
//
// Build (codec/_build.py does it at first use): g++ -O3 -shared -fPIC f3dz.cpp

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

constexpr uint32_t MAGIC = 0x5A443346u; // "F3DZ" little-endian
constexpr uint32_t VERSION = 1;
constexpr uint32_t TILE = 256;
constexpr uint32_t PROB_BITS = 12;            // frequency table precision
constexpr uint32_t PROB_SCALE = 1u << PROB_BITS;
constexpr uint32_t RANS_L = 1u << 23;         // renorm lower bound
constexpr uint32_t ESCAPE = 255;              // token for big residuals

// ---------------------------------------------------------------------- CRC32
uint32_t crc32_table[256];
bool crc_init_done = false;

void crc_init() {
    if (crc_init_done) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc32_table[i] = c;
    }
    crc_init_done = true;
}

uint32_t crc32(const uint8_t* data, size_t n) {
    crc_init();
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < n; i++)
        c = crc32_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------------------ bit utils
inline uint32_t zigzag(int64_t v) {
    return (uint32_t)((v << 1) ^ (v >> 63));
}
inline int64_t unzigzag(uint32_t v) {
    return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
}

struct ByteWriter {
    std::vector<uint8_t> buf;
    void u8(uint8_t v) { buf.push_back(v); }
    void u16(uint16_t v) { u8(v & 0xFF); u8(v >> 8); }
    void u32(uint32_t v) { u16(v & 0xFFFF); u16(v >> 16); }
    void f32(float v) { uint32_t u; std::memcpy(&u, &v, 4); u32(u); }
    void f64(double v) { uint64_t u; std::memcpy(&u, &v, 8); u32((uint32_t)u); u32((uint32_t)(u >> 32)); }
    void bytes(const uint8_t* p, size_t n) { buf.insert(buf.end(), p, p + n); }
};

struct ByteReader {
    const uint8_t* p;
    size_t n, pos = 0;
    bool fail = false;
    ByteReader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
    uint8_t u8() { if (pos >= n) { fail = true; return 0; } return p[pos++]; }
    uint16_t u16() { uint16_t a = u8(); return a | ((uint16_t)u8() << 8); }
    uint32_t u32() { uint32_t a = u16(); return a | ((uint32_t)u16() << 16); }
    float f32() { uint32_t u = u32(); float v; std::memcpy(&v, &u, 4); return v; }
    double f64() { uint64_t u = u32(); u |= ((uint64_t)u32()) << 32; double v; std::memcpy(&v, &u, 8); return v; }
};

// ------------------------------------------------------------------- MED pred
inline int64_t med_predict(const int64_t* q, uint32_t w, uint32_t x, uint32_t y) {
    if (x == 0 && y == 0) return 0;
    if (y == 0) return q[x - 1];
    if (x == 0) return q[(y - 1) * w];
    int64_t a = q[y * w + x - 1];        // left
    int64_t b = q[(y - 1) * w + x];      // top
    int64_t c = q[(y - 1) * w + x - 1];  // top-left
    int64_t mx = a > b ? a : b, mn = a > b ? b : a;
    if (c >= mx) return mn;
    if (c <= mn) return mx;
    return a + b - c;
}

// ---------------------------------------------------------------------- rANS
// order-0, 8-bit symbols, static per-tile table normalized to PROB_SCALE.

struct RansTable {
    uint16_t freq[256];
    uint32_t cum[257];
    void build_cum() {
        cum[0] = 0;
        for (int s = 0; s < 256; s++) cum[s + 1] = cum[s] + freq[s];
    }
};

bool normalize_freqs(const uint64_t* counts, RansTable& t) {
    uint64_t total = 0;
    for (int s = 0; s < 256; s++) total += counts[s];
    if (total == 0) return false;
    uint32_t assigned = 0;
    int nonzero = 0;
    for (int s = 0; s < 256; s++) if (counts[s]) nonzero++;
    for (int s = 0; s < 256; s++) {
        if (!counts[s]) { t.freq[s] = 0; continue; }
        uint32_t f = (uint32_t)((counts[s] * PROB_SCALE) / total);
        if (f == 0) f = 1;
        t.freq[s] = (uint16_t)f;
        assigned += f;
    }
    // adjust largest symbol so the table sums exactly to PROB_SCALE
    while (assigned != PROB_SCALE) {
        int big = -1;
        uint32_t bigf = 0;
        for (int s = 0; s < 256; s++)
            if (t.freq[s] > bigf) { bigf = t.freq[s]; big = s; }
        if (big < 0) return false;
        if (assigned > PROB_SCALE) {
            uint32_t over = assigned - PROB_SCALE;
            uint32_t cut = t.freq[big] > over + 1 ? over : t.freq[big] - 1;
            if (cut == 0) return false;
            t.freq[big] -= cut; assigned -= cut;
        } else {
            t.freq[big] += PROB_SCALE - assigned;
            assigned = PROB_SCALE;
        }
    }
    (void)nonzero;
    t.build_cum();
    return true;
}

// encode symbols (reverse order) -> byte stream
void rans_encode(const std::vector<uint8_t>& syms, const RansTable& t,
                 std::vector<uint8_t>& out) {
    uint32_t state = RANS_L;
    std::vector<uint8_t> rev;
    for (size_t i = syms.size(); i-- > 0;) {
        uint8_t s = syms[i];
        uint32_t f = t.freq[s];
        // renormalize: keep state < (RANS_L >> PROB_BITS) * f * 256... use
        // standard condition state >= ((RANS_L >> PROB_BITS) << 8) * f
        uint32_t x_max = ((RANS_L >> PROB_BITS) << 8) * f;
        while (state >= x_max) {
            rev.push_back(state & 0xFF);
            state >>= 8;
        }
        state = ((state / f) << PROB_BITS) + (state % f) + t.cum[s];
    }
    // flush 4 bytes
    for (int k = 0; k < 4; k++) { rev.push_back(state & 0xFF); state >>= 8; }
    out.assign(rev.rbegin(), rev.rend());
}

bool rans_decode(const uint8_t* in, size_t n, const RansTable& t,
                 size_t n_syms, std::vector<uint8_t>& syms) {
    if (n < 4) return false;
    size_t pos = 0;
    uint32_t state = 0;
    for (int k = 0; k < 4; k++) state = (state << 8) | in[pos++];
    // inverse symbol lookup
    std::vector<uint8_t> slot2sym(PROB_SCALE);
    for (int s = 0; s < 256; s++)
        for (uint32_t i = t.cum[s]; i < t.cum[s + 1]; i++) slot2sym[i] = (uint8_t)s;
    syms.resize(n_syms);
    for (size_t i = 0; i < n_syms; i++) {
        uint32_t slot = state & (PROB_SCALE - 1);
        uint8_t s = slot2sym[slot];
        syms[i] = s;
        state = t.freq[s] * (state >> PROB_BITS) + slot - t.cum[s];
        while (state < RANS_L) {
            if (pos >= n) return false;
            state = (state << 8) | in[pos++];
        }
    }
    return true;
}

} // namespace

extern "C" {

// Encode heights (h*w f32) with |err| <= max_error. Returns number of bytes
// written to out (caller provides capacity cap); 0 on failure; if needed
// size > cap, returns needed size as negative.
long long f3dz_encode(const float* heights, uint32_t width, uint32_t height,
                      float max_error, uint8_t* out, long long cap) {
    if (!heights || width == 0 || height == 0 || !(max_error > 0)) return 0;
    // Leave headroom for f32 rounding of the reconstruction q*step: the
    // cast can move the value by up to ulp(|v|)/2 <= |v| * 2^-24, so the
    // quantization half-step must shrink by the data's worst-case ulp.
    double maxabs = 0.0;
    for (size_t i = 0; i < (size_t)width * height; i++) {
        double a = std::fabs((double)heights[i]);
        if (a > maxabs) maxabs = a;
    }
    double slack = maxabs * std::pow(2.0, -23);
    double half = (double)max_error - slack;
    // Fail closed when the requested bound is unachievable in f32 (the
    // decoder reconstructs (float)(q*step), whose rounding alone can exceed
    // max_error) — matching the NaN/Inf refuse-to-encode behavior rather
    // than silently shipping a codec that violates its error contract.
    if (half <= 0) return 0;
    const double step = 2.0 * half;
    ByteWriter w;
    w.u32(MAGIC); w.u32(VERSION);
    w.u32(width); w.u32(height);
    w.f32(max_error); w.f64(step);
    w.u32(TILE);
    const uint32_t ntx = (width + TILE - 1) / TILE;
    const uint32_t nty = (height + TILE - 1) / TILE;
    w.u32(ntx); w.u32(nty);

    std::vector<int64_t> q;
    std::vector<uint8_t> tokens;
    std::vector<uint8_t> extras;

    for (uint32_t ty = 0; ty < nty; ty++) {
        for (uint32_t tx = 0; tx < ntx; tx++) {
            const uint32_t x0 = tx * TILE, y0 = ty * TILE;
            const uint32_t tw = (x0 + TILE <= width) ? TILE : width - x0;
            const uint32_t th = (y0 + TILE <= height) ? TILE : height - y0;
            q.assign((size_t)tw * th, 0);
            bool finite = true;
            for (uint32_t y = 0; y < th && finite; y++)
                for (uint32_t x = 0; x < tw; x++) {
                    double h = heights[(size_t)(y0 + y) * width + x0 + x];
                    if (!std::isfinite(h)) { finite = false; break; }
                    int64_t qi = (int64_t)std::llround(h / step);
                    // exact bound in f32: the decoder reconstructs
                    // (float)(q*step); nudge q if f32 rounding breaks it
                    float recon = (float)((double)qi * step);
                    if ((double)recon - h > (double)max_error) qi--;
                    else if (h - (double)recon > (double)max_error) qi++;
                    q[(size_t)y * tw + x] = qi;
                }
            if (!finite) return 0; // fail-closed: NaN/Inf DEM refuses encode

            tokens.clear(); extras.clear();
            uint64_t counts[256] = {0};
            for (uint32_t y = 0; y < th; y++)
                for (uint32_t x = 0; x < tw; x++) {
                    int64_t pred = med_predict(q.data(), tw, x, y);
                    int64_t delta = q[(size_t)y * tw + x] - pred;
                    // Fail closed if the residual cannot round-trip through
                    // 32-bit zigzag (huge height ranges at tiny max_error).
                    if (delta > (int64_t)INT32_MAX || delta < (int64_t)INT32_MIN)
                        return 0;
                    uint32_t z = zigzag(delta);
                    if (z < ESCAPE) {
                        tokens.push_back((uint8_t)z);
                    } else {
                        tokens.push_back((uint8_t)ESCAPE);
                        for (int k = 0; k < 4; k++)
                            extras.push_back((uint8_t)(z >> (8 * k)));
                    }
                }
            for (uint8_t s : tokens) counts[s]++;
            RansTable table;
            if (!normalize_freqs(counts, table)) return 0;

            std::vector<uint8_t> stream;
            rans_encode(tokens, table, stream);

            // tile record: sizes, freq table (sparse), streams, crc
            ByteWriter tb;
            tb.u32((uint32_t)tokens.size());
            tb.u32((uint32_t)stream.size());
            tb.u32((uint32_t)extras.size());
            uint32_t nz = 0;
            for (int s = 0; s < 256; s++) if (table.freq[s]) nz++;
            tb.u16((uint16_t)nz);
            for (int s = 0; s < 256; s++)
                if (table.freq[s]) { tb.u8((uint8_t)s); tb.u16(table.freq[s]); }
            tb.bytes(stream.data(), stream.size());
            tb.bytes(extras.data(), extras.size());
            uint32_t crc = crc32(tb.buf.data(), tb.buf.size());
            w.u32((uint32_t)tb.buf.size());
            w.u32(crc);
            w.bytes(tb.buf.data(), tb.buf.size());
        }
    }
    long long need = (long long)w.buf.size();
    if (need > cap) return -need;
    std::memcpy(out, w.buf.data(), w.buf.size());
    return need;
}

// Probe header: fills width/height/max_error; returns 1 on ok.
int f3dz_info(const uint8_t* data, long long n, uint32_t* width,
              uint32_t* height, float* max_error) {
    ByteReader r(data, (size_t)n);
    if (r.u32() != MAGIC || r.u32() != VERSION) return 0;
    *width = r.u32(); *height = r.u32();
    *max_error = r.f32();
    return r.fail ? 0 : 1;
}

// Decode into out (width*height f32). Returns 1 ok, 0 failure (corrupt /
// truncated / CRC mismatch — fail-closed, out untouched on failure).
int f3dz_decode(const uint8_t* data, long long n, float* out,
                uint32_t out_w, uint32_t out_h) {
    ByteReader r(data, (size_t)n);
    if (r.u32() != MAGIC || r.u32() != VERSION) return 0;
    uint32_t width = r.u32(), height = r.u32();
    (void)r.f32(); // max_error
    double step = r.f64();
    uint32_t tile = r.u32();
    uint32_t ntx = r.u32(), nty = r.u32();
    if (r.fail || width != out_w || height != out_h || tile == 0) return 0;
    if (ntx != (width + tile - 1) / tile || nty != (height + tile - 1) / tile)
        return 0;

    std::vector<float> result((size_t)width * height);
    std::vector<int64_t> q;
    std::vector<uint8_t> tokens;

    for (uint32_t ty = 0; ty < nty; ty++) {
        for (uint32_t tx = 0; tx < ntx; tx++) {
            uint32_t rec_size = r.u32();
            uint32_t crc_expect = r.u32();
            if (r.fail || r.pos + rec_size > r.n) return 0;
            const uint8_t* rec = r.p + r.pos;
            if (crc32(rec, rec_size) != crc_expect) return 0; // fail-closed
            ByteReader t(rec, rec_size);
            uint32_t n_tokens = t.u32();
            uint32_t stream_size = t.u32();
            uint32_t extra_size = t.u32();
            uint16_t nz = t.u16();
            RansTable table{};
            uint32_t sum = 0;
            for (uint16_t i = 0; i < nz; i++) {
                uint8_t s = t.u8();
                uint16_t f = t.u16();
                table.freq[s] = f;
                sum += f;
            }
            if (t.fail || sum != PROB_SCALE) return 0;
            table.build_cum();
            if (t.pos + stream_size + extra_size > t.n) return 0;
            const uint8_t* stream = t.p + t.pos;
            const uint8_t* extras = stream + stream_size;

            if (!rans_decode(stream, stream_size, table, n_tokens, tokens))
                return 0;

            const uint32_t x0 = tx * tile, y0 = ty * tile;
            const uint32_t tw = (x0 + tile <= width) ? tile : width - x0;
            const uint32_t th = (y0 + tile <= height) ? tile : height - y0;
            if ((size_t)tw * th != n_tokens) return 0;
            q.assign((size_t)tw * th, 0);
            size_t epos = 0;
            for (uint32_t y = 0; y < th; y++)
                for (uint32_t x = 0; x < tw; x++) {
                    uint32_t z = tokens[(size_t)y * tw + x];
                    if (z == ESCAPE) {
                        if (epos + 4 > extra_size) return 0;
                        z = (uint32_t)extras[epos] | ((uint32_t)extras[epos + 1] << 8)
                          | ((uint32_t)extras[epos + 2] << 16)
                          | ((uint32_t)extras[epos + 3] << 24);
                        epos += 4;
                    }
                    int64_t pred = med_predict(q.data(), tw, x, y);
                    q[(size_t)y * tw + x] = pred + unzigzag(z);
                }
            for (uint32_t y = 0; y < th; y++)
                for (uint32_t x = 0; x < tw; x++)
                    result[(size_t)(y0 + y) * width + x0 + x] =
                        (float)(q[(size_t)y * tw + x] * step);
            r.pos += rec_size;
        }
    }
    std::memcpy(out, result.data(), result.size() * sizeof(float));
    return 1;
}

uint32_t f3dz_crc32(const uint8_t* data, long long n) {
    return crc32(data, (size_t)n);
}

} // extern "C"
