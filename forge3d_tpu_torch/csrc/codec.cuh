// forge3d_tpu_torch/csrc/codec.cuh
// Per-tile device code of the F3DZ device decode lane, C1
// (forge3d_tpu/codec/f3dz_device.py:_tile_decoder 46-135): the order-0 rANS
// decode with the escape substitution and the zig-zag step, and the
// MED (LOCO-I) reconstruction with the height scale. Integer arithmetic in
// uint32/int32 with wrap-around, as JAX's uint32 and int32 arrays have it,
// so the residuals and the quantized heights equal JAX's bit for bit.
//
// The height scale is the C++ and Python lanes' `(float)((double)q * step)`
// (native/f3dz.cpp: f3dz_decode; f3dz_pylane.py), one double multiply
// rounded once to float. JAX's device lane forms it as the float32 sum
// qf * step_hi + qf * step_lo, which rounds differently on about one height
// in ten and can break the error bound the encoder promised; the port does
// not carry that over.
//
// The functions are __host__ __device__ so that tests/test_torch_kernels.py
// can build them with g++ and hold them against the plain versions.

#pragma once

#include <stdint.h>

#ifndef __CUDACC__
struct uint2 {     // CUDA's vector type, for the host build of the tests
    uint32_t x, y;
};
#endif

#ifndef F3D_HD
#ifdef __CUDACC__
#define F3D_HD __host__ __device__ __forceinline__
#else
#define F3D_HD inline
#endif
#endif

#define F3DZ_TILE 256                    // native/f3dz.cpp: TILE, every stream's tile
#define F3DZ_TILE_PX (F3DZ_TILE * F3DZ_TILE)
#define F3DZ_PROB_BITS 12                // the frequency tables sum to 2^12
#define F3DZ_PROB_SCALE (1u << F3DZ_PROB_BITS)
#define F3DZ_RANS_LO (1u << 23)          // the renormalisation bound
#define F3DZ_ESCAPE 255u                 // token of a residual carried in the extras

// JAX's zig-zag step: (z >> 1) ^ -(z & 1) in int32.
F3D_HD int32_t unzigzag32(uint32_t z) {
    return (int32_t)(z >> 1) ^ -(int32_t)(z & 1u);
}

// The stream's bytes as the chain reads them: a 64-bit register buffer
// holding the next 4-8 bytes, big-endian and top-aligned, refilled a word
// at a time from a word loaded one refill ahead, so that a step's byte
// pulls never wait on memory (a tile's stream drains at about a byte a
// token). The row's words past `cap` bytes read as zero, and so does every
// byte at or past `len`, as JAX pulls them.
struct ByteBuffer {
    const uint32_t* words;   // the stream's row as little-endian words
    uint32_t len, n_words, next_i, next_w, pos, nbuf;
    uint64_t buf;

    F3D_HD uint32_t word(uint32_t i) const { return i < n_words ? words[i] : 0u; }
    F3D_HD static uint32_t bswap(uint32_t v) {
        return (v >> 24) | ((v >> 8) & 0xFF00u) | ((v << 8) & 0xFF0000u) | (v << 24);
    }
    F3D_HD void init(const uint8_t* stream, uint32_t len_, uint32_t cap) {
        words = reinterpret_cast<const uint32_t*>(stream);
        len = len_;
        n_words = cap / 4u;
        buf = (uint64_t)bswap(word(0)) << 32;
        nbuf = 4u;
        pos = 0u;
        next_i = 1u;
        next_w = word(1);
    }
    // the next four bytes as a big-endian word, those at or past len zero;
    // then top the buffer up to at least four bytes for the next step
    F3D_HD uint32_t peek() const {
        const uint32_t left = len > pos ? len - pos : 0u;
        const uint32_t keep = left >= 4u ? 0xFFFFFFFFu : ~(0xFFFFFFFFu >> (8u * left));
        return (uint32_t)(buf >> 32) & keep;
    }
    F3D_HD void consume(uint32_t j) {
        buf <<= 8u * j;
        nbuf -= j;
        pos += j;
        if (nbuf < 4u) {
            buf |= (uint64_t)bswap(next_w) << (32u - 8u * nbuf);
            nbuf += 4u;
            next_w = word(++next_i);
        }
    }
};

// The number of JAX's four conditional byte pulls a state takes (pull
// while the state is under 2^23), from the 64-bit concatenation of the
// state and the next four bytes: after j pulls the state is x >> (32 - 8j),
// which is 2^23 or more exactly when x's top set bit is at 55 - 8j or above.
F3D_HD uint32_t pulls(uint64_t x) {
#ifdef __CUDA_ARCH__
    const int msb = 63 - __clzll((long long)x);
#else
    const int msb = x ? 63 - __builtin_clzll(x) : -1;
#endif
    const int j = (55 - msb + 7) >> 3;
    return (uint32_t)(j < 0 ? 0 : (j > 4 ? 4 : j));
}

// The tile's whole rANS chain with the general step, one token a step
// (JAX's rans_step under lax.scan): decode the slot (rans_fill_fast's
// tables), at most four byte pulls to bring the state back over 2^23, an
// escape takes extras[min(n_esc, ecap - 1)]; each token is written to d as
// its zig-zag-decoded residual. rans_kernel runs it for a tile whose first
// state is under 2^23 (rans_fast_step's comment). The pulls are counted
// from the top set bit, the bytes come from the register buffer and an
// escape's extra is loaded an escape ahead. `stream` is the tile's row of
// `cap` bytes, a multiple of 4, 4-byte aligned.
F3D_HD void rans_chain(const uint2* tab, const uint8_t* sym, const uint8_t* stream, uint32_t len,
                       uint32_t cap, const uint32_t* extras, int ecap, int n_tokens, int32_t* d) {
    ByteBuffer in;
    in.init(stream, len, cap);
    uint32_t state = in.peek();
    in.consume(4u);
    uint32_t n_esc = 0u;
    const uint32_t last = (uint32_t)(ecap - 1);
    uint32_t extra = extras[0];
    for (int i = 0; i < n_tokens; ++i) {
        const uint32_t next = in.peek();
        const uint32_t slot = state & (F3DZ_PROB_SCALE - 1u);
        const uint2 e = tab[slot];
        const uint32_t s = sym[slot];
        state = e.x * (state >> F3DZ_PROB_BITS) + e.y;
        const uint64_t x = ((uint64_t)state << 32) | next;
        const uint32_t j = pulls(x);
        state = (uint32_t)(x >> (32u - 8u * j));
        in.consume(j);
        const bool esc = s == F3DZ_ESCAPE;
        d[i] = unzigzag32(esc ? extra : s);
        n_esc += esc ? 1u : 0u;
        if (esc) extra = extras[n_esc < last ? n_esc : last];
    }
}

// ---------------------------------------------------------------------------
// The staged chain (rans_kernel's fast path). Once the state is 2^23 or
// more at a step's start, the new state freq * (x >> 12) + slot - cum is
// 2^11 or more, so two byte pulls always bring it back over 2^23: every step
// takes 0, 1 or 2 pulls, decided by two compares on the 32-bit state, and
// the state stays 2^23 or more. A stream whose first state is at least 2^23
// (every encoder's flushed state is) runs this step from its first token;
// any other takes rans_chain's general step.
//
// The stream comes from a ring in shared memory, which the block's helper
// threads fill ahead of the chain: entry i holds the stream's big-endian
// words i and i + 1, zero at and past `len`, so one 64-bit load gives any
// four bytes. The chain keeps the next 8 bytes in two registers and loads
// the 4 after them beside each step. Its symbols go to a ring of bytes,
// F3DZ_CHUNK tokens a chunk; the helpers substitute the escapes, zig-zag
// decode and store them a chunk behind the chain.
// ---------------------------------------------------------------------------

#define F3DZ_CHUNK 2048u                  // tokens a chunk (divides 65,536)
#define F3DZ_RING_WORDS 4096u             // the stream ring's entries (a power of two)

// The tile's stream word w (bytes 4w .. 4w + 3) as a big-endian word, the
// bytes at or past len zero, as JAX pulls them. `row` is `cap` bytes, 4-byte
// aligned, cap a multiple of 4.
F3D_HD uint32_t rans_stream_word(const uint8_t* row, uint32_t len, uint32_t cap, uint32_t w) {
    const uint32_t b = 4u * w;
    if (b >= len || b >= cap) return 0u;
    const uint32_t v = ByteBuffer::bswap(reinterpret_cast<const uint32_t*>(row)[w]);
    return len - b >= 4u ? v : v & ~(0xFFFFFFFFu >> (8u * (len - b)));
}

// The ring's entry for word w: words w and w + 1
F3D_HD uint2 rans_ring_entry(const uint8_t* row, uint32_t len, uint32_t cap, uint32_t w) {
    uint2 e;
    e.x = rans_stream_word(row, len, cap, w);
    e.y = rans_stream_word(row, len, cap, w + 1u);
    return e;
}

// The end (exclusive) of the ring's fill that covers the next chunk, for a
// chunk that starts at byte `pos`: the next chunk starts at most
// 2 * F3DZ_CHUNK bytes on and reads the entries of the words up to
// 2 * F3DZ_CHUNK + 6 bytes past its start (rans_fast_step's look-ahead).
F3D_HD uint32_t rans_fill_end(uint32_t pos) { return (pos + 4u * F3DZ_CHUNK + 6u) / 4u + 1u; }

// The top 32 bits of (hi:lo) << (sh mod 32): __funnelshift_l
F3D_HD uint32_t rans_funnel(uint32_t lo, uint32_t hi, uint32_t sh) {
#ifdef __CUDA_ARCH__
    return __funnelshift_l(lo, hi, sh);
#else
    const uint32_t s = sh & 31u;
    return s ? (hi << s) | (lo >> (32u - s)) : hi;
#endif
}

// The fast chain's registers: the state, the byte offset of its slot's
// entry in the table ((x & 0xfff) * 8), the stream's next 8 bytes (hi
// first) and the position of hi's first byte, in bits.
struct RansFast {
    uint32_t x, off, hi, lo, pb;
};

// The table offset of the state whose top 32 bits (hi:nx) << sh gives
F3D_HD uint32_t rans_slot_off(uint32_t hi, uint32_t nx, uint32_t sh) {
    return rans_funnel(hi, nx, sh + 3u) & ((F3DZ_PROB_SCALE - 1u) << 3);
}

// One token: the slot's (freq, slot - cum) from `tab` (a byte-addressed
// table of 8-byte entries) and its symbol from `sym`; the new state; the
// pulls (0, 1 or 2) by two compares; each pull count's state and table
// offset formed beside them by funnel shifts of the state and the window,
// then selected; the window moved on by funnel shifts, its next word from
// one load of the ring on the position alone. The chain is the lookup, the
// multiply-add, a compare and two selects.
F3D_HD uint32_t rans_fast_step(const unsigned char* tab, const uint8_t* sym, const uint2* ring,
                               RansFast& c) {
    const uint2 e = *reinterpret_cast<const uint2*>(tab + c.off);
    const uint32_t s = sym[c.off >> 3];
    const uint2 w = ring[((c.pb >> 5) + 2u) & (F3DZ_RING_WORDS - 1u)];   // bytes pos + 8 ..
    const uint32_t r = rans_funnel(w.y, w.x, c.pb);
    const uint32_t nx = e.x * (c.x >> F3DZ_PROB_BITS) + e.y;
    const bool none = nx >= F3DZ_RANS_LO, one = nx >= (1u << 15);
    const uint32_t o0 = rans_slot_off(c.hi, nx, 0u), o1 = rans_slot_off(c.hi, nx, 8u),
                   o2 = rans_slot_off(c.hi, nx, 16u);
    c.off = none ? o0 : (one ? o1 : o2);
    const uint32_t x1 = rans_funnel(c.hi, nx, 8u), x2 = rans_funnel(c.hi, nx, 16u);
    const uint32_t sh = none ? 0u : (one ? 8u : 16u);
    c.x = none ? nx : (one ? x1 : x2);
    const uint32_t hi = c.hi;
    c.hi = rans_funnel(c.lo, hi, sh);
    c.lo = rans_funnel(r, c.lo, sh);
    c.pb += sh;
    return s;
}

// The chain's registers at the tile's first token: the state from the
// ring's first entry, the window from the next two
F3D_HD RansFast rans_fast_start(const uint2* ring) {
    RansFast c;
    c.x = ring[0].x;
    c.off = (c.x & (F3DZ_PROB_SCALE - 1u)) << 3;
    c.hi = ring[1].x;
    c.lo = ring[2].x;
    c.pb = 32u;
    return c;
}

// n_words * 4 tokens of the fast chain, their symbols packed four to a
// word (token 4g + u in bits 8u .. 8u + 7 of word g)
F3D_HD void rans_fast_chunk(const unsigned char* tab, const uint8_t* sym, const uint2* ring,
                            RansFast& c, uint32_t* out, uint32_t n_words) {
    for (uint32_t g = 0; g < n_words; ++g) {
        uint32_t v = rans_fast_step(tab, sym, ring, c);
        v |= rans_fast_step(tab, sym, ring, c) << 8;
        v |= rans_fast_step(tab, sym, ring, c) << 16;
        v |= rans_fast_step(tab, sym, ring, c) << 24;
        out[g] = v;
    }
}

// The escapes among a word's four symbols
F3D_HD uint32_t rans_escapes(uint32_t v) {
    uint32_t n = 0u;
    for (uint32_t u = 0; u < 4u; ++u) n += ((v >> (8u * u)) & 0xFFu) == F3DZ_ESCAPE ? 1u : 0u;
    return n;
}

// A word's four tokens as residuals: the escapes in it, in order, take
// extras[min(rank, ecap - 1)] with rank counting on from `rank` (the
// escapes before the word), then the zig-zag step
F3D_HD void rans_drain_word(uint32_t v, uint32_t rank, const uint32_t* extras, uint32_t ecap,
                            int32_t* out) {
    for (uint32_t u = 0; u < 4u; ++u) {
        const uint32_t s = (v >> (8u * u)) & 0xFFu;
        uint32_t z = s;
        if (s == F3DZ_ESCAPE) {
            z = extras[rank < ecap - 1u ? rank : ecap - 1u];
            ++rank;
        }
        out[u] = unzigzag32(z);
    }
}

// One tile's decode tables for symbol s's run, slots cum .. cum + freq - 1
// (np.repeat of JAX's host parse): (freq, slot - cum) in `tab` and the
// symbol in `sym`, so one lookup gives JAX's freq[s] and slot - cum[s];
// the host checked that the frequencies sum to 4096
F3D_HD void rans_fill_fast(uint32_t s, uint32_t freq, uint32_t cum, uint2* tab, uint8_t* sym) {
    for (uint32_t j = 0; j < freq && cum + j < F3DZ_PROB_SCALE; ++j) {
        tab[cum + j].x = freq;
        tab[cum + j].y = j;
        sym[cum + j] = (uint8_t)s;
    }
}

// int32 addition with JAX's wrap-around (signed overflow is undefined in C++)
F3D_HD int32_t wrap_add(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }

// The prediction of q[y, x] from its left, up and up-left neighbours
// (f3dz_device.py:109-128): row 0 chains from the left (a cumsum), column 0
// from above, the rest take MED(left, up, upleft).
F3D_HD int32_t med_pred(int32_t left, int32_t up, int32_t upleft, int x, int y) {
    const int32_t mx = left > up ? left : up, mn = left > up ? up : left;
    const int32_t sum = (int32_t)((uint32_t)left + (uint32_t)up - (uint32_t)upleft);
    const int32_t med = upleft >= mx ? mn : (upleft <= mn ? mx : sum);
    return y == 0 ? (x == 0 ? 0 : left) : (x == 0 ? up : med);
}

// The height of quantized value q: the C++ lane's (float)((double)q * step).
F3D_HD float f3dz_height(int32_t q, double step) { return (float)((double)q * step); }

// C1 reconstruction's wavefront (codec.cu:med_kernel), a block a tile and a
// thread a row: lane j of warp w owns row y = 32 w + j and at the warp's
// step k takes column x = k - j, so a warp sweeps its 32 rows in 256 + 31
// steps. `left` is the lane's own last q, `up` lane j - 1's q of the step
// before (a shuffle; for lane 0, the row above's q, which warp w - 1's lane
// 31 publishes to an edge row F3DZ_MED_HAND columns at a time), `upleft`
// the lane's own `up` of the step before. A warp stages its rows' residuals
// F3DZ_MED_CHUNK columns at a time in a ring of F3DZ_MED_RING chunks a row,
// q overwrites d there, and a chunk's heights are drained once the warp's
// last lane has passed it.
#define F3DZ_MED_WARPS (F3DZ_TILE / 32)                  // a warp 32 rows
#define F3DZ_MED_CHUNK 32                                // columns a staged chunk
#define F3DZ_MED_CHUNKS (F3DZ_TILE / F3DZ_MED_CHUNK)     // chunks a row
#define F3DZ_MED_RING 3                                  // chunks a warp holds
#define F3DZ_MED_RING_COLS (F3DZ_MED_RING * F3DZ_MED_CHUNK)   // a row's ring
#define F3DZ_MED_RING_WORDS (32 * F3DZ_MED_RING_COLS)    // a warp's ring
#define F3DZ_MED_HAND 8                                  // columns a handoff

// q[y, x] from its neighbours and its residual
F3D_HD int32_t med_step(int32_t left, int32_t up, int32_t upleft, int32_t d, int x, int y) {
    return wrap_add(med_pred(left, up, upleft, x, y), d);
}

// MED(left, up, upleft) alone: med_pred wherever x > 0 and y > 0, and on
// row 0 (x > 0) too where up = upleft = 0, as lane 0 of warp 0 has them:
// MED(left, 0, 0) is left (left <= 0: the minimum, left; left > 0: 0 is at
// most the minimum, so the maximum, left), med_pred's row-0 rule.
F3D_HD int32_t med_inner(int32_t left, int32_t up, int32_t upleft) {
    const int32_t mx = left > up ? left : up, mn = left > up ? up : left;
    const int32_t sum = (int32_t)((uint32_t)left + (uint32_t)up - (uint32_t)upleft);
    return upleft >= mx ? mn : (upleft <= mn ? mx : sum);
}

// One lane's step at column x of its row y: `from_above` is what the
// shuffle brought from lane - 1, `edge` the published q above a lane 0
// (0 above row 0); `slot` holds the residual and gets q. q is the lane's
// last q on entry. kInner: x > 0, so med_inner is the prediction.
template <bool kInner>
F3D_HD void med_lane_step(int32_t& q, int32_t& upleft, int32_t from_above, int32_t edge,
                          int32_t* slot, int lane, int x, int y) {
    const int32_t up = lane ? from_above : edge;
    q = kInner ? wrap_add(med_inner(q, up, upleft), *slot) : med_step(q, up, upleft, *slot, x, y);
    *slot = q;
    upleft = up;
}

// The word of (the warp's row `row`, column chunk * 32 + col) in its ring:
// a row's F3DZ_MED_RING_COLS columns x mod F3DZ_MED_RING_COLS. No padding:
// a row's stride is a multiple of 32 words, so at a step the lanes' columns
// x = k - lane, 32 consecutive values, fall in 32 different banks.
F3D_HD int med_slot(int chunk, int row, int col) {
    return row * F3DZ_MED_RING_COLS + (chunk % F3DZ_MED_RING) * F3DZ_MED_CHUNK + col;
}

// The column of the lane's ring row at the start of period c (its column
// x = 32 c - lane, mod the ring; x >= -31), and the next step's column, as
// the kernel steps them.
F3D_HD int med_ring_col(int c, int lane) {
    return (F3DZ_MED_CHUNK * c - lane + F3DZ_MED_RING_COLS) % F3DZ_MED_RING_COLS;
}
F3D_HD int med_next_col(int col) { return col == F3DZ_MED_RING_COLS - 1 ? 0 : col + 1; }

// The lane's i-th (0..7) 16-byte piece of a chunk, which it copies in and
// drains out: the warp's row and the piece's first column in the chunk.
// Eight lanes take a row's 128 bytes, so both ways are coalesced.
F3D_HD void med_piece(int lane, int i, int& row, int& col) {
    const int p = lane + 32 * i;
    row = p >> 3;
    col = 4 * (p & 7);
}

// Warp w waits, before its step k, for handoff k / F3DZ_MED_HAND of the row
// above; its lane 31 publishes a handoff's columns after the last of them.
F3D_HD bool med_waits(int w, int k) {
    return w > 0 && k < F3DZ_TILE && k % F3DZ_MED_HAND == 0;
}
F3D_HD bool med_publishes(int w, int lane) { return w < F3DZ_MED_WARPS - 1 && lane == 31; }
