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

// One tile's decode table, a slot a word: the symbol in bits 24-31, its
// frequency less one in bits 12-23 and the slot's offset in the symbol's
// run (slot - cum[s]) in bits 0-11. One lookup then gives everything a step
// needs: slot2sym[slot], freq[s] and slot - cum[s] of JAX's step.
F3D_HD uint32_t rans_entry(uint32_t sym, uint32_t freq, uint32_t offset) {
    return (sym << 24) | ((freq - 1u) << 12) | offset;
}

// Fill symbol s's run of the table, slots cum .. cum + freq - 1 (np.repeat
// of JAX's host parse); the host checked that the frequencies sum to 4096.
F3D_HD void rans_fill(uint32_t s, uint32_t freq, uint32_t cum, uint32_t* tab) {
    for (uint32_t j = 0; j < freq && cum + j < F3DZ_PROB_SCALE; ++j)
        tab[cum + j] = rans_entry(s, freq, j);
}

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

// The tile's whole rANS chain, one token a step (JAX's rans_step under
// lax.scan): decode the slot, at most four byte pulls to bring the state
// back over 2^23, an escape takes extras[min(n_esc, ecap - 1)]; each token
// is written to d as its zig-zag-decoded residual. The chain's critical
// path is one shared-memory lookup, a multiply-add and the pulls' count:
// no branch, and no load (the bytes come from the register buffer; an
// escape's extra is loaded an escape ahead). `stream` is the tile's row of
// `cap` bytes, a multiple of 4, 4-byte aligned.
F3D_HD void rans_chain(const uint32_t* tab, const uint8_t* stream, uint32_t len, uint32_t cap,
                       const uint32_t* extras, int ecap, int n_tokens, int32_t* d) {
    ByteBuffer in;
    in.init(stream, len, cap);
    uint32_t state = in.peek();
    in.consume(4u);
    uint32_t n_esc = 0u;
    const uint32_t last = (uint32_t)(ecap - 1);
    uint32_t extra = extras[0];
    for (int i = 0; i < n_tokens; ++i) {
        const uint32_t next = in.peek();
        const uint32_t e = tab[state & (F3DZ_PROB_SCALE - 1u)];
        const uint32_t s = e >> 24;
        state = (((e >> 12) & 0xFFFu) + 1u) * (state >> F3DZ_PROB_BITS) + (e & 0xFFFu);
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
