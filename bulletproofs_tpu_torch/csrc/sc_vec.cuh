// Per-element bodies of kernels K17-K20 (csrc/scalar.cu): the batch
// prover's mod-l vector arithmetic (ops/scalar.py mont_mul, smul, sadd,
// sneg, tree_sum, from_wide_bytes) and its ChaCha20 blinding draws
// (ops/chacha.py random_scalars).  Everything here is the arithmetic of
// csrc/sc25519.cuh on 29-bit canonical limbs, so a kernel's scalars equal
// the plain versions' exactly.
//
// The witness rows (a, b, s_L, s_R, the blinds) pass through these bodies:
// no branch and no memory index depends on a scalar's value (the
// conditional subtraction of l selects by a mask).
#pragma once
#include "sc25519.cuh"

// 2^256 R mod l (R = 2^261): the Montgomery factor of a wide value's high
// half.  A CPU test checks it.
__device__ __constant__ uint32_t SC_W256_M[9] = {
    147395749, 34354560, 457688582, 356494647, 483104506,
    488734555, 518485561, 233882216, 206883};

// 9 int64 limbs, `sl` elements apart -> a scalar (limbs below 2^29)
__device__ __forceinline__ sc sc_load(const int64_t* p, int64_t sl) {
  sc r;
#pragma unroll
  for (int k = 0; k < 9; ++k) r.v[k] = (uint32_t)p[k * sl];
  return r;
}

__device__ __forceinline__ void sc_store(int64_t* p, int64_t sl, const sc& x) {
#pragma unroll
  for (int k = 0; k < 9; ++k) p[k * sl] = x.v[k];
}

// K17: MODE 0 is a b R^-1 (ops/scalar.mont_mul; a < R, b < l), MODE 1 is
// a b mod l (ops/scalar.smul: the same product, then one by R^2), both
// canonical
template <int MODE>
__device__ __forceinline__ sc sc_mul_elem(const sc& a, const sc& b) {
  const sc p = sc_mont_mul(a, b);
  return MODE == 0 ? p : sc_mont_mul(p, sc_const(SC_R2));
}

// K18: OP 0 is a + b mod l (ops/scalar.sadd), OP 1 is -a mod l
// (ops/scalar.sneg; b unused)
template <int OP>
__device__ __forceinline__ sc sc_add_elem(const sc& a, const sc& b) {
  return OP == 0 ? sc_add(a, b) : sc_neg(a);
}

// K19: the sum mod l of rows first, first + step, .. < n of one column
// (row i at p + i s0, its limbs sl apart); 0 when there are none.  The
// rows are canonical, so every order of addition gives the same limbs.
// (Loading four rows at a time was no faster from memory on an H100, and
// slower warm in L2: the loop stays one row a step.)
__device__ __forceinline__ sc sc_sum_rows(const int64_t* p, int64_t s0,
                                          int64_t sl, int64_t n,
                                          int64_t first, int64_t step) {
  sc acc = sc_zero();
  for (int64_t i = first; i < n; i += step)
    acc = sc_add(acc, sc_load(p + i * s0, sl));
  return acc;
}

// K19's slice s of `slices` equal parts of rows [0, rows): [r0, r1), empty
// (r1 <= r0) past the last row
__device__ __forceinline__ void sc_slice(int64_t rows, int64_t slices,
                                         int64_t s, int64_t& r0,
                                         int64_t& r1) {
  const int64_t q = (rows + slices - 1) / slices;
  r0 = s * q;
  r1 = r0 + q < rows ? r0 + q : rows;
}

// -- K20: ChaCha20 (RFC 8439) and the wide reduction --------------------------

__device__ __forceinline__ uint32_t chacha_rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define CHACHA_QR(a, b, c, d)                  \
  do {                                         \
    x[a] += x[b];                              \
    x[d] = chacha_rotl(x[d] ^ x[a], 16);       \
    x[c] += x[d];                              \
    x[b] = chacha_rotl(x[b] ^ x[c], 12);       \
    x[a] += x[b];                              \
    x[d] = chacha_rotl(x[d] ^ x[a], 8);        \
    x[c] += x[d];                              \
    x[b] = chacha_rotl(x[b] ^ x[c], 7);        \
  } while (0)

// The 64-byte keystream block of `key` (8 little-endian words) with block
// counter `ctr` and nonce 0, as 16 little-endian words (ops/chacha.py
// keystream_blocks: 20 rounds, then the input added)
__device__ __forceinline__ void chacha20_block(const uint32_t key[8],
                                               uint32_t ctr,
                                               uint32_t out[16]) {
  uint32_t x[16];
  x[0] = 0x61707865u;                           // "expand 32-byte k"
  x[1] = 0x3320646eu;
  x[2] = 0x79622d32u;
  x[3] = 0x6b206574u;
#pragma unroll
  for (int i = 0; i < 8; ++i) x[4 + i] = key[i];
  x[12] = ctr;
  x[13] = x[14] = x[15] = 0;
  uint32_t in[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) in[i] = x[i];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    CHACHA_QR(0, 4, 8, 12);
    CHACHA_QR(1, 5, 9, 13);
    CHACHA_QR(2, 6, 10, 14);
    CHACHA_QR(3, 7, 11, 15);
    CHACHA_QR(0, 5, 10, 15);
    CHACHA_QR(1, 6, 11, 12);
    CHACHA_QR(2, 7, 8, 13);
    CHACHA_QR(3, 4, 9, 14);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = x[i] + in[i];
}

// 8 little-endian words (a 256-bit value) -> exact limbs
__device__ __forceinline__ sc sc_from_words(const uint32_t w[8]) {
  sc r;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int pos = SC_BITS * k, i = pos / 32, off = pos % 32;
    uint64_t v = w[i] >> off;
    if (i + 1 < 8) v |= (uint64_t)w[i + 1] << (32 - off);
    r.v[k] = (uint32_t)(v & SC_MASK);
  }
  return r;
}

// 16 little-endian words (lo | hi, 512 bits) -> (lo + 2^256 hi) mod l,
// canonical (ops/scalar.from_wide_bytes): lo R + hi (2^256 R) under one
// Montgomery reduction, (lo R + hi 2^256 R) R^-1 = lo + 2^256 hi.  Both
// products are below 2^256 l, so the sum is below l R and one conditional
// subtraction finishes (sc_mont_mul_sum's bounds; its columns take limbs
// below 2^29, which exact limbs of lo and hi are).
__device__ __forceinline__ sc sc_from_wide(const uint32_t w[16]) {
  return sc_mont_mul_sum(sc_from_words(w), sc_const(SC_ONE_M),
                         sc_from_words(w + 8), sc_const(SC_W256_M));
}

// 64 bytes, `bs` apart -> 16 little-endian words
__device__ __forceinline__ void wide_words(const uint8_t* p, int64_t bs,
                                           uint32_t w[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) v |= (uint32_t)p[(4 * i + k) * bs] << (8 * k);
    w[i] = v;
  }
}

// draw `ctr` of `key`: its keystream block reduced mod l
// (ops/chacha.random_scalars)
__device__ __forceinline__ sc chacha_scalar(const uint32_t key[8],
                                            uint32_t ctr) {
  uint32_t w[16];
  chacha20_block(key, ctr, w);
  return sc_from_wide(w);
}
