// Arithmetic mod l = 2^252 + 27742317777372353535851937790883648493 for the
// port's kernels: the CUDA twin of ops/scalar.py.
//
// A scalar is 9 exact limbs of 29 bits (261 bits), kept canonical (< l)
// between operations.  Multiplication is Montgomery (CIOS, R = 2^261):
// 29 x 29 -> 58-bit products accumulate in uint64 (at most nine rounds of
// two products per column, < 2^63).  The JAX package's counterpart is
// ops/vec_scalar.py (20 x 13-bit lazy limbs with Barrett reduction);
// canonical limbs make every output unique, so a kernel's scalars equal
// the plain version's exactly.
#pragma once
#include <stdint.h>

#define SC_BITS 29
#define SC_MASK ((1u << SC_BITS) - 1u)

struct sc {
  uint32_t v[9];
};

// exact limbs of l, R^2 mod l, R mod l (Montgomery one) and 0x77..7 (64
// sevens, the signed-digit bias); -l^-1 mod 2^29.  A CPU test checks them.
__device__ __constant__ uint32_t SC_ELL[9] = {
    485872621, 9640146, 501691798, 502512965, 333, 0, 0, 0, 1048576};
__device__ __constant__ uint32_t SC_R2[9] = {
    190815506, 504634135, 361594685, 339687255, 426956673,
    70249340, 485410621, 504909086, 328813};
__device__ __constant__ uint32_t SC_ONE_M[9] = {
    290322925, 442594051, 259787148, 377041255, 536700270,
    536870911, 536870911, 536870911, 1048575};
__device__ __constant__ uint32_t SC_SEVENS[9] = {
    393705335, 465288123, 501079517, 250539758, 393705335,
    465288123, 501079517, 250539758, 7829367};
#define SC_LINV 307527195ull

__device__ __forceinline__ sc sc_const(const uint32_t* c) {
  sc r;
#pragma unroll
  for (int k = 0; k < 9; ++k) r.v[k] = c[k];
  return r;
}

__device__ __forceinline__ sc sc_zero() {
  sc r;
#pragma unroll
  for (int k = 0; k < 9; ++k) r.v[k] = 0;
  return r;
}

// value < 2l with exact limbs in t (signed work limbs) -> value mod l
__device__ __forceinline__ sc sc_cond_sub_l(const int64_t t[9]) {
  int64_t d[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) d[k] = t[k] - (int64_t)SC_ELL[k];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t c = d[k] >> SC_BITS;
    d[k] &= SC_MASK;
    d[k + 1] += c;
  }
  const bool keep = d[8] < 0;
  sc r;
#pragma unroll
  for (int k = 0; k < 9; ++k) r.v[k] = (uint32_t)(keep ? t[k] : d[k]);
  return r;
}

// a b R^-1 mod l for a < R, b < l (ops/scalar.mont_mul)
__device__ __forceinline__ sc sc_mont_mul(const sc& a, const sc& b) {
  uint64_t t[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] += (uint64_t)a.v[i] * b.v[j];
    const uint64_t mq = ((t[0] & SC_MASK) * SC_LINV) & SC_MASK;
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] += mq * SC_ELL[j];
    const uint64_t c = t[0] >> SC_BITS;
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[0] += c;
    t[8] = 0;
  }
  int64_t e[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) e[k] = (int64_t)t[k];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t c = e[k] >> SC_BITS;
    e[k] &= SC_MASK;
    e[k + 1] += c;
  }
  return sc_cond_sub_l(e);
}

__device__ __forceinline__ sc sc_add(const sc& a, const sc& b) {
  int64_t e[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) e[k] = (int64_t)a.v[k] + b.v[k];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t c = e[k] >> SC_BITS;
    e[k] &= SC_MASK;
    e[k + 1] += c;
  }
  return sc_cond_sub_l(e);
}

__device__ __forceinline__ sc sc_neg(const sc& a) {
  int64_t e[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) e[k] = (int64_t)SC_ELL[k] - a.v[k];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t c = e[k] >> SC_BITS;
    e[k] &= SC_MASK;
    e[k + 1] += c;
  }
  return sc_cond_sub_l(e);
}

__device__ __forceinline__ sc sc_to_mont(const sc& x) {
  return sc_mont_mul(x, sc_const(SC_R2));
}

__device__ __forceinline__ sc sc_from_mont(const sc& x) {
  sc one = sc_zero();
  one.v[0] = 1;
  return sc_mont_mul(x, one);
}

// 32 little-endian bytes -> exact limbs (value < 2^256)
__device__ __forceinline__ sc sc_from_bytes(const uint8_t* b) {
  sc r;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int pos = SC_BITS * k;
    uint64_t acc = 0;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int idx = pos / 8 + t;
      if (idx < 32) acc |= (uint64_t)b[idx] << (8 * t);
    }
    const int width = k < 8 ? SC_BITS : 256 - SC_BITS * 8;
    r.v[k] = (uint32_t)((acc >> (pos % 8)) & ((1ull << width) - 1));
  }
  return r;
}

// exact limbs of x < 2^261 -> x mod l (ops/scalar.reduce_top): with
// q = floor(x / 2^252) < 2^9, x - q l lies in (-l, 2^252), so one
// conditional addition of l finishes (by a mask, not a branch: the
// prover's scalars are secret).  The identity on canonical x.
__device__ __forceinline__ sc sc_reduce_top(const sc& x) {
  const int64_t q = x.v[8] >> 20;                  // limb 8 starts at bit 232
  int64_t e[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) e[k] = (int64_t)x.v[k] - q * SC_ELL[k];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t c = e[k] >> SC_BITS;
    e[k] &= SC_MASK;
    e[k + 1] += c;
  }
  const int64_t neg = e[8] >> 63;                  // all ones when x - q l < 0
#pragma unroll
  for (int k = 0; k < 9; ++k) e[k] += (int64_t)SC_ELL[k] & neg;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t c = e[k] >> SC_BITS;
    e[k] &= SC_MASK;
    e[k + 1] += c;
  }
  sc r;
#pragma unroll
  for (int k = 0; k < 9; ++k) r.v[k] = (uint32_t)e[k];
  return r;
}

// l - 2, the Fermat exponent, as little-endian 64-bit words
__device__ __constant__ uint64_t SC_ELL_MINUS_2[4] = {
    0x5812631a5cf5d3ebull, 0x14def9dea2f79cd6ull, 0ull, 0x1000000000000000ull};

// canonical x -> x^(l-2) mod l, canonical (0 -> 0; ops/scalar.sinv_plain):
// the MSB-first square-and-multiply ladder in Montgomery form, starting at
// the top bit (252).  It branches on the exponent's bits, which are
// public and the same for every thread; the input (the prover's IPP
// challenges) is public too.
__device__ __forceinline__ sc sc_invert(const sc& x) {
  const sc xm = sc_to_mont(x);
  sc acc = xm;
  for (int b = 251; b >= 0; --b) {
    acc = sc_mont_mul(acc, acc);
    if ((SC_ELL_MINUS_2[b >> 6] >> (b & 63)) & 1) acc = sc_mont_mul(acc, xm);
  }
  return sc_from_mont(acc);
}

// canonical x -> signed base-16 digits in [-7, 8] (ops/scalar.signed_digits:
// the nibbles of x + 0x77..7, minus 7)
__device__ __forceinline__ void sc_signed_digits(const sc& x, int8_t out[64]) {
  int64_t e[10];
#pragma unroll
  for (int k = 0; k < 9; ++k) e[k] = (int64_t)x.v[k] + SC_SEVENS[k];
  e[9] = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t c = e[k] >> SC_BITS;
    e[k] &= SC_MASK;
    e[k + 1] += c;
  }
#pragma unroll
  for (int w = 0; w < 64; ++w) {
    const int limb = (4 * w) / SC_BITS, off = (4 * w) % SC_BITS;
    int64_t v = e[limb] >> off;
    if (off > SC_BITS - 4) v |= e[limb + 1] << (SC_BITS - off);
    out[w] = (int8_t)((v & 15) - 7);
  }
}
