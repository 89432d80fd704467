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
  const int64_t keep = d[8] >> 63;                 // all ones when t < l
  sc r;
#pragma unroll
  for (int k = 0; k < 9; ++k)
    r.v[k] = (uint32_t)((t[k] & keep) | (d[k] & ~keep));
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

// (a b + c d) R^-1 mod l for canonical a, b, c, d (< l): the two products'
// columns summed, then one Montgomery reduction (K8's fold: 252 limb
// products where two sc_mont_mul take 342).  a b + c d < 2 l^2 < l R, as
// 2 l < R = 2^261, so the reduced value lies below 2 l and one conditional
// subtraction finishes.  Column headroom: each of the 9 rounds adds three
// 58-bit products to a column (a_i b_j, c_i d_j, the quotient's q l_j),
// so a column collects at most 27 of them, < 2^62.8, plus the carry of
// the column below, < 2^34: below 2^63.
__device__ __forceinline__ sc sc_mont_mul_sum(const sc& a, const sc& b,
                                              const sc& c, const sc& d) {
  uint64_t t[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
#pragma unroll
    for (int j = 0; j < 9; ++j)
      t[j] += (uint64_t)a.v[i] * b.v[j] + (uint64_t)c.v[i] * d.v[j];
    const uint64_t mq = ((t[0] & SC_MASK) * SC_LINV) & SC_MASK;
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] += mq * SC_ELL[j];
    const uint64_t cy = t[0] >> SC_BITS;
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[0] += cy;
    t[8] = 0;
  }
  int64_t e[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) e[k] = (int64_t)t[k];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t cy = e[k] >> SC_BITS;
    e[k] &= SC_MASK;
    e[k + 1] += cy;
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

// -- inversion: Bernstein-Yang safegcd ("Fast constant-time gcd computation
// and modular inversion", 2019) in the layout of libsecp256k1's modinv32
// (its constant-time form) ----------------------------------------------------
//
// f, g, d, e are 9 signed limbs of 30 bits (limb 8 keeps the sign and the
// rest).  Starting from f = l, g = x, d = 0, e = 1, each of 20 batches
// runs 30 divsteps (the half-delta variant, tracked as zeta = -(delta +
// 1/2)) on the low 32 bits of f and g alone, which yields a 2x2 matrix t
// with entries in [-2^30, 2^30] and t (f, g) = 2^30 (f', g').  The batch
// then applies t to (f, g), exactly, and to (d, e) mod l, adding the
// multiple of l that makes the low 30 bits zero before the shift.  The
// invariants f = d x, g = e x (mod l) hold throughout.  600 divsteps
// exceed the 590 that bound any input below 2^256 (libsecp256k1's
// safegcd_implementation.md), so g reaches 0 and f = +-gcd(l, x) = +-1,
// whence x^-1 = +-d; x = 0 keeps d = 0, so 0 -> 0.  The count is fixed:
// no thread's work depends on its input, so a warp never diverges.
#define SC30_MASK ((1 << 30) - 1)

struct sc30 {
  int32_t v[9];
};

// exact 30-bit limbs of l
__device__ __constant__ int32_t SC30_ELL[9] = {
    485872621, 541690985, 796511589, 935229352, 20, 0, 0, 0, 4096};
// l^-1 mod 2^30.  l = 2^252 + c, so l = c = 485872621 (mod 2^30); Newton's
// step y <- y (2 - c y) doubles the correct low bits, and four of them
// from y = c (c c = 1 mod 8: 3, 6, 12, 24, 48 bits) give 766214629.  A CPU
// test checks it.
#define SC30_LINV 766214629u

// 30 divsteps on the low bits of f and g -> the new zeta and the matrix
// (u v; q r) of the batch, each entry in [-2^30, 2^30] (libsecp256k1
// modinv32_divsteps_30, branch-free: masks in place of the cases)
__device__ __forceinline__ int32_t sc30_divsteps(int32_t zeta, uint32_t f,
                                                 uint32_t g, int32_t t[4]) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < 30; ++i) {
    uint32_t c1 = (uint32_t)(zeta >> 31);           // zeta < 0
    const uint32_t c2 = 0u - (g & 1u);              // g odd
    const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    c1 &= c2;                                       // swap (zeta < 0, g odd)
    zeta = (zeta ^ (int32_t)c1) - 1;
    f += g & c1;
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return zeta;
}

// (d, e) <- t (d, e) / 2^30 mod l, kept in (-2l, l) (libsecp256k1
// modinv32_update_de_30): md, me start as the multiples of l that undo a
// negative d or e, then take the low 30 bits that cancel those of t (d, e)
__device__ __forceinline__ void sc30_update_de(sc30& d, sc30& e,
                                               const int32_t t[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d.v[0] + (int64_t)v * e.v[0];
  int64_t ce = (int64_t)q * d.v[0] + (int64_t)r * e.v[0];
  md -= (int32_t)((SC30_LINV * (uint32_t)cd + (uint32_t)md) & SC30_MASK);
  me -= (int32_t)((SC30_LINV * (uint32_t)ce + (uint32_t)me) & SC30_MASK);
  cd += (int64_t)SC30_ELL[0] * md;
  ce += (int64_t)SC30_ELL[0] * me;
  cd >>= 30;                                        // the low 30 bits are 0
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const int32_t di = d.v[i], ei = e.v[i];
    cd += (int64_t)u * di + (int64_t)v * ei + (int64_t)SC30_ELL[i] * md;
    ce += (int64_t)q * di + (int64_t)r * ei + (int64_t)SC30_ELL[i] * me;
    d.v[i - 1] = (int32_t)cd & SC30_MASK;
    e.v[i - 1] = (int32_t)ce & SC30_MASK;
    cd >>= 30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// (f, g) <- t (f, g) / 2^30, exact (libsecp256k1 modinv32_update_fg_30)
__device__ __forceinline__ void sc30_update_fg(sc30& f, sc30& g,
                                               const int32_t t[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = (int64_t)u * f.v[0] + (int64_t)v * g.v[0];
  int64_t cg = (int64_t)q * f.v[0] + (int64_t)r * g.v[0];
  cf >>= 30;                                        // the low 30 bits are 0
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cf += (int64_t)u * f.v[i] + (int64_t)v * g.v[i];
    cg += (int64_t)q * f.v[i] + (int64_t)r * g.v[i];
    f.v[i - 1] = (int32_t)cf & SC30_MASK;
    g.v[i - 1] = (int32_t)cg & SC30_MASK;
    cf >>= 30;
    cg >>= 30;
  }
  f.v[8] = (int32_t)cf;
  g.v[8] = (int32_t)cg;
}

// d in (-2l, l) -> (sign < 0 ? -d : d) mod l in [0, l), exact limbs
// (libsecp256k1 modinv32_normalize_30): add l if d < 0, negate on the
// sign, carry; add l again if still negative, carry
__device__ __forceinline__ void sc30_normalize(sc30& d, int32_t sign) {
  int32_t add = d.v[8] >> 31;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i)
    d.v[i] = ((d.v[i] + (SC30_ELL[i] & add)) ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d.v[i + 1] += d.v[i] >> 30;
    d.v[i] &= SC30_MASK;
  }
  add = d.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d.v[i] += SC30_ELL[i] & add;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d.v[i + 1] += d.v[i] >> 30;
    d.v[i] &= SC30_MASK;
  }
}

// canonical x -> x^-1 mod l, canonical (0 -> 0).  Every exact inversion
// gives the same canonical limbs, so this equals ops/scalar.sinv_plain,
// which computes x^(l-2) by the Fermat ladder: an independent oracle.
// One thread's chain is 600 divsteps of a few dependent integer
// instructions and 20 pairs of matrix updates, where a ladder is 326
// dependent Montgomery multiplications.  The input (the prover's IPP
// challenges) is public; the fixed count keeps the work data-independent
// all the same.
__device__ __forceinline__ sc sc_invert(const sc& x) {
  sc30 f, g, d, e;
#pragma unroll
  for (int j = 0; j < 9; ++j) {                     // 29-bit -> 30-bit limbs
    const int k = 30 * j / SC_BITS, o = 30 * j % SC_BITS;
    const uint64_t hi = k + 1 < 9 ? x.v[k + 1] : 0;
    g.v[j] = (int32_t)((((uint64_t)x.v[k] >> o) | (hi << (SC_BITS - o))) &
                       SC30_MASK);
    f.v[j] = SC30_ELL[j];
    d.v[j] = 0;
    e.v[j] = j == 0;
  }
  int32_t zeta = -1;                                // delta = 1/2
#pragma unroll 1
  for (int b = 0; b < 20; ++b) {
    int32_t t[4];
    zeta = sc30_divsteps(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    sc30_update_de(d, e, t);
    sc30_update_fg(f, g, t);
  }
  sc30_normalize(d, f.v[8]);
  sc r;
#pragma unroll
  for (int k = 0; k < 9; ++k) {                     // 30-bit -> 29-bit limbs
    const int j = SC_BITS * k / 30, o = SC_BITS * k % 30;
    const uint64_t hi = j + 1 < 9 ? (uint32_t)d.v[j + 1] : 0;
    r.v[k] = (uint32_t)((((uint64_t)(uint32_t)d.v[j] >> o) | (hi << (30 - o)))
                        & SC_MASK);
  }
  return r;
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
