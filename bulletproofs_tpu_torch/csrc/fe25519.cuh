// GF(2^255 - 19) for the port's kernels: the CUDA twin of ops/field.py,
// and the one field product of every curve kernel (K1, K3, K4, K5, K6, K7,
// K11, K12).
//
// An element is 10 signed int32 limbs in radix 2^25.5 (ref10 layout: limb
// k at bit ceil(25.5 k), 26 bits wide for even k, 25 for odd k).  A limb
// product is one signed 32 x 32 -> 64-bit multiply-add (mad.wide.s32); every
// column sum stays below 2^63 for inputs that are sums of at most three
// carried values (|limb| < 2^27), which is all the curve formulas feed
// `fe_mul`, and the carry rounds after round 1 run in 32 bits.  `fe_sq`
// makes fe_mul(a, a)'s column sums from 55 limb products.
//
// Every function gives the plain PyTorch version's integers (the same
// column sums, the same three rounded carry rounds, the same canonical
// reduction), so a kernel built from these functions returns the plain
// version's limbs exactly, not just the same value mod p.  The JAX
// package's counterpart is the field half of ops/pallas_math.py (20 x
// 13-bit limbs on the TPU's int32 VPU).  tests/test_torch_fe_header.py
// compiles this header with the host compiler and holds each function to
// ops/field.py over the full range of its callers' inputs.
#pragma once
#include <stdint.h>

struct fe {
  int32_t v[10];
};

// curve constants as exact limbs (ops/limbs.fe_ints_to_limbs; a CPU test
// checks them against the host field constants)
__device__ __constant__ int32_t FE_D[10] = {
    56195235, 13857412, 51736253, 6949390, 114729,
    24766616, 60832955, 30306712, 48412415, 21499315};
__device__ __constant__ int32_t FE_D2[10] = {
    45281625, 27714825, 36363642, 13898781, 229458,
    15978800, 54557047, 27058993, 29715967, 9444199};
__device__ __constant__ int32_t FE_SQRT_M1[10] = {
    34513072, 25610706, 9377949, 3500415, 12389472,
    33281959, 41962654, 31548777, 326685, 11406482};
__device__ __constant__ int32_t FE_INVSQRT_A_MINUS_D[10] = {
    6111466, 4156064, 39310137, 12243467, 41204824,
    120896, 20826367, 26493656, 6093567, 31568420};

__device__ __forceinline__ fe fe_const(const int32_t* c) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = c[k];
  return r;
}

__device__ __forceinline__ fe fe_zero() {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = 0;
  return r;
}

__device__ __forceinline__ fe fe_one() {
  fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

// One limb product is one signed 32 x 32 -> 64-bit multiply-add
// (mad.wide.s32, one IMAD.WIDE); `(int64_t)a * b` compiled to up to three
// instructions (an unsigned wide product and sign corrections).
__device__ __forceinline__ int64_t mad_wide(int32_t a, int32_t b, int64_t c) {
#ifdef __CUDA_ARCH__
  int64_t r;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(c));
  return r;
#else
  return c + (int64_t)a * b;
#endif
}

// Three rounded parallel carry rounds (ops/field.carry; limb 9 wraps into
// limb 0 times 19), with rounds 2 and 3 in 32 bits.  Round 1 leaves limb k
// a residue in [-2^(w-1), 2^(w-1)) and passes limb k + 1 its carry times
// the factor limb k + 1 takes it with (19 into limb 0, else 1);
// carry_round1 splits that product at limb k + 1's width into a quotient
// and a remainder.  For any |h| < 2^63 - 2^25 that carry stays below 2^43,
// so quotient, remainder and residue fit in 32 bits, and so does every
// later round.  The same integers as three 64-bit rounds, so the same
// limbs.
struct carry_out {
  int32_t res, quo, rem;
};

__device__ __forceinline__ carry_out carry_round1(int64_t h, int k) {
  const int w = 26 - (k & 1);
  const int wn = 26 - ((k + 1) & 1);
  const int32_t half = 1 << (w - 1);
  const int64_t c = ((h + half) >> w) * (k == 9 ? 19 : 1);
  return carry_out{
      (int32_t)(((uint32_t)h + (uint32_t)half) & ((1u << w) - 1)) - half,
      (int32_t)(c >> wn), (int32_t)((uint32_t)c & ((1u << wn) - 1))};
}

__device__ __forceinline__ fe fe_carry(const int64_t h[10]) {
  carry_out o[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) o[k] = carry_round1(h[k], k);
  // limb k's round-2 value is its residue plus the remainder of limb
  // src's carry; the quotient joins the round-2 carry
  int32_t r2[10], c2[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const int w = 26 - (k & 1), src = k == 0 ? 9 : k - 1;
    const int32_t s = o[k].res + o[src].rem;
    const int32_t e = (s + (1 << (w - 1))) >> w;
    c2[k] = o[src].quo + e;
    r2[k] = s - e * (1 << w);
  }
  int32_t h2[10], c3[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const int w = 26 - (k & 1), src = k == 0 ? 9 : k - 1;
    h2[k] = r2[k] + (k == 0 ? 19 : 1) * c2[src];
    c3[k] = (h2[k] + (1 << (w - 1))) >> w;
  }
  fe out;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const int w = 26 - (k & 1), src = k == 0 ? 9 : k - 1;
    out.v[k] = h2[k] - c3[k] * (1 << w) + (k == 0 ? 19 : 1) * c3[src];
  }
  return out;
}

#ifdef __CUDACC__
#define FULL_MASK 0xffffffffu

// fe_carry on ten lanes of a warp (limb k's column sum h on lane base + k),
// round by round: each round passes the carries from lane k - 1 to lane k
// (limb 9's into limb 0, x19).  K4b's pair products and K5's ten-lane
// products end in it.
__device__ __forceinline__ int32_t carry_rounds(int64_t h, int k, int base) {
  const int w = 26 - (k & 1);
  const int32_t half = 1 << (w - 1), f = k == 0 ? 19 : 1;
  const int src = base + (k == 0 ? 9 : k - 1);
  const carry_out o = carry_round1(h, k);
  const int32_t s = o.res + __shfl_sync(FULL_MASK, o.rem, src);
  const int32_t e = (s + half) >> w;
  const int32_t c2 = __shfl_sync(FULL_MASK, o.quo, src) + e;
  const int32_t h2 = s - e * (1 << w) + f * __shfl_sync(FULL_MASK, c2, src);
  const int32_t c3 = (h2 + half) >> w;
  return h2 - c3 * (1 << w) + f * __shfl_sync(FULL_MASK, c3, src);
}
#endif

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = a.v[k] + b.v[k];
  return r;
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = a.v[k] - b.v[k];
  return r;
}

__device__ __forceinline__ fe fe_neg(const fe& a) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = -a.v[k];
  return r;
}

// schoolbook 10 x 10 with the odd-odd doubling, one mad_wide a limb
// product; columns 10..18 fold back x19
__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  int64_t lo[10], hi[9];
#pragma unroll
  for (int k = 0; k < 10; ++k) lo[k] = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) hi[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const int32_t bj = (i & j & 1) ? 2 * b.v[j] : b.v[j];
      if (i + j < 10)
        lo[i + j] = mad_wide(a.v[i], bj, lo[i + j]);
      else
        hi[i + j - 10] = mad_wide(a.v[i], bj, hi[i + j - 10]);
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) lo[k] += 19 * hi[k];
  return fe_carry(lo);
}

// fe_mul(a, a) in 55 limb products: each pair i < j once, its factor 2
// and the odd-odd doubling folded into the operand (|limb| < 2^27, so
// 4 a_j fits in 32 bits).  Every column sum is the integer fe_mul(a, a)
// forms, so the limbs are its limbs.
__device__ __forceinline__ fe fe_sq(const fe& a) {
  int64_t lo[10], hi[9];
#pragma unroll
  for (int k = 0; k < 10; ++k) lo[k] = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) hi[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = i; j < 10; ++j) {
      const int f = (i == j ? 1 : 2) * ((i & j & 1) ? 2 : 1);
      const int32_t aj = f * a.v[j];
      if (i + j < 10)
        lo[i + j] = mad_wide(a.v[i], aj, lo[i + j]);
      else
        hi[i + j - 10] = mad_wide(a.v[i], aj, hi[i + j - 10]);
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) lo[k] += 19 * hi[k];
  return fe_carry(lo);
}

__device__ __forceinline__ fe fe_mul_small(const fe& a, int32_t s) {
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = mad_wide(a.v[k], s, 0);
  return fe_carry(h);
}

__device__ __forceinline__ fe fe_pow2k(fe a, int k) {
  for (int i = 0; i < k; ++i) a = fe_sq(a);
  return a;
}

// a^((p - 5) / 8) = a^(2^252 - 3), the addition chain of ops/field.pow_p58
__device__ __noinline__ fe fe_pow_p58(const fe& a) {
  fe t0 = fe_sq(a);
  fe t1 = fe_sq(fe_sq(t0));
  fe t2 = fe_mul(a, t1);
  fe t3 = fe_mul(t0, t2);
  fe t4 = fe_sq(t3);
  fe t5 = fe_mul(t2, t4);
  fe t6 = fe_mul(fe_pow2k(t5, 5), t5);
  fe t7 = fe_mul(fe_pow2k(t6, 10), t6);
  fe t8 = fe_mul(fe_pow2k(t7, 20), t7);
  fe t9 = fe_mul(fe_pow2k(t8, 10), t6);
  fe t10 = fe_mul(fe_pow2k(t9, 50), t9);
  fe t11 = fe_mul(fe_pow2k(t10, 100), t10);
  fe t12 = fe_mul(fe_pow2k(t11, 50), t9);
  return fe_mul(fe_sq(fe_sq(t12)), a);
}

// exact limbs (0 <= limb < 2^width) of the value mod p (ref10 fe_tobytes)
__device__ __forceinline__ fe fe_canon(const fe& a) {
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = a.v[k];
  fe c = fe_carry(h);
  int64_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = c.v[k];
  int64_t q = (19 * t[9] + (1LL << 24)) >> 25;
#pragma unroll
  for (int k = 0; k < 10; ++k) q = (t[k] + q) >> (26 - (k & 1));
  t[0] += 19 * q;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int w = 26 - (k & 1);
    const int64_t cr = t[k] >> w;
    t[k + 1] += cr;
    t[k] -= cr * (1LL << w);
  }
  t[9] &= (1LL << 25) - 1;
  fe out;
#pragma unroll
  for (int k = 0; k < 10; ++k) out.v[k] = (int32_t)t[k];
  return out;
}

__device__ __forceinline__ int fe_is_negative(const fe& a) {
  return fe_canon(a).v[0] & 1;
}

__device__ __forceinline__ bool fe_is_zero(const fe& a) {
  const fe c = fe_canon(a);
  int32_t acc = 0;
#pragma unroll
  for (int k = 0; k < 10; ++k) acc |= c.v[k];
  return acc == 0;
}

__device__ __forceinline__ bool fe_eq(const fe& a, const fe& b) {
  return fe_is_zero(fe_sub(a, b));
}

__device__ __forceinline__ fe fe_select(bool flag, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = flag ? a.v[k] : b.v[k];
  return r;
}

__device__ __forceinline__ fe fe_abs(const fe& a) {
  return fe_select(fe_is_negative(a) != 0, fe_neg(a), a);
}

// RFC 9496 SQRT_RATIO_M1 (ops/field.sqrt_ratio_m1)
__device__ __forceinline__ bool fe_sqrt_ratio_m1(const fe& u, const fe& v,
                                                 fe& r_out) {
  const fe sqrt_m1 = fe_const(FE_SQRT_M1);
  const fe v3 = fe_mul(fe_sq(v), v);
  const fe v7 = fe_mul(fe_sq(v3), v);
  fe r = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)));
  const fe check = fe_mul(v, fe_sq(r));
  const fe neg_u = fe_neg(u);
  const bool correct = fe_eq(check, u);
  const bool flipped = fe_eq(check, neg_u);
  const bool flipped_i = fe_eq(check, fe_mul(neg_u, sqrt_m1));
  r = fe_select(flipped || flipped_i, fe_mul(r, sqrt_m1), r);
  r_out = fe_abs(r);
  return correct || flipped;
}

// -- points: extended (X : Y : Z : T); Niels form (Y+X, Y-X, 2dT) ------------

struct ge {
  fe X, Y, Z, T;
};

struct ge_niels {
  fe ypx, ymx, t2d;
};

__device__ __forceinline__ ge ge_identity() {
  ge p;
  p.X = fe_zero();
  p.Y = fe_one();
  p.Z = fe_one();
  p.T = fe_zero();
  return p;
}

// complete addition add-2008-hwcd-3 (ops/curve.add)
__device__ __forceinline__ ge ge_add(const ge& p, const ge& q) {
  const fe A = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  const fe B = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  const fe C = fe_mul(fe_mul(p.T, fe_const(FE_D2)), q.T);
  const fe D = fe_mul_small(fe_mul(p.Z, q.Z), 2);
  const fe E = fe_sub(B, A), F = fe_sub(D, C), G = fe_add(D, C),
           H = fe_add(B, A);
  ge r;
  r.X = fe_mul(E, F);
  r.Y = fe_mul(G, H);
  r.Z = fe_mul(F, G);
  r.T = fe_mul(E, H);
  return r;
}

// mixed addition with a Z = 1 point in Niels form (ops/curve.madd)
__device__ __forceinline__ ge ge_madd(const ge& p, const ge_niels& q) {
  const fe A = fe_mul(fe_sub(p.Y, p.X), q.ymx);
  const fe B = fe_mul(fe_add(p.Y, p.X), q.ypx);
  const fe C = fe_mul(p.T, q.t2d);
  const fe D = fe_mul_small(p.Z, 2);
  const fe E = fe_sub(B, A), F = fe_sub(D, C), G = fe_add(D, C),
           H = fe_add(B, A);
  ge r;
  r.X = fe_mul(E, F);
  r.Y = fe_mul(G, H);
  r.Z = fe_mul(F, G);
  r.T = fe_mul(E, H);
  return r;
}

// dbl-2008-hwcd for a = -1 (ops/curve.double)
__device__ __forceinline__ ge ge_double(const ge& p) {
  const fe A = fe_sq(p.X);
  const fe B = fe_sq(p.Y);
  const fe C = fe_mul_small(fe_sq(p.Z), 2);
  const fe H = fe_add(A, B);
  const fe E = fe_sub(H, fe_sq(fe_add(p.X, p.Y)));
  const fe G = fe_sub(A, B);
  const fe F = fe_add(C, G);
  ge r;
  r.X = fe_mul(E, F);
  r.Y = fe_mul(G, H);
  r.Z = fe_mul(F, G);
  r.T = fe_mul(E, H);
  return r;
}

// (4, 10, N) int32 point tensors: coordinate c, limb k of point i at
// (c * 10 + k) * n + i
__device__ __forceinline__ fe fe_load(const int32_t* base, int64_t stride) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = base[k * stride];
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* base, int64_t stride,
                                         const fe& a) {
#pragma unroll
  for (int k = 0; k < 10; ++k) base[k * stride] = a.v[k];
}

__device__ __forceinline__ ge ge_load(const int32_t* base, int64_t stride) {
  ge p;
  p.X = fe_load(base, stride);
  p.Y = fe_load(base + 10 * stride, stride);
  p.Z = fe_load(base + 20 * stride, stride);
  p.T = fe_load(base + 30 * stride, stride);
  return p;
}

__device__ __forceinline__ void ge_store(int32_t* base, int64_t stride,
                                         const ge& p) {
  fe_store(base, stride, p.X);
  fe_store(base + 10 * stride, stride, p.Y);
  fe_store(base + 20 * stride, stride, p.Z);
  fe_store(base + 30 * stride, stride, p.T);
}
