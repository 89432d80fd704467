// Kernel K5: batch ristretto255 compression (RFC 9496 ENCODE).
//
// Replaces the JAX package's Pallas kernel ops/msm_pallas.py:251
// _compress_kernel (called from compress_lanes, :297) together with the XLA
// limb -> byte step of ops/vec_curve.py:252-261, so the card writes the 32
// canonical bytes of each point once.
//
// Bound: operations.  Each point costs one sqrt-ratio exponentiation (287
// field products, 255 of them squarings) against 160 bytes in and 32 out;
// at the prover's sizes (512 to 12,288 points a launch) all of it is a few
// microseconds of the card's multiply rate, so what sets the time is one
// point's chain of dependent products and how many of the card's 528 SM
// sub-partitions (132 SMs x 4) have a warp to run.
//
// Design: one kernel body over two forms of the field arithmetic, LP lanes
// of a warp a point (one warp a block; ops/curve.compress_lanes picks LP
// from N):
// - one lane (LP = 1): the header's fe_mul / fe_sq in one thread, 32
//   points a warp.  Few instructions a point, but N / 32 warps: below
//   ~17 k points most sub-partitions idle, and the launch takes one
//   thread's chain of products.
// - ten lanes (LP = 10): lane r of a point's ten holds limb r of every
//   element and makes column r of every product, so a warp runs 3 points
//   and a launch has N / 3 warps.  A product gathers the operands by
//   __shfl_sync (a_i from lane i, b rotated so that b_(r - i) is register
//   (10 - i) mod 10), forms its column as fe_mul does (the odd-odd
//   doubling, a column past 9 folded x19), and runs fe_carry's rounds with
//   each carry from the lane before; a squaring takes its column's 5 or 6
//   pair products of fe_sq, each once.  Integer column sums are exact in
//   any order, so every limb is fe_mul's, fe_sq's and fe_carry's.  The
//   shuffles bound this form once the card is full (16 a squaring, 24 a
//   product, for 3 points).
// The reductions that need every limb (is_negative, equality, the
// canonical form) gather the element on every lane of the point and run
// the header's fe_canon there.  The arithmetic is ops/curve.compress_plain
// step for step, so the bytes match it exactly.  No branch or index
// depends on the data (selects); the identity (and any point equal to it
// up to 4-torsion) encodes as 32 zero bytes.
#include "common.cuh"
#include "fe25519.cuh"

// one lane a point: an element is an fe
struct one_lane {
  static constexpr int LP = 1;
  using E = fe;

  __device__ __forceinline__ explicit one_lane(int) {}
  __device__ __forceinline__ E load(const int32_t* p, int64_t n, int c) const {
    return fe_load(p + 10 * c * n, n);
  }
  __device__ __forceinline__ E constant(const int32_t* tab) const {
    return fe_const(tab);
  }
  __device__ __forceinline__ E one() const { return fe_one(); }
  __device__ __forceinline__ E add(const E& a, const E& b) const {
    return fe_add(a, b);
  }
  __device__ __forceinline__ E sub(const E& a, const E& b) const {
    return fe_sub(a, b);
  }
  __device__ __forceinline__ E neg(const E& a) const { return fe_neg(a); }
  __device__ __forceinline__ E select(bool f, const E& a, const E& b) const {
    return fe_select(f, a, b);
  }
  __device__ __forceinline__ E mul(const E& a, const E& b) const {
    return fe_mul(a, b);
  }
  __device__ __forceinline__ E sq(const E& a) const { return fe_sq(a); }
  __device__ __forceinline__ fe full(const E& a) const { return a; }
};

// ten lanes a point: lane r of the point's ten (first lane `base`) holds
// limb r of an element
struct ten_lanes {
  static constexpr int LP = 10;
  using E = int32_t;
  int r, base;
  // column r's pair products of fe_sq, t = 0..5: pairs (i, r - i mod 10)
  // for i = r / 2 - t (t = 0 and 5 the diagonals for an even r; t = 5
  // repeats t = 4 for an odd one): the factor lanes, the operand's factor
  // (x2 a pair, x2 odd-odd, 0 the repeat) and bit t when the pair's column
  // is past 9 (folded x19)
  int sq_i[6], sq_j[6], sq_f[6];
  unsigned sq_wrap;

  __device__ __forceinline__ explicit ten_lanes(int lane) {
    r = lane % 10;
    base = lane - r;
    sq_wrap = 0;
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      const int i = (r / 2 - t + 10) % 10, j = (r - i + 10) % 10;
      sq_i[t] = base + i;
      sq_j[t] = base + j;
      sq_f[t] = (t == 5 && (r & 1)) ? 0
                                    : (i == j ? 1 : 2) * ((i & j & 1) ? 2 : 1);
      sq_wrap |= (unsigned)(i + j >= 10) << t;
    }
  }
  __device__ __forceinline__ int32_t pull(int32_t v, int src) const {
    return __shfl_sync(FULL_MASK, v, src);
  }
  __device__ __forceinline__ E load(const int32_t* p, int64_t n, int c) const {
    return p[(10 * c + r) * n];
  }
  __device__ __forceinline__ E constant(const int32_t* tab) const {
    return tab[r];
  }
  __device__ __forceinline__ E one() const { return r == 0; }
  __device__ __forceinline__ E add(E a, E b) const { return a + b; }
  __device__ __forceinline__ E sub(E a, E b) const { return a - b; }
  __device__ __forceinline__ E neg(E a) const { return -a; }
  __device__ __forceinline__ E select(bool f, E a, E b) const {
    return f ? a : b;
  }
  // fe_mul's column r, then fe_carry's rounds across the ten lanes:
  // A[i] = a_i, B[d] = b_((r + d) mod 10), so b_(r - i) = B[(10 - i) mod
  // 10]; a row i > r lands in column r + 10
  __device__ __forceinline__ E mul(E a, E b) const {
    int32_t A[10], B[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      A[i] = pull(a, base + i);
      B[i] = pull(b, base + (r + i) % 10);
    }
    int64_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      int32_t bj = B[(10 - i) % 10];
      if (i & 1) bj *= 2 - (r & 1);        // b_(r - i) odd iff r is even
      if (i > r)
        hi = mad_wide(A[i], bj, hi);
      else
        lo = mad_wide(A[i], bj, lo);
    }
    return carry_rounds(lo + 19 * hi, r, base);
  }
  __device__ __forceinline__ E sq(E a) const {
    int64_t lo = 0, hi = 0;
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      const int32_t ai = pull(a, sq_i[t]);
      const int32_t aj = pull(a, sq_j[t]) * sq_f[t];
      if ((sq_wrap >> t) & 1)
        hi = mad_wide(ai, aj, hi);
      else
        lo = mad_wide(ai, aj, lo);
    }
    return carry_rounds(lo + 19 * hi, r, base);
  }
  __device__ __forceinline__ fe full(E a) const {
    fe o;
#pragma unroll
    for (int i = 0; i < 10; ++i) o.v[i] = pull(a, base + i);
    return o;
  }
};

template <class A>
__device__ __forceinline__ typename A::E pow2k(const A& f,
                                               typename A::E a, int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) a = f.sq(a);
  return a;
}

// fe_pow_p58's chain
template <class A>
__device__ __forceinline__ typename A::E pow_p58(const A& f,
                                                 const typename A::E& a) {
  using E = typename A::E;
  const E t0 = f.sq(a);
  const E t1 = f.sq(f.sq(t0));
  const E t2 = f.mul(a, t1);
  const E t3 = f.mul(t0, t2);
  const E t4 = f.sq(t3);
  const E t5 = f.mul(t2, t4);
  const E t6 = f.mul(pow2k(f, t5, 5), t5);
  const E t7 = f.mul(pow2k(f, t6, 10), t6);
  const E t8 = f.mul(pow2k(f, t7, 20), t7);
  const E t9 = f.mul(pow2k(f, t8, 10), t6);
  const E t10 = f.mul(pow2k(f, t9, 50), t9);
  const E t11 = f.mul(pow2k(f, t10, 100), t10);
  const E t12 = f.mul(pow2k(f, t11, 50), t9);
  return f.mul(f.sq(f.sq(t12)), a);
}

template <class A>
__device__ __forceinline__ bool e_is_negative(const A& f,
                                            const typename A::E& a) {
  return fe_is_negative(f.full(a)) != 0;
}

template <class A>
__device__ __forceinline__ bool e_eq(const A& f, const typename A::E& a,
                                   const typename A::E& b) {
  return fe_is_zero(f.full(f.sub(a, b)));
}

template <class A>
__device__ __forceinline__ typename A::E e_abs(const A& f,
                                             const typename A::E& a) {
  return f.select(e_is_negative(f, a), f.neg(a), a);
}

// fe_sqrt_ratio_m1's root (RFC 9496 SQRT_RATIO_M1; the flag unused)
template <class A>
__device__ __forceinline__ typename A::E invsqrt(const A& f,
                                                 const typename A::E& u,
                                                 const typename A::E& v,
                                                 const typename A::E& i) {
  using E = typename A::E;
  const E v3 = f.mul(f.sq(v), v);
  const E v7 = f.mul(f.sq(v3), v);
  E r = f.mul(f.mul(u, v3), pow_p58(f, f.mul(u, v7)));
  const E check = f.mul(v, f.sq(r));
  const E neg_u = f.neg(u);
  const bool flipped = e_eq(f, check, neg_u);
  const bool flipped_i = e_eq(f, check, f.mul(neg_u, i));
  r = f.select(flipped || flipped_i, f.mul(r, i), r);
  return e_abs(f, r);
}

// exact canonical limbs -> 8 little-endian words, the 32 bytes of
// ops/limbs.fe_to_bytes
__device__ __forceinline__ void fe_to_words(const fe& c, uint32_t* out) {
  uint64_t acc = 0;
  int bits = 0, j = 0;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    acc |= (uint64_t)(uint32_t)c.v[k] << bits;
    bits += 26 - (k & 1);
    if (bits >= 32) {
      out[j++] = (uint32_t)acc;
      acc >>= 32;
      bits -= 32;
    }
  }
  out[7] = (uint32_t)acc;                       // the last 31 bits
}

template <class A>
__global__ void __launch_bounds__(32)
compress_kernel(const int32_t* __restrict__ pts, uint8_t* __restrict__ out,
                int64_t n) {
  using E = typename A::E;
  constexpr int PPW = 32 / A::LP;               // points a warp
  const int lane = threadIdx.x;
  const A f(lane);
  const int64_t i = (int64_t)blockIdx.x * PPW + lane / A::LP;
  const bool live = lane < PPW * A::LP && i < n;
  const int64_t ic = live ? i : 0;         // spare lanes shuffle along
  const E X = f.load(pts + ic, n, 0), Y = f.load(pts + ic, n, 1),
          Z = f.load(pts + ic, n, 2), T = f.load(pts + ic, n, 3);
  const E sqrt_m1 = f.constant(FE_SQRT_M1);

  const E u1 = f.mul(f.add(Z, Y), f.sub(Z, Y));
  const E u2 = f.mul(X, Y);
  const E inv = invsqrt(f, f.one(), f.mul(u1, f.sq(u2)), sqrt_m1);
  const E den1 = f.mul(inv, u1);
  const E den2 = f.mul(inv, u2);
  const E z_inv = f.mul(f.mul(den1, den2), T);
  const E ix0 = f.mul(X, sqrt_m1);
  const E iy0 = f.mul(Y, sqrt_m1);
  const E enchanted = f.mul(den1, f.constant(FE_INVSQRT_A_MINUS_D));
  const bool rotate = e_is_negative(f, f.mul(T, z_inv));
  const E x = f.select(rotate, iy0, X);
  E y = f.select(rotate, ix0, Y);
  const E den_inv = f.select(rotate, enchanted, den2);
  y = f.select(e_is_negative(f, f.mul(x, z_inv)), f.neg(y), y);
  const fe s = fe_canon(f.full(e_abs(f, f.mul(den_inv, f.sub(Z, y)))));

  if (live && lane % A::LP == 0) {
    uint32_t wds[8];
    fe_to_words(s, wds);
    uint4* dst = reinterpret_cast<uint4*>(out + 32 * i);
    dst[0] = make_uint4(wds[0], wds[1], wds[2], wds[3]);
    dst[1] = make_uint4(wds[4], wds[5], wds[6], wds[7]);
  }
}

// pts (4, 10, n) int32 -> out (n, 32) uint8 (16-byte aligned), `lp` lanes
// a point (1 or 10), one warp a block
BP_EXPORT int bp_compress(const int32_t* pts, uint8_t* out, int64_t n,
                          int64_t lp, cudaStream_t stream) {
  const int64_t ppw = 32 / lp;
  const unsigned blocks = (unsigned)((n + ppw - 1) / ppw);
  if (lp == 1)
    compress_kernel<one_lane><<<blocks, 32, 0, stream>>>(pts, out, n);
  else if (lp == 10)
    compress_kernel<ten_lanes><<<blocks, 32, 0, stream>>>(pts, out, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
