// Kernels K3, K11 and K4: the Pippenger multi-scalar multiplication of the
// batch verifier, for Z = 1 points given in Niels form (K3, the fused
// route) and for points of arbitrary Z (K11, the chunked route, whose final
// MSM adds per-chunk partial results).
//
// K3 msm_accumulate replaces ops/msm_pallas.py:58 _accum_kernel_niels
// (the phase-1 pallas_call of _msm_pallas_niels, :379).  K11
// msm_accumulate_z replaces :121 _accum_kernel (the phase-1 pallas_call of
// _msm_pallas, :459).  K4 is two launches of this file, after either:
// msm_reduce replaces :178 _reduce_kernel (:397, :477) and msm_horner
// replaces :214 _horner_kernel (:412, :492).
//
// Digits are signed base-16 in [-8, 8] (64 windows), so there are 8
// buckets per window (digit 0 adds nothing).  Verifier data is public, so
// the bucket is indexed directly by |digit|; the TPU kernel's one-hot mux
// over all buckets was a Mosaic workaround.
//
// K3 bound: operations.  Each nonzero digit costs one 7-multiplication
// mixed addition (~700 IMAD.WIDE) against 1 byte of digit and a 120-byte
// Niels point that all 64 windows share through L2.  Design: grid
// (lanes / 32, 64 windows), one thread per (window, lane); thread j walks
// points j, j + lanes, j + 2 lanes, ... (the loop that replaces the TPU
// grid's sequential chunk axis) and keeps its 8 buckets in shared memory,
// laid out [bucket][coordinate][limb][thread] so a warp's accesses hit 32
// different banks; 40 KB per block of 32 threads, so five blocks share an
// SM.  The slab leaves the kernel once: (64, 8, 4, 10, lanes) int32.
//
// K11 bound: operations, as K3's, with the complete 9-multiplication
// addition (~900 IMAD.WIDE) per nonzero digit against a 160-byte point.
// Design: K3's, point for point; a negative digit negates X and T (two limb
// negations, as the TPU kernel's fneg).  It writes K3's slab layout, so K4
// runs unchanged after it.
//
// K4 msm_reduce: grid (8 buckets, 64 windows), lanes / 2 threads; a tree of
// complete additions over the lanes in shared memory -> (64, 8, 4, 10).
// K4 msm_horner (K4b): the window sums S_w = sum_b (b + 1) B_b, then the
// Horner chain sum_w 16^w S_w (63 x (4 doublings + 1 addition)) and the
// ristretto is-identity flag (X == 0 or Y == 0); its design is at the
// kernel below.
//
// Every step is ops/msm.py's plain version in the same order, so the
// slab, the bucket sums and the result match it limb for limb.
#include "common.cuh"
#include "fe25519.cuh"

#include <cooperative_groups.h>

#define NBUCKET 8
#define ACC_THREADS 32

__device__ __forceinline__ fe smem_fe_load(const int32_t* s, int stride) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) r.v[k] = s[k * stride];
  return r;
}

__device__ __forceinline__ void smem_fe_store(int32_t* s, int stride,
                                              const fe& a) {
#pragma unroll
  for (int k = 0; k < 10; ++k) s[k * stride] = a.v[k];
}

__global__ void __launch_bounds__(ACC_THREADS)
accumulate_kernel(const int32_t* __restrict__ niels,
                  const int8_t* __restrict__ digits, int32_t* __restrict__ slab,
                  int64_t n, int lanes) {
  __shared__ int32_t buckets[NBUCKET * 4 * 10 * ACC_THREADS];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * ACC_THREADS + tid;
  const int w = blockIdx.y;
  const int cstride = 10 * ACC_THREADS;            // one coordinate
  const int bstride = 4 * cstride;                 // one bucket

  const ge id = ge_identity();
  for (int b = 0; b < NBUCKET; ++b) {
    int32_t* s = buckets + b * bstride + tid;
    smem_fe_store(s, ACC_THREADS, id.X);
    smem_fe_store(s + cstride, ACC_THREADS, id.Y);
    smem_fe_store(s + 2 * cstride, ACC_THREADS, id.Z);
    smem_fe_store(s + 3 * cstride, ACC_THREADS, id.T);
  }

  const int8_t* drow = digits + (int64_t)w * n;
  for (int64_t k = lane; k < n; k += lanes) {
    const int d = drow[k];
    if (d == 0) continue;
    ge_niels q;
    const fe ypx = fe_load(niels + k, n);
    const fe ymx = fe_load(niels + 10 * n + k, n);
    const fe t2d = fe_load(niels + 20 * n + k, n);
    if (d < 0) {
      q.ypx = ymx;
      q.ymx = ypx;
      q.t2d = fe_neg(t2d);
    } else {
      q.ypx = ypx;
      q.ymx = ymx;
      q.t2d = t2d;
    }
    int32_t* s = buckets + ((d < 0 ? -d : d) - 1) * bstride + tid;
    ge acc;
    acc.X = smem_fe_load(s, ACC_THREADS);
    acc.Y = smem_fe_load(s + cstride, ACC_THREADS);
    acc.Z = smem_fe_load(s + 2 * cstride, ACC_THREADS);
    acc.T = smem_fe_load(s + 3 * cstride, ACC_THREADS);
    acc = ge_madd(acc, q);
    smem_fe_store(s, ACC_THREADS, acc.X);
    smem_fe_store(s + cstride, ACC_THREADS, acc.Y);
    smem_fe_store(s + 2 * cstride, ACC_THREADS, acc.Z);
    smem_fe_store(s + 3 * cstride, ACC_THREADS, acc.T);
  }

  // slab[w][b][c][limb][lane]
  for (int b = 0; b < NBUCKET; ++b) {
    const int32_t* s = buckets + b * bstride + tid;
    int32_t* dst = slab + ((int64_t)(w * NBUCKET + b) * 40) * lanes + lane;
    for (int ck = 0; ck < 40; ++ck) dst[(int64_t)ck * lanes] = s[ck * ACC_THREADS];
  }
}

// K11: accumulate_kernel for points of arbitrary Z (extended coordinates),
// the complete 9-multiplication addition in place of the mixed one; a
// negative digit adds (-X : Y : Z : -T).  Same grid, lanes and slab.
__global__ void __launch_bounds__(ACC_THREADS)
accumulate_z_kernel(const int32_t* __restrict__ pts,
                    const int8_t* __restrict__ digits,
                    int32_t* __restrict__ slab, int64_t n, int lanes) {
  __shared__ int32_t buckets[NBUCKET * 4 * 10 * ACC_THREADS];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * ACC_THREADS + tid;
  const int w = blockIdx.y;
  const int cstride = 10 * ACC_THREADS;
  const int bstride = 4 * cstride;

  const ge id = ge_identity();
  for (int b = 0; b < NBUCKET; ++b) {
    int32_t* s = buckets + b * bstride + tid;
    smem_fe_store(s, ACC_THREADS, id.X);
    smem_fe_store(s + cstride, ACC_THREADS, id.Y);
    smem_fe_store(s + 2 * cstride, ACC_THREADS, id.Z);
    smem_fe_store(s + 3 * cstride, ACC_THREADS, id.T);
  }

  const int8_t* drow = digits + (int64_t)w * n;
  for (int64_t k = lane; k < n; k += lanes) {
    const int d = drow[k];
    if (d == 0) continue;
    ge q = ge_load(pts + k, n);
    if (d < 0) {
      q.X = fe_neg(q.X);
      q.T = fe_neg(q.T);
    }
    int32_t* s = buckets + ((d < 0 ? -d : d) - 1) * bstride + tid;
    ge acc;
    acc.X = smem_fe_load(s, ACC_THREADS);
    acc.Y = smem_fe_load(s + cstride, ACC_THREADS);
    acc.Z = smem_fe_load(s + 2 * cstride, ACC_THREADS);
    acc.T = smem_fe_load(s + 3 * cstride, ACC_THREADS);
    acc = ge_add(acc, q);
    smem_fe_store(s, ACC_THREADS, acc.X);
    smem_fe_store(s + cstride, ACC_THREADS, acc.Y);
    smem_fe_store(s + 2 * cstride, ACC_THREADS, acc.Z);
    smem_fe_store(s + 3 * cstride, ACC_THREADS, acc.T);
  }

  for (int b = 0; b < NBUCKET; ++b) {
    const int32_t* s = buckets + b * bstride + tid;
    int32_t* dst = slab + ((int64_t)(w * NBUCKET + b) * 40) * lanes + lane;
    for (int ck = 0; ck < 40; ++ck) dst[(int64_t)ck * lanes] = s[ck * ACC_THREADS];
  }
}

__global__ void reduce_kernel(const int32_t* __restrict__ slab,
                              int32_t* __restrict__ sums, int lanes) {
  extern __shared__ int32_t tree[];                // (40, lanes / 2)
  const int half = lanes / 2;
  const int t = threadIdx.x;
  const int wb = blockIdx.y * NBUCKET + blockIdx.x;
  const int32_t* src = slab + (int64_t)wb * 40 * lanes;
  ge p = ge_add(ge_load(src + t, lanes), ge_load(src + half + t, lanes));
  ge_store(tree + t, half, p);
  __syncthreads();
  for (int h = half / 2; h >= 1; h /= 2) {
    if (t < h) {
      p = ge_add(ge_load(tree + t, half), ge_load(tree + t + h, half));
      ge_store(tree + t, half, p);
    }
    __syncthreads();
  }
  if (t == 0) ge_store(sums + (int64_t)wb * 40, 1, p);
}

// -- K4b: the Horner window combine ----------------------------------------
//
// Bound: latency.  The work is small (2,709 field products, 0.000127 ms at
// the card's multiply rate), but the chain is 63 x (4 doublings + 1
// addition) of dependent products: a doubling is two stages of four
// independent products ({X^2, Y^2, 2 Z^2, (X + Y)^2}, then {EF, GH, FG,
// EH}), an addition three ({A, B, T 2d, Z Z'}, {C = (T 2d) T', D = 2 Z Z'},
// {EF, GH, FG, EH}), 693 stages in all; no reordering shortens it (window
// 63 is doubled 252 times) and the order is part of the output.  What the
// design cuts is the time of one stage.
//
// A field product on twenty lanes of a warp (a "pair"): lanes k and
// 10 + k both hold limb k of each operand, gather the other limbs by
// __shfl_sync and make the even-i and the odd-i halves of fe_mul's column
// k (five int64 products each, the odd-odd doubling and the x19 fold as
// fe_mul has them), then swap their sums; fe_carry's three rounds follow
// on the column sums, a carry passing from lane k - 1 to lane k.  Integer
// sums are exact in any order, so every limb is fe_mul's.
//
// Phase 1, a cluster of 16 blocks of four warps: warp w of the cluster
// makes window w's sum by horner_plain's double running sum (8 + 6
// complete additions, the two independent additions of each step side by
// side, each product a pair) and writes it into block 0's shared memory
// (distributed shared memory), then the cluster synchronises.  Phase 2,
// block 0: warp g makes product g of each stage of the chain; products
// pass through shared memory between stages, a 128-thread named barrier
// apart.  Both phases keep every operation of horner_plain in its order,
// so the point and the flag equal its limbs.

#define FULL_MASK 0xffffffffu
#define HORNER_CLUSTER 16                   // blocks; 4 windows each
#define HORNER_THREADS 128                  // a warp per window, per product

// a lane's place in its pair: limb k, half (0: even rows, 1: odd), the
// first lane of its ten (base), of the pair (src0) and its partner lane
struct pair_lane {
  int k, half, base, src0, partner;
};

__device__ __forceinline__ pair_lane pair_lane_of(int lane) {
  const int sub = lane / 10;               // lanes 20-31 shadow lanes 0-11
  return pair_lane{lane - 10 * sub, sub & 1, 10 * sub, 20 * (sub >> 1),
                   (sub & 1) ? lane - 10 : lane + 10};
}

// column k of fe_mul(a, b) before the carry, on a pair (lane k: rows
// i = 0, 2, .., 8; lane 10 + k: i = 1, 3, .., 9)
__device__ __forceinline__ int64_t pair_col(int32_t ak, int32_t bk,
                                            const pair_lane& l) {
  int64_t lo = 0, hi = 0;
  // b_j is doubled for odd i and odd j; for odd i, j = k - i is odd iff k is
  // even
  const int32_t scale = l.half ? 2 - (l.k & 1) : 1;
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    const int i = 2 * t + l.half;
    const int j = l.k - i;
    const int32_t ai = __shfl_sync(FULL_MASK, ak, l.src0 + i);
    const int32_t bj =
        __shfl_sync(FULL_MASK, bk, l.src0 + (j < 0 ? j + 10 : j)) * scale;
    const int32_t alo = j < 0 ? 0 : ai, ahi = j < 0 ? ai : 0;
    lo += (int64_t)alo * bj;                 // column k
    hi += (int64_t)ahi * bj;                 // column k + 10, folded x19
  }
  const int64_t col = lo + 19 * hi;
  return col + (int64_t)__shfl_sync(FULL_MASK, (long long)col, l.partner);
}

// fe_carry's round 1 for limb k: its residue and its carry times the
// factor limb k + 1 takes it with (19 into limb 0, else 1), split at limb
// k + 1's width into a quotient and a remainder.  Carries reach 2^38;
// quotient, remainder and residue fit in 32 bits, and so does every later
// round, so rounds 2 and 3 run in 32 bits: limb k's round-2 value is its
// residue plus the incoming remainder, its round-2 carry the incoming
// quotient plus that value's carry.
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

// fe_carry on a group of ten lanes (limb k on lane base + k), round by
// round: each round passes carries from lane k - 1 to lane k
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

// the same limbs with one exchange: lane k takes round 1's outputs of
// limbs k - 1, k - 2 and k - 3 at once and runs rounds 2 and 3 of limbs
// k - 2 .. k itself (limb k after round r depends on limbs k - r .. k
// only): fewer dependent shuffles, more shuffles and arithmetic in all.
// The chain, bound by latency, takes this form; the window sums, where a
// warp runs product after product and the instruction rate bounds it,
// take carry_rounds (each was the faster there on the card).
__device__ __forceinline__ int32_t carry_exchange(int64_t h, int k, int base) {
  const carry_out o = carry_round1(h, k);
  int W[3], F[3];
  int32_t R[3], Q[3], G[3];                  // limbs k - 2 + m, m = 0, 1, 2
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int j = k - 2 + m < 0 ? k + 8 + m : k - 2 + m;
    W[m] = 26 - (j & 1);
    F[m] = j == 0 ? 19 : 1;
    if (m < 2) {
      R[m] = __shfl_sync(FULL_MASK, o.res, base + j);
      Q[m + 1] = __shfl_sync(FULL_MASK, o.quo, base + j);
      G[m + 1] = __shfl_sync(FULL_MASK, o.rem, base + j);
    }
  }
  const int j3 = k < 3 ? k + 7 : k - 3;
  Q[0] = __shfl_sync(FULL_MASK, o.quo, base + j3);
  G[0] = __shfl_sync(FULL_MASK, o.rem, base + j3);
  R[2] = o.res;
  int32_t s[3], e[3], c2[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    s[m] = R[m] + G[m];
    e[m] = (s[m] + (1 << (W[m] - 1))) >> W[m];
    c2[m] = Q[m] + e[m];
  }
  int32_t h2[3], c3[3];
#pragma unroll
  for (int m = 1; m < 3; ++m) {
    h2[m] = s[m] - e[m] * (1 << W[m]) + F[m] * c2[m - 1];
    c3[m] = (h2[m] + (1 << (W[m] - 1))) >> W[m];
  }
  return h2[2] - c3[2] * (1 << W[2]) + F[2] * c3[1];
}

__device__ __forceinline__ int32_t pair_mul(int32_t a, int32_t b,
                                            const pair_lane& l) {
  return carry_rounds(pair_col(a, b, l), l.k, l.base);
}

// limb k of a point's four coordinates
struct lpt {
  int32_t X, Y, Z, T;
};

__device__ __forceinline__ lpt lpt_load(const int32_t* p, int k) {
  return lpt{p[k], p[10 + k], p[20 + k], p[30 + k]};
}

__device__ __forceinline__ void lpt_store(int32_t* p, int k, const lpt& a) {
  p[k] = a.X;
  p[10 + k] = a.Y;
  p[20 + k] = a.Z;
  p[30 + k] = a.T;
}

// ge_add on a pair, product after product in one warp
__device__ __forceinline__ lpt pair_add(const lpt& p, const lpt& q,
                                        int32_t d2k, const pair_lane& l) {
  const int32_t A = pair_mul(p.Y - p.X, q.Y - q.X, l);
  const int32_t B = pair_mul(p.Y + p.X, q.Y + q.X, l);
  const int32_t C = pair_mul(pair_mul(p.T, d2k, l), q.T, l);
  const int32_t D =
      carry_rounds(2 * (int64_t)pair_mul(p.Z, q.Z, l), l.k, l.base);
  const int32_t E = B - A, F = D - C, G = D + C, H = B + A;
  return lpt{pair_mul(E, F, l), pair_mul(G, H, l), pair_mul(F, G, l),
             pair_mul(E, H, l)};
}

#define BAR128() asm volatile("bar.sync 1, 128;" ::: "memory")

// The chain on warps 0-3 of a block: warp g makes product g of each stage
// (lanes 0-9 store it), acc holds the point, tmp a stage's products
__device__ __forceinline__ void horner_chain(const int32_t* win, int32_t* acc,
                                             int32_t* tmp, int32_t* out,
                                             int32_t* flag, int32_t d2k,
                                             const pair_lane& l) {
  const int k = l.k;
  const int g = threadIdx.x >> 5;
  const bool on = (threadIdx.x & 31) < 10;
  const int gk = g * 10 + k;
#define MUL(a, b) carry_exchange(pair_col(a, b, l), k, l.base)
  if (on) acc[gk] = win[63 * 40 + gk];
  BAR128();
#pragma unroll 1
  for (int i = 62; i >= 0; --i) {
#pragma unroll 1
    for (int d = 0; d < 4; ++d) {
      {  // doubling: A = X^2, B = Y^2, C = 2 Z^2, S = (X + Y)^2
        const int32_t x = acc[k], y = acc[10 + k], z = acc[20 + k];
        const int32_t a = g == 0 ? x : g == 1 ? y : g == 2 ? z : x + y;
        int32_t r = MUL(a, a);
        if (g == 2) r = carry_exchange(2 * (int64_t)r, k, l.base);
        if (on) tmp[gk] = r;
      }
      BAR128();
      {  // X = EF, Y = GH, Z = FG, T = EH
        const int32_t A = tmp[k], B = tmp[10 + k], C = tmp[20 + k],
                      S = tmp[30 + k];
        const int32_t H = A + B, E = H - S, G = A - B, F = C + G;
        const int32_t a = g == 0 ? E : g == 1 ? G : g == 2 ? F : E;
        const int32_t b = g == 0 ? F : g == 1 ? H : g == 2 ? G : H;
        const int32_t r = MUL(a, b);
        if (on) acc[gk] = r;
      }
      BAR128();
    }
    const int32_t* q = win + i * 40;
    {  // addition of window i: A, B, T 2d, Z Z'
      const int32_t X = acc[k], Y = acc[10 + k], Z = acc[20 + k],
                    T = acc[30 + k];
      const int32_t X2 = q[k], Y2 = q[10 + k], Z2 = q[20 + k];
      const int32_t a = g == 0 ? Y - X : g == 1 ? Y + X : g == 2 ? T : Z;
      const int32_t b = g == 0 ? Y2 - X2 : g == 1 ? Y2 + X2 : g == 2 ? d2k : Z2;
      const int32_t r = MUL(a, b);
      if (on) tmp[gk] = r;
    }
    BAR128();
    if (g == 2) {  // C = (T 2d) T'
      const int32_t r = MUL(tmp[20 + k], q[30 + k]);
      if (on) tmp[gk] = r;
    } else if (g == 3) {  // D = 2 Z Z'
      const int32_t r = carry_exchange(2 * (int64_t)tmp[30 + k], k, l.base);
      if (on) tmp[gk] = r;
    }
    BAR128();
    {
      const int32_t A = tmp[k], B = tmp[10 + k], C = tmp[20 + k],
                    D = tmp[30 + k];
      const int32_t E = B - A, F = D - C, G = D + C, H = B + A;
      const int32_t a = g == 0 ? E : g == 1 ? G : g == 2 ? F : E;
      const int32_t b = g == 0 ? F : g == 1 ? H : g == 2 ? G : H;
      const int32_t r = MUL(a, b);
      if (on) acc[gk] = r;
    }
    BAR128();
  }
#undef MUL
  if (on) out[gk] = acc[gk];
  if (threadIdx.x == 0) {  // the ristretto is-identity flag: X == 0 or Y == 0
    fe X, Y;
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      X.v[j] = acc[j];
      Y.v[j] = acc[10 + j];
    }
    flag[0] = (fe_is_zero(X) || fe_is_zero(Y)) ? 1 : 0;
  }
}

__global__ void __launch_bounds__(HORNER_THREADS)
horner_kernel(const int32_t* __restrict__ sums, int32_t* __restrict__ out,
              int32_t* __restrict__ flag) {
  __shared__ int32_t win[64 * 40];         // the window sums, in block 0
  __shared__ int32_t acc[40], tmp[40];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  const pair_lane l = pair_lane_of(threadIdx.x & 31);
  const int32_t d2k = FE_D2[l.k];
  const int w = rank * (HORNER_THREADS / 32) + (threadIdx.x >> 5);
  const int32_t* B = sums + (int64_t)w * NBUCKET * 40;
  lpt running = lpt_load(B + (NBUCKET - 1) * 40, l.k);
  lpt total = running;
  running = pair_add(running, lpt_load(B + (NBUCKET - 2) * 40, l.k), d2k, l);
#pragma unroll 1
  for (int b = NBUCKET - 3; b >= 0; --b) {
    const lpt t = pair_add(total, running, d2k, l);
    running = pair_add(running, lpt_load(B + b * 40, l.k), d2k, l);
    total = t;
  }
  total = pair_add(total, running, d2k, l);
  if ((threadIdx.x & 31) < 10)
    lpt_store(cluster.map_shared_rank(win, 0) + w * 40, l.k, total);
  cluster.sync();
  if (rank == 0) horner_chain(win, acc, tmp, out, flag, d2k, l);
}

// niels (3, 10, n) int32, digits (64, n) int8 -> slab (64, 8, 4, 10, lanes)
BP_EXPORT int bp_msm_accumulate(const int32_t* niels, const int8_t* digits,
                                int32_t* slab, int64_t n, int64_t lanes,
                                cudaStream_t stream) {
  dim3 grid((unsigned)(lanes / ACC_THREADS), 64);
  accumulate_kernel<<<grid, ACC_THREADS, 0, stream>>>(niels, digits, slab, n,
                                                      (int)lanes);
  return (int)cudaGetLastError();
}

// pts (4, 10, n) int32, digits (64, n) int8 -> slab (64, 8, 4, 10, lanes)
BP_EXPORT int bp_msm_accumulate_z(const int32_t* pts, const int8_t* digits,
                                  int32_t* slab, int64_t n, int64_t lanes,
                                  cudaStream_t stream) {
  dim3 grid((unsigned)(lanes / ACC_THREADS), 64);
  accumulate_z_kernel<<<grid, ACC_THREADS, 0, stream>>>(pts, digits, slab, n,
                                                        (int)lanes);
  return (int)cudaGetLastError();
}

// slab (64, 8, 4, 10, lanes) -> sums (64, 8, 4, 10)
BP_EXPORT int bp_msm_reduce(const int32_t* slab, int32_t* sums, int64_t lanes,
                            cudaStream_t stream) {
  const size_t smem = sizeof(int32_t) * 40 * (size_t)(lanes / 2);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(reduce_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid(NBUCKET, 64);
  reduce_kernel<<<grid, (unsigned)(lanes / 2), smem, stream>>>(slab, sums,
                                                              (int)lanes);
  return (int)cudaGetLastError();
}

// sums (64, 8, 4, 10) -> out (4, 10), flag (1,) int32: one cluster of
// HORNER_CLUSTER blocks (above the portable 8, so it is allowed first)
BP_EXPORT int bp_msm_horner(const int32_t* sums, int32_t* out, int32_t* flag,
                            cudaStream_t stream) {
  cudaFuncSetAttribute(horner_kernel,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(HORNER_CLUSTER);
  cfg.blockDim = dim3(HORNER_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = HORNER_CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, horner_kernel, sums, out, flag);
  return (int)cudaGetLastError();
}
