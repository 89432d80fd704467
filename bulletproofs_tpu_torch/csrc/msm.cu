// Kernels K3, K11 and K4: the Pippenger multi-scalar multiplication of the
// batch verifier, for Z = 1 points in Niels form, or given as extended
// points that its binning puts in Niels form (K3, the fused route and the
// MSM entry's Niels route), and for points of arbitrary Z (K11, the chunked
// route, whose final MSM adds per-chunk partial results).
//
// K3, msm_bin_niels then msm_accumulate, replaces ops/msm_pallas.py:58
// _accum_kernel_niels (the phase-1 pallas_call of _msm_pallas_niels, :379).
// K11, msm_bin then msm_accumulate_z, replaces :121 _accum_kernel (the
// phase-1 pallas_call of _msm_pallas, :459).  K3 and K11 share one binning
// (two launches: bin_kernel, a template over the point form, then
// rank_kernel) and one accumulation kernel, a template over the form.
// K4 is two launches of this file, after either: msm_reduce replaces :178
// _reduce_kernel (:397, :477) and msm_horner replaces :214 _horner_kernel
// (:412, :492).
//
// Digits are signed base-16 in [-8, 8] (64 windows), so there are 8
// buckets per window (digit 0 adds nothing).  Verifier data is public, so
// the bucket is indexed directly by |digit|; the TPU kernel's one-hot mux
// over all buckets was a Mosaic workaround.
//
// K4 msm_reduce (K4a): grid (8 buckets, 64 windows), a block of two warps a
// bucket; reduce_plain's tree of complete additions over the lanes, in
// registers, then each addition on four lanes -> (64, 8, 4, 10); its
// design is at the kernel below.
// K4 msm_horner (K4b): the window sums S_w = sum_b (b + 1) B_b, then the
// Horner chain sum_w 16^w S_w (63 x (4 doublings + 1 addition)) and the
// ristretto is-identity flag (X == 0 or Y == 0); its design is at the
// kernel below.
//
// Every step is ops/msm.py's plain version in the same order, so the
// slab, the bucket sums and the result match it limb for limb.
#include "common.cuh"
#include "fe25519.cuh"
#include "reduce.cuh"
#include "msm_bin.cuh"

#include <cooperative_groups.h>

#define NBUCKET BIN_BUCKETS

// -- K3 and K11: bucket accumulation over per-lane lists ----------------------
//
// Two launches each, a binning kernel then an accumulation kernel, with the
// slab of the plain version: entry (w, b, ., ., j) is the sum, from the
// identity and in ascending k, of the points k = j (mod lanes) with
// |d[w, k]| = b + 1.  K3 (Niels rows Y+X, Y-X, 2dT of Z = 1 points, the
// fused verifier's static generators and decoded proof points) adds by the
// 7-multiplication mixed addition ge_madd, a negative digit swapping Y+X
// and Y-X and negating 2dT; K11 (points of any Z) by the 9-multiplication
// complete addition ge_add, a negative digit adding (-X : Y : Z : -T).
//
// Bound: operations, one addition per non-zero digit; its limb products
// are about a quarter of the integer instructions it runs (the carries and
// operand sums are the rest; benches/accumulate_z.py counts the kernels'
// SASS), and on the H100 their throughput, not latency, bounds the
// accumulation: the first form kept a thread's 8 buckets in shared memory
// (40 KB a warp, 5 warps an SM), yet 8 to 16 warps an SM moved this form's
// time by a few per cent.  Design: one thread per (window, bucket, lane)
// keeps its one bucket in registers and walks a list of its own points,
// 64 x 8 x lanes threads; the longest lists first; a warp's 32 lists of
// nearly one length.
//
// The binning, two launches (ops/msm.py bin_points and bin_niels), with
// bin_plain's outputs: bit s of mask[w][b][m][j] is set when |d[w, j +
// (32 m + s) lanes]| = b + 1, bit s of sign[w][m][j] when that digit is
// negative, cnt[w][b][j] counts bucket b's bits and perm[w][b][.] lists
// the lanes by count, longest first.  An accumulation thread walks its
// mask's set bits in order: ascending k, digit 0 never listed (index
// lists, tried first, cost 0.5 ms of scattered 4-byte stores at 196,653
// points on the H100).
//
// Bound: bytes (the points and digits read once, the rows and lists
// written once), 0.0049 ms at a verify sub-batch's 34,946 points.  The
// first form ran 64 blocks of `lanes` threads, a window each, so at most 64
// of the 132 SMs binned, and each thread ranked its lane in every bucket
// by comparing it with all 512 lanes: 0.069 ms.  Design:
// - bin_kernel: a thread per (window, lane step, lane) writes its nine
//   words (bin_step of csrc/msm_bin.cuh: 32 digit loads in flight,
//   coalesced across the warp; 64 nm lanes threads), and blocks between
//   them write the point-major rows (row_words), ROW_POINTS points a
//   block through shared memory (a warp's loads are one word of 32
//   neighbouring points, its stores 16 bytes of one row).  The Niels form
//   takes a Niels prefix and Z = 1 extended points after it and makes
//   their rows itself: Y+X and Y-X by limb additions, 2dT by fe_mul
//   (ops/curve.to_niels' limbs), one field product a point, so its
//   callers make no Niels array.
// - rank_kernel: a block per (window, bucket) counts its lanes' bits and
//   ranks them by a counting sort (rank_lanes of csrc/msm_bin.cuh); it
//   needs every step of the window, so it is the second launch.
// A point's row is contiguous: the 32 threads of an accumulation warp read
// 32 unrelated points, and a row is a few sectors where the (c, 10, N)
// layout spreads it over 10 c.  A Niels row (30 words) is padded to 32
// words, one 128-byte line of eight aligned 16-byte loads (at 120 bytes
// every odd row would sit 8 bytes off a 16-byte boundary, and 8-byte loads
// double the load count); an extended row is 40 words, ten 16-byte loads.
#define ACCZ_THREADS 128                 // the accumulation's block
#define ACCZ_MIN_BLOCKS 2                // its blocks per SM
#define MAX_LANES 512                    // ops/msm.py MAX_LANES
#define BIN_THREADS 128                  // bin_kernel's block
#define ROW_POINTS BIN_THREADS           // points of a row block
#define ROW_PAD 41                       // a point's words in shared memory

// the point forms: words of a point, of its row, and its addition
struct niels_form {
  static constexpr int WORDS = 30, ROW = 32;
};
struct ext_form {
  static constexpr int WORDS = 40, ROW = 40;
};

// row_blocks blocks write the rows of ROW_POINTS points each, list_blocks
// a thread per (window, lane step, lane) each; the two kinds alternate
// over the grid, so that an SM runs the rows' loads and stores beside the
// lists' integer work
template <class Form>
__global__ void __launch_bounds__(BIN_THREADS)
bin_kernel(const int32_t* __restrict__ pre, int64_t n0,
           const int32_t* __restrict__ pts, const int8_t* __restrict__ digits,
           int32_t* __restrict__ rows, uint32_t* __restrict__ mask,
           uint32_t* __restrict__ sign, int64_t n, int lanes, int nm,
           int row_blocks, int list_blocks) {
  constexpr int W = Form::WORDS, R = Form::ROW;
  __shared__ int32_t tile[ROW_POINTS * ROW_PAD];
  const int fewer = row_blocks < list_blocks ? row_blocks : list_blocks;
  const int b = blockIdx.x;
  const bool row = b < 2 * fewer ? !(b & 1) : row_blocks > list_blocks;
  const int idx = b < 2 * fewer ? b >> 1 : b - fewer;
  if (row) {
    const int64_t k0 = (int64_t)idx * ROW_POINTS;
    row_words<W>(pre, n0, pts, n, k0 + threadIdx.x,
                 tile + threadIdx.x * ROW_PAD);
    __syncthreads();
    int4* out = reinterpret_cast<int4*>(rows + k0 * R);
    for (int i = threadIdx.x; i < ROW_POINTS * R / 4; i += BIN_THREADS) {
      const int p = 4 * i / R, c = 4 * i % R;
      if (k0 + p >= n) break;
      const int32_t* t = tile + p * ROW_PAD + c;
      out[i] = make_int4(t[0], t[1], c + 2 < W ? t[2] : 0,
                         c + 3 < W ? t[3] : 0);
    }
    return;
  }
  // lanes is a power of two; 64 nm lanes < 2^31
  const unsigned t = (unsigned)idx * BIN_THREADS + threadIdx.x;
  if (t >= 64u * nm * lanes) return;
  const unsigned j = t & (lanes - 1), q = t / lanes, m = q % nm,
                 w = q / nm;
  const int64_t k0 = j + (int64_t)32 * m * lanes;
  uint32_t bits[NBUCKET], neg;
  bin_step(digits + (int64_t)w * n + k0, n - k0, lanes, bits, neg);
  uint32_t* mrow = mask + ((int64_t)w * NBUCKET * nm + m) * lanes + j;
#pragma unroll
  for (int b2 = 0; b2 < NBUCKET; ++b2)
    mrow[(int64_t)b2 * nm * lanes] = bits[b2];
  sign[((int64_t)w * nm + m) * lanes + j] = neg;
}

struct block_barrier {
  __device__ void operator()() const { __syncthreads(); }
};

// block w * 8 + b, `lanes` threads: cnt[w][b][j] from the mask words of
// lane j, then the bucket's lanes ranked into perm[w][b] (32 nm + 1 ints
// of dynamic shared memory, the counts' histogram)
__global__ void __launch_bounds__(MAX_LANES)
rank_kernel(const uint32_t* __restrict__ mask, int32_t* __restrict__ cnt,
            int32_t* __restrict__ perm, int lanes, int nm) {
  extern __shared__ int hist[];
  __shared__ int cs[MAX_LANES];
  const int64_t g = blockIdx.x;
  const int j = threadIdx.x;
  const uint32_t* mrow = mask + g * nm * lanes + j;
  int count = 0;                         // four loads in flight
#pragma unroll 4
  for (int m = 0; m < nm; ++m) count += __popc(__ldg(mrow + (int64_t)m * lanes));
  cnt[g * lanes + j] = count;
  rank_lanes(j, lanes, count, 32 * nm + 1, cs, hist, perm + g * lanes,
             block_barrier());
}

// the R words of row k, R / 4 aligned 16-byte loads
template <int R>
__device__ __forceinline__ void row_load(const int32_t* __restrict__ rows,
                                         int64_t k, int32_t (&v)[R]) {
  const int4* r = reinterpret_cast<const int4*>(rows + k * R);
#pragma unroll
  for (int i = 0; i < R / 4; ++i) {
    const int4 x = __ldg(r + i);
    v[4 * i] = x.x;
    v[4 * i + 1] = x.y;
    v[4 * i + 2] = x.z;
    v[4 * i + 3] = x.w;
  }
}

// acc + (+-point k): ge_madd with Y+X and Y-X swapped and 2dT negated for a
// negative digit
__device__ __forceinline__ ge add_row(const ge& acc, niels_form,
                                      const int32_t* __restrict__ rows,
                                      int64_t k, bool neg) {
  int32_t v[niels_form::ROW];
  row_load(rows, k, v);
  fe ypx, ymx, t2d;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    ypx.v[i] = v[i];
    ymx.v[i] = v[10 + i];
    t2d.v[i] = v[20 + i];
  }
  ge_niels q;
  q.ypx = fe_select(neg, ymx, ypx);
  q.ymx = fe_select(neg, ypx, ymx);
  q.t2d = fe_select(neg, fe_neg(t2d), t2d);
  return ge_madd(acc, q);
}

// acc + (+-point k): ge_add with X and T negated for a negative digit
__device__ __forceinline__ ge add_row(const ge& acc, ext_form,
                                      const int32_t* __restrict__ rows,
                                      int64_t k, bool neg) {
  int32_t v[ext_form::ROW];
  row_load(rows, k, v);
  ge q;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    q.X.v[i] = v[i];
    q.Y.v[i] = v[10 + i];
    q.Z.v[i] = v[20 + i];
    q.T.v[i] = v[30 + i];
  }
  q.X = fe_select(neg, fe_neg(q.X), q.X);
  q.T = fe_select(neg, fe_neg(q.T), q.T);
  return ge_add(acc, q);
}

// window and bucket of thread group g (the 64 x 8 groups of `lanes`
// threads): window 63 first, since a 253-bit scalar's top digit is 0 or 1,
// so bucket 0 of window 63 holds about half the points, the longest lists
__device__ __forceinline__ void group_wb(int64_t g, int& w, int& b) {
  w = 63 - (int)(g / NBUCKET);
  b = (int)(g % NBUCKET);
}

// thread (w, b, j) adds its list's points into one bucket in registers
// and writes it to slab[w][b][c][limb][j] once (the identity for an empty
// list).  Thread r of group (w, b) takes lane perm[w][b][r], so a warp's 32
// lists are of nearly one length (a warp runs as long as its longest) and
// the longest start first.  Blocks are of four warps, two an SM: a block
// holds its registers until its longest warp ends, and a larger one spans
// more of a group's lengths.
template <class Form>
__global__ void __launch_bounds__(ACCZ_THREADS, ACCZ_MIN_BLOCKS)
accumulate_kernel(const int32_t* __restrict__ rows,
                  const uint32_t* __restrict__ mask,
                  const uint32_t* __restrict__ sign,
                  const int32_t* __restrict__ cnt,
                  const int32_t* __restrict__ perm,
                  int32_t* __restrict__ slab, int lanes, int nm) {
  const int64_t t = (int64_t)blockIdx.x * ACCZ_THREADS + threadIdx.x;
  int w, b;
  group_wb(t / lanes, w, b);
  const int64_t g = (int64_t)w * NBUCKET + b;
  const int j = perm[g * lanes + t % lanes];
  const int total = cnt[g * lanes + j];
  const uint32_t* mrow = mask + g * nm * lanes + j;
  const uint32_t* srow = sign + (int64_t)w * nm * lanes + j;
  ge acc = ge_identity();
  uint32_t bits = 0, neg = 0;
  int m = -1;
  for (int i = 0; i < total; ++i) {
    while (bits == 0) {
      ++m;
      bits = __ldg(mrow + (int64_t)m * lanes);
      neg = __ldg(srow + (int64_t)m * lanes);
    }
    const int s = __ffs(bits) - 1;
    bits &= bits - 1;
    acc = add_row(acc, Form(), rows, j + (int64_t)(32 * m + s) * lanes,
                  (neg >> s) & 1);
  }
  ge_store(slab + g * 40 * lanes + j, lanes, acc);
}

// -- K4a: the bucket reduction ----------------------------------------------
//
// Bound: operations, 64 x 8 x (lanes - 1) complete additions (0.028 ms at
// 512 lanes counting the limb products' multiply-adds; a ge_add compiles to
// ~3,600 integer instructions, each at half rate, so the issue of all of
// them takes longer).  The first form ran one block of lanes / 2 threads a
// bucket, a 9-level tree in shared memory with a barrier at every level,
// in four waves of 512 blocks (208 registers, 8 warps an SM): from the
// second level on at least half of each block was idle, and the last five
// levels ran one point addition at a time in one warp, ~12,000 cycles
// each.  Design (csrc/reduce.cuh): a bucket is a block of two warps, four
// blocks an SM, so all 512 buckets are resident at once (one wave on 132
// SMs).  Each thread adds its own lanes (t mod 64) in registers, the two
// warps of a sub-partition side by side; the last six levels run each
// addition on four lanes over shared memory, one field product a lane a
// stage, three stages deep.  The pairs and the products are
// reduce_plain's, so the sums (and K4b's inputs) are its limbs.
#define REDUCE_BLOCKS_PER_SM 4

struct warp_barrier {
  __device__ void operator()() const { __syncwarp(); }
};

struct reduce_points {
  using value = ge;
  const int32_t* src;                  // the bucket's (4, 10, lanes) slab
  int lanes;
  int32_t* nodes;                      // (REDUCE_THREADS, 40) shared words
  int32_t* scratch;                    // (REDUCE_GROUPS, 40) shared words
  __device__ ge load(int j) const { return ge_load(src + j, lanes); }
  __device__ ge add(const ge& a, const ge& b) const { return ge_add(a, b); }
  __device__ void put(int t, const ge& p) const {
    ge_store(nodes + 40 * t, 1, p);
  }
  __device__ void add_nodes(int dst, int from, int role, bool active,
                            int group) const {
    ge_add_on_four_lanes(nodes, scratch + 40 * group, dst, from, role,
                         active, warp_barrier());
  }
  __device__ void sync() const { __syncthreads(); }
};

__global__ void __launch_bounds__(REDUCE_THREADS, REDUCE_BLOCKS_PER_SM)
reduce_kernel(const int32_t* __restrict__ slab, int32_t* __restrict__ sums,
              int lanes) {
  __shared__ int32_t nodes[40 * REDUCE_THREADS];
  __shared__ int32_t scratch[40 * REDUCE_GROUPS];
  const int wb = blockIdx.y * NBUCKET + blockIdx.x;
  reduce_points b{slab + (int64_t)wb * 40 * lanes, lanes, nodes, scratch};
  reduce_bucket(b, threadIdx.x, lanes);
  if (threadIdx.x < 40)
    sums[(int64_t)wb * 40 + threadIdx.x] = nodes[threadIdx.x];
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

template <class Form>
static int bin_launch(const int32_t* pre, int64_t n0, const int32_t* pts,
                      const int8_t* digits, int32_t* rows, uint32_t* mask,
                      uint32_t* sign, int64_t n, int64_t lanes,
                      cudaStream_t stream) {
  const int nm = (int)((n + 32 * lanes - 1) / (32 * lanes));
  const int row_blocks = (int)((n + ROW_POINTS - 1) / ROW_POINTS);
  const int list_blocks =
      (int)((64 * nm * lanes + BIN_THREADS - 1) / BIN_THREADS);
  bin_kernel<Form><<<(unsigned)(row_blocks + list_blocks), BIN_THREADS, 0,
                     stream>>>(pre, n0, pts, digits, rows, mask, sign, n,
                               (int)lanes, nm, row_blocks, list_blocks);
  return (int)cudaGetLastError();
}

template <class Form>
static int accumulate_launch(const int32_t* rows, const uint32_t* mask,
                             const uint32_t* sign, const int32_t* cnt,
                             const int32_t* perm, int32_t* slab, int64_t n,
                             int64_t lanes, cudaStream_t stream) {
  const int nm = (int)((n + 32 * lanes - 1) / (32 * lanes));
  const unsigned blocks = (unsigned)(64 * NBUCKET * lanes / ACCZ_THREADS);
  accumulate_kernel<Form><<<blocks, ACCZ_THREADS, 0, stream>>>(
      rows, mask, sign, cnt, perm, slab, (int)lanes, nm);
  return (int)cudaGetLastError();
}

// K3's binning, first launch: a Niels prefix pre (3, 10, n0) int32 and
// Z = 1 points pts (4, 10, n - n0) int32 (either part may be empty; pre
// may be null when n0 = 0), digits (64, n) int8 -> rows (n, 32) (the Niels
// words of cat(pre, to_niels(pts)), two pad words 0), mask (64, 8, nm,
// lanes) and sign (64, nm, lanes); nm = ceil(n / (32 lanes)), a lane's
// words of 32 steps.  bp_msm_rank is the second launch.
BP_EXPORT int bp_msm_bin_niels(const int32_t* pre, int64_t n0,
                               const int32_t* pts, const int8_t* digits,
                               int32_t* rows, uint32_t* mask, uint32_t* sign,
                               int64_t n, int64_t lanes, cudaStream_t stream) {
  return bin_launch<niels_form>(pre, n0, pts, digits, rows, mask, sign, n,
                                lanes, stream);
}

// K11's binning, first launch: pts (4, 10, n) int32 -> rows (n, 40), the
// rest as K3's
BP_EXPORT int bp_msm_bin(const int32_t* pts, const int8_t* digits,
                         int32_t* rows, uint32_t* mask, uint32_t* sign,
                         int64_t n, int64_t lanes, cudaStream_t stream) {
  return bin_launch<ext_form>(nullptr, 0, pts, digits, rows, mask, sign, n,
                              lanes, stream);
}

// Both binnings' second launch: mask (64, 8, nm, lanes) -> cnt and perm
// (64, 8, lanes), a block a (window, bucket)
BP_EXPORT int bp_msm_rank(const uint32_t* mask, int32_t* cnt, int32_t* perm,
                          int64_t n, int64_t lanes, cudaStream_t stream) {
  const int nm = (int)((n + 32 * lanes - 1) / (32 * lanes));
  const int smem = (32 * nm + 1) * (int)sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  rank_kernel<<<64 * NBUCKET, (unsigned)lanes, smem, stream>>>(
      mask, cnt, perm, (int)lanes, nm);
  return (int)cudaGetLastError();
}

// K3: rows, mask, sign, cnt, perm of bp_msm_bin_niels -> slab (64, 8, 4,
// 10, lanes)
BP_EXPORT int bp_msm_accumulate(const int32_t* rows, const uint32_t* mask,
                                const uint32_t* sign, const int32_t* cnt,
                                const int32_t* perm, int32_t* slab, int64_t n,
                                int64_t lanes, cudaStream_t stream) {
  return accumulate_launch<niels_form>(rows, mask, sign, cnt, perm, slab, n,
                                       lanes, stream);
}

// K11: rows, mask, sign, cnt, perm of bp_msm_bin -> slab (64, 8, 4, 10,
// lanes)
BP_EXPORT int bp_msm_accumulate_z(const int32_t* rows, const uint32_t* mask,
                                  const uint32_t* sign, const int32_t* cnt,
                                  const int32_t* perm, int32_t* slab,
                                  int64_t n, int64_t lanes,
                                  cudaStream_t stream) {
  return accumulate_launch<ext_form>(rows, mask, sign, cnt, perm, slab, n,
                                     lanes, stream);
}

// blocks that one SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and their threads:
// out = {K11 blocks, ACCZ_THREADS, msm_bin blocks, BIN_THREADS, K3 blocks,
// msm_bin_niels blocks, K4a blocks, REDUCE_THREADS}
BP_EXPORT int bp_msm_blocks_per_sm(int* out) {
  out[1] = ACCZ_THREADS;
  out[3] = BIN_THREADS;
  out[7] = REDUCE_THREADS;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, accumulate_kernel<ext_form>, ACCZ_THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2, bin_kernel<ext_form>, BIN_THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 4, accumulate_kernel<niels_form>, ACCZ_THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 5, bin_kernel<niels_form>, BIN_THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 6, reduce_kernel, REDUCE_THREADS, 0);
  return (int)err;
}

// slab (64, 8, 4, 10, lanes) -> sums (64, 8, 4, 10): a block a bucket
BP_EXPORT int bp_msm_reduce(const int32_t* slab, int32_t* sums, int64_t lanes,
                            cudaStream_t stream) {
  if (lanes < 2 || lanes > MAX_LANES || (lanes & (lanes - 1)))
    return (int)cudaErrorInvalidValue;
  reduce_kernel<<<dim3(NBUCKET, 64), REDUCE_THREADS, 0, stream>>>(
      slab, sums, (int)lanes);
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
