// The chain step of kernels K15 and K16 (csrc/fmul13.cu): a lane's step
// a <- carry(fmul(a, b1) + fmul(a, b2) + fmul(a, b3)) spread over a warp,
// thread k holding limb k (k < 20; threads 20..31 idle).
//
// Thread k's two columns of product j are c_j[k] (k + 1 products) and
// c_j[20 + k] (19 - k products; none at k = 19, whose c_j[39] is 0).
// fold_tail's lo[k] = c[k] + 608 (c[20 + k] & MASK) + 608 (c[19 + k] >> 13)
// then needs one value of thread k - 1 (c[19 + k] is its c[20 + k - 1]),
// and each carry round one more (limb k - 1's carry; limb 19's, times 608,
// into limb 0).  Sums and products wrap mod 2^32 (uint32 here) and shifts
// are arithmetic on int32, as in ops/pallas_math.py and the plain
// versions, so the order of a column's additions is free but every `>>`
// and `&` sees the plain version's value.
//
// K15 (CUDA cores): thread k gathers a_{(k - l) mod 20} for l = 0..19 by
// shuffles, reads the operands b_j[l] as broadcasts from shared memory and
// makes its two columns per operand: product l goes to c[k] when l <= k,
// else to c[20 + k].  The split point differs per thread, so a thread
// makes their sum (all 20 products) and the smaller of the two apart:
// 90 multiply-adds a step (a split by a zero factor took 120).
//
// K16 (int8 tensor cores, mma.sync m16n8k32): P = M(b) A over 8 lanes,
// A = [a & 127; a >> 7].  The rows of P1 and P3 of M ([band | 0]) are
// non-zero only in columns 0-19, those of P2 and P4 ([0 | band]) only in
// 20-39, so tile (G, h) takes one k32 step over half h of the columns:
// rows 0-7 are P1 (h = 0) or P2 (h = 1) of the 8 columns of group G, rows
// 8-15 P3 or P4 of the same columns.  Its k positions 4t + i are the
// half's columns 4t + i, positions 16 + i (i < 4) columns 16 + i, the
// other 12 zero: thread (g, t) loads one word of each of its two rows
// (and thread t = 0 one more), and the lanes' split is read the same way.
// A group's 8 columns share a parity and differ mod 16 (fm_col), so the 32
// threads' words of a load fall in 32 banks.  The accumulator of thread
// (g, t) then holds P1, P3 (tile h = 0) and P2, P4 (h = 1) of a column
// for lanes 2t, 2t + 1, so c = P1 + 128 (P2 + P3) + 16384 P4 is formed in
// the thread.  Five column groups, two halves and three operands: 30 mma
// a step for 8 lanes.  The tail runs ten threads a lane, two limbs a
// thread (fm_tail2): three lanes a warp.
#pragma once
#include <stdint.h>

#define FL 20             // limbs
#define FN 39             // column sums
#define FMASK 8191u
#define FTOP 608u         // 2^260 mod p
#define MROWS 156         // rows of a banded matrix M(b): P1..P4, 39 each
#define MCOLS 40          // its columns: the 7-bit halves of 20 limbs
#define MSTEP_BYTES (MROWS * MCOLS)  // one operand's matrix of one step
#define MMA_LANES 8       // lanes of one mma (its n)
#define MMA_PAIRS 15      // (operand, column group) pairs of 8 lanes a step
#define CS_PITCH 40       // words of a (lane, operand) row of column sums
#define SP_PITCH 80       // bytes of a lane's int8 split (two 32-byte rows)

// -- the card's primitives (a host harness defines its own) -----------------------
#ifndef FMUL13_HOST
__device__ __forceinline__ int32_t fm_shfl(int32_t v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}

__device__ __forceinline__ int32_t fm_shfl_up1(int32_t v) {
  return __shfl_up_sync(0xffffffffu, v, 1);
}

// 16 bytes of shared memory (16-byte aligned) as four words
__device__ __forceinline__ void fm_ld4(const int32_t* p, uint32_t v[4]) {
  const int4 q = *reinterpret_cast<const int4*>(p);
  v[0] = (uint32_t)q.x;
  v[1] = (uint32_t)q.y;
  v[2] = (uint32_t)q.z;
  v[3] = (uint32_t)q.w;
}

// a word of shared memory (4-byte aligned)
__device__ __forceinline__ uint32_t fm_ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += A B, A 16 x 32 and B 32 x 8 int8, d 16 x 8 int32 (PTX's fragments)
__device__ __forceinline__ void fm_mma(int32_t d[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// -- the tail, both kernels -------------------------------------------------------

// one round of pallas_math.carry on thread k's limb v: v & MASK plus limb
// src's carry times mul (src = k - 1, mul = 1; at k = 0 src = 19, mul = 608)
__device__ __forceinline__ uint32_t fm_carry(uint32_t v, int src, uint32_t mul) {
  const int32_t cr = fm_shfl((int32_t)v >> 13, src);
  return (v & FMASK) + mul * (uint32_t)cr;
}

// thread k's limb of carry(y_0 + y_1 + y_2), y_j = fold_tail(c_j), from
// lo[j] = c_j[k] and hi[j] = c_j[20 + k]; the three tails interleave
__device__ __forceinline__ uint32_t fm_tail(const uint32_t lo[3],
                                            const uint32_t hi[3], int k) {
  const int src = k == 0 ? FL - 1 : k - 1;
  const uint32_t mul = k == 0 ? FTOP : 1u;
  uint32_t v[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int32_t prev = fm_shfl_up1((int32_t)hi[j]);      // c_j[19 + k]
    v[j] = lo[j] + FTOP * (hi[j] & FMASK) +
           (k == 0 ? 0u : FTOP * (uint32_t)(prev >> 13));
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int j = 0; j < 3; ++j) v[j] = fm_carry(v[j], src, mul);
  return fm_carry(v[0] + v[1] + v[2], src, mul);
}

// -- K15 ---------------------------------------------------------------------------

// thread k's columns of the step's three products: lo[j] = c_j[k],
// hi[j] = c_j[20 + k].  a is thread k's limb (0 at k >= 20); b the step's
// operands b_j[l] at b[20 j + l] in shared memory, 16-byte aligned, read
// as broadcasts; x_l = a_{(k - l) mod 20} by shuffles.  lo + hi is the
// cyclic sum over all l (60 multiply-adds), and the smaller of the two, at
// most 10 products (c[k] for k < 10: l = 0..k; c[20 + k] for k >= 10:
// l = 19..k + 1), is made apart (30), so the other is their difference
// (exact mod 2^32): 90 multiply-adds, 60 of them the 1,200 products' share
__device__ __forceinline__ void fm_columns_vpu(uint32_t a, const int32_t* b,
                                               int k, uint32_t lo[3],
                                               uint32_t hi[3]) {
  uint32_t bl[3 * FL], x[FL];
#pragma unroll
  for (int q = 0; q < 3 * FL / 4; ++q) fm_ld4(b + 4 * q, bl + 4 * q);
  x[0] = a;
#pragma unroll
  for (int l = 1; l < FL; ++l) {
    const int d = k - l;
    x[l] = (uint32_t)fm_shfl((int32_t)a, d < 0 ? d + FL : d);
  }
  const bool low = k < FL / 2;
  uint32_t full[3] = {0u, 0u, 0u}, part[3] = {0u, 0u, 0u};
#pragma unroll
  for (int l = 0; l < FL; ++l)
#pragma unroll
    for (int j = 0; j < 3; ++j) full[j] += bl[FL * j + l] * x[l];
#pragma unroll
  for (int i = 0; i < FL / 2; ++i) {
    const int l = low ? i : FL - 1 - i;
    const bool in = low ? i <= k : l > k;
    const uint32_t xs = in ? (low ? x[i] : x[FL - 1 - i]) : 0u;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      part[j] += (low ? bl[FL * j + i] : bl[FL * j + FL - 1 - i]) * xs;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    lo[j] = low ? part[j] : full[j] - part[j];
    hi[j] = low ? full[j] - part[j] : part[j];
  }
}

// -- K16 ---------------------------------------------------------------------------

// column of thread g's rows in group G (39: none): groups 0-3 the even
// columns 0-14 and 16-30, the odd 1-15 and 17-31; group 4 the rest
__device__ __forceinline__ int fm_col(int G, int g) {
  return G < 4 ? 16 * (G & 1) + (G >> 1) + 2 * g : g < 4 ? 32 + 2 * g : 25 + 2 * g;
}

// row of M behind row r (0..15) of tile (G, h), or -1 past column 38
__device__ __forceinline__ int fm_tile_row(int G, int h, int r) {
  const int col = fm_col(G, r & 7);
  return col < FN ? (r >> 3) * 2 * FN + h * FN + col : -1;
}

// word of column c of (block lane L, operand j) in the column sums: a
// tail thread's four columns 2u, 2u + 1, 20 + 2u, 21 + 2u side by side
__device__ __forceinline__ int fm_cs_at(int L, int j, int c) {
  const int cc = c < FL ? c : c - FL;
  return (L * 3 + j) * CS_PITCH + 4 * (cc >> 1) + 2 * (c >= FL) + (cc & 1);
}

// pair p of a block (8 lanes, operand, column group): p / 15 is the lane
// group, (p % 15) / 5 the operand, p % 5 the column group G; warp w of
// `warps` takes pairs w, w + warps, ... (at most PMAX), two tiles each.
// A step's three matrices lie `jstride` bytes apart, then (at 3 jstride)
// a zero row of 32 bytes.  Thread (g, t)'s A fragment of tile (G, h):
// registers 0 / 1 (rows g, g + 8) are columns 20h + 4t .. + 3, registers
// 2 / 3 columns 20h + 16 .. 19 for t = 0 and zero for the others; a row
// past column 38 reads the zero row.  What a thread loads and where it
// stores its sums is fixed for the whole chain, so the plan is made once.
template <int PMAX>
struct FmPlan {
  int n;                       // the warp's pairs (warp-uniform)
  int frag[PMAX][4];           // byte offsets of its tiles' rows g, g + 8
  int sum[PMAX][2];            // words of its column sums, lanes 2t, 2t + 1
  int group[PMAX];             // lane group
  bool first;                  // t = 0: registers 2, 3 hold columns 16-19
};

template <int PMAX>
__device__ __forceinline__ void fm_plan(int w, int warps, int pairs,
                                        int jstride, int lane,
                                        FmPlan<PMAX>& pl) {
  const int g = lane >> 2, t = lane & 3;
  pl.n = 0;
  pl.first = t == 0;
#pragma unroll
  for (int i = 0; i < PMAX; ++i) {
    const int p = w + i * warps;
    if (p < pairs) pl.n = i + 1;
    const int G = p % 5, j = (p % MMA_PAIRS) / 5, grp = p / MMA_PAIRS;
    const int col = fm_col(G, g);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        pl.frag[i][2 * h + r] =
            col < FN ? j * jstride + fm_tile_row(G, h, g + 8 * r) * MCOLS +
                           20 * h + 4 * t
                     : 3 * jstride;    // +16 stays in the zero row
    pl.sum[i][0] = fm_cs_at(MMA_LANES * grp + 2 * t, j, col);
    pl.sum[i][1] = fm_cs_at(MMA_LANES * grp + 2 * t + 1, j, col);
    pl.group[i] = grp;
  }
}

template <int PMAX>
struct FmFrags {
  uint32_t x[PMAX][4], y[PMAX][4];
};

// the A fragments of a warp's pairs from one step's matrices at m, a word
// a load straight into the mma's registers (the t = 0 threads' second
// words by predicated loads, zero elsewhere): no load's value is used
// before the mma, a phase later
template <int PMAX>
__device__ __forceinline__ void fm_load_frags(const uint8_t* m,
                                              const FmPlan<PMAX>& pl,
                                              FmFrags<PMAX>& f) {
#pragma unroll
  for (int i = 0; i < PMAX; ++i)
    if (i < pl.n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int x = pl.frag[i][r], y = pl.frag[i][2 + r];
        f.x[i][r] = fm_ld32(m + x);
        f.y[i][r] = fm_ld32(m + y);
        f.x[i][2 + r] = pl.first ? fm_ld32(m + x + 16) : 0u;
        f.y[i][2 + r] = pl.first ? fm_ld32(m + y + 16) : 0u;
      }
    }
}

// thread (g, t)'s B fragment of half h: the words of block lane `lane`'s
// split that face the same columns.  A lane's SP_PITCH bytes hold a & 127
// of limb k at byte k and (a >> 7) at byte 32 + k, zeros elsewhere (bytes
// 20-31 of each half: the second word of t > 0).
__device__ __forceinline__ void fm_frag_split(const uint8_t* sp, int lane,
                                              int h, int t, uint32_t b[2]) {
  const uint8_t* p = sp + lane * SP_PITCH + 32 * h + 4 * t;
  b[0] = fm_ld32(p);
  b[1] = fm_ld32(p + 16);
}

// c = P1 + 128 (P2 + P3) + 16384 P4 of column 8G + g for lanes 2t, 2t + 1,
// from the accumulators of tiles h = 0 (x: P1, P3) and h = 1 (y: P2, P4)
__device__ __forceinline__ void fm_combine(const int32_t x[4], const int32_t y[4],
                                           uint32_t c[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (uint32_t)x[i] + 128u * ((uint32_t)y[i] + (uint32_t)x[i + 2]) +
           16384u * (uint32_t)y[i + 2];
}

// a warp's products of a step: the B fragments of each of the block's
// GROUPS lane groups, then every pair's two mma, then their column sums to
// cs (no load or mma waits for the one before it)
template <int PMAX, int GROUPS>
__device__ __forceinline__ void fm_mma_phase(const FmFrags<PMAX>& f,
                                             const FmPlan<PMAX>& pl,
                                             const uint8_t* sp, uint32_t* cs,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t bx[GROUPS][2], by[GROUPS][2];
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    fm_frag_split(sp, MMA_LANES * k + g, 0, t, bx[k]);
    fm_frag_split(sp, MMA_LANES * k + g, 1, t, by[k]);
  }
  int32_t dx[PMAX][4] = {}, dy[PMAX][4] = {};
#pragma unroll
  for (int i = 0; i < PMAX; ++i)
    if (i < pl.n) {
      uint32_t b0[2] = {bx[0][0], bx[0][1]}, b1[2] = {by[0][0], by[0][1]};
#pragma unroll
      for (int k = 1; k < GROUPS; ++k)    // lane group (uniform)
        if (pl.group[i] == k) {
          b0[0] = bx[k][0];
          b0[1] = bx[k][1];
          b1[0] = by[k][0];
          b1[1] = by[k][1];
        }
      fm_mma(dx[i], f.x[i], b0);
      fm_mma(dy[i], f.y[i], b1);
    }
#pragma unroll
  for (int i = 0; i < PMAX; ++i)
    if (i < pl.n) {
      uint32_t c[2];
      fm_combine(dx[i], dy[i], c);
      cs[pl.sum[i][0]] = c[0];
      cs[pl.sum[i][1]] = c[1];
    }
}

// one carry round on limbs 2u, 2u + 1 of thread u: limb 2u takes limb
// 2u - 1's carry from thread src (limb 19's, times mul = 608, at u = 0)
__device__ __forceinline__ void fm_carry2(uint32_t& v0, uint32_t& v1, int src,
                                          uint32_t mul) {
  const int32_t in = fm_shfl((int32_t)v1 >> 13, src);
  v1 = (v1 & FMASK) + (uint32_t)((int32_t)v0 >> 13);
  v0 = (v0 & FMASK) + mul * (uint32_t)in;
}

// K16's tail: block lane L's limbs 2u, 2u + 1 of carry(y_0 + y_1 + y_2) on
// thread 10 s + u of its warp (u < 10, s = L % 3: three lanes a warp), from
// the column sums in cs; threads 30, 31 and unused lane slots read lane 0
__device__ __forceinline__ void fm_tail2(const uint32_t* cs, int L, int s,
                                         int u, uint32_t& a0, uint32_t& a1) {
  const uint32_t* row = cs + fm_cs_at(L, 0, 2 * (u < 10 ? u : 0));
  const int src = 10 * s + (u == 0 ? 9 : u - 1);
  const uint32_t mul = u == 0 ? FTOP : 1u;
  uint32_t v0[3], v1[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    uint32_t c[4];                 // c[2u], c[2u + 1], c[20 + 2u], c[21 + 2u]
    fm_ld4((const int32_t*)row + j * CS_PITCH, c);
    const int32_t prev = fm_shfl((int32_t)c[3], src);      // c[19 + 2u]
    v0[j] = c[0] + FTOP * (c[2] & FMASK) +
            (u == 0 ? 0u : FTOP * (uint32_t)(prev >> 13));
    v1[j] = c[1] + FTOP * (c[3] & FMASK) + FTOP * (uint32_t)((int32_t)c[2] >> 13);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int j = 0; j < 3; ++j) fm_carry2(v0[j], v1[j], src, mul);
  a0 = v0[0] + v0[1] + v0[2];
  a1 = v1[0] + v1[1] + v1[2];
  fm_carry2(a0, a1, src, mul);
}

// limbs 2u, 2u + 1 of block lane L's int8 split (the JAX astype's wrap
// above 2^14), as two 2-byte stores
__device__ __forceinline__ void fm_put_split2(uint8_t* sp, int L, int u,
                                              uint32_t a0, uint32_t a1) {
  uint8_t* p = sp + L * SP_PITCH;
  *reinterpret_cast<uint16_t*>(p + 2 * u) =
      (uint16_t)((a0 & 127u) | (a1 & 127u) << 8);
  *reinterpret_cast<uint16_t*>(p + 32 + 2 * u) =
      (uint16_t)(((uint32_t)((int32_t)a0 >> 7) & 255u) |
                 ((uint32_t)((int32_t)a1 >> 7) & 255u) << 8);
}
