// The binning of kernels K3 and K11 (csrc/msm.cu bin_kernel, rank_kernel):
// a point's row words, one lane step's bucket masks, and one bucket's lanes
// ranked by their list lengths.  ops/msm.py bin_points_plain and bin_plain
// are the plain versions: every row word, mask, sign, count and rank here
// is theirs, bit for bit.
//
// The rank is a counting sort over one bucket's `lanes` counts (each at
// most 32 nm, a lane's points): a histogram of the counts, its suffix sum
// (start[c], the lanes of count above c: the first rank of count c), then
// a stable scatter in ascending lane order, 32 lanes at a time by one warp
// (lanes of one count in one step take consecutive ranks by lane).  So
// perm lists the lanes by count, largest first, ties by the lower lane:
// bin_plain's stable sort of -cnt, and the old kernel's key count * 1024 +
// (1023 - j).  The parent kernel ranked each lane by comparing it with
// every lane, 8 x 512 dependent compare-adds a thread.
#pragma once
#include <stdint.h>

#include "fe25519.cuh"

#ifndef MSM_BIN_HOST
__device__ __forceinline__ uint32_t br_match(int v) {
  return __match_any_sync(0xffffffffu, v);
}
__device__ __forceinline__ int br_shfl_down(int v, int d) {
  return __shfl_down_sync(0xffffffffu, v, d);
}
__device__ __forceinline__ void br_syncwarp() { __syncwarp(); }
__device__ __forceinline__ void br_add(int* p, int v) { atomicAdd(p, v); }
__device__ __forceinline__ int br_popc(uint32_t x) { return __popc(x); }
#endif

#define BIN_BUCKETS 8

// Point k's W row words into t: an extended point's 40 (W = 40, K11); a
// Niels prefix point's 30 (k < n0), or Y+X, Y-X, 2dT of the Z = 1 extended
// point k - n0 after it (W = 30, K3): curve.to_niels' limbs.
// Thread p of a block takes point k0 + p, so a word's loads are coalesced
// across the warp; all of a thread's loads are in flight at once.
template <int W>
__device__ __forceinline__ void row_words(const int32_t* __restrict__ pre,
                                         int64_t n0,
                                         const int32_t* __restrict__ pts,
                                         int64_t n, int64_t k, int32_t* t) {
  if (k >= n) return;
  int32_t v[W];
  if constexpr (W == 40) {
#pragma unroll
    for (int c = 0; c < W; ++c) v[c] = pts[c * n + k];
  } else if (k < n0) {
#pragma unroll
    for (int c = 0; c < W; ++c) v[c] = pre[c * n0 + k];
  } else {
    const int64_t n1 = n - n0, i = k - n0;
    fe x, y, z;
#pragma unroll
    for (int c = 0; c < 10; ++c) {
      x.v[c] = pts[c * n1 + i];
      y.v[c] = pts[(10 + c) * n1 + i];
      z.v[c] = pts[(30 + c) * n1 + i];           // T
    }
    const fe ypx = fe_add(y, x), ymx = fe_sub(y, x),
             t2d = fe_mul(z, fe_const(FE_D2));
#pragma unroll
    for (int c = 0; c < 10; ++c) {
      v[c] = ypx.v[c];
      v[10 + c] = ymx.v[c];
      v[20 + c] = t2d.v[c];
    }
  }
#pragma unroll
  for (int c = 0; c < W; ++c) t[c] = v[c];
}

// Lane j's masks of lane step m of one window, from p = the window's
// digits + j + 32 m lanes and left = n - (j + 32 m lanes): bit u of bits[b]
// is set when |p[u lanes]| = b + 1, bit u of neg when that digit is
// negative; a point past n (u lanes >= left) has digit 0.  The
// magnitudes' four bit planes are gathered first (a magnitude above 8,
// which no bucket takes, counts as 0); a bucket is then one three-input
// logic operation of the low three planes (7 = 111 is 7, 8 = 1000 alone
// sets the top plane), where comparing each digit with each bucket took
// twice the integer operations.
__device__ __forceinline__ void bin_step(const int8_t* p, int64_t left,
                                         int lanes,
                                         uint32_t (&bits)[BIN_BUCKETS],
                                         uint32_t& neg) {
  int d[32];                             // 32 loads in flight
#pragma unroll
  for (int u = 0; u < 32; ++u) d[u] = u * lanes < left ? p[u * lanes] : 0;
  uint32_t p0 = 0, p1 = 0, p2 = 0, p3 = 0;
  neg = 0;
#pragma unroll
  for (int u = 0; u < 32; ++u) {
    const int v = d[u] < 0 ? -d[u] : d[u];
    const uint32_t a = v > 8 ? 0u : (uint32_t)v;
    p0 |= (a & 1u) << u;
    p1 |= (a >> 1 & 1u) << u;
    p2 |= (a >> 2 & 1u) << u;
    p3 |= (a >> 3) << u;
    neg |= (uint32_t)d[u] >> 31 << u;
  }
  bits[0] = ~p2 & ~p1 & p0;
  bits[1] = ~p2 & p1 & ~p0;
  bits[2] = ~p2 & p1 & p0;
  bits[3] = p2 & ~p1 & ~p0;
  bits[4] = p2 & ~p1 & p0;
  bits[5] = p2 & p1 & ~p0;
  bits[6] = p2 & p1 & p0;
  bits[7] = p3;
}

// Thread j (of `lanes`, a multiple of 32, at most 512) of one bucket's
// block, whose lane has `count` points: perm[r] = the lane of rank r.  cs
// holds `lanes` ints, hist `bins` = (most a count can be) + 1;
// block_sync() is the block's barrier.  The histogram takes one shared
// atomic add per count of a warp; warp 0 alone runs past it.
template <class Sync>
__device__ __forceinline__ void rank_lanes(int j, int lanes, int count,
                                           int bins, int* cs, int* hist,
                                           int32_t* perm, Sync block_sync) {
  for (int c = j; c < bins; c += lanes) hist[c] = 0;
  cs[j] = count;
  block_sync();
  {                                      // a warp's lanes of a count at once
    const uint32_t peers = br_match(count);
    if ((peers & ((1u << (j & 31)) - 1u)) == 0)
      br_add(hist + count, br_popc(peers));
  }
  block_sync();
  if (j >= 32) return;
  // start[c] in place of hist[c]: thread j takes bins [lo, hi), the
  // threads above it the bins above
  const int per = (bins + 31) / 32;
  const int lo = j * per < bins ? j * per : bins;
  const int hi = lo + per < bins ? lo + per : bins;
  int own = 0;
  for (int c = lo; c < hi; ++c) own += hist[c];
  int above = own;                       // then the sum over threads >= j
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = br_shfl_down(above, d);
    if (j + d < 32) above += v;
  }
  above -= own;
  for (int c = hi - 1; c >= lo; --c) {
    const int t = hist[c];
    hist[c] = above;
    above += t;
  }
  br_syncwarp();
  for (int q = 0; q < lanes; q += 32) {
    const int c = cs[q + j];
    const uint32_t peers = br_match(c);
    const int before = br_popc(peers & ((1u << j) - 1u));
    perm[hist[c] + before] = q + j;
    br_syncwarp();
    if (before == 0) hist[c] += br_popc(peers);
    br_syncwarp();
  }
}
