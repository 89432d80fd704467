// Kernel K4a's schedule: the halving tree of ops/msm.reduce_plain over one
// bucket's lanes (at every level, with h half the width, node t becomes
// node t + node t + h), split between a thread's registers and four-lane
// additions over shared memory.  Generic over what a node is and how two
// are added (`B`), so that csrc/msm.cu runs it on points, and
// tests/test_torch_reduce_header.py compiles it with the host g++ and runs
// it on symbolic nodes (which pairs are added) and on points, against
// reduce_plain's pairs and limbs.
//
// A bucket has REDUCE_THREADS threads (two warps).  Thread t owns the lanes
// congruent to t mod threads (threads = min(lanes, 64)), so the levels
// with h >= threads pair two of its own lanes: it adds them in registers,
// in the tree's depth-first order (its k-th lane, k bit-reversed, merged
// like a binary counter), with no barrier: the issue-bound part, every
// lane busy.  The last log2(threads) levels would leave one warp adding
// one point at a time, each ge_add a chain of ~3,600 instructions, so
// there each addition runs on four lanes (ge_add_on_four_lanes): node t of
// the level is added by threads 4 t' .. 4 t' + 3, sixteen additions at a
// time, a block barrier between levels.
#pragma once
#include "fe25519.cuh"

#define REDUCE_THREADS 64                // a bucket's threads: two warps
#define REDUCE_GROUPS (REDUCE_THREADS / 4)  // four-lane additions at a time

// B provides: value; load(j) (lane j of the bucket); add(a, b); put(t, v)
// (node t of the tail); add_nodes(dst, src, role, active, group) (node dst
// += node src by the four threads of `group`, this one with `role`;
// every thread of the block calls it); sync() (the bucket's barrier).
// After the call node 0 holds the bucket's sum.
template <class B>
__device__ __forceinline__ void reduce_bucket(B& b, int t, int lanes) {
  using V = typename B::value;
  const int threads = lanes < REDUCE_THREADS ? lanes : REDUCE_THREADS;
  const int leaves = lanes / threads;
  int bits = 0;
  while ((1 << bits) < leaves) ++bits;
  if (t < threads) {
    // levels h >= threads: thread t's lanes t + k threads, k < leaves.  The
    // tree over them adds (the tree of the even k, the tree of the odd k),
    // recursively, so its depth-first order visits k bit-reversed; stack[l]
    // holds the finished subtree of 2^l leaves that waits for its right
    // neighbour.
    V stack[3], p;
    for (int k = 0; k < leaves; ++k) {
      int rev = 0;
      for (int i = 0; i < bits; ++i) rev |= ((k >> i) & 1) << (bits - 1 - i);
      p = b.load(t + rev * threads);
      int l = 0;
      for (; (k >> l) & 1; ++l) p = b.add(stack[l], p);
      if (k + 1 < leaves) stack[l] = p;
    }
    b.put(t, p);
  }
  b.sync();
  // levels h < threads: node g += node g + h, four threads an addition
  for (int h = threads / 2; h >= 1; h /= 2) {
    for (int g0 = 0; g0 < h; g0 += REDUCE_GROUPS) {
      const int g = g0 + t / 4;
      b.add_nodes(g, g + h, t % 4, g < h, t / 4);
    }
    b.sync();
  }
}

// Node dst += node src (complete addition, ge_add's limbs) on four
// threads: nodes are 40 words (X, Y, Z, T) in shared memory, `scratch` 40
// words of this group, warp_sync() the warp's barrier (every thread of the
// warp calls this, `active` or not).  Role r makes one field product a
// stage, the same operands in the same order as ge_add:
//   1: A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)(Y2 + X2), C' = T1 2d, D' = Z1 Z2
//   2: C = C' T2, D = 2 D' (roles 2, 3; 2 D' as a product by (2, 0, ..),
//      whose column sums are fe_mul_small's)
//   3: X = E F, Y = G H, Z = F G, T = E H, with E = B - A, F = D - C,
//      G = D + C, H = B + A, written to node dst.
template <class WarpSync>
__device__ __forceinline__ void ge_add_on_four_lanes(
    int32_t* nodes, int32_t* scratch, int dst, int src, int role,
    bool active, WarpSync warp_sync) {
  const int32_t* p = nodes + 40 * dst;
  const int32_t* q = nodes + 40 * src;
  fe r;
  if (active) {
    // stage 1: coordinate `at` plus s times X (Y -+ X for roles 0, 1)
    const int at = role < 2 ? 10 : role == 2 ? 30 : 20;
    const int s = role == 0 ? -1 : role == 1 ? 1 : 0;
    fe a, c;
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      a.v[k] = p[at + k] + s * p[k];
      c.v[k] = role == 2 ? FE_D2[k] : q[at + k] + s * q[k];
    }
    r = fe_mul(a, c);
    if (role >= 2) {                                  // stage 2
#pragma unroll
      for (int k = 0; k < 10; ++k)
        c.v[k] = role == 2 ? q[30 + k] : (k == 0 ? 2 : 0);
      r = fe_mul(r, c);
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) scratch[10 * role + k] = r.v[k];
  }
  warp_sync();
  if (active) {                                       // stage 3
    fe A, B, C, D;
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      A.v[k] = scratch[k];
      B.v[k] = scratch[10 + k];
      C.v[k] = scratch[20 + k];
      D.v[k] = scratch[30 + k];
    }
    const fe E = fe_sub(B, A), F = fe_sub(D, C), G = fe_add(D, C),
             H = fe_add(B, A);
    r = fe_mul(role == 0 || role == 3 ? E : role == 1 ? G : F,
               role == 0 ? F : role == 2 ? G : H);
  }
  warp_sync();
  if (active) {
#pragma unroll
    for (int k = 0; k < 10; ++k) nodes[40 * dst + 10 * role + k] = r.v[k];
  }
}
