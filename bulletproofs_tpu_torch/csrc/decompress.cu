// Kernel K1: batch ristretto255 decompression (RFC 9496 DECODE).
//
// Replaces the JAX package's Pallas kernel ops/msm_pallas.py:242
// _decompress_kernel (called from decompress_lanes, :271) together with the
// XLA byte -> limb step and canonical-encoding mask of ops/vec_curve.py:
// 224-243, so the card reads the raw 32-byte encodings once.
//
// Bound: operations.  Each point costs one sqrt-ratio exponentiation
// (~265 field multiplications of 100 IMAD.WIDE each) against 32 bytes in
// and 161 bytes out, so the integer multiply rate bounds it by orders of
// magnitude over memory.  Design: one thread per point, every field
// element in registers, no shared memory and no synchronisation.  The
// arithmetic is ops/curve.decompress_plain step for step, so the outputs
// match it exactly.
//
// Waves.  Registers are allotted per SM sub-partition (16,384 each, four
// an SM).  At the compiler's own count (178) two warps fit a
// sub-partition, eight an SM: 33,792 points on an H100's 132 SMs, and a
// launch above that runs a tail wave on a nearly idle card (an m=1
// verifier sub-batch is 34,816 points).  So blocks are one warp and
// __launch_bounds__ asks for 12 of them an SM: at most 168 registers (164,
// no spills), three warps a sub-partition, 50,688 points resident, which
// holds a verifier sub-batch and the linear batch's 45,056 in one wave.
// The shape is a constant on purpose: on an H100 this form was as fast as
// the uncapped one at 33,792 points and faster at 34,816, 45,056 and
// 65,579, so no rule of N picks between them.  One wave is not the whole
// story: a sub-partition that holds two or more warps issues their integer
// instructions at ~0.08 ms a warp, so a launch takes about that times its
// busiest sub-partition's warps (three at 34,816 points: ~0.25 ms); only
// fewer instructions a point take it lower (PERF.md §6).
#include "common.cuh"
#include "fe25519.cuh"

// canonical field encoding: value < p and even (ops/limbs.canonical_mask)
__device__ __forceinline__ bool canonical(const uint8_t* b) {
  bool all_ff = true;
#pragma unroll
  for (int i = 1; i < 31; ++i) all_ff = all_ff && (b[i] == 255);
  const bool ge_p = (b[31] == 127) && (b[0] >= 237) && all_ff;
  return b[31] < 128 && !ge_p && (b[0] & 1) == 0;
}

// the low 255 bits as exact limbs (ops/limbs.fe_from_bytes)
__device__ __forceinline__ fe fe_from_bytes(const uint8_t* b) {
  fe r;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const int pos = (51 * k + 1) / 2, width = 26 - (k & 1);
    uint64_t acc = 0;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int idx = pos / 8 + t;
      if (idx < 32) acc |= (uint64_t)b[idx] << (8 * t);
    }
    r.v[k] = (int32_t)((acc >> (pos % 8)) & ((1ull << width) - 1));
  }
  return r;
}

#define K1_THREADS 32        // a block: one warp
#define K1_BLOCKS_PER_SM 12  // resident an SM: three warps a sub-partition

__global__ void __launch_bounds__(K1_THREADS, K1_BLOCKS_PER_SM)
decompress_kernel(const uint8_t* __restrict__ raw, uint8_t* __restrict__ valid,
                  int32_t* __restrict__ pts, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * K1_THREADS + threadIdx.x;
  if (i >= n) return;
  uint8_t b[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) b[k] = raw[32 * i + k];
  // the bytes die here: nothing of them stays live across the chain
  const bool canon = canonical(b);
  const fe s = fe_from_bytes(b);

  const fe one = fe_one();
  const fe ss = fe_sq(s);
  const fe u1 = fe_sub(one, ss);
  const fe u2 = fe_add(one, ss);
  const fe u2_sqr = fe_sq(u2);
  const fe v = fe_sub(fe_neg(fe_mul(fe_const(FE_D), fe_sq(u1))), u2_sqr);
  fe invsqrt;
  const bool was_square = fe_sqrt_ratio_m1(one, fe_mul(v, u2_sqr), invsqrt);
  const fe den_x = fe_mul(invsqrt, u2);
  const fe den_y = fe_mul(fe_mul(invsqrt, den_x), v);
  const fe x = fe_abs(fe_mul(fe_mul_small(s, 2), den_x));
  const fe y = fe_mul(u1, den_y);
  const fe t = fe_mul(x, y);
  const bool ok = was_square && fe_is_negative(t) == 0 && !fe_is_zero(y) &&
                  canon;

  valid[i] = ok ? 1 : 0;
  ge p;
  p.X = x;
  p.Y = y;
  p.Z = one;
  p.T = t;
  ge_store(pts + i, n, p);
}

// threads resident an SM on the current device: the blocks that
// cudaOccupancyMaxActiveBlocksPerMultiprocessor allows times K1_THREADS
BP_EXPORT int bp_decompress_threads_per_sm(int* out) {
  int blocks = 0;
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, decompress_kernel, K1_THREADS, 0);
  *out = blocks * K1_THREADS;
  return err;
}

// raw (n, 32) uint8 -> valid (n,) uint8, pts (4, 10, n) int32
BP_EXPORT int bp_decompress(const uint8_t* raw, uint8_t* valid, int32_t* pts,
                            int64_t n, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + K1_THREADS - 1) / K1_THREADS);
  decompress_kernel<<<blocks, K1_THREADS, 0, stream>>>(raw, valid, pts, n);
  return (int)cudaGetLastError();
}
