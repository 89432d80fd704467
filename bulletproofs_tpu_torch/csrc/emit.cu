// Kernel K2: the batch-verification scalar emit.
//
// Replaces the JAX package's Pallas kernel ops/verify_pallas.py:190
// _emit_kernel (called from emit_digits, :310).  From each proof's compact
// challenge block [u_0..u_{lg-1}, r, x, rc, z, y^-1, -a, -b, prod(u)^-1]
// (32-byte canonical scalars written by the host replay) it computes
//   * the 4 + 2 lg + m dynamic MSM coefficients
//     [r, rx, rcx, rcx^2, r u_k^2, r u_k^-2, r c z^2 z^j], written as signed
//     4-bit digits in [-7, 8], column p * n_dyn + slot (the proof-major
//     order of the dynamic points, so the points need no reordering);
//   * the static coefficients g_i = -rz - a r s_i and
//     h_i = rz + y^-i (r z^2 z^(i/n) 2^(i%n) - b r s_{nm-1-i}), summed over
//     the proofs of each tile of EMIT_TILE proofs into partial[tile][g|h][i]
//     (canonical).  The tiles are summed mod l by a second pass in PyTorch
//     (ops/verify.tree_sum): blocks run in no order, so unlike the TPU's
//     sequential grid nothing accumulates across blocks.
//
// Bound: operations, Montgomery products (171 64-bit multiply-adds each):
// 272 a proof at n = 64, m = 1 under the cheapest schedule (three plain
// tables of g and h terms by doubling, one product a row; no conversion
// out of the Montgomery domain), against 448 bytes of input a proof.  A
// Montgomery product is ~440 integer instructions, each issued at half
// rate, and a dependent one takes ~1,300 cycles in one thread, so what
// sets the time is how many rounds of products each warp issues and how
// many warps share a sub-partition.  Design: a block is a tile of 8
// proofs, a warp each (256 threads, two blocks an SM at n = 64, m = 1, so
// a 2048-proof sub-batch is one wave of 16 warps an SM).  A warp runs its
// proof's schedule (csrc/emit.cuh): the block loaded a lane a scalar, then
// 13 steps of up to 32 products at n = 64, m = 1 (the longest chain; 265
// products), the digits a lane a slot.  The first form ran each proof's
// ~100 products in one thread and, per generator index, ~100 more; a first
// redesign with the lanes on hand-written phases serialised their
// diverging branches (~52 product rounds a warp).  Then lane 8 il + q of
// warp w takes proof q at i = 4 w + il (+ 32 k): (g_i, h_i) from the
// proof's tables in shared memory by three additions, summed over the
// tile's 8 proofs by three xor shuffles of sc_add (exact in any order).
// The TPU kernel's one-hot lane doubling and static-slice Barrett were
// Mosaic workarounds and are gone.
#include "common.cuh"
#include "emit.cuh"

#define EMIT_TILE 8                    // proofs a block: ops/verify.EMIT_TILE
#define EMIT_THREADS (32 * EMIT_TILE)  // a warp a proof
#define EMIT_BLOCKS_PER_SM 2

static_assert(EMIT_TILE == 8, "the tile sum takes 8 proofs in 8 lanes");

__global__ void __launch_bounds__(EMIT_THREADS, EMIT_BLOCKS_PER_SM)
emit_kernel(const uint8_t* __restrict__ blk, const uint32_t* __restrict__ pow2,
            const int32_t* __restrict__ sched, int8_t* __restrict__ digits,
            int32_t* __restrict__ partial, int64_t P, int n, int m) {
  extern __shared__ sc slots[];
  const EmitShape s = emit_shape(P, n, m, sched);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t p0 = (int64_t)blockIdx.x * EMIT_TILE;
  const int count = (int)(P - p0 < EMIT_TILE ? P - p0 : EMIT_TILE);

  if (warp < count) {
    const int64_t p = p0 + warp;
    sc* v = slots + warp * s.slots;
    emit_load(v, s, lane, blk + p * (s.lg + 8) * 32, pow2);
    __syncwarp();
    for (int step = 0; step < s.steps; ++step) {
      emit_step(v, s, step, lane);
      __syncwarp();
    }
    emit_out(v, s, lane, p, digits);
  }
  __syncthreads();

  const int q = lane & 7, il = lane >> 3;
  for (int ib = 0; ib < s.nm; ib += 32) {
    const int i = ib + 4 * warp + il;
    sc g = sc_zero(), h = sc_zero();
    if (i < s.nm && q < count) emit_terms(slots + q * s.slots, s, i, g, h);
#pragma unroll
    for (int d = 1; d < EMIT_TILE; d <<= 1) {
      sc g2, h2;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        g2.v[k] = __shfl_xor_sync(0xffffffffu, g.v[k], d);
        h2.v[k] = __shfl_xor_sync(0xffffffffu, h.v[k], d);
      }
      g = sc_add(g, g2);
      h = sc_add(h, h2);
    }
    if (i < s.nm && q < 2) {
      const sc& out = q ? h : g;
      int32_t* dst = partial + (((int64_t)blockIdx.x * 2 + q) * s.nm + i) * 9;
#pragma unroll
      for (int k = 0; k < 9; ++k) dst[k] = (int32_t)out.v[k];
    }
  }
}

// shared memory of a block whose proofs have `slots` slots each (at most
// 1,023: the schedule's 10-bit slot fields)
static int emit_smem(int64_t slots, size_t* smem) {
  *smem = sizeof(sc) * EMIT_TILE * (size_t)slots;
  return (int)cudaFuncSetAttribute(
      emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// blk (P, lg + 8, 32) uint8, pow2 (log2 n, 9) uint32 (2^(2^b) R mod l),
// sched (ops/verify.emit_schedule(n, m), `slots` slots a proof) ->
// digits (64, P * n_dyn) int8, partial (ceil(P / EMIT_TILE), 2, nm, 9)
// int32
BP_EXPORT int bp_emit(const uint8_t* blk, const uint32_t* pow2,
                      const int32_t* sched, int8_t* digits, int32_t* partial,
                      int64_t P, int64_t n, int64_t m, int64_t slots,
                      cudaStream_t stream) {
  if (n * m > (1 << EMIT_LG_MAX) || m > EMIT_M_MAX || slots >= 1024)
    return (int)cudaErrorInvalidValue;
  size_t smem;
  const int err = emit_smem(slots, &smem);
  if (err) return err;
  const int64_t tiles = (P + EMIT_TILE - 1) / EMIT_TILE;
  emit_kernel<<<(unsigned)tiles, EMIT_THREADS, smem, stream>>>(
      blk, pow2, sched, digits, partial, P, (int)n, (int)m);
  return (int)cudaGetLastError();
}

// blocks of emit_kernel with `slots` slots a proof that one SM of the
// current device holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// with its shared memory) and their threads: out = {blocks, EMIT_THREADS}
BP_EXPORT int bp_emit_blocks_per_sm(int64_t slots, int* out) {
  size_t smem;
  int err = emit_smem(slots, &smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, emit_kernel, EMIT_THREADS, smem);
  out[1] = EMIT_THREADS;
  return err;
}
