// Kernels K15 and K16: T chained steps a <- carry(a b1 + a b2 + a b3) of
// GF(2^255 - 19) multiplication over 20 x 13-bit int32 limbs, for Q lanes
// that share the three operands of every step (ops/fmul13.py).
//
// They replace the two Pallas kernels of the JAX package's MXU probe,
// benches/_mxu_fmul_probe.py: `vpu_kernel` (:135, pallas_call :189) and
// `mxu_kernel` (:147, pallas_call :197).  The arithmetic is
// ops/pallas_math.py `fmul` / `carry`: 39 schoolbook column sums, the 19
// high columns folded back by 608 = 2^260 mod p, three carries.  Products
// and sums keep the low 32 bits (uint32 here, int32 in the JAX form and in
// the plain versions); shifts are arithmetic on int32.
//
// K15 `fmul13_chain_kernel` (CUDA cores): one thread per lane, its 20
// limbs in registers for all T steps.  The 3 x 20 x T shared operands are
// the same for every lane, so a block stages them through shared memory,
// VPU_CHUNK steps at a time, and every thread reads each one as a
// broadcast.  Bound: operations, 3 x 400 int32 multiply-adds per lane and
// step (plus the tail), on the IMAD pipe.  At the probe's Q = 512 the
// grid is 16 blocks of one warp: 16 of 132 SMs, each with one dependent
// chain, so the time is one warp's latency chain, far above the bound.
//
// K16 `fmul13_chain_mma_kernel` (int8 tensor cores, nvcuda::wmma
// m32n8k16): a block takes MMA_LANES = 8 lanes.  Per step it loads the
// three banded matrices M(b) (156 x 40 int8 each, from m3, 19.2 MB in all
// at T = 1024) into shared memory padded to 160 x 48 with zeros (the
// padding is written once), and multiplies each by the lanes' split
// A = [a & 127; a >> 7] (40 x 8, padded to 48): 15 output tiles of 32 x 8
// over 4 warps, 3 k-steps each.  The int32 products go to shared memory,
// where one thread per (operand, lane) folds P1 + 128 (P2 + P3) +
// 16384 P4 into the 39 column sums and applies the tail; one thread per
// lane then adds the three, carries, and writes the next step's int8
// split back as the next B tile.  Bound: the int8 multiply-adds
// (3 x 156 x 40 per lane and step) at the tensor cores' dense rate, and
// the 19.2 MB of m3.  The form is the simple one: no wgmma, no TMA, no
// double buffering; each step waits for its loads.
#include <mma.h>

#include "common.cuh"

#define FL 20           // limbs
#define FN 39           // column sums
#define FMASK 8191
#define FTOP 608
#define VPU_THREADS 32
#define VPU_CHUNK 64    // steps of operands staged in shared memory at once
#define MMA_THREADS 128
#define MMA_LANES 8     // lanes per block: the n of one m32n8k16 tile
#define MROWS 156       // rows of a banded matrix (4 x 39)
#define MROWS_P 160     // padded to 5 m-tiles of 32
#define MCOLS 40        // its columns: the 7-bit halves of 20 limbs
#define MKT 3           // k-tiles of 16 (40 padded to 48)
#define MTILES 15       // output tiles per step: 3 operands x 5 m-tiles

using namespace nvcuda;

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// pallas_math.carry: c & MASK plus c >> 13 moved up one limb, the top
// limb's carry times 608 into limb 0
__device__ __forceinline__ void carry(int32_t* c) {
  int32_t cr[FL];
#pragma unroll
  for (int k = 0; k < FL; ++k) cr[k] = c[k] >> 13;
#pragma unroll
  for (int k = FL - 1; k >= 1; --k) c[k] = wadd(c[k] & FMASK, cr[k - 1]);
  c[0] = wadd(c[0] & FMASK, wmul(FTOP, cr[FL - 1]));
}

// pallas_math.fmul's tail: 39 column sums -> 20 limbs
__device__ __forceinline__ void fold_tail(const int32_t* c, int32_t* lo) {
#pragma unroll
  for (int k = 0; k < FL; ++k) lo[k] = c[k];
#pragma unroll
  for (int k = 0; k < FL - 1; ++k)
    lo[k] = wadd(lo[k], wmul(FTOP, c[FL + k] & FMASK));
#pragma unroll
  for (int k = 1; k < FL; ++k)
    lo[k] = wadd(lo[k], wmul(FTOP, c[FL + k - 1] >> 13));
  carry(lo);
  carry(lo);
  carry(lo);
}

// -- K15 -----------------------------------------------------------------------

__global__ void __launch_bounds__(VPU_THREADS)
fmul13_chain_kernel(const int32_t* __restrict__ a_in,
                    const int32_t* __restrict__ b3,
                    int32_t* __restrict__ out, int64_t Q, int64_t T) {
  __shared__ int32_t bs[VPU_CHUNK][3][FL];
  const int64_t q = (int64_t)blockIdx.x * VPU_THREADS + threadIdx.x;
  const bool live = q < Q;
  int32_t a[FL];
#pragma unroll
  for (int k = 0; k < FL; ++k) a[k] = live ? a_in[k * Q + q] : 0;
  for (int64_t t0 = 0; t0 < T; t0 += VPU_CHUNK) {
    const int n = T - t0 < VPU_CHUNK ? (int)(T - t0) : VPU_CHUNK;
    __syncthreads();                       // the previous chunk is done
    for (int e = threadIdx.x; e < 3 * FL * n; e += VPU_THREADS) {
      const int s = e % n, r = e / n;      // b3 row r = j * 20 + limb
      bs[s][r / FL][r % FL] = b3[(int64_t)r * T + t0 + s];
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      int32_t acc[FL];
#pragma unroll
      for (int k = 0; k < FL; ++k) acc[k] = 0;
#pragma unroll 1
      for (int j = 0; j < 3; ++j) {
        int32_t b[FL], c[FN], y[FL];
#pragma unroll
        for (int k = 0; k < FL; ++k) b[k] = bs[s][j][k];
#pragma unroll
        for (int k = 0; k < FN; ++k) c[k] = 0;
#pragma unroll
        for (int i = 0; i < FL; ++i)
#pragma unroll
          for (int l = 0; l < FL; ++l) c[i + l] = wadd(c[i + l], wmul(a[i], b[l]));
        fold_tail(c, y);
#pragma unroll
        for (int k = 0; k < FL; ++k) acc[k] = wadd(acc[k], y[k]);
      }
      carry(acc);
#pragma unroll
      for (int k = 0; k < FL; ++k) a[k] = acc[k];
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < FL; ++k) out[k * Q + q] = a[k];
  }
}

// a (20, Q) int32 in and out; b3 (3, 20, T) int32
BP_EXPORT int bp_fmul13_chain(const int32_t* a, const int32_t* b3, int32_t* out,
                              int64_t Q, int64_t T, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((Q + VPU_THREADS - 1) / VPU_THREADS);
  fmul13_chain_kernel<<<blocks, VPU_THREADS, 0, stream>>>(a, b3, out, Q, T);
  return (int)cudaGetLastError();
}

// -- K16 -----------------------------------------------------------------------

// a lane's limbs -> its column n of the B tiles: k < 20 the low 7 bits,
// 20 <= k < 40 the rest (an int8 that wraps above 2^14, as the JAX
// astype does); k-tile k / 16, row k % 16
__device__ __forceinline__ void split_into(const int32_t* a,
                                           int8_t (*bsm)[MMA_LANES][16],
                                           int n) {
#pragma unroll
  for (int k = 0; k < FL; ++k) {
    const int kh = FL + k;
    bsm[k >> 4][n][k & 15] = (int8_t)(a[k] & 127);
    bsm[kh >> 4][n][kh & 15] = (int8_t)(a[k] >> 7);
  }
}

__global__ void __launch_bounds__(MMA_THREADS)
fmul13_chain_mma_kernel(const int32_t* __restrict__ a_in,
                        const int8_t* __restrict__ m3,
                        int32_t* __restrict__ out, int64_t Q, int64_t T) {
  // A tiles, row-major 16 bytes a row: ms[operand][k-tile][row][k % 16]
  __shared__ __align__(32) int8_t ms[3][MKT][MROWS_P][16];
  // B tiles, column-major: bsm[k-tile][lane][k % 16]
  __shared__ __align__(32) int8_t bsm[MKT][MMA_LANES][16];
  __shared__ __align__(32) int32_t ps[3][MROWS_P][MMA_LANES];
  __shared__ int32_t ys[3][FL][MMA_LANES];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int64_t q = (int64_t)blockIdx.x * MMA_LANES + tid;
  const bool owner = tid < MMA_LANES;      // thread n keeps lane n's limbs
  const bool live = owner && q < Q;

  for (int e = tid; e < (int)(sizeof(ms) / 4); e += MMA_THREADS)
    reinterpret_cast<int32_t*>(&ms[0][0][0][0])[e] = 0;
  for (int e = tid; e < (int)(sizeof(bsm) / 4); e += MMA_THREADS)
    reinterpret_cast<int32_t*>(&bsm[0][0][0])[e] = 0;
  __syncthreads();
  int32_t a[FL];
  if (owner) {
#pragma unroll
    for (int k = 0; k < FL; ++k) a[k] = live ? a_in[k * Q + q] : 0;
    split_into(a, bsm, tid);
  }

  for (int64_t t = 0; t < T; ++t) {
    // (1) this step's three matrices, as 4-byte words, 10 to a row
#pragma unroll 4
    for (int e = tid; e < 3 * MROWS * 10; e += MMA_THREADS) {
      const int j = e / (MROWS * 10), r = (e / 10) % MROWS, k = 4 * (e % 10);
      const int32_t v = *reinterpret_cast<const int32_t*>(
          m3 + (((int64_t)j * T + t) * MROWS + r) * MCOLS + k);
      *reinterpret_cast<int32_t*>(&ms[j][k >> 4][r][k & 15]) = v;
    }
    __syncthreads();
    // (2) the products on the tensor cores
    for (int tile = warp; tile < MTILES; tile += MMA_THREADS / 32) {
      const int j = tile / 5, mt = tile % 5;
      wmma::fragment<wmma::accumulator, 32, 8, 16, int> acc;
      wmma::fill_fragment(acc, 0);
#pragma unroll
      for (int kt = 0; kt < MKT; ++kt) {
        wmma::fragment<wmma::matrix_a, 32, 8, 16, signed char, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 32, 8, 16, signed char, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, &ms[j][kt][mt * 32][0], 16);
        wmma::load_matrix_sync(fb, &bsm[kt][0][0], 16);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(&ps[j][mt * 32][0], acc, MMA_LANES,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // (3) one thread per (operand, lane): column sums and the tail
    if (tid < 3 * MMA_LANES) {
      const int j = tid / MMA_LANES, n = tid % MMA_LANES;
      int32_t c[FN], y[FL];
#pragma unroll
      for (int k = 0; k < FN; ++k)
        c[k] = wadd(wadd(ps[j][k][n],
                         wmul(128, wadd(ps[j][FN + k][n], ps[j][2 * FN + k][n]))),
                    wmul(16384, ps[j][3 * FN + k][n]));
      fold_tail(c, y);
#pragma unroll
      for (int k = 0; k < FL; ++k) ys[j][k][n] = y[k];
    }
    __syncthreads();
    // (4) one thread per lane: the step's sum, carried, split for the next
    if (owner) {
#pragma unroll
      for (int k = 0; k < FL; ++k)
        a[k] = wadd(wadd(ys[0][k][tid], ys[1][k][tid]), ys[2][k][tid]);
      carry(a);
      split_into(a, bsm, tid);
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < FL; ++k) out[k * Q + q] = a[k];
  }
}

// a (20, Q) int32 in and out; m3 (3, T, 156, 40) int8
BP_EXPORT int bp_fmul13_chain_mma(const int32_t* a, const int8_t* m3,
                                  int32_t* out, int64_t Q, int64_t T,
                                  cudaStream_t stream) {
  const unsigned blocks = (unsigned)((Q + MMA_LANES - 1) / MMA_LANES);
  fmul13_chain_mma_kernel<<<blocks, MMA_THREADS, 0, stream>>>(a, m3, out, Q,
                                                              T);
  return (int)cudaGetLastError();
}
