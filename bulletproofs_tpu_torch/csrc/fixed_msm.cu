// Kernels K6 and K7: the prover's fixed-base multi-scalar multiplication,
// many output lanes over one shared Niels table stream.
//
// K6 fixed_accumulate replaces ops/fixed_msm.py:274 _fixed_accum_kernel (the
// first pallas_call of _fixed_msm, :387); K7 fixed_reduce replaces :346
// _fixed_reduce_kernel (the second, :406).
//
// K6: lane q streams rows s of its chunk in order and adds digit[s][q] times
// table point s into bucket |digit| (8 buckets, digits in [-7, 8]).  The
// table stream (3, 10, S) is shared: every thread of a warp reads the same
// row, one broadcast load.  Bound: operations, one 7-multiplication mixed
// addition (~700 IMAD.WIDE) per (row, lane) against 1 byte of digit.
//
// The V/A/S and T rows carry the prover's witness, so the bucket access
// must not depend on the digit (docs/architecture.md, "Determinism,
// security notes": the prover MSMs are uniform-time).  At every row the
// thread reads all 8 buckets and ORs each under an all-ones / all-zeros
// mask (exactly one mask is set, none for digit 0), adds, and writes all
// 8 back, each as (new & m) | (old & ~m).
// Negating the Niels point (Y+X <-> Y-X, 2dT -> -2dT) is a select too.
// This is the one-hot mux of the TPU kernel; unlike the verifier's K3
// (public data), nothing is indexed by the digit.
//
// Occupancy: the buckets live in shared memory, [bucket][coord][limb]
// [thread] so a warp's accesses hit 32 banks, 40 KB per block of 32 lanes,
// five blocks per SM.  The TPU ran one serial stream per lane; here each
// lane's S rows are split into `splits` contiguous chunks (grid.y), each
// with its own buckets, so Q * splits threads fill the 132 SMs.  The slab
// (splits, 8, 4, 10, Q) leaves the kernel once.
//
// K7: one thread per lane merges the chunks' buckets in order with
// complete additions and forms sum_b b B_b by the running double sum
// (14 additions; the TPU kernel's two suffix scans were its lane-parallel
// form of the same sum).  Bound: operations, small beside K6.
//
// Every step is ops/fixed_msm.py's plain version in the same order, so the
// slab and the points match it limb for limb.
#include "common.cuh"
#include "fe25519.cuh"

#define NBUCKET 8
#define FX_THREADS 32
#define RED_THREADS 128

__device__ __forceinline__ ge ge_from_words(const int32_t w[40]) {
  ge p;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    p.X.v[k] = w[k];
    p.Y.v[k] = w[10 + k];
    p.Z.v[k] = w[20 + k];
    p.T.v[k] = w[30 + k];
  }
  return p;
}

__device__ __forceinline__ void ge_to_words(const ge& p, int32_t w[40]) {
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    w[k] = p.X.v[k];
    w[10 + k] = p.Y.v[k];
    w[20 + k] = p.Z.v[k];
    w[30 + k] = p.T.v[k];
  }
}

__global__ void __launch_bounds__(FX_THREADS)
fixed_accumulate_kernel(const int32_t* __restrict__ niels,
                        const int8_t* __restrict__ digits,
                        int32_t* __restrict__ slab, int64_t S, int64_t Q,
                        int64_t rows) {
  __shared__ int32_t buckets[NBUCKET * 40 * FX_THREADS];
  const int tid = threadIdx.x;
  const int64_t q = (int64_t)blockIdx.x * FX_THREADS + tid;
  const int c = blockIdx.y;
  if (q >= Q) return;
  // word w of bucket b at my[(b * 40 + w) * 32]; volatile, so that every
  // masked load and store below is issued as written and none is turned
  // into a predicated (digit-dependent) access
  volatile int32_t* my = buckets + tid;
#pragma unroll
  for (int b = 0; b < NBUCKET; ++b)
#pragma unroll
    for (int w = 0; w < 40; ++w)                   // identity (0 : 1 : 1 : 0)
      my[(b * 40 + w) * FX_THREADS] = (w == 10 || w == 20) ? 1 : 0;

  for (int64_t s = c * rows; s < (c + 1) * rows; ++s) {
    const int d = digits[s * Q + q];
    const bool neg = d < 0;
    const int mag = neg ? -d : d;
    const fe ypx = fe_load(niels + s, S);
    const fe ymx = fe_load(niels + 10 * S + s, S);
    const fe t2d = fe_load(niels + 20 * S + s, S);
    ge_niels pt;
    pt.ypx = fe_select(neg, ymx, ypx);
    pt.ymx = fe_select(neg, ypx, ymx);
    pt.t2d = fe_select(neg, fe_neg(t2d), t2d);

    int32_t cur[40];
#pragma unroll
    for (int w = 0; w < 40; ++w) cur[w] = 0;
#pragma unroll
    for (int b = 0; b < NBUCKET; ++b) {
      const int32_t m = -(int32_t)(mag == b + 1);
#pragma unroll
      for (int w = 0; w < 40; ++w) cur[w] |= my[(b * 40 + w) * FX_THREADS] & m;
    }
    int32_t nw[40];
    ge_to_words(ge_madd(ge_from_words(cur), pt), nw);
#pragma unroll
    for (int b = 0; b < NBUCKET; ++b) {
      const int32_t m = -(int32_t)(mag == b + 1);
#pragma unroll
      for (int w = 0; w < 40; ++w) {
        volatile int32_t* p = my + (b * 40 + w) * FX_THREADS;
        *p = (nw[w] & m) | (*p & ~m);
      }
    }
  }

  // slab[c][b][coord][limb][q]
#pragma unroll
  for (int b = 0; b < NBUCKET; ++b) {
    int32_t* dst = slab + ((int64_t)(c * NBUCKET + b) * 40) * Q + q;
#pragma unroll
    for (int w = 0; w < 40; ++w)
      dst[(int64_t)w * Q] = my[(b * 40 + w) * FX_THREADS];
  }
}

__global__ void __launch_bounds__(RED_THREADS)
fixed_reduce_kernel(const int32_t* __restrict__ slab, int32_t* __restrict__ out,
                    int64_t Q, int splits) {
  const int64_t q = (int64_t)blockIdx.x * RED_THREADS + threadIdx.x;
  if (q >= Q) return;
  ge running, total;
  for (int b = NBUCKET - 1; b >= 0; --b) {
    ge m = ge_load(slab + ((int64_t)b * 40) * Q + q, Q);
    for (int k = 1; k < splits; ++k)
      m = ge_add(m, ge_load(slab + ((int64_t)(k * NBUCKET + b) * 40) * Q + q, Q));
    if (b == NBUCKET - 1) {
      running = m;
      total = m;
    } else {
      running = ge_add(running, m);
      total = ge_add(total, running);
    }
  }
  ge_store(out + q, Q, total);
}

// niels (3, 10, S) int32, digits (S, Q) int8 -> slab (splits, 8, 4, 10, Q)
BP_EXPORT int bp_fixed_accumulate(const int32_t* niels, const int8_t* digits,
                                  int32_t* slab, int64_t S, int64_t Q,
                                  int64_t splits, cudaStream_t stream) {
  dim3 grid((unsigned)((Q + FX_THREADS - 1) / FX_THREADS), (unsigned)splits);
  fixed_accumulate_kernel<<<grid, FX_THREADS, 0, stream>>>(
      niels, digits, slab, S, Q, S / splits);
  return (int)cudaGetLastError();
}

// slab (splits, 8, 4, 10, Q) -> out (4, 10, Q)
BP_EXPORT int bp_fixed_reduce(const int32_t* slab, int32_t* out, int64_t Q,
                              int64_t splits, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((Q + RED_THREADS - 1) / RED_THREADS);
  fixed_reduce_kernel<<<blocks, RED_THREADS, 0, stream>>>(slab, out, Q,
                                                          (int)splits);
  return (int)cudaGetLastError();
}
