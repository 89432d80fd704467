// Kernels K6, K12 and K7: the prover's fixed-base multi-scalar
// multiplication, many output lanes over one shared Niels table stream.
//
// K6 fixed_accumulate replaces ops/fixed_msm.py:274 _fixed_accum_kernel (the
// first pallas_call of _fixed_msm, :387); K12 fixed_accumulate2 replaces
// :206 _fixed_accum_kernel2, the same call under _ILP2 (two bucket sets fed
// by alternate rows, two independent mixed-addition chains per thread,
// merged at the end); K7 fixed_reduce replaces :346 _fixed_reduce_kernel
// (the second call, :406), and takes K6's and K12's slabs alike.
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
// K12: K6's work per (row, lane) with the same one-hot access to both sets
// at every row, plus 8 complete additions per thread at the end.  Two sets
// are 80 KB of shared memory per block of 32 lanes, above the 48 KB of
// static shared memory, so they are dynamic shared memory
// (cudaFuncSetAttribute) and 2 blocks fit an SM where K6 fits 5;
// `pick_splits` aims at 132 x 2 x 32 threads for it.  Each chunk has an
// even number of rows (the wrapper pads with Niels identities and zero
// digits).  Its slab differs from K6's only in the points' projective
// representation, so K7 and compression give the same bytes.
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

// Bucket word w of bucket b of a thread's set sits at set[(b * 40 + w) *
// FX_THREADS] (the set pointer is offset by the thread's index).  The
// pointer is volatile, so that every masked load and store below is issued
// as written and none is turned into a predicated (digit-dependent) access.
__device__ __forceinline__ void init_buckets(volatile int32_t* set) {
#pragma unroll
  for (int b = 0; b < NBUCKET; ++b)
#pragma unroll
    for (int w = 0; w < 40; ++w)                   // identity (0 : 1 : 1 : 0)
      set[(b * 40 + w) * FX_THREADS] = (w == 10 || w == 20) ? 1 : 0;
}

// the Niels table point of stream row s, negated for a negative digit
__device__ __forceinline__ ge_niels signed_point(const int32_t* niels,
                                                 int64_t S, int64_t s,
                                                 bool neg) {
  const fe ypx = fe_load(niels + s, S);
  const fe ymx = fe_load(niels + 10 * S + s, S);
  const fe t2d = fe_load(niels + 20 * S + s, S);
  ge_niels pt;
  pt.ypx = fe_select(neg, ymx, ypx);
  pt.ymx = fe_select(neg, ypx, ymx);
  pt.t2d = fe_select(neg, fe_neg(t2d), t2d);
  return pt;
}

// word w of bucket b ORed into cur (read) or replaced by nw (write) under
// the all-ones / all-zeros mask m
__device__ __forceinline__ void or_bucket(volatile int32_t* set, int b,
                                          int32_t m, int32_t cur[40]) {
#pragma unroll
  for (int w = 0; w < 40; ++w) cur[w] |= set[(b * 40 + w) * FX_THREADS] & m;
}

__device__ __forceinline__ void write_bucket(volatile int32_t* set, int b,
                                             int32_t m, const int32_t nw[40]) {
#pragma unroll
  for (int w = 0; w < 40; ++w) {
    volatile int32_t* p = set + (b * 40 + w) * FX_THREADS;
    *p = (nw[w] & m) | (*p & ~m);
  }
}

// bucket `mag` of the set (the identity's words are never all zero, so
// digit 0 reads zeros), read under one-hot masks.  ROLLED keeps the loop
// over the 8 buckets a loop: with two chains live (K12) the unrolled form
// runs out of registers and spills.
template <bool ROLLED>
__device__ __forceinline__ ge select_bucket(volatile int32_t* set, int mag) {
  int32_t cur[40];
#pragma unroll
  for (int w = 0; w < 40; ++w) cur[w] = 0;
  if (ROLLED) {
#pragma unroll 1
    for (int b = 0; b < NBUCKET; ++b)
      or_bucket(set, b, -(int32_t)(mag == b + 1), cur);
  } else {
#pragma unroll
    for (int b = 0; b < NBUCKET; ++b)
      or_bucket(set, b, -(int32_t)(mag == b + 1), cur);
  }
  return ge_from_words(cur);
}

// every bucket written back, bucket `mag` with the new point
template <bool ROLLED>
__device__ __forceinline__ void update_buckets(volatile int32_t* set, int mag,
                                               const ge& pt) {
  int32_t nw[40];
  ge_to_words(pt, nw);
  if (ROLLED) {
#pragma unroll 1
    for (int b = 0; b < NBUCKET; ++b)
      write_bucket(set, b, -(int32_t)(mag == b + 1), nw);
  } else {
#pragma unroll
    for (int b = 0; b < NBUCKET; ++b)
      write_bucket(set, b, -(int32_t)(mag == b + 1), nw);
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
  volatile int32_t* my = buckets + tid;
  init_buckets(my);

  for (int64_t s = c * rows; s < (c + 1) * rows; ++s) {
    const int d = digits[s * Q + q];
    const int mag = d < 0 ? -d : d;
    const ge_niels pt = signed_point(niels, S, s, d < 0);
    update_buckets<false>(my, mag, ge_madd(select_bucket<false>(my, mag), pt));
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

// K12: rows 2t of the chunk go to bucket set 0, rows 2t + 1 to set 1.  The
// two mixed additions are independent chains: set 1 is read while set 0's
// madd runs and set 0 is written while set 1's runs (the volatile accesses
// keep this order; the arithmetic is free to interleave).  At
// the end the sets merge bucket by bucket with complete additions and
// leave in K6's slab layout.  Two sets are 80 KB per block of 32 lanes:
// dynamic shared memory, 2 blocks per SM (K6: 40 KB, 5 blocks).
__global__ void __launch_bounds__(FX_THREADS)
fixed_accumulate2_kernel(const int32_t* __restrict__ niels,
                         const int8_t* __restrict__ digits,
                         int32_t* __restrict__ slab, int64_t S, int64_t Q,
                         int64_t rows) {
  extern __shared__ int32_t sets[];              // [set][bucket][word][thread]
  const int tid = threadIdx.x;
  const int64_t q = (int64_t)blockIdx.x * FX_THREADS + tid;
  const int c = blockIdx.y;
  if (q >= Q) return;
  volatile int32_t* set0 = sets + tid;
  volatile int32_t* set1 = sets + NBUCKET * 40 * FX_THREADS + tid;
  init_buckets(set0);
  init_buckets(set1);

  for (int64_t s = c * rows; s < (c + 1) * rows; s += 2) {
    const int d0 = digits[s * Q + q];
    const int d1 = digits[(s + 1) * Q + q];
    const int mag0 = d0 < 0 ? -d0 : d0;
    const int mag1 = d1 < 0 ? -d1 : d1;
    const ge new0 = ge_madd(select_bucket<true>(set0, mag0),
                            signed_point(niels, S, s, d0 < 0));
    const ge cur1 = select_bucket<true>(set1, mag1);
    update_buckets<true>(set0, mag0, new0);
    const ge new1 = ge_madd(cur1, signed_point(niels, S, s + 1, d1 < 0));
    update_buckets<true>(set1, mag1, new1);
  }

#pragma unroll 1
  for (int b = 0; b < NBUCKET; ++b) {
    int32_t w0[40], w1[40];
#pragma unroll
    for (int w = 0; w < 40; ++w) {
      w0[w] = set0[(b * 40 + w) * FX_THREADS];
      w1[w] = set1[(b * 40 + w) * FX_THREADS];
    }
    ge_store(slab + ((int64_t)(c * NBUCKET + b) * 40) * Q + q, Q,
             ge_add(ge_from_words(w0), ge_from_words(w1)));
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

// niels (3, 10, S) int32, digits (S, Q) int8 -> slab (splits, 8, 4, 10, Q);
// S / splits must be even
BP_EXPORT int bp_fixed_accumulate2(const int32_t* niels, const int8_t* digits,
                                   int32_t* slab, int64_t S, int64_t Q,
                                   int64_t splits, cudaStream_t stream) {
  const int smem = 2 * NBUCKET * 40 * FX_THREADS * (int)sizeof(int32_t);
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      fixed_accumulate2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Q + FX_THREADS - 1) / FX_THREADS), (unsigned)splits);
  fixed_accumulate2_kernel<<<grid, FX_THREADS, smem, stream>>>(
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
