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
// K4 msm_horner: one block of 64 threads; thread w forms its window sum
// S_w = sum_b b B_b by the double running sum (8 + 6 additions), then one
// thread runs the Horner chain (63 x (4 doublings + 1 addition)) -- the
// serial tail that bounds this launch by latency -- and writes the point
// and the ristretto is-identity flag (X == 0 or Y == 0).
//
// Every step is ops/msm.py's plain version in the same order, so the
// slab, the bucket sums and the result match it limb for limb.
#include "common.cuh"
#include "fe25519.cuh"

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

__global__ void __launch_bounds__(64)
horner_kernel(const int32_t* __restrict__ sums, int32_t* __restrict__ out,
              int32_t* __restrict__ flag) {
  __shared__ int32_t win[64 * 40];
  const int w = threadIdx.x;
  const int32_t* B = sums + (int64_t)w * NBUCKET * 40;
  ge running = ge_load(B + (NBUCKET - 1) * 40, 1);
  ge total = running;
  for (int b = NBUCKET - 2; b >= 0; --b) {
    running = ge_add(running, ge_load(B + b * 40, 1));
    total = ge_add(total, running);
  }
  ge_store(win + w * 40, 1, total);
  __syncthreads();
  if (w != 0) return;
  ge acc = ge_load(win + 63 * 40, 1);
  for (int i = 62; i >= 0; --i) {
    for (int k = 0; k < 4; ++k) acc = ge_double(acc);
    acc = ge_add(acc, ge_load(win + i * 40, 1));
  }
  ge_store(out, 1, acc);
  flag[0] = (fe_is_zero(acc.X) || fe_is_zero(acc.Y)) ? 1 : 0;
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

// sums (64, 8, 4, 10) -> out (4, 10), flag (1,) int32
BP_EXPORT int bp_msm_horner(const int32_t* sums, int32_t* out, int32_t* flag,
                            cudaStream_t stream) {
  horner_kernel<<<1, 64, 0, stream>>>(sums, out, flag);
  return (int)cudaGetLastError();
}
