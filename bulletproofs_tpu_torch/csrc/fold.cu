// Kernels K8, K9, K10 and K14: the batch prover's mod-l vector kernels.
//
// K14 sinv has no Pallas counterpart: it is the JAX package's XLA
// vec_scalar.py:207 sinv (a scan of 253 steps), the inverse of each IPP
// challenge u on the device transcript route.  One thread per proof runs
// sc_invert (sc25519.cuh): a safegcd inversion of 20 batches of 30
// branch-free divsteps, each batch's 2x2 matrix applied to 9 signed 30-bit
// limbs, all in registers.  At 4096 proofs the launch has 128 warps, one
// per SM sub-partition on 32 SMs, so the time is one thread's chain: its
// dependent instructions (a latency floor, which benches/field_kernels.py
// counts, above the operations bound) and its instructions issued one warp
// at a time (~21,900, at ~2.3 cycles each on an H100).
//
// K8 fold replaces ops/fold_pallas.py:42 _fold_kernel (fold_lanes, :88),
// u x + v y elementwise, the IPP fold of a and b.  K9 smul replaces :50
// _smul_kernel (smul_lanes, :95), x m elementwise, the update of the
// generator weights gw and hw.  K10 digits replaces :115 _digits_kernel
// (digits_lanes, :124), scalars -> signed base-16 digits, which every
// fixed-base MSM of the prover and the chunked verifier's MSMs take.
//
// Layout: the port's vectors are (R, 9, P) int64, 29-bit canonical limbs
// (csrc/sc25519.cuh), so limb k of element (r, p) sits at (r * 9 + k) * P
// + p.  The threads of a warp take neighbouring p, so each limb load and
// store is one coalesced 256-byte access.  u, v and the two gw / hw
// multipliers are per proof, (9, P): the kernels read them by p, and the
// broadcast over rows (the TPU kernel's block shape) is never
// materialised.
//
// K8 folds a and b of one IPP round in one launch, under the round's maps
// read from device memory: out_a[j] = u a[j] + v a[idx[j]] where mask[j],
// else a[j], and out_b likewise with u and v swapped (ops/fold.fold_pair,
// the prover's fold_dyn: the rows above nk copied through, stale).  The
// launch's host arguments are the same in every round, so a round can be
// captured once as a CUDA graph.  fold_lanes (u x + v y of two vectors) is
// the same kernel with the identity map and one vector.  A thread owns a
// proof column p and FOLD_ROWS rows spread over the vector (so a first
// round's folded rows, the first half, fall evenly on the blocks): it
// makes u R and v R mod l once (one Montgomery product by R^2 each), after
// which a folded element is one sc_mont_mul_sum, x (u R) + y (v R) under
// one reduction, = u x + v y with no conversion: 252 limb products (an
// earlier kernel made three Montgomery products, 513).  Only rows under
// the mask make products.  A form that took runs of 4 neighbouring rows
// and read each row's mask and map entry in turn ran at 2.2x the bound:
// half its blocks folded while half copied, and each row waited on two
// dependent loads.
//
// Bound.  K8 moves 4 x 72 bytes per row and proof (a and b read once,
// written once; the partner rows are a's and b's own) against 504 32-bit
// multiply-adds per folded element: at a round's nk = N / 2 bytes bound it
// about 3x (0.0225 ms against 0.0079 at N P = 262,144).  K9 moves 144
// bytes against 2 multiplications: balanced.  K10 moves 72 bytes in and
// 64 out against a few dozen integer operations: bytes.  Design: no
// shared memory and no reuse to exploit; the kernels are streaming loops
// whose arithmetic stays in registers (the TPU kernel's Barrett constants
// and 13-bit limb matrices were VMEM/Mosaic workarounds).
//
// Results are canonical (the plain versions' values exactly); the JAX
// kernels' outputs are lazy (< ~10 l) and agree with them mod l.  K10
// reduces its input with sc_reduce_top first: the identity on the
// canonical scalars the port passes, and a guard that keeps a stray value
// >= 8 * 2^252 from breaking the signed recode.
#include "common.cuh"
#include "sc25519.cuh"

#define FOLD_THREADS 128

__device__ __forceinline__ sc sc_load64(const int64_t* base, int64_t stride) {
  sc r;
#pragma unroll
  for (int k = 0; k < 9; ++k) r.v[k] = (uint32_t)base[k * stride];
  return r;
}

__device__ __forceinline__ void sc_store64(int64_t* base, int64_t stride,
                                           const sc& a) {
#pragma unroll
  for (int k = 0; k < 9; ++k) base[k * stride] = (int64_t)a.v[k];
}

// a b mod l for canonical a, b: (a b R^-1) R^2 R^-1
__device__ __forceinline__ sc sc_mul(const sc& a, const sc& b) {
  return sc_mont_mul(sc_mont_mul(a, b), sc_const(SC_R2));
}

// rows of one K8 thread: r0 and r0 + S, S = ceil(R / 2), so at a first
// round's nk = R / 2 every thread folds one row and copies its partner,
// which it has just read (4 rows a thread took 0.037 ms at 64 x 4096 on an
// H100, 8 rows 0.071: a thread's rows run one after another)
#define FOLD_ROWS 2

// the low words of 9 int64 limbs (each < 2^29): 4-byte loads, half the
// registers of 8-byte ones, the same sectors
__device__ __forceinline__ sc sc_load_lo(const int64_t* base, int64_t stride) {
  const uint32_t* w = (const uint32_t*)base;
  sc r;
#pragma unroll
  for (int k = 0; k < 9; ++k) r.v[k] = w[2 * k * stride];
  return r;
}

// oa[j] = u xa[j] + v ya[idx[j]] where mask[j], else xa[j]; ob[j] = v xb[j]
// + u yb[idx[j]] where mask[j], else xb[j].  idx == nullptr is the
// identity, mask == nullptr every row, xb == nullptr no second vector.
// idx[j] must lie in [0, R).  Block (row slot r0, FOLD_THREADS columns);
// the mask and the map are the same across a warp, and a thread reads its
// rows' entries first, all at once.
__global__ void __launch_bounds__(FOLD_THREADS)
fold_kernel(const int64_t* __restrict__ xa, const int64_t* __restrict__ ya,
            const int64_t* __restrict__ xb, const int64_t* __restrict__ yb,
            const int64_t* __restrict__ u, const int64_t* __restrict__ v,
            const int64_t* __restrict__ idx, const uint8_t* __restrict__ mask,
            int64_t* __restrict__ oa, int64_t* __restrict__ ob, int64_t R,
            int64_t P) {
  const int64_t p = (int64_t)blockIdx.y * FOLD_THREADS + threadIdx.x;
  if (p >= P) return;
  const int64_t S = gridDim.x;
  bool fold[FOLD_ROWS];
  int64_t g[FOLD_ROWS];
  bool any = false;
#pragma unroll
  for (int k = 0; k < FOLD_ROWS; ++k) {
    const int64_t j = blockIdx.x + k * S;
    fold[k] = j < R && (mask == nullptr || mask[j]);
    g[k] = j < R && idx != nullptr ? idx[j] : j;
    any |= fold[k];
  }
  sc uR = sc_zero(), vR = sc_zero();
  if (any) {                            // u R, v R mod l: Montgomery factors
    uR = sc_mont_mul(sc_load_lo(u + p, P), sc_const(SC_R2));
    vR = sc_mont_mul(sc_load_lo(v + p, P), sc_const(SC_R2));
  }
#pragma unroll
  for (int k = 0; k < FOLD_ROWS; ++k) {
    const int64_t j = blockIdx.x + k * S;
    if (j >= R) break;
    const int64_t off = j * 9 * P + p;
    if (fold[k]) {
      const int64_t gy = g[k] * 9 * P + p;
      sc_store64(oa + off, P, sc_mont_mul_sum(sc_load_lo(xa + off, P), uR,
                                              sc_load_lo(ya + gy, P), vR));
      if (xb != nullptr)
        sc_store64(ob + off, P, sc_mont_mul_sum(sc_load_lo(xb + off, P), vR,
                                                sc_load_lo(yb + gy, P), uR));
    } else {
#pragma unroll
      for (int q = 0; q < 9; ++q) oa[off + q * P] = xa[off + q * P];
      if (xb != nullptr) {
#pragma unroll
        for (int q = 0; q < 9; ++q) ob[off + q * P] = xb[off + q * P];
      }
    }
  }
}

// out[r] = x[r] (mask[r] ? m1 : m0)
__global__ void __launch_bounds__(FOLD_THREADS)
smul_kernel(const int64_t* __restrict__ x, const uint8_t* __restrict__ mask,
            const int64_t* __restrict__ m1, const int64_t* __restrict__ m0,
            int64_t* __restrict__ out, int64_t total, int64_t P) {
  const int64_t e = (int64_t)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (e >= total) return;
  const int64_t r = e / P, p = e - r * P;
  const int64_t off = r * 9 * P + p;
  const int64_t* m = mask[r] ? m1 : m0;
  sc_store64(out + off, P, sc_mul(sc_load64(x + off, P), sc_load64(m + p, P)));
}

// x (nb, 9, Q) -> out (nb * 64, Q) int8, row j * 64 + w (the fixed-base
// tables' stream order)
__global__ void __launch_bounds__(FOLD_THREADS)
digits_kernel(const int64_t* __restrict__ x, int8_t* __restrict__ out,
              int64_t total, int64_t Q) {
  const int64_t e = (int64_t)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (e >= total) return;
  const int64_t j = e / Q, q = e - j * Q;
  int8_t d[64];
  sc_signed_digits(sc_reduce_top(sc_load64(x + j * 9 * Q + q, Q)), d);
  int8_t* dst = out + j * 64 * Q + q;
#pragma unroll
  for (int w = 0; w < 64; ++w) dst[w * Q] = d[w];
}

// x (9, P) -> out (9, P): x^-1 mod l per proof
__global__ void __launch_bounds__(FOLD_THREADS)
sinv_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
            int64_t P) {
  const int64_t p = (int64_t)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (p >= P) return;
  sc_store64(out + p, P, sc_invert(sc_load64(x + p, P)));
}

static unsigned blocks_for(int64_t total) {
  return (unsigned)((total + FOLD_THREADS - 1) / FOLD_THREADS);
}

// xa, ya, oa (R, 9, P); xb, yb, ob (R, 9, P) or null; u, v (9, P); idx (R,)
// int64 or null; mask (R,) uint8 or null
BP_EXPORT int bp_fold(const int64_t* xa, const int64_t* ya, const int64_t* xb,
                      const int64_t* yb, const int64_t* u, const int64_t* v,
                      const int64_t* idx, const uint8_t* mask, int64_t* oa,
                      int64_t* ob, int64_t R, int64_t P, cudaStream_t stream) {
  const dim3 grid((unsigned)((R + FOLD_ROWS - 1) / FOLD_ROWS),
                  (unsigned)((P + FOLD_THREADS - 1) / FOLD_THREADS));
  fold_kernel<<<grid, FOLD_THREADS, 0, stream>>>(xa, ya, xb, yb, u, v, idx,
                                                 mask, oa, ob, R, P);
  return (int)cudaGetLastError();
}

// x, out (R, 9, P); mask (R,) uint8; m1, m0 (9, P)
BP_EXPORT int bp_smul(const int64_t* x, const uint8_t* mask, const int64_t* m1,
                      const int64_t* m0, int64_t* out, int64_t R, int64_t P,
                      cudaStream_t stream) {
  smul_kernel<<<blocks_for(R * P), FOLD_THREADS, 0, stream>>>(x, mask, m1, m0,
                                                              out, R * P, P);
  return (int)cudaGetLastError();
}

// x (nb, 9, Q) int64 -> out (nb * 64, Q) int8
BP_EXPORT int bp_digits(const int64_t* x, int8_t* out, int64_t nb, int64_t Q,
                        cudaStream_t stream) {
  digits_kernel<<<blocks_for(nb * Q), FOLD_THREADS, 0, stream>>>(x, out,
                                                                 nb * Q, Q);
  return (int)cudaGetLastError();
}

// x, out (9, P) int64
BP_EXPORT int bp_sinv(const int64_t* x, int64_t* out, int64_t P,
                      cudaStream_t stream) {
  sinv_kernel<<<blocks_for(P), FOLD_THREADS, 0, stream>>>(x, out, P);
  return (int)cudaGetLastError();
}
