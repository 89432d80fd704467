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
// + p.  One thread per element; the threads of a warp take neighbouring p,
// so each limb load and store is one coalesced 256-byte access.  u, v and
// the two gw / hw multipliers are per proof, (9, P): the kernel reads them
// by p, and the broadcast over rows (the TPU kernel's block shape) is never
// materialised.
//
// Bound.  K8 moves 216 bytes per element (x, y in, the result out) against
// 3 Montgomery multiplications (513 limb products, 1026 32-bit
// multiply-adds): at the card's 3.35 TB/s and ~1.67e13 multiply-adds/s the
// two limits are within 5 % of each other.  K9 moves 144 bytes against 2
// multiplications: likewise balanced.  K10 moves 72 bytes in and 64 out
// against a few dozen integer operations: bytes.  Design: no shared memory
// and no reuse to exploit; the kernels are plain streaming loops whose
// arithmetic stays in registers (the TPU kernel's Barrett constants and
// 13-bit limb matrices were VMEM/Mosaic workarounds).
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

// out[r] = u x[r] + v y[r]: (x u R^-1 + y v R^-1) R^2 R^-1
__global__ void __launch_bounds__(FOLD_THREADS)
fold_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
            const int64_t* __restrict__ u, const int64_t* __restrict__ v,
            int64_t* __restrict__ out, int64_t total, int64_t P) {
  const int64_t e = (int64_t)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (e >= total) return;
  const int64_t r = e / P, p = e - r * P;
  const int64_t off = r * 9 * P + p;
  const sc s = sc_add(sc_mont_mul(sc_load64(x + off, P), sc_load64(u + p, P)),
                      sc_mont_mul(sc_load64(y + off, P), sc_load64(v + p, P)));
  sc_store64(out + off, P, sc_mont_mul(s, sc_const(SC_R2)));
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

// x, y, out (R, 9, P); u, v (9, P)
BP_EXPORT int bp_fold(const int64_t* x, const int64_t* y, const int64_t* u,
                      const int64_t* v, int64_t* out, int64_t R, int64_t P,
                      cudaStream_t stream) {
  fold_kernel<<<blocks_for(R * P), FOLD_THREADS, 0, stream>>>(x, y, u, v, out,
                                                              R * P, P);
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
