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
// K8 fold replaces ops/fold_pallas.py:42 _fold_kernel (fold_lanes, :89),
// u x + v y elementwise, the IPP fold of a and b.  K9 smul replaces :50
// _smul_kernel (smul_lanes, :96), x m elementwise, the update of the
// generator weights gw and hw.  K10 digits replaces :115 _digits_kernel
// (digits_lanes, :125), scalars -> signed base-16 digits, which every
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
// K9 updates gw and hw of one IPP round in one launch (ops/fold.smul_pair,
// the prover's fold_dyn and round_fold): gw[r] (mask[r] ? m1 : m0) and
// hw[r] (mask[r] ? m0 : m1), every row.  smul_lanes (one vector) is the
// same kernel with a null second vector.  A block of SMUL_WARPS rows x 32
// columns makes m1 R and m0 R mod l once for its columns, after which an
// element is one sc_mont_mul, x (m R) R^-1 = x m: 171 limb products,
// where the kernel before made two Montgomery products an element (x m
// R^-1, then R^2 R^-1), took one launch a vector and found its row by a
// 64-bit division.  Slower forms, on an H100: a thread a column and 4
// rows (the factors in registers; 15 warps an SM, each running its rows'
// loads, products and stores in turn) was slower than the two launches
// it replaced; a warp's next row loaded before its current row is
// multiplied (4 to 8 rows a warp) and 8 or 16 rows a block were slower
// than 4 rows a block.
//
// Bound.  K8 moves 4 x 72 bytes per row and proof (a and b read once,
// written once; the partner rows are a's and b's own) against 504 32-bit
// multiply-adds per folded element: at a round's nk = N / 2 bytes bound it
// about 3x (0.0225 ms against 0.0079 at N P = 262,144).  K9 moves the
// same 4 x 72 bytes per row and proof (gw and hw read once, written once)
// against 342 multiply-adds per element: bytes bind it about 2x (0.0225
// ms against 0.0107 at N P = 262,144; on an H100 a PyTorch copy of the
// same bytes takes 0.028 ms, K9's loads and stores alone 0.027).  K10
// moves 72 bytes in and 64 out against a few dozen integer operations:
// bytes.  Design: no
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

// K9's block: SMUL_WARPS rows of 32 columns, a warp a row
#define SMUL_WARPS 4
static_assert(SMUL_WARPS >= 2, "warps 0 and 1 make the two factors");

// ox[r] = x[r] (mask[r] ? m1 : m0) and oy[r] = y[r] (mask[r] ? m0 : m1);
// y == nullptr updates x alone.  Thread (row r, column p) loads its
// elements first; meanwhile warps 0 and 1 make m1 R and m0 R of the
// block's 32 columns into shared memory (one product by R^2 each, 2
// products for every 2 SMUL_WARPS elements); then each element is one
// product, x (m R) R^-1 = x m.  A warp shares its row, so the mask is the
// same across it and its factor reads never diverge.
__global__ void __launch_bounds__(32 * SMUL_WARPS)
smul_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
            const uint8_t* __restrict__ mask, const int64_t* __restrict__ m1,
            const int64_t* __restrict__ m0, int64_t* __restrict__ ox,
            int64_t* __restrict__ oy, int64_t R, int64_t P) {
  __shared__ uint32_t fac[2][9][32];             // m1 R, m0 R; limb, column
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int64_t p = (int64_t)blockIdx.y * 32 + lane;
  const int64_t r = (int64_t)blockIdx.x * SMUL_WARPS + w;
  const bool live = p < P && r < R;
  const int64_t off = r * 9 * P + p;
  sc xv = sc_zero(), yv = sc_zero();
  bool hi = false;
  if (live) {
    hi = mask[r];
    xv = sc_load_lo(x + off, P);
    if (y != nullptr) yv = sc_load_lo(y + off, P);
  }
  if (w < 2 && p < P) {
    const sc f = sc_mont_mul(sc_load_lo((w == 0 ? m1 : m0) + p, P),
                             sc_const(SC_R2));
#pragma unroll
    for (int k = 0; k < 9; ++k) fac[w][k][lane] = f.v[k];
  }
  __syncthreads();
  if (!live) return;
  sc a, b;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    a.v[k] = fac[hi ? 0 : 1][k][lane];
    b.v[k] = fac[hi ? 1 : 0][k][lane];
  }
  sc_store64(ox + off, P, sc_mont_mul(xv, a));
  if (y != nullptr) sc_store64(oy + off, P, sc_mont_mul(yv, b));
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

// x, ox (R, 9, P); y, oy (R, 9, P) or null; mask (R,) uint8; m1, m0 (9, P)
BP_EXPORT int bp_smul(const int64_t* x, const int64_t* y, const uint8_t* mask,
                      const int64_t* m1, const int64_t* m0, int64_t* ox,
                      int64_t* oy, int64_t R, int64_t P, cudaStream_t stream) {
  const dim3 grid((unsigned)((R + SMUL_WARPS - 1) / SMUL_WARPS),
                  (unsigned)((P + 31) / 32));
  smul_kernel<<<grid, 32 * SMUL_WARPS, 0, stream>>>(x, y, mask, m1, m0, ox,
                                                    oy, R, P);
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
