// Kernels K17-K20: the batch prover's mod-l vector arithmetic and its
// blinding draws, one launch per call of ops/scalar.py / ops/chacha.py.
//
// None of them replaces a Pallas kernel.  The JAX package runs this code
// as XLA inside its compiled prover programs (ops/prover_stages.py: two
// jitted programs at m = 1, the segmented ones above): K17 sc_mul is
// ops/vec_scalar.py:107 smul (and the Montgomery product under to_mont /
// from_mont / sreduce), K18 sc_add is :85 sadd and :124 sneg, K19
// sc_tree_sum is :281 tree_sum, K20 chacha_scalars is ops/chacha.py:52
// _keystream_blocks with :91 random_scalars, and :189 from_wide_bytes.
// The port's plain versions run limb step by limb step, each step a
// PyTorch launch: a smul was ~330 launches, a half of an m = 1 prove
// ~28,000 of them.
//
// Layout: scalars are (..., 9, P) int64, 29-bit canonical limbs
// (csrc/sc25519.cuh).  K17 and K18 take two operands of any strides over
// (row0, row1, limb, column), stride 0 where a dimension is broadcast (a
// (9, 1) constant, an expanded vector, a per-proof scalar against a (n, 9,
// P) vector), and write a fresh contiguous (row0 row1, 9, P) output: the
// broadcasts are never materialised.  A block is SC_THREADS neighbouring
// columns of one row (grid.y walks the rows), so every limb load and store
// of a warp is one coalesced access of a contiguous operand.
//
// Bound.  K17 at the prover's round-emit shapes (256 x 4096 at m = 1)
// reads two 72-byte operands and writes one per element against two
// Montgomery products (342 limb products, 684 32-bit multiply-adds): bytes
// bind it (0.0676 ms against 0.0429 of multiply-adds on an H100).  K18 and
// K19 are additions: bytes.  K20 reads nothing (the key is a launch
// argument) and writes 72 bytes a draw against 20 ChaCha rounds (976
// 32-bit additions, XORs and rotations on the integer pipe) and one
// double Montgomery reduction (504 multiply-adds, beside them): the ALU
// operations bind (0.0315 ms at the m = 1 half's 540,672 draws).  Design:
// no shared memory (K19's eight partial sums aside) and no reuse to
// exploit; each thread's arithmetic stays in registers.  K19's first form
// ran one block per 32 columns whatever the rows: 16 blocks at the m = 16
// round's 1024 x 512, each thread adding 128 rows in turn (12 % of its
// bound).  Its blocks now also split the rows (grid.y) until the card
// holds about two blocks an SM (ops/scalar.tree_slices), and a second
// launch adds the slices' canonical sums: canonical sums are unique, so
// the limbs are tree_sum_plain's whatever the order, with no atomics.  Its prefix form
// sums the first h rows of two vectors side by side, h read from device
// memory (the IPP round's cross terms: no masked copy, and every round's
// launch the same).
//
// Secret data: the witness rows pass through K17-K19 and K20 draws the
// blinds.  Every thread runs the same instructions whatever its values
// (sc25519.cuh selects by masks); an index depends only on the thread's
// position and the shapes.
#include "common.cuh"
#include "sc_vec.cuh"

#define SC_THREADS 128
// K19: a block is TS_COLS columns x TS_SLICES row slices
#define TS_COLS 32
#define TS_SLICES 8

// one operand: element (r0, r1, limb k, column c) at p[r0 s0 + r1 s1 + k sl
// + c scol]
struct sc_view {
  const int64_t* p;
  int64_t s0, s1, sl, scol;
};

__device__ __forceinline__ const int64_t* view_at(const sc_view& v,
                                                  int64_t r0, int64_t r1,
                                                  int64_t c) {
  return v.p + r0 * v.s0 + r1 * v.s1 + c * v.scol;
}

// out (rows, 9, P) with rows = R0 R1, row r = r0 R1 + r1
template <int MODE>
__global__ void __launch_bounds__(SC_THREADS)
sc_mul_kernel(sc_view a, sc_view b, int64_t* __restrict__ out, int64_t R1,
              int64_t rows, int64_t P) {
  const int64_t c = (int64_t)blockIdx.x * SC_THREADS + threadIdx.x;
  if (c >= P) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const int64_t r0 = r / R1, r1 = r - r0 * R1;
    const sc x = sc_load(view_at(a, r0, r1, c), a.sl);
    const sc y = sc_load(view_at(b, r0, r1, c), b.sl);
    sc_store(out + r * 9 * P + c, P, sc_mul_elem<MODE>(x, y));
  }
}

template <int OP>
__global__ void __launch_bounds__(SC_THREADS)
sc_add_kernel(sc_view a, sc_view b, int64_t* __restrict__ out, int64_t R1,
              int64_t rows, int64_t P) {
  const int64_t c = (int64_t)blockIdx.x * SC_THREADS + threadIdx.x;
  if (c >= P) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const int64_t r0 = r / R1, r1 = r - r0 * R1;
    const sc x = sc_load(view_at(a, r0, r1, c), a.sl);
    const sc y = OP == 0 ? sc_load(view_at(b, r0, r1, c), b.sl) : x;
    sc_store(out + r * 9 * P + c, P, sc_add_elem<OP>(x, y));
  }
}

// K19 over columns [0, Pa) of operand a and [Pa, Pt) of operand b (b.p
// null when Pa = Pt; the prefix form's second vector) and rows [0, rows),
// rows = min(n, *h) (h null: n): slice s = blockIdx.y sums its part of the
// rows (sc_slice) into out + s 9 Pt.  Each of a column's TS_SLICES threads
// sums every TS_SLICES-th row of the part, then the first adds the others'
// partial sums from shared memory.  (Two columns a thread by 16-byte loads
// were slower from memory on an H100 than one.)
__global__ void __launch_bounds__(TS_COLS * TS_SLICES)
sc_tree_sum_kernel(sc_view a, sc_view b, int64_t Pa, int64_t Pt, int64_t n,
                   const int64_t* __restrict__ h, int64_t* __restrict__ out) {
  __shared__ uint32_t part[TS_SLICES][9][TS_COLS];
  const int64_t c = (int64_t)blockIdx.x * TS_COLS + threadIdx.x;
  const bool live = c < Pt;
  const int64_t hv = h ? *h : n;
  const int64_t rows = hv < 0 ? 0 : hv < n ? hv : n;
  int64_t r0, r1;
  sc_slice(rows, gridDim.y, blockIdx.y, r0, r1);
  sc acc = sc_zero();
  if (live) {
    const sc_view v = c < Pa ? a : b;
    acc = sc_sum_rows(v.p + (c < Pa ? c : c - Pa) * v.scol + r0 * v.s0,
                      v.s0, v.sl, r1 - r0, threadIdx.y, TS_SLICES);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) part[threadIdx.y][k][threadIdx.x] = acc.v[k];
  __syncthreads();
  if (threadIdx.y != 0 || !live) return;
#pragma unroll 1
  for (int s = 1; s < TS_SLICES; ++s) {
    sc x;
#pragma unroll
    for (int k = 0; k < 9; ++k) x.v[k] = part[s][k][threadIdx.x];
    acc = sc_add(acc, x);
  }
  sc_store(out + (int64_t)blockIdx.y * 9 * Pt + c, Pt, acc);
}

struct chacha_key {
  uint32_t w[8];
};

// draw i -> out[:, i]: with WIDE, (lo + 2^256 hi) mod l of the 64 bytes at
// rows + i rs (bytes bs apart); else the ChaCha20 block of `key` with
// counter i, reduced the same way
template <bool WIDE>
__global__ void __launch_bounds__(SC_THREADS)
chacha_scalars_kernel(const uint8_t* __restrict__ rows, int64_t rs,
                      int64_t bs, chacha_key key, int64_t* __restrict__ out,
                      int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * SC_THREADS + threadIdx.x;
  if (i >= n) return;
  sc r;
  if (WIDE) {
    uint32_t w[16];
    wide_words(rows + i * rs, bs, w);
    r = sc_from_wide(w);
  } else {
    r = chacha_scalar(key.w, (uint32_t)i);
  }
  sc_store(out + i, n, r);
}

static dim3 row_grid(int64_t rows, int64_t P) {
  return dim3((unsigned)((P + SC_THREADS - 1) / SC_THREADS),
              (unsigned)(rows < 65535 ? rows : 65535));
}

// a, b: operands with their (row0, row1, limb, column) strides; out (R0 R1,
// 9, P) contiguous; mode 0: a b R^-1, mode 1: a b mod l
BP_EXPORT int bp_sc_mul(const int64_t* a, int64_t as0, int64_t as1,
                        int64_t asl, int64_t asc, const int64_t* b,
                        int64_t bs0, int64_t bs1, int64_t bsl, int64_t bsc,
                        int64_t* out, int64_t R0, int64_t R1, int64_t P,
                        int64_t mode, cudaStream_t stream) {
  const sc_view va{a, as0, as1, asl, asc}, vb{b, bs0, bs1, bsl, bsc};
  const dim3 grid = row_grid(R0 * R1, P);
  if (mode == 0)
    sc_mul_kernel<0><<<grid, SC_THREADS, 0, stream>>>(va, vb, out, R1,
                                                      R0 * R1, P);
  else
    sc_mul_kernel<1><<<grid, SC_THREADS, 0, stream>>>(va, vb, out, R1,
                                                      R0 * R1, P);
  return (int)cudaGetLastError();
}

// op 0: a + b mod l; op 1: -a mod l (b null)
BP_EXPORT int bp_sc_add(const int64_t* a, int64_t as0, int64_t as1,
                        int64_t asl, int64_t asc, const int64_t* b,
                        int64_t bs0, int64_t bs1, int64_t bsl, int64_t bsc,
                        int64_t* out, int64_t R0, int64_t R1, int64_t P,
                        int64_t op, cudaStream_t stream) {
  const sc_view va{a, as0, as1, asl, asc}, vb{b, bs0, bs1, bsl, bsc};
  const dim3 grid = row_grid(R0 * R1, P);
  if (op == 0)
    sc_add_kernel<0><<<grid, SC_THREADS, 0, stream>>>(va, vb, out, R1,
                                                      R0 * R1, P);
  else
    sc_add_kernel<1><<<grid, SC_THREADS, 0, stream>>>(va, vb, out, R1,
                                                      R0 * R1, P);
  return (int)cudaGetLastError();
}

// a (n, 9, Pa) and b (n, 9, Pt - Pa) with strides (s0, sl, scol), b null
// when Pt = Pa; h null or a device int64, the rows summed at most -> out
// (slices, 9, Pt) contiguous, slice s the sum of the s-th of `slices`
// equal parts of the rows (ops/scalar.py adds the slices by a second call)
BP_EXPORT int bp_sc_tree_sum(const int64_t* a, int64_t as0, int64_t asl,
                             int64_t asc, const int64_t* b, int64_t bs0,
                             int64_t bsl, int64_t bsc, int64_t Pa, int64_t Pt,
                             int64_t n, const int64_t* h, int64_t* out,
                             int64_t slices, cudaStream_t stream) {
  const sc_view va{a, as0, 0, asl, asc}, vb{b, bs0, 0, bsl, bsc};
  sc_tree_sum_kernel<<<dim3((unsigned)((Pt + TS_COLS - 1) / TS_COLS),
                            (unsigned)slices),
                       dim3(TS_COLS, TS_SLICES), 0, stream>>>(va, vb, Pa, Pt,
                                                              n, h, out);
  return (int)cudaGetLastError();
}

// rows non-null: (n, 64) bytes at rows + i rs + j bs, reduced mod l; rows
// null: n draws of the key k0..k7 (little-endian words); out (9, n)
BP_EXPORT int bp_chacha_scalars(const uint8_t* rows, int64_t rs, int64_t bs,
                                int64_t k0, int64_t k1, int64_t k2,
                                int64_t k3, int64_t k4, int64_t k5,
                                int64_t k6, int64_t k7, int64_t* out,
                                int64_t n, cudaStream_t stream) {
  const chacha_key key{{(uint32_t)k0, (uint32_t)k1, (uint32_t)k2,
                        (uint32_t)k3, (uint32_t)k4, (uint32_t)k5,
                        (uint32_t)k6, (uint32_t)k7}};
  const unsigned blocks = (unsigned)((n + SC_THREADS - 1) / SC_THREADS);
  if (rows)
    chacha_scalars_kernel<true><<<blocks, SC_THREADS, 0, stream>>>(
        rows, rs, bs, key, out, n);
  else
    chacha_scalars_kernel<false><<<blocks, SC_THREADS, 0, stream>>>(
        rows, rs, bs, key, out, n);
  return (int)cudaGetLastError();
}
