// Kernels K6, K12 and K7: the prover's fixed-base multi-scalar
// multiplication, many output lanes over one shared Niels table stream.
//
// K6 fixed_accumulate replaces ops/fixed_msm.py:274 _fixed_accum_kernel (the
// first pallas_call of _fixed_msm, :387); K12 fixed_accumulate2 replaces
// :206 _fixed_accum_kernel2, the same call under _ILP2 (two bucket sets fed
// by alternate rows, two independent mixed-addition chains per thread,
// merged at the end); K7 fixed_reduce replaces :346 _fixed_reduce_kernel
// (the second call, :406), and takes K6 one-hot's and K12's slabs alike.
//
// K6: lane q streams rows s of its chunk in order and adds digit[s][q] times
// table point s (digits in [-7, 8]; in the one-hot form into bucket |digit|
// of 8).  The table rows are shared: every thread of a warp reads the same
// row.  Bound: operations, one 7-multiplication mixed addition (~700
// IMAD.WIDE) per non-zero (row, lane) against 1 byte of digit.
//
// K6 has two forms, each its own kernel:
// * one-hot (fixed_accumulate, consttime): the V/A/S and T rows carry the
//   prover's witness, so the bucket access must not depend on the digit
//   (docs/architecture.md, "Determinism, security notes": the prover MSMs
//   are uniform-time).  At every row the thread reads all 8 buckets and
//   ORs each under an all-ones / all-zeros mask (exactly one mask is set,
//   none for digit 0), adds, and writes all 8 back, each as (new & m) |
//   (old & ~m).  Negating the Niels point (Y+X <-> Y-X, 2dT -> -2dT) is a
//   select too.  This is the one-hot mux of the TPU kernel; its buckets
//   are laid out so that a thread's 8 copies of a word take two 16-byte
//   accesses (OneHotSet).  It keeps 1,280 B of buckets per lane in shared
//   memory, 40 KB per block of 32 lanes: five blocks per SM on an H100
//   (228 KB of shared memory per SM; bp_fixed_blocks_per_sm asks the
//   runtime).  The slab (splits, 8, 4, 10, Q) leaves the kernel once.
// * direct (fixed_accumulate_vt, fixed_direct_kernel; public rows only):
//   the IPP rounds' L / R coefficients are public, as the reference's
//   vartime MSM treats them (the JAX host route's rist_msm_rows), so a
//   non-zero digit d of row s adds +-|d| P_s read from a table of
//   multiples into one accumulator in registers (csrc/fixed_direct.cuh):
//   no buckets, no shared memory, one mixed addition a non-zero digit as
//   in the one-hot form.  Its rows are read through a row map (the IPP
//   round's rows of the full table), blocks of 128 lanes of one chunk, so
//   a warp's 32 loads of a row touch at most 8 lines; registers alone set
//   its residency (DIRECT_MIN_BLOCKS blocks an SM, two warps on each
//   scheduler).  Its slab is (splits, 1, 4, 10, Q): one point a chunk.
// The TPU ran one serial stream per lane; here each lane's S rows are
// split into `splits` contiguous chunks (grid.y), each with its own
// buckets or accumulator, so Q * splits threads fill the 132 SMs at any
// lane count (ops/fixed_msm.pick_splits, with a thread target per form).
//
// K7: 8 G threads per lane, thread 8 g + b of the lane's span: bucket b
// (0..7) of chunk group g (0..G-1), G = 1, 2 or 4 by the split (about one
// group per 16 chunks; ops/fixed_msm.red_groups).  Group g sums chunks g,
// g + G, g + 2G, ... in order with complete additions; the groups fold by
// a shuffle tree (g += g + h, h = G/2 .. 1); then the 8 bucket threads of
// group 0 form sum_b (b + 1) B_b as sum_b S_b with S_b = sum_{c >= b} B_c:
// a suffix scan (3 steps) and a tree sum (3 steps) by warp shuffles, the
// TPU kernel's two suffix scans done lane-parallel.  So a lane's chain is
// ceil(splits / G) - 1 + log2 G + 6 additions (was (splits - 1) * 8 + 14
// in one thread); at a small split (the m=1 prover's 5) G = 1 keeps the
// warp's 32 threads on 4 lanes' work.  Bound: operations, small beside K6.
// K7's chunk merge (fixed_merge_kernel) is the same body over the direct
// form's one point a chunk: G threads a lane, no scan and no tree.
//
// K12: K6's one-hot work per (row, lane), the chunk's rows 2i into bucket
// set 0 and rows 2i + 1 into set 1, plus 8 complete additions per lane
// and chunk at the end (set 0 + set 1, bucket by bucket).  The TPU
// kernel ran the two sets as two chains in one thread, for instruction-
// level parallelism; here the two chains are two threads.  A block of 32
// threads holds 16 lanes x 2 sets: thread t takes lane t % 16 and set
// t / 16, and keeps its set as K6's OneHotSet, 1,280 B, so a block has
// K6's 40 KB of static shared memory and an SM holds K6's 5 blocks (the
// kernel before kept both sets in one thread in the [bucket][word]
// [thread] layout: 80 KB of dynamic shared memory a block, 2 blocks an
// SM, 960 shared-memory instructions a row where OneHotSet takes 240).
// Each chunk has an even number of rows (the wrapper pads with Niels
// identities and zero digits).  Its slab differs from K6's only in the
// points' projective representation, so K7 and compression give the same
// bytes.
//
// Every step is ops/fixed_msm.py's plain version in the same order, so the
// slab and the points match it limb for limb.
#include "common.cuh"
#include "fe25519.cuh"
#include "fixed_direct.cuh"

#define NBUCKET 8
#define FX_THREADS 32
#define RED_THREADS 128                  // K7: 4 warps
#define DIRECT_THREADS 128               // K6 direct: 4 warps of one chunk
#define DIRECT_MIN_BLOCKS 2              // 8 warps an SM: 2 a scheduler

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

// -- K6's one-hot form (witness rows): [word][half][thread][4 buckets] -------
//
// A thread's 8 copies of bucket word w sit side by side, buckets 4h..4h+3
// in 16 bytes at ((w * 2 + h) * FX_THREADS + thread) * 16: consecutive
// threads on consecutive 16 bytes, so a warp's 16-byte access has no bank
// conflict.  Per row and word two 16-byte loads fetch all 8 copies to
// select, and two 16-byte read-modify-writes put them back: 240
// shared-memory instructions a row where the [bucket][word][thread]
// layout took 960, the same bytes (1.3-1.4x faster on an H100).  Every
// access is an `asm volatile` ld / st.shared.v4, issued as written, at an
// address that does not depend on the digit; the digit only forms the
// masks.
__device__ __forceinline__ void lds4(uint32_t addr, int32_t* v) {
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr));
}

__device__ __forceinline__ void sts4(uint32_t addr, const int32_t* v) {
  asm volatile("st.shared.v4.s32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]));
}

struct OneHotSet {
  uint32_t base;                                 // shared address, this thread

  // the 8 copies of word w: v[b], bucket b
  __device__ __forceinline__ void load8(int w, int32_t v[8]) const {
    lds4(base + (uint32_t)(2 * w * FX_THREADS * 16), v);
    lds4(base + (uint32_t)((2 * w + 1) * FX_THREADS * 16), v + 4);
  }
  __device__ __forceinline__ void store8(int w, const int32_t v[8]) const {
    sts4(base + (uint32_t)(2 * w * FX_THREADS * 16), v);
    sts4(base + (uint32_t)((2 * w + 1) * FX_THREADS * 16), v + 4);
  }

  // the shared address of thread tid's slots in the block's buckets
  static __device__ __forceinline__ uint32_t slots(int32_t* buckets, int tid) {
    return (uint32_t)__cvta_generic_to_shared(buckets) + tid * 16;
  }

  __device__ OneHotSet(int32_t* buckets, int tid) : base(slots(buckets, tid)) {
#pragma unroll
    for (int w = 0; w < 40; ++w) {               // identity (0 : 1 : 1 : 0)
      const int32_t one = (w == 10 || w == 20) ? 1 : 0;
      const int32_t v[8] = {one, one, one, one, one, one, one, one};
      store8(w, v);
    }
  }
  // every copy of every word read, ORed under the all-ones / all-zeros
  // masks (exactly one set, none for digit 0: its sum is dropped), added
  // to, and written back as (new & m) | (old & ~m)
  // (each mask formed where it is used: held in eight registers across the
  // addition, they made ptxas spill 60 B once fe_mul took mad.wide.s32)
  __device__ __forceinline__ void add(int mag, const ge_niels& pt) {
    int32_t cur[40];
#pragma unroll
    for (int w = 0; w < 40; ++w) {
      int32_t v[8];
      load8(w, v);
      int32_t x = 0;
#pragma unroll
      for (int b = 0; b < NBUCKET; ++b) x |= v[b] & -(int32_t)(mag == b + 1);
      cur[w] = x;
    }
    int32_t nw[40];
    ge_to_words(ge_madd(ge_from_words(cur), pt), nw);
#pragma unroll
    for (int w = 0; w < 40; ++w) {
      int32_t v[8];
      load8(w, v);
#pragma unroll
      for (int b = 0; b < NBUCKET; ++b) {
        const int32_t m = -(int32_t)(mag == b + 1);
        v[b] = (nw[w] & m) | (v[b] & ~m);
      }
      store8(w, v);
    }
  }
  // word w of bucket b of the set whose slots start at `at`
  static __device__ __forceinline__ int32_t word_at(uint32_t at, int b,
                                                    int w) {
    int32_t v;
    asm volatile("ld.shared.s32 %0, [%1];"
                 : "=r"(v)
                 : "r"(at + (uint32_t)(((2 * w + b / 4) * FX_THREADS) * 16 +
                                       (b % 4) * 4)));
    return v;
  }
  __device__ __forceinline__ int32_t word(int b, int w) const {
    return word_at(base, b, w);
  }
};

// K6's one-hot form over its bucket set (SET = OneHotSet): a zero digit's
// sum is computed and dropped.
template <class SET>
__global__ void __launch_bounds__(FX_THREADS)
fixed_accumulate_kernel(const int32_t* __restrict__ niels,
                        const int8_t* __restrict__ digits,
                        int32_t* __restrict__ slab, int64_t S, int64_t Q,
                        int64_t rows) {
  __shared__ __align__(16) int32_t buckets[NBUCKET * 40 * FX_THREADS];
  const int tid = threadIdx.x;
  const int64_t q = (int64_t)blockIdx.x * FX_THREADS + tid;
  const int c = blockIdx.y;
  if (q >= Q) return;
  SET set(buckets, tid);

  for (int64_t s = c * rows; s < (c + 1) * rows; ++s) {
    const int d = digits[s * Q + q];
    set.add(d < 0 ? -d : d, signed_point(niels, S, s, d < 0));
  }

  // slab[c][b][coord][limb][q]
#pragma unroll
  for (int b = 0; b < NBUCKET; ++b) {
    int32_t* dst = slab + ((int64_t)(c * NBUCKET + b) * 40) * Q + q;
#pragma unroll
    for (int w = 0; w < 40; ++w) dst[(int64_t)w * Q] = set.word(b, w);
  }
}

// K6's direct form: thread (q, c) sums its lane's digit rows [c rows,
// (c + 1) rows) of the S (the last chunks may be short or empty) and
// stores one point, slab[c][0][coord][limb][q]
__global__ void __launch_bounds__(DIRECT_THREADS, DIRECT_MIN_BLOCKS)
fixed_direct_kernel(const int32_t* __restrict__ mult,
                    const int64_t* __restrict__ sel,
                    const int8_t* __restrict__ digits,
                    int32_t* __restrict__ slab, int64_t S, int64_t Q,
                    int64_t rows) {
  const int64_t q = (int64_t)blockIdx.x * DIRECT_THREADS + threadIdx.x;
  const int64_t c = blockIdx.y;
  if (q >= Q) return;
  const int64_t s0 = c * rows, s1 = s0 + rows < S ? s0 + rows : S;
  ge_store(slab + c * 40 * Q + q, Q,
           direct_chunk(mult, sel, digits, Q, q, s0, s1));
}

// K12: lanes a block of 32 threads, each lane's two sets on two threads
#define FX2_LANES (FX_THREADS / 2)

// Thread t of block (b, c) accumulates rows c rows + 2i + h of lane q = 16
// b + t % 16 into its own OneHotSet, h = t / 16, as K6's one-hot form
// does (every bucket read and written at every row, at addresses that do
// not depend on the digit: witness rows).  After the warp's __syncwarp,
// thread (q, h) reads buckets 4h..4h+3 of both of its lane's sets, the
// partner's through the partner's slots, and stores set 0 + set 1.  A
// lane past Q runs no row but reaches the __syncwarp, which takes the
// whole warp.
__global__ void __launch_bounds__(FX_THREADS)
fixed_accumulate2_kernel(const int32_t* __restrict__ niels,
                         const int8_t* __restrict__ digits,
                         int32_t* __restrict__ slab, int64_t S, int64_t Q,
                         int64_t rows) {
  __shared__ __align__(16) int32_t buckets[NBUCKET * 40 * FX_THREADS];
  const int tid = threadIdx.x, lane = tid % FX2_LANES, h = tid / FX2_LANES;
  const int64_t q = (int64_t)blockIdx.x * FX2_LANES + lane;
  const int c = blockIdx.y;
  OneHotSet set(buckets, tid);
  if (q < Q) {
    for (int64_t s = c * rows + h; s < (c + 1) * rows; s += 2) {
      const int d = digits[s * Q + q];
      set.add(d < 0 ? -d : d, signed_point(niels, S, s, d < 0));
    }
  }
  __syncwarp();
  if (q >= Q) return;
  const uint32_t set0 = OneHotSet::slots(buckets, lane);
  const uint32_t set1 = OneHotSet::slots(buckets, lane + FX2_LANES);
#pragma unroll 1
  for (int b = 4 * h; b < 4 * h + 4; ++b) {
    int32_t w0[40], w1[40];
#pragma unroll
    for (int w = 0; w < 40; ++w) {
      w0[w] = OneHotSet::word_at(set0, b, w);
      w1[w] = OneHotSet::word_at(set1, b, w);
    }
    ge_store(slab + ((int64_t)(c * NBUCKET + b) * 40) * Q + q, Q,
             ge_add(ge_from_words(w0), ge_from_words(w1)));
  }
}

// lane i of the warp gets p of lane i + delta (its own p where i + delta
// is past the warp); every lane of the warp must take part
__device__ __forceinline__ ge ge_shfl_down(const ge& p, int delta) {
  int32_t w[40];
  ge_to_words(p, w);
#pragma unroll
  for (int k = 0; k < 40; ++k) w[k] = __shfl_down_sync(0xffffffffu, w[k], delta);
  return ge_from_words(w);
}

// groups G = 1, 2 or 4 (ops/fixed_msm.red_groups): lane q's NB G threads
// are t = NB G j + NB g + b of a warp holding 32 / (NB G) lanes; NB = 8
// buckets (K7) or one point a chunk (K7's chunk merge, where the scan and
// the tree over the buckets vanish)
template <int NB>
__device__ __forceinline__ void reduce_body(const int32_t* __restrict__ slab,
                                            int32_t* __restrict__ out,
                                            int64_t Q, int splits,
                                            int groups) {
  const int t = threadIdx.x % 32, b = t % NB, g = t / NB % groups;
  const int span = NB * groups;                        // threads per lane
  int64_t q = ((int64_t)blockIdx.x * (RED_THREADS / 32) + threadIdx.x / 32)
                  * (32 / span) + t / span;
  // a lane past Q repeats lane Q - 1's work and stores nothing: every
  // thread of the warp takes part in the shuffles
  const bool store = q < Q;
  if (!store) q = Q - 1;
  const int64_t chunk = (int64_t)NB * 40 * Q;          // slab[k] stride
  const int32_t* src = slab + (int64_t)b * 40 * Q + q;
  ge m = ge_identity();
  if (g < splits) {
    m = ge_load(src + g * chunk, Q);
    for (int k = g + groups; k < splits; k += groups)
      m = ge_add(m, ge_load(src + k * chunk, Q));
  }
  const int live = splits < groups ? splits : groups;
  for (int h = groups / 2; h >= 1; h /= 2) {           // groups: g += g + h
    const ge o = ge_shfl_down(m, NB * h);
    if (g < h && g + h < live) m = ge_add(m, o);
  }
#pragma unroll
  for (int d = 1; d < NB; d *= 2) {                    // S_b += S_{b + d}
    const ge o = ge_shfl_down(m, d);
    if (g == 0 && b + d < NB) m = ge_add(m, o);
  }
#pragma unroll
  for (int h = NB / 2; h >= 1; h /= 2) {               // sum_b S_b
    const ge o = ge_shfl_down(m, h);
    if (g == 0 && b < h) m = ge_add(m, o);
  }
  if (store && g == 0 && b == 0) ge_store(out + q, Q, m);
}

__global__ void __launch_bounds__(RED_THREADS)
fixed_reduce_kernel(const int32_t* __restrict__ slab, int32_t* __restrict__ out,
                    int64_t Q, int splits, int groups) {
  reduce_body<NBUCKET>(slab, out, Q, splits, groups);
}

__global__ void __launch_bounds__(RED_THREADS)
fixed_merge_kernel(const int32_t* __restrict__ slab, int32_t* __restrict__ out,
                   int64_t Q, int splits, int groups) {
  reduce_body<1>(slab, out, Q, splits, groups);
}

// niels (3, 10, S) int32, digits (S, Q) int8 -> slab (splits, 8, 4, 10, Q)
BP_EXPORT int bp_fixed_accumulate(const int32_t* niels, const int8_t* digits,
                                  int32_t* slab, int64_t S, int64_t Q,
                                  int64_t splits, cudaStream_t stream) {
  dim3 grid((unsigned)((Q + FX_THREADS - 1) / FX_THREADS), (unsigned)splits);
  fixed_accumulate_kernel<OneHotSet><<<grid, FX_THREADS, 0, stream>>>(
      niels, digits, slab, S, Q, S / splits);
  return (int)cudaGetLastError();
}

// the direct form, public rows only: mult (T, 8, 32) int32 multiples
// table, sel (S,) int64 rows of it (null: rows 0..S-1), digits (S, Q) int8
// -> slab (splits, 1, 4, 10, Q), chunks of `rows` digit rows
BP_EXPORT int bp_fixed_accumulate_vt(const int32_t* mult, const int64_t* sel,
                                     const int8_t* digits, int32_t* slab,
                                     int64_t S, int64_t Q, int64_t splits,
                                     int64_t rows, cudaStream_t stream) {
  dim3 grid((unsigned)((Q + DIRECT_THREADS - 1) / DIRECT_THREADS),
            (unsigned)splits);
  fixed_direct_kernel<<<grid, DIRECT_THREADS, 0, stream>>>(
      mult, sel, digits, slab, S, Q, rows);
  return (int)cudaGetLastError();
}

// niels (3, 10, S) int32, digits (S, Q) int8 -> slab (splits, 8, 4, 10, Q);
// S / splits must be even
BP_EXPORT int bp_fixed_accumulate2(const int32_t* niels, const int8_t* digits,
                                   int32_t* slab, int64_t S, int64_t Q,
                                   int64_t splits, cudaStream_t stream) {
  dim3 grid((unsigned)((Q + FX2_LANES - 1) / FX2_LANES), (unsigned)splits);
  fixed_accumulate2_kernel<<<grid, FX_THREADS, 0, stream>>>(
      niels, digits, slab, S, Q, S / splits);
  return (int)cudaGetLastError();
}

// slab (splits, 8, 4, 10, Q) -> out (4, 10, Q); groups 1, 2 or 4
BP_EXPORT int bp_fixed_reduce(const int32_t* slab, int32_t* out, int64_t Q,
                              int64_t splits, int64_t groups,
                              cudaStream_t stream) {
  const int64_t lanes = RED_THREADS / (NBUCKET * groups);   // per block
  const unsigned blocks = (unsigned)((Q + lanes - 1) / lanes);
  fixed_reduce_kernel<<<blocks, RED_THREADS, 0, stream>>>(
      slab, out, Q, (int)splits, (int)groups);
  return (int)cudaGetLastError();
}

// slab (splits, 1, 4, 10, Q) -> out (4, 10, Q); groups 1, 2 or 4
BP_EXPORT int bp_fixed_merge(const int32_t* slab, int32_t* out, int64_t Q,
                             int64_t splits, int64_t groups,
                             cudaStream_t stream) {
  const int64_t lanes = RED_THREADS / groups;                // per block
  const unsigned blocks = (unsigned)((Q + lanes - 1) / lanes);
  fixed_merge_kernel<<<blocks, RED_THREADS, 0, stream>>>(
      slab, out, Q, (int)splits, (int)groups);
  return (int)cudaGetLastError();
}

// blocks that one SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): out[0] K6 one-hot,
// out[1] K6 direct (blocks of DIRECT_THREADS), out[2] K12, out[3] K7
BP_EXPORT int bp_fixed_blocks_per_sm(int* out) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fixed_accumulate_kernel<OneHotSet>, FX_THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, fixed_direct_kernel, DIRECT_THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2, fixed_accumulate2_kernel, FX_THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 3, fixed_reduce_kernel, RED_THREADS, 0);
  return (int)err;
}
