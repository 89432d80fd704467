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
// the plain versions); shifts are arithmetic on int32.  The step itself
// is in csrc/fmul13.cuh.
//
// What bounds them.  A lane's T steps are a serial chain, so the
// throughput bounds (K15: 3 x 441 + 1 multiply-adds a lane-step on the
// CUDA cores; K16: 3 x 156 x 40 int8 multiply-adds on the tensor cores)
// cannot bind at the probe's Q = 512: one step's dependent path does, x T
// (benches/field_kernels.fmul13_latency_floor_ms).  The first forms ran a
// lane's whole step in one thread (K15: one warp of 32 lanes a block, 16
// of the card's 528 sub-partitions busy at Q = 512) or on a few threads
// after loads that each step waited for (K16).  Both now spread a lane's
// step over threads that exchange neighbour limbs by shuffles.
//
// K15 `fmul13_chain_kernel`: a warp a lane, thread k holding limb k
// (fm_columns_vpu, fm_tail): the 20 limbs gathered by shuffles, 90
// multiply-adds a thread, one shuffle for the fold, one a carry round.
// The 12 idle threads of each warp are the price of a thread a limb.  A
// block of VPU_WARPS lanes stages the shared operands of VPU_CHUNK steps
// in shared memory by cp.async, the next chunk in flight while this one
// runs (double buffered), so no step waits on a global load.
//
// K16 `fmul13_chain_mma_kernel`: a block of MMA_BLOCK_LANES lanes runs
// three kinds of warp.  One keeps MMA_STAGES steps of the three matrices
// (18,720 bytes a step, three bulk copies onto an mbarrier) in flight in a
// ring of dynamic shared memory.  MMA_XWARPS product warps split the
// step's 15 (operand, column group) pairs of 8 lanes, two mma.sync
// m16n8k32 each on the zero-skipping tiles of fmul13.cuh, and write the
// combined column sums; their A fragments are loaded from the ring a
// phase ahead, a word a load straight into the mma's registers, at
// offsets planned once (fm_plan).  Lane warps run the tails, ten threads
// a lane and two limbs a thread, three lanes a warp (fm_tail2), and write
// the lanes' new int8 split.  A step: products; a barrier of the block;
// tails while the product warps load the next fragments; a barrier of the
// lane and product warps.  30 mma a step for 8 lanes: 15,360 int8
// multiply-adds a lane-step against the 18,720 of the dense product.  The
// shapes are measured choices (benches/fmul13_chain.py --sweep).
#include "common.cuh"
#include "fmul13.cuh"

// -- K15 -----------------------------------------------------------------------------

#ifndef VPU_WARPS
#define VPU_WARPS 4     // lanes (warps) a block
#endif
#define VPU_CHUNK 64    // steps of operands staged at once (a power of two)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// operands of steps t0 .. t0 + n - 1 (b3 rows r = 20 j + l, T apart) into
// bs[s][r] by 4-byte cp.async, one commit group
__device__ __forceinline__ void vpu_stage(int32_t (*bs)[3 * FL],
                                          const int32_t* __restrict__ b3,
                                          int64_t T, int64_t t0, int n) {
  for (int e = threadIdx.x; e < 3 * FL * VPU_CHUNK; e += 32 * VPU_WARPS) {
    const int r = e / VPU_CHUNK, s = e % VPU_CHUNK;
    if (s < n)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       smem_addr(&bs[s][r])),
                   "l"(b3 + (int64_t)r * T + t0 + s)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(32 * VPU_WARPS)
fmul13_chain_kernel(const int32_t* __restrict__ a_in,
                    const int32_t* __restrict__ b3,
                    int32_t* __restrict__ out, int64_t Q, int64_t T) {
  __shared__ __align__(16) int32_t bs[2][VPU_CHUNK][3 * FL];
  const int k = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * VPU_WARPS + (threadIdx.x >> 5);
  const bool live = q < Q && k < FL;
  uint32_t a = live ? (uint32_t)a_in[k * Q + q] : 0u;

  vpu_stage(bs[0], b3, T, 0, T < VPU_CHUNK ? (int)T : VPU_CHUNK);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  for (int64_t t0 = 0, c = 0; t0 < T; t0 += VPU_CHUNK, ++c) {
    const int n = T - t0 < VPU_CHUNK ? (int)(T - t0) : VPU_CHUNK;
    const int64_t t1 = t0 + VPU_CHUNK;
    if (t1 < T)                            // the next chunk, in flight
      vpu_stage(bs[(c + 1) & 1], b3, T, t1,
                T - t1 < VPU_CHUNK ? (int)(T - t1) : VPU_CHUNK);
    for (int s = 0; s < n; ++s) {
      uint32_t lo[3], hi[3];
      fm_columns_vpu(a, bs[c & 1][s], k, lo, hi);
      a = fm_tail(lo, hi, k);
    }
    // the next chunk landed (own copies), and every warp is done with
    // this one before the chunk after overwrites it
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
  }
  if (live) out[k * Q + q] = (int32_t)a;
}

// a (20, Q) int32 in and out; b3 (3, 20, T) int32
BP_EXPORT int bp_fmul13_chain(const int32_t* a, const int32_t* b3, int32_t* out,
                              int64_t Q, int64_t T, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((Q + VPU_WARPS - 1) / VPU_WARPS);
  fmul13_chain_kernel<<<blocks, 32 * VPU_WARPS, 0, stream>>>(a, b3, out, Q, T);
  return (int)cudaGetLastError();
}

// -- K16 -----------------------------------------------------------------------------

#ifndef MMA_BLOCK_LANES
#define MMA_BLOCK_LANES 8    // lanes a block
#endif
#ifndef MMA_STAGES
#define MMA_STAGES 4         // steps of matrices in flight
#endif
#ifndef MMA_XWARPS
#define MMA_XWARPS 15        // warps that run the products in the lane
#endif                       // warps' place (0: the lane warps run them)
#define MMA_GROUPS ((MMA_BLOCK_LANES + MMA_LANES - 1) / MMA_LANES)
#define MMA_LW ((MMA_BLOCK_LANES + 2) / 3)      // lane warps, 3 lanes each
#define MMA_MW (MMA_LW + MMA_XWARPS)            // lane and product warps
#define MMA_PW (MMA_XWARPS ? MMA_XWARPS : MMA_LW)   // warps with pairs
#define MMA_THREADS (32 * (MMA_MW + 1))        // and the copying warp
#define MMA_PMAX ((MMA_PAIRS * MMA_GROUPS + MMA_PW - 1) / MMA_PW)
#define STAGE_BYTES (3 * MSTEP_BYTES)          // a step's three matrices
#define STAGE_PITCH (STAGE_BYTES + 32)         // and a zero row

struct MmaSmem {
  uint8_t ring[MMA_STAGES][STAGE_PITCH];        // 16-byte aligned pieces
  uint32_t cs[MMA_GROUPS * MMA_LANES * 3 * CS_PITCH];  // a step's sums
  uint8_t sp[MMA_GROUPS * MMA_LANES * SP_PITCH];        // the lanes' split
  uint64_t full[MMA_STAGES];                    // a stage's copies landed
};

static_assert(STAGE_PITCH % 16 == 0 && MSTEP_BYTES % 16 == 0,
              "bulk copies move multiples of 16 bytes to 16-byte aligned "
              "places");
// a stage is refilled after the first barrier of the step that read it,
// and the next step's fragments are waited for after that barrier
static_assert(MMA_STAGES >= 2, "the ring needs two stages or more");

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// step `step`'s three matrices (m3 (3, T, 156, 40)) into stage s
__device__ __forceinline__ void mma_issue(MmaSmem& sm, int s,
                                          const int8_t* __restrict__ m3,
                                          int64_t T, int64_t step) {
  const uint32_t bar = smem_addr(&sm.full[s]);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(STAGE_BYTES)
               : "memory");
#pragma unroll
  for (int j = 0; j < 3; ++j)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(sm.ring[s] + j * MSTEP_BYTES)),
        "l"(m3 + ((int64_t)j * T + step) * MSTEP_BYTES), "r"(MSTEP_BYTES),
        "r"(bar)
        : "memory");
}

// FMUL13_PHASES (benches/fmul13_chain.py --phases builds it apart, never
// the port) records clock64 at K16's phase boundaries of the first
// PHASE_STEPS steps: lane warp 0 (0 loop top, 2 after the first barrier,
// 3 next fragments loaded, 4 split stored), the first warp with pairs (1
// products stored) and the copying warp (5 after the first barrier, 6
// refill issued), block 0
#ifdef FMUL13_PHASES
#define PHASE_STEPS 64
__device__ long long fm_phases[7][PHASE_STEPS];
#define FM_MARK(i, tid)                                            \
  if (blockIdx.x == 0 && threadIdx.x == (tid) && t < PHASE_STEPS) \
    fm_phases[i][t] = clock64();
BP_EXPORT int bp_fmul13_phases(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, fm_phases, sizeof(fm_phases));
}
#else
#define FM_MARK(i, tid)
#endif

__global__ void __launch_bounds__(MMA_THREADS)
fmul13_chain_mma_kernel(const int32_t* __restrict__ a_in,
                        const int8_t* __restrict__ m3,
                        int32_t* __restrict__ out, int64_t Q, int64_t T) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  MmaSmem& sm = *reinterpret_cast<MmaSmem*>(smem_raw);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool copier = w == MMA_MW, tails = w < MMA_LW;
  const int pairs = MMA_PAIRS * MMA_GROUPS;
  // the tail's layout: lane slot s of lane warp w is block lane 3w + s,
  // its thread u (< 10) limbs 2u, 2u + 1
  const int s = lane / 10, u = lane - 10 * s, L = 3 * w + s;
  const bool mine = tails && s < 3 && L < MMA_BLOCK_LANES;
  const int Lr = mine ? L : 0;            // the others compute lane 0's
  const int64_t q = (int64_t)blockIdx.x * MMA_BLOCK_LANES + L;

  if (copier && lane == 0) {
    for (int k = 0; k < MMA_STAGES; ++k) mbar_init(&sm.full[k]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int e = threadIdx.x; e < (int)sizeof(sm.sp) / 4; e += MMA_THREADS)
    reinterpret_cast<uint32_t*>(sm.sp)[e] = 0u;
  if (threadIdx.x < 8 * MMA_STAGES)        // the stages' zero rows
    reinterpret_cast<uint32_t*>(sm.ring[threadIdx.x / 8] +
                                STAGE_BYTES)[threadIdx.x % 8] = 0u;
  FmPlan<MMA_PMAX> pl;
  // a warp's place among those with pairs (none: past the last pair)
  const int pw = MMA_XWARPS ? (tails ? pairs : w - MMA_LW) : w;
  fm_plan(pw, MMA_PW, pairs, MSTEP_BYTES, lane, pl);
  __syncthreads();
  uint32_t a0 = 0, a1 = 0;
  if (mine && q < Q) {
    a0 = (uint32_t)a_in[2 * u * Q + q];
    a1 = (uint32_t)a_in[(2 * u + 1) * Q + q];
  }
  if (mine) fm_put_split2(sm.sp, L, u, a0, a1);
  if (copier && lane == 0)
    for (int k = 0; k < MMA_STAGES && k < T; ++k) mma_issue(sm, k, m3, T, k);
  __syncthreads();
  FmFrags<MMA_PMAX> f;
  const bool products = !copier && pl.n > 0;
  if (products) {
    mbar_wait(&sm.full[0], 0);
    fm_load_frags(sm.ring[0], pl, f);
  }
  for (int64_t t = 0; t < T; ++t) {
    FM_MARK(0, 0)
    if (products) {
      fm_mma_phase<MMA_PMAX, MMA_GROUPS>(f, pl, sm.sp, sm.cs, lane);
      FM_MARK(1, 32 * (MMA_XWARPS ? MMA_LW : 0))
    }
    __syncthreads();                       // every warp's column sums
    if (copier) {
      FM_MARK(5, 32 * MMA_MW)
      // step t's stage was read before the barrier: refill it with step
      // t + MMA_STAGES (generic reads, then the async proxy's writes);
      // the lane warps' second barrier does not wait for this
      if (lane == 0 && t + MMA_STAGES < T) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mma_issue(sm, (int)(t % MMA_STAGES), m3, T, t + MMA_STAGES);
      }
      FM_MARK(6, 32 * MMA_MW)
    } else {
      FM_MARK(2, 0)
      if (products && t + 1 < T) {         // the next step's A fragments
        const int k = (int)((t + 1) % MMA_STAGES);
        mbar_wait(&sm.full[k], (uint32_t)((t + 1) / MMA_STAGES) & 1u);
        fm_load_frags(sm.ring[k], pl, f);
      }
      FM_MARK(3, 0)
      if (tails) {
        fm_tail2(sm.cs, Lr, s, u, a0, a1);
        if (mine) fm_put_split2(sm.sp, L, u, a0, a1);
      }
      FM_MARK(4, 0)
      // the lanes' new split, among the warps that run products
      asm volatile("bar.sync 1, %0;" ::"n"(32 * MMA_MW) : "memory");
    }
  }
  if (mine && q < Q) {
    out[2 * u * Q + q] = (int32_t)a0;
    out[(2 * u + 1) * Q + q] = (int32_t)a1;
  }
}

static int mma_smem(size_t* smem) {
  *smem = sizeof(MmaSmem);
  return (int)cudaFuncSetAttribute(fmul13_chain_mma_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*smem);
}

// a (20, Q) int32 in and out; m3 (3, T, 156, 40) int8, 16-byte aligned
BP_EXPORT int bp_fmul13_chain_mma(const int32_t* a, const int8_t* m3,
                                  int32_t* out, int64_t Q, int64_t T,
                                  cudaStream_t stream) {
  if ((uintptr_t)m3 % 16) return (int)cudaErrorMisalignedAddress;
  size_t smem;
  const int err = mma_smem(&smem);
  if (err) return err;
  const unsigned blocks =
      (unsigned)((Q + MMA_BLOCK_LANES - 1) / MMA_BLOCK_LANES);
  fmul13_chain_mma_kernel<<<blocks, MMA_THREADS, smem, stream>>>(a, m3, out, Q,
                                                                 T);
  return (int)cudaGetLastError();
}

// the design's shape and the residency the current device gives it:
// out = {K15 blocks an SM, its threads, K16 blocks an SM, its threads, K16
// dynamic shared memory bytes, MMA_STAGES, K16 lanes a block}
BP_EXPORT int bp_fmul13_residency(int* out) {
  size_t smem;
  int err = mma_smem(&smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, fmul13_chain_kernel, 32 * VPU_WARPS, 0);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2, fmul13_chain_mma_kernel, MMA_THREADS, smem);
  out[1] = 32 * VPU_WARPS;
  out[3] = MMA_THREADS;
  out[4] = (int)smem;
  out[5] = MMA_STAGES;
  out[6] = MMA_BLOCK_LANES;
  return err;
}
