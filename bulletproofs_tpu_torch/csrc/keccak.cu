// Kernel K13: Keccak-f[1600] over P independent 200-byte sponge states, the
// permutation under the batch prover's device transcripts
// (ops/transcript_device.py), with the transcripts' pending pad (their
// constant bytes and the permutation's padding, one (200,) row for all)
// XORed in first, so a permutation is one launch.
//
// No Pallas counterpart: the JAX package computes it in XLA,
// ops/keccak_device.py:68 f1600_words (24 rounds under a fori_loop on
// (50, P) uint32 words), after an XOR of the pad.
//
// Layout: the state is (200, P) uint8, byte b of transcript p at b * P + p.
// A block takes KECCAK_STATES = 32 neighbouring states and five warps:
// warp x keeps column x of the 32 states (lane s of the warp one state)
// and runs the round step of csrc/keccak.cuh, whose two phases a round
// exchange pi's lanes and the column parities through shared memory, one
// word a lane, between barriers.  At 4,096 states that is 128 blocks, one
// on each of 128 SMs, where one thread a state put 128 warps on 32 SMs
// and ran the 24 rounds of ~300 instructions in one thread.  A round costs
// ~520 cycles: two of the five warps share one of the SM's four
// schedulers, and the barriers and shared loads wait in line; a form with
// one barrier a round (two buffers alternating, each thread reading all
// 25 of pi's lanes to make its neighbours' parities) issued 191
// instructions a round and took ~800.
// The block's 6,400 state bytes come in and go out as 16-byte rows of 16
// states (one access a row half, coalesced), through shared memory; a P
// that is not a multiple of 16 (or a tensor not on a 16-byte boundary),
// or the block past P's last full half, takes bytes one at a time.
//
// Bound: bytes, 400 per transcript (the state read once and written once)
// against 24 x ~150 64-bit logic operations and no multiplications: 0.0005
// ms at 4,096 states, far below a launch.  What is left is latency: per
// round two shared-memory round trips (store, barrier, load) and ~7
// dependent instructions, x 24 (benches/field_kernels.keccak_latency_floor_ms),
// and the shared-memory traffic, ~920 bytes a state a round.
#include "common.cuh"
#include "keccak.cuh"

#define KECCAK_STATES 32
#define KECCAK_THREADS (5 * KECCAK_STATES)

__global__ void __launch_bounds__(KECCAK_THREADS)
keccak_f1600_kernel(const uint8_t* __restrict__ st,
                    const uint8_t* __restrict__ pad,
                    uint8_t* __restrict__ out, int64_t P) {
  __shared__ __align__(16) uint8_t raw[200 * KECCAK_STATES];
  __shared__ uint64_t lanes[25 * KECCAK_STATES];
  __shared__ uint64_t par[5 * KECCAK_STATES];
  const int s = threadIdx.x % KECCAK_STATES;
  const int64_t p0 = (int64_t)blockIdx.x * KECCAK_STATES;
  const int n = (int)min((int64_t)KECCAK_STATES, P - p0);
  const bool wide =
      P % 16 == 0 && ((uintptr_t)st | (uintptr_t)out) % 16 == 0;
  // row b, half h: states p0 + 16 h .. + 15, byte b, at raw[b * 32 + 16 h]
  for (int v = threadIdx.x; v < 400; v += KECCAK_THREADS) {
    const int b = v >> 1, h = 16 * (v & 1);
    const uint8_t* src = st + b * P + p0 + h;
    union { uint4 w; uint8_t c[16]; } q;
    if (wide && h + 16 <= n) {
      q.w = *(const uint4*)src;
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) q.c[k] = h + k < n ? src[k] : 0;
    }
    if (pad != nullptr) {
      const uint32_t r = 0x01010101u * pad[b];
      q.w.x ^= r;
      q.w.y ^= r;
      q.w.z ^= r;
      q.w.w ^= r;
    }
    *(uint4*)(raw + b * KECCAK_STATES + h) = q.w;
  }
  __syncthreads();
  KeccakColumn c = keccak_column(threadIdx.x / KECCAK_STATES, raw + s,
                                 KECCAK_STATES);
  keccak_parity(c, par + s, KECCAK_STATES);
  __syncthreads();
#pragma unroll 1
  for (int rnd = 0; rnd < 24; ++rnd) {
    keccak_theta_rho_pi(c, par + s, lanes + s, KECCAK_STATES);
    __syncthreads();
    keccak_chi_iota(c, lanes + s, KECCAK_STATES, KECCAK_RC[rnd], par + s);
    __syncthreads();
  }
  keccak_store(c, raw + s, KECCAK_STATES);
  __syncthreads();
  for (int v = threadIdx.x; v < 400; v += KECCAK_THREADS) {
    const int b = v >> 1, h = 16 * (v & 1);
    uint8_t* dst = out + b * P + p0 + h;
    union { uint4 w; uint8_t c[16]; } q;
    q.w = *(const uint4*)(raw + b * KECCAK_STATES + h);
    if (wide && h + 16 <= n) {
      *(uint4*)dst = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (h + k < n) dst[k] = q.c[k];
    }
  }
}

// st, out (200, P) uint8; pad (200,) uint8 or null
BP_EXPORT int bp_keccak_f1600(const uint8_t* st, const uint8_t* pad,
                              uint8_t* out, int64_t P, cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)((P + KECCAK_STATES - 1) / KECCAK_STATES);
  keccak_f1600_kernel<<<blocks, KECCAK_THREADS, 0, stream>>>(st, pad, out, P);
  return (int)cudaGetLastError();
}
