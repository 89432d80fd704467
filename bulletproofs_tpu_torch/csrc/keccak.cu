// Kernel K13: Keccak-f[1600] over P independent 200-byte sponge states, the
// permutation under the batch prover's device transcripts
// (ops/transcript_device.py).
//
// No Pallas counterpart: the JAX package computes it in XLA,
// ops/keccak_device.py:68 f1600_words (24 rounds under a fori_loop on
// (50, P) uint32 words).  In plain PyTorch one permutation is hundreds of
// tiny launches, about 10 of them per half-batch per IPP round, so the
// port gives it a kernel of its own.
//
// Layout: the state is (200, P) uint8, byte b of transcript p at b * P + p,
// so the threads of a warp (neighbouring p) read and write neighbouring
// bytes of each row.  One thread per transcript keeps the 25 lanes as
// uint64_t in registers for all 24 rounds; the rho-pi step is written out
// lane by lane, so every index and rotation is a constant and nothing is
// spilled to local memory.
//
// Bound: bytes, 400 per transcript (the state read once and written once)
// against about 24 x 150 64-bit logic operations and no multiplications.
// At P = 4096 the card is far from either limit: the time is the latency
// of one thread's chain of 24 dependent rounds.
#include "common.cuh"

#define KECCAK_THREADS 128

__device__ __constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return r == 0 ? x : (x << r) | (x >> (64 - r));
}

__global__ void __launch_bounds__(KECCAK_THREADS)
keccak_f1600_kernel(const uint8_t* __restrict__ st, uint8_t* __restrict__ out,
                    int64_t P) {
  const int64_t p = (int64_t)blockIdx.x * KECCAK_THREADS + threadIdx.x;
  if (p >= P) return;
  uint64_t a[25], b[25], c[5];
#pragma unroll
  for (int i = 0; i < 25; ++i) {                 // little-endian lanes
    uint64_t v = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v |= (uint64_t)st[(int64_t)(8 * i + k) * P + p] << (8 * k);
    a[i] = v;
  }
  for (int rnd = 0; rnd < 24; ++rnd) {
    // theta
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
    }
    // rho and pi: b[y + 5 ((2x + 3y) % 5)] = rotl(a[x + 5y], r[x][y])
    b[0] = a[0];
    b[16] = rotl64(a[5], 36);
    b[7] = rotl64(a[10], 3);
    b[23] = rotl64(a[15], 41);
    b[14] = rotl64(a[20], 18);
    b[10] = rotl64(a[1], 1);
    b[1] = rotl64(a[6], 44);
    b[17] = rotl64(a[11], 10);
    b[8] = rotl64(a[16], 45);
    b[24] = rotl64(a[21], 2);
    b[20] = rotl64(a[2], 62);
    b[11] = rotl64(a[7], 6);
    b[2] = rotl64(a[12], 43);
    b[18] = rotl64(a[17], 15);
    b[9] = rotl64(a[22], 61);
    b[5] = rotl64(a[3], 28);
    b[21] = rotl64(a[8], 55);
    b[12] = rotl64(a[13], 25);
    b[3] = rotl64(a[18], 21);
    b[19] = rotl64(a[23], 56);
    b[15] = rotl64(a[4], 27);
    b[6] = rotl64(a[9], 20);
    b[22] = rotl64(a[14], 39);
    b[13] = rotl64(a[19], 8);
    b[4] = rotl64(a[24], 14);
    // chi
#pragma unroll
    for (int y = 0; y < 25; y += 5)
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[x + y] = b[x + y] ^ (~b[(x + 1) % 5 + y] & b[(x + 2) % 5 + y]);
    // iota
    a[0] ^= KECCAK_RC[rnd];
  }
#pragma unroll
  for (int i = 0; i < 25; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      out[(int64_t)(8 * i + k) * P + p] = (uint8_t)(a[i] >> (8 * k));
}

// st, out (200, P) uint8
BP_EXPORT int bp_keccak_f1600(const uint8_t* st, uint8_t* out, int64_t P,
                              cudaStream_t stream) {
  const unsigned blocks = (unsigned)((P + KECCAK_THREADS - 1) / KECCAK_THREADS);
  keccak_f1600_kernel<<<blocks, KECCAK_THREADS, 0, stream>>>(st, out, P);
  return (int)cudaGetLastError();
}
