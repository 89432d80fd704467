// Keccak-f[1600] spread over five threads a state, one a column: the round
// step of kernel K13 (csrc/keccak.cu).
//
// Lane i = x + 5y of a state is the little-endian 64-bit word at bytes
// 8i .. 8i + 7.  Thread x of a state keeps column x, lanes (x, y) for
// y = 0..4, in registers.  A round is two phases, each ended by a barrier
// of the block, and each phase reads only what the other one wrote:
//   A. theta, rho, pi: D = C[x - 1] ^ rotl(C[x + 1], 1) from the column
//      parities in shared memory; each lane, XORed with D and rotated by
//      rho, goes to its pi slot y + 5 ((2x + 3y) % 5) in shared memory
//      (the round's one transpose);
//   B. chi, iota: column x of the new state from pi's rows, lanes x,
//      x + 1 and x + 2 of each; thread 0 XORs the round constant into lane
//      (0, 0); each thread writes its new column's parity for the next
//      round's phase A.
// A phase's shared accesses are one 8-byte word a lane; a state's slots
// and parities sit `stride` words apart, so the states of a warp (one a
// thread) read and write neighbouring words.
#pragma once
#include <stdint.h>

__device__ __constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

// rho's rotation of lane x + 5y
__device__ __constant__ int KECCAK_ROT[25] = {
    0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43,
    25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};

// one thread's column: its lanes, their rotations and pi slots
struct KeccakColumn {
  int x;
  uint64_t a[5];
  int rot[5];
  int dst[5];
};

// rotate left by r in [0, 64): on the card two funnel shifts of the
// 32-bit halves, swapped first for r >= 32; r = 0 gives v
__device__ __forceinline__ uint64_t keccak_rotl(uint64_t v, int r) {
#ifdef __CUDA_ARCH__
  const uint32_t lo = (uint32_t)v, hi = (uint32_t)(v >> 32);
  const uint32_t h = r & 32 ? lo : hi, l = r & 32 ? hi : lo;
  const int s = r & 31;
  return ((uint64_t)__funnelshift_l(l, h, s) << 32) | __funnelshift_l(h, l, s);
#else
  return (v << r) | (v >> ((64 - r) & 63));
#endif
}

// column x's constants; lanes from `raw`, byte b of the state at
// raw[b * stride]
__device__ __forceinline__ KeccakColumn keccak_column(int x, const uint8_t* raw,
                                                      int stride) {
  KeccakColumn c;
  c.x = x;
#pragma unroll
  for (int y = 0; y < 5; ++y) {
    const int i = x + 5 * y;
    c.rot[y] = KECCAK_ROT[i];
    c.dst[y] = y + 5 * ((2 * x + 3 * y) % 5);
    uint64_t v = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v |= (uint64_t)raw[(8 * i + k) * stride] << (8 * k);
    c.a[y] = v;
  }
  return c;
}

// the column's lanes back to bytes, byte b at raw[b * stride]
__device__ __forceinline__ void keccak_store(const KeccakColumn& c,
                                             uint8_t* raw, int stride) {
#pragma unroll
  for (int y = 0; y < 5; ++y)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      raw[(8 * (c.x + 5 * y) + k) * stride] = (uint8_t)(c.a[y] >> (8 * k));
}

// the column's parity into par[x * stride]
__device__ __forceinline__ void keccak_parity(const KeccakColumn& c,
                                              uint64_t* par, int stride) {
  par[c.x * stride] = c.a[0] ^ c.a[1] ^ c.a[2] ^ c.a[3] ^ c.a[4];
}

// phase A: theta from the parities par[x * stride], rho, then each lane
// to its pi slot lanes[slot * stride]
__device__ __forceinline__ void keccak_theta_rho_pi(const KeccakColumn& c,
                                                    const uint64_t* par,
                                                    uint64_t* lanes,
                                                    int stride) {
  const uint64_t d = par[((c.x + 4) % 5) * stride] ^
                     keccak_rotl(par[((c.x + 1) % 5) * stride], 1);
#pragma unroll
  for (int y = 0; y < 5; ++y)
    lanes[c.dst[y] * stride] = keccak_rotl(c.a[y] ^ d, c.rot[y]);
}

// phase B: chi on pi's rows into the column, iota (round constant rc) on
// lane (0, 0), the new parity into par[x * stride]
__device__ __forceinline__ void keccak_chi_iota(KeccakColumn& c,
                                                const uint64_t* lanes,
                                                int stride, uint64_t rc,
                                                uint64_t* par) {
  const int x1 = (c.x + 1) % 5, x2 = (c.x + 2) % 5;
#pragma unroll
  for (int y = 0; y < 5; ++y)
    c.a[y] = lanes[(c.x + 5 * y) * stride] ^
             (~lanes[(x1 + 5 * y) * stride] & lanes[(x2 + 5 * y) * stride]);
  if (c.x == 0) c.a[0] ^= rc;
  keccak_parity(c, par, stride);
}
