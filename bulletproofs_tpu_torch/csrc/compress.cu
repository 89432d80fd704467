// Kernel K5: batch ristretto255 compression (RFC 9496 ENCODE).
//
// Replaces the JAX package's Pallas kernel ops/msm_pallas.py:251
// _compress_kernel (called from compress_lanes, :297) together with the XLA
// limb -> byte step of ops/vec_curve.py:252-261, so the card writes the 32
// canonical bytes of each point once.
//
// Bound: operations.  Each point costs one sqrt-ratio exponentiation
// (~265 field multiplications of 100 IMAD.WIDE each) against 160 bytes in
// and 32 bytes out.  Design: one thread per point, every field element in
// registers, no shared memory; N / 128 blocks of 128 threads.  The
// arithmetic is ops/curve.compress_plain step for step, so the bytes match
// it exactly.  The identity (and any point equal to it up to 4-torsion)
// encodes as 32 zero bytes.
#include "common.cuh"
#include "fe25519.cuh"

// exact canonical limbs -> 32 little-endian bytes (ops/limbs.fe_to_bytes)
__device__ __forceinline__ void fe_to_bytes(const fe& c, uint8_t* out) {
  uint64_t acc = 0;
  int bits = 0, k = 0, j = 0;
#pragma unroll
  for (k = 0; k < 10; ++k) {
    acc |= (uint64_t)(uint32_t)c.v[k] << bits;
    bits += 26 - (k & 1);
    while (bits >= 8) {
      out[j++] = (uint8_t)(acc & 255);
      acc >>= 8;
      bits -= 8;
    }
  }
  if (j < 32) out[j] = (uint8_t)(acc & 255);    // the last 7 bits
}

__global__ void __launch_bounds__(128)
compress_kernel(const int32_t* __restrict__ pts, uint8_t* __restrict__ out,
                int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const ge p = ge_load(pts + i, n);
  const fe sqrt_m1 = fe_const(FE_SQRT_M1);

  const fe u1 = fe_mul(fe_add(p.Z, p.Y), fe_sub(p.Z, p.Y));
  const fe u2 = fe_mul(p.X, p.Y);
  fe invsqrt;
  fe_sqrt_ratio_m1(fe_one(), fe_mul(u1, fe_sq(u2)), invsqrt);
  const fe den1 = fe_mul(invsqrt, u1);
  const fe den2 = fe_mul(invsqrt, u2);
  const fe z_inv = fe_mul(fe_mul(den1, den2), p.T);
  const fe ix0 = fe_mul(p.X, sqrt_m1);
  const fe iy0 = fe_mul(p.Y, sqrt_m1);
  const fe enchanted = fe_mul(den1, fe_const(FE_INVSQRT_A_MINUS_D));
  const bool rotate = fe_is_negative(fe_mul(p.T, z_inv)) != 0;
  const fe x = fe_select(rotate, iy0, p.X);
  fe y = fe_select(rotate, ix0, p.Y);
  const fe den_inv = fe_select(rotate, enchanted, den2);
  y = fe_select(fe_is_negative(fe_mul(x, z_inv)) != 0, fe_neg(y), y);
  const fe s = fe_canon(fe_abs(fe_mul(den_inv, fe_sub(p.Z, y))));

  uint8_t b[32];
  fe_to_bytes(s, b);
#pragma unroll
  for (int k = 0; k < 32; ++k) out[32 * i + k] = b[k];
}

// pts (4, 10, n) int32 -> out (n, 32) uint8
BP_EXPORT int bp_compress(const int32_t* pts, uint8_t* out, int64_t n,
                          cudaStream_t stream) {
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  compress_kernel<<<(unsigned)blocks, threads, 0, stream>>>(pts, out, n);
  return (int)cudaGetLastError();
}
