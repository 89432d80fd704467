// Kernel K2: the batch-verification scalar emit.
//
// Replaces the JAX package's Pallas kernel ops/verify_pallas.py:190
// _emit_kernel (called from emit_digits, :310).  From each proof's compact
// challenge block [u_0..u_{lg-1}, r, x, rc, z, y^-1, -a, -b, prod(u)^-1]
// (32-byte canonical scalars written by the host replay) it computes
//   * the 4 + 2 lg + m dynamic MSM coefficients
//     [r, rx, rcx, rcx^2, r u_k^2, r u_k^-2, r c z^2 z^j], written as signed
//     4-bit digits in [-7, 8], column p * n_dyn + slot (the proof-major
//     order of the dynamic points, so the points need no reordering);
//   * the static coefficients g_i = -rz - a r s_i and
//     h_i = rz + y^-i (r z^2 z^(i/n) 2^(i%n) - b r s_{nm-1-i}), summed over
//     the proofs of each tile of EMIT_TILE proofs into partial[tile][g|h][i]
//     (canonical).  The tiles are summed mod l by a second pass in PyTorch
//     (ops/verify.tree_sum): blocks run in no order, so unlike the TPU's
//     sequential grid nothing accumulates across blocks.
//
// Bound: operations (Montgomery multiplications: 171 64-bit multiply-adds
// each, ~14 per (proof, i) pair and ~70 per proof, against 448 bytes of
// input per proof).  Design: one block per tile; phase 1 runs one thread per
// proof through the serial per-proof chain (prefix/suffix products for the
// u^-1, the y^-2^j squarings) into shared memory and writes the digits;
// phase 2 runs one thread per generator index i, looping over the tile's
// proofs: s_i and s_{nm-1-i} are products over the bits of i and y^-i a
// product of the y^-2^j, so no thread waits on another.  The TPU kernel's
// one-hot lane doubling and static-slice Barrett were Mosaic workarounds and
// are gone; everything stays in the Montgomery domain with canonical limbs.
#include "common.cuh"
#include "sc25519.cuh"

#define LG_MAX 10
#define M_MAX 16

struct ProofState {
  sc u_sq[LG_MAX], u_inv_sq[LG_MAX], ypow2[LG_MAX], rzz_zj[M_MAX];
  sc t0, t0r, rz, neg_rz, neg_a, neg_b;
};

__global__ void __launch_bounds__(64)
emit_kernel(const uint8_t* __restrict__ blk, const uint32_t* __restrict__ pow2,
            int8_t* __restrict__ digits, int32_t* __restrict__ partial,
            int64_t P, int n, int m, int tile_p) {
  extern __shared__ ProofState st[];
  const int nm = n * m;
  const int lg = 31 - __clz(nm);
  const int nblk = lg + 8;
  const int n_dyn = 4 + 2 * lg + m;
  const int64_t p0 = (int64_t)blockIdx.x * tile_p;
  const int64_t rem = P - p0;
  const int count = (int)(rem < tile_p ? rem : tile_p);

  // phase 1: per-proof chain (one thread per proof)
  for (int q = threadIdx.x; q < count; q += blockDim.x) {
    const int64_t p = p0 + q;
    const uint8_t* b = blk + p * nblk * 32;
    sc u[LG_MAX];
    for (int k = 0; k < lg; ++k) u[k] = sc_to_mont(sc_from_bytes(b + 32 * k));
    const sc r = sc_to_mont(sc_from_bytes(b + 32 * (lg + 0)));
    const sc x = sc_to_mont(sc_from_bytes(b + 32 * (lg + 1)));
    const sc rc = sc_to_mont(sc_from_bytes(b + 32 * (lg + 2)));
    const sc z = sc_to_mont(sc_from_bytes(b + 32 * (lg + 3)));
    const sc y_inv = sc_to_mont(sc_from_bytes(b + 32 * (lg + 4)));
    const sc neg_a = sc_to_mont(sc_from_bytes(b + 32 * (lg + 5)));
    const sc neg_b = sc_to_mont(sc_from_bytes(b + 32 * (lg + 6)));
    const sc allinv = sc_to_mont(sc_from_bytes(b + 32 * (lg + 7)));
    const sc one = sc_const(SC_ONE_M);

    ProofState& S = st[q];
    sc pres[LG_MAX], sufs[LG_MAX + 1];
    pres[0] = one;
    for (int k = 1; k < lg; ++k) pres[k] = sc_mont_mul(pres[k - 1], u[k - 1]);
    sufs[lg] = one;
    for (int k = lg - 1; k >= 0; --k) sufs[k] = sc_mont_mul(sufs[k + 1], u[k]);
    sc cur = y_inv;
    for (int k = 0; k < lg; ++k) {
      S.u_sq[k] = sc_mont_mul(u[k], u[k]);
      const sc uinv = sc_mont_mul(sc_mont_mul(allinv, pres[k]), sufs[k + 1]);
      S.u_inv_sq[k] = sc_mont_mul(uinv, uinv);
      S.ypow2[k] = cur;
      cur = sc_mont_mul(cur, cur);
    }
    const sc prod = sufs[0];
    S.t0 = sc_mont_mul(r, allinv);
    S.t0r = sc_mont_mul(r, prod);
    const sc rx = sc_mont_mul(r, x);
    const sc rcx = sc_mont_mul(rc, x);
    const sc rcxx = sc_mont_mul(rcx, x);
    S.rz = sc_mont_mul(r, z);
    S.neg_rz = sc_neg(S.rz);
    const sc rzz = sc_mont_mul(S.rz, z);
    const sc rczz = sc_mont_mul(sc_mont_mul(rc, z), z);
    S.neg_a = neg_a;
    S.neg_b = neg_b;

    // dynamic coefficients -> signed digits, column p * n_dyn + slot
    int8_t d[64];
    const int64_t cols = P * n_dyn;
    int8_t* out = digits + p * n_dyn;
    auto emit = [&](int slot, const sc& v) {
      sc_signed_digits(sc_from_mont(v), d);
      for (int w = 0; w < 64; ++w) out[w * cols + slot] = d[w];
    };
    emit(0, r);
    emit(1, rx);
    emit(2, rcx);
    emit(3, rcxx);
    for (int k = 0; k < lg; ++k) {
      emit(4 + k, sc_mont_mul(r, S.u_sq[k]));
      emit(4 + lg + k, sc_mont_mul(r, S.u_inv_sq[k]));
    }
    sc zp = one;
    for (int j = 0; j < m; ++j) {
      emit(4 + 2 * lg + j, sc_mont_mul(rczz, zp));
      S.rzz_zj[j] = sc_mont_mul(rzz, zp);
      zp = sc_mont_mul(zp, z);
    }
  }
  __syncthreads();

  // phase 2: one thread per generator index i, summed over the tile
  for (int i = threadIdx.x; i < nm; i += blockDim.x) {
    sc pw;
#pragma unroll
    for (int k = 0; k < 9; ++k) pw.v[k] = pow2[(i % n) * 9 + k];
    sc acc_g = sc_zero(), acc_h = sc_zero();
    for (int q = 0; q < count; ++q) {
      const ProofState& S = st[q];
      sc t = S.t0, tr = S.t0r, yp = sc_const(SC_ONE_M);
      for (int j = 0; j < lg; ++j) {
        if ((i >> j) & 1) {
          t = sc_mont_mul(t, S.u_sq[lg - 1 - j]);
          tr = sc_mont_mul(tr, S.u_inv_sq[lg - 1 - j]);
          yp = sc_mont_mul(yp, S.ypow2[j]);
        }
      }
      const sc g = sc_add(S.neg_rz, sc_mont_mul(S.neg_a, t));
      const sc term1 = sc_mont_mul(S.rzz_zj[i / n], pw);
      const sc term2 = sc_mont_mul(S.neg_b, tr);
      const sc h = sc_add(S.rz, sc_mont_mul(yp, sc_add(term1, term2)));
      acc_g = sc_add(acc_g, g);
      acc_h = sc_add(acc_h, h);
    }
    const sc g_out = sc_from_mont(acc_g), h_out = sc_from_mont(acc_h);
    int32_t* dst = partial + (int64_t)blockIdx.x * 2 * nm * 9;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      dst[i * 9 + k] = (int32_t)g_out.v[k];
      dst[(nm + i) * 9 + k] = (int32_t)h_out.v[k];
    }
  }
}

// blk (P, lg + 8, 32) uint8, pow2 (n, 9) uint32 (2^i R mod l) ->
// digits (64, P * n_dyn) int8, partial (ceil(P / tile_p), 2, nm, 9) int32
BP_EXPORT int bp_emit(const uint8_t* blk, const uint32_t* pow2, int8_t* digits,
                      int32_t* partial, int64_t P, int64_t n, int64_t m,
                      int64_t tile_p, cudaStream_t stream) {
  const int64_t tiles = (P + tile_p - 1) / tile_p;
  const size_t smem = sizeof(ProofState) * (size_t)tile_p;
  emit_kernel<<<(unsigned)tiles, 64, smem, stream>>>(
      blk, pow2, digits, partial, P, (int)n, (int)m, (int)tile_p);
  return (int)cudaGetLastError();
}
