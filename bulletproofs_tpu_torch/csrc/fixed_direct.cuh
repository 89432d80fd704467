// K6's direct form, public rows only: one lane's chunk of a fixed-base MSM
// as a sum of signed multiples read from a table, into one accumulator that
// lives in registers.  fixed_msm.cu's fixed_direct_kernel runs it a thread
// per (lane, chunk); tests/test_torch_fixed_direct_header.py compiles this
// header with the host g++ and holds it to ops/fixed_msm.py's plain version
// limb for limb.
//
// The table (ops/fixed_msm.make_multiples) holds, for every row s of a
// Niels stream (the point 2^(4w) B_j at s = j * 64 + w), its multiples
// k P_s for k = 1..8 as canonical Niels points (Y+X, Y-X, 2dT), each padded
// to 32 words (128 bytes): mult[(s * 8 + k - 1) * 32 + word].  A digit d in
// [-7, 8] of row s adds +-|d| P_s: one mixed addition, the multiple |d|
// read as seven 16-byte loads and one 8-byte load of one aligned line,
// negated by a select for d < 0 (Y+X <-> Y-X, 2dT -> -2dT).  A zero digit
// adds nothing.  The row of digit row s is sel[s] (the IPP round's row map
// into the full table), or s where sel is null.
//
// The bucket method of the one-hot form exists to need no table of
// multiples; on this card table memory is cheap (the full table of an m = 16
// prover is 2,050 bases x 64 windows x 8 multiples x 128 B = 134 MB) and
// shared memory is what the buckets ran out of, so this form keeps nothing
// in shared memory and its residency is set by registers.  The rows are
// public (the IPP rounds' L / R coefficients; the JAX package's host route
// sends them to the vartime rist_msm_rows), so a load whose address
// depends on the digit is allowed here and nowhere else (fixed_msm.cu's
// one-hot form).
#pragma once
#include "fe25519.cuh"

#define DIRECT_MULTIPLES 8       // multiples 1..8 of each table row
#define MULT_WORDS 32            // one multiple: 30 words of Niels point, 2 pad

// the 30 words of multiple |d| of table row `row` (multiple 1 for d = 0,
// read and never added)
__device__ __forceinline__ void direct_load(const int32_t* __restrict__ mult,
                                            int64_t row, int d,
                                            int32_t w[30]) {
  const int k = d < 0 ? -d : (d == 0 ? 1 : d);
  const int32_t* at = mult + (row * DIRECT_MULTIPLES + k - 1) * MULT_WORDS;
  const int4* v = reinterpret_cast<const int4*>(at);
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const int4 x = __ldg(v + i);
    w[4 * i] = x.x;
    w[4 * i + 1] = x.y;
    w[4 * i + 2] = x.z;
    w[4 * i + 3] = x.w;
  }
  const int2 t = __ldg(reinterpret_cast<const int2*>(at + 28));
  w[28] = t.x;
  w[29] = t.y;
}

// acc + (sign of d) * the loaded multiple
__device__ __forceinline__ ge direct_add(const ge& acc, int d,
                                         const int32_t w[30]) {
  const bool neg = d < 0;
  fe ypx, ymx, t2d;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    ypx.v[k] = w[k];
    ymx.v[k] = w[10 + k];
    t2d.v[k] = w[20 + k];
  }
  ge_niels pt;
  pt.ypx = fe_select(neg, ymx, ypx);
  pt.ymx = fe_select(neg, ypx, ymx);
  pt.t2d = fe_select(neg, fe_neg(t2d), t2d);
  return ge_madd(acc, pt);
}

// sum over digit rows s in [s0, s1) of digit[s][q] * P_sel[s], from the
// identity in row order.  Each row's digit and multiple are loaded where
// they are added: a form that loaded row s + 1's before row s's addition
// kept two points live, took 255 registers with 24 B of spills and ran
// 6.33 ms at the m = 16 IPP L shape on an H100 where this one, 216
// registers and no spills, runs 5.98 (two warps on each scheduler hide
// the load)
__device__ __forceinline__ ge direct_chunk(const int32_t* __restrict__ mult,
                                           const int64_t* __restrict__ sel,
                                           const int8_t* __restrict__ digits,
                                           int64_t Q, int64_t q, int64_t s0,
                                           int64_t s1) {
  ge acc = ge_identity();
  for (int64_t s = s0; s < s1; ++s) {
    const int d = digits[s * Q + q];
    int32_t w[30];
    direct_load(mult, sel ? sel[s] : s, d, w);
    if (d != 0) acc = direct_add(acc, d, w);
  }
  return acc;
}
