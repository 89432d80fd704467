// Kernel K2's arithmetic, one proof at a time: the pieces that one warp
// runs for its proof (csrc/emit.cu launches them), and the (g_i, h_i) terms
// of one (proof, i).  Plain C++ over csrc/sc25519.cuh, with no CUDA
// intrinsic, so tests/test_torch_emit_header.py compiles it with the host
// g++ and runs it lane by lane, in both lane orders, against
// ops/verify.emit_plain.
//
// Every value is a canonical scalar, and a Montgomery product a b R^-1 of
// canonical values is exact, so any order of the same products gives the
// plain version's bytes.  A proof's values live in `slots` of shared
// memory: its challenge block (slots 0 .. lg + 7; rc, -a and -b as read,
// the others in the Montgomery domain), Montgomery one (lg + 8), r as read
// (lg + 9) and 2^(2^b) R (lg + 10 + b, b < log2 n), loaded a lane a
// scalar, then every product a schedule names.  A product of a scalar as
// read and one in the Montgomery domain is out of that domain, so what
// leaves the kernel is made plain and nothing is converted out.  The
// schedule (ops/verify.emit_schedule, made once per shape on the host)
// lists steps of up to 32 products (dst = a b R^-1), one a lane, none
// reading what its own step writes: the per-proof chains, the dynamic
// coefficients and three tables, plain,
//   row_1,i = -a t0 prod_{bit j of i} u_{lg-1-j}^2,
//   row_2,i = -b t0r prod_{bit j of i} u_{lg-1-j}^-2 y^-2^j,
//   row_3,i = rzz prod_{bit j of i} y^-2^j (2^(2^j) or z^(2^(j - log2 n))),
// so that g_i = -rz + row_1,i and h_i = rz + row_2,i + row_3,i, each split
// at bit lo_bits (i = hi 2^lo_bits + lo, 2^lo_bits = min(nm, 64)) into
// plain lo rows from the seed and hi rows from one (in the Montgomery
// domain), built by doubling, one product a row.  Every lane of a step
// runs the same product on other slots, so a warp never serialises
// diverging chains, and the steps are as few as the longest chain allows.
// emit_terms then makes (g_i, h_i) of one (proof, i) by three additions,
// and three products more where i >= 64.
#pragma once
#include "sc25519.cuh"

#define EMIT_LG_MAX 10
#define EMIT_M_MAX 16

// the schedule (int32): a header, the dynamic coefficients' slots (n_dyn),
// then steps x 32 ops, each dst | a << 10 | b << 20 or -1 (none)
enum {
  EMIT_STEPS,        // steps
  EMIT_SLOTS,        // slots a proof
  EMIT_LO,           // first lo row of table tb: EMIT_LO + tb 2^lo_bits
  EMIT_HI,           // hi row h of table tb: EMIT_HI + tb 2^hi_bits + h
  EMIT_RZ,           // rz, plain
  EMIT_LO_BITS,      // lo_bits
  EMIT_HEADER        // header ints
};

struct EmitShape {
  int n, m, nm, lg, lg_n, n_dyn, lo_bits, hi_bits;
  int steps, slots, lo, hi, rz;
  int64_t P;
  const int32_t* dyn;    // the dynamic coefficients' slots
  const int32_t* ops;    // steps x 32
};

__device__ __forceinline__ EmitShape emit_shape(int64_t P, int n, int m,
                                                const int32_t* sched) {
  EmitShape s;
  s.n = n;
  s.m = m;
  s.nm = n * m;
  s.lg = 0;
  while ((1 << s.lg) < s.nm) ++s.lg;
  s.lg_n = 0;
  while ((1 << s.lg_n) < n) ++s.lg_n;
  s.n_dyn = 4 + 2 * s.lg + m;
  s.lo_bits = sched[EMIT_LO_BITS];
  s.hi_bits = s.lg - s.lo_bits;
  s.steps = sched[EMIT_STEPS];
  s.slots = sched[EMIT_SLOTS];
  s.lo = sched[EMIT_LO];
  s.hi = sched[EMIT_HI];
  s.rz = sched[EMIT_RZ];
  s.P = P;
  s.dyn = sched + EMIT_HEADER;
  s.ops = s.dyn + s.n_dyn;
  return s;
}

// canonical x -> its 64 signed base-16 digits, digit w stored at
// out[w * stride] (sc_signed_digits, written straight out)
__device__ __forceinline__ void emit_digits(const sc& x, int8_t* out,
                                            int64_t stride) {
  int64_t e[10];
#pragma unroll
  for (int k = 0; k < 9; ++k) e[k] = (int64_t)x.v[k] + SC_SEVENS[k];
  e[9] = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t c = e[k] >> SC_BITS;
    e[k] &= SC_MASK;
    e[k + 1] += c;
  }
#pragma unroll
  for (int w = 0; w < 64; ++w) {
    const int limb = (4 * w) / SC_BITS, off = (4 * w) % SC_BITS;
    int64_t v = e[limb] >> off;
    if (off > SC_BITS - 4) v |= e[limb + 1] << (SC_BITS - off);
    out[w * stride] = (int8_t)((v & 15) - 7);
  }
}

// lane's part of loading proof p's challenge block blk (lg + 8 scalars of
// 32 bytes): rc, -a and -b as read, the others into the Montgomery domain;
// r as read again, pow2's 2^(2^b) R (b < log2 n) and Montgomery one
__device__ __forceinline__ void emit_load(sc* v, const EmitShape& s, int lane,
                                          const uint8_t* blk,
                                          const uint32_t* pow2) {
  if (lane < s.lg + 8) {
    const sc x = sc_from_bytes(blk + 32 * lane);
    const sc xm = sc_to_mont(x);
    const bool as_read =
        lane == s.lg + 2 || lane == s.lg + 5 || lane == s.lg + 6;
    v[lane] = as_read ? x : xm;
  } else if (lane == s.lg + 8) {
    v[s.lg + 9] = sc_from_bytes(blk + 32 * s.lg);
  } else if (lane < s.lg + 9 + s.lg_n) {
    v[lane + 1] = sc_const(pow2 + 9 * (lane - s.lg - 9));
  }
  if (lane == 31) v[s.lg + 8] = sc_const(SC_ONE_M);
}

// lane's product of schedule step `step`
__device__ __forceinline__ void emit_step(sc* v, const EmitShape& s, int step,
                                          int lane) {
  const int32_t op = s.ops[step * 32 + lane];
  if (op >= 0)
    v[op & 1023] = sc_mont_mul(v[(op >> 10) & 1023], v[(op >> 20) & 1023]);
}

// lane's dynamic coefficients of proof p (plain), a lane a slot: signed
// digits at column p * n_dyn + slot (a warp's stores are consecutive bytes
// of each digit row)
__device__ __forceinline__ void emit_out(const sc* v, const EmitShape& s,
                                         int lane, int64_t p,
                                         int8_t* digits) {
  for (int slot = lane; slot < s.n_dyn; slot += 32)
    emit_digits(v[s.dyn[slot]], digits + p * s.n_dyn + slot,
                s.P * s.n_dyn);
}

// (g_i, h_i) of one proof from its tables (after every step), plain
__device__ __forceinline__ void emit_terms(const sc* v, const EmitShape& s,
                                           int i, sc& g, sc& h) {
  const int lo = i & ((1 << s.lo_bits) - 1), hi = i >> s.lo_bits;
  const int lo_rows = 1 << s.lo_bits, hi_rows = 1 << s.hi_bits;
  sc t = v[s.lo + lo], tr = v[s.lo + lo_rows + lo],
     tz = v[s.lo + 2 * lo_rows + lo];
  if (hi) {
    t = sc_mont_mul(t, v[s.hi + hi]);
    tr = sc_mont_mul(tr, v[s.hi + hi_rows + hi]);
    tz = sc_mont_mul(tz, v[s.hi + 2 * hi_rows + hi]);
  }
  const sc& rz = v[s.rz];
  g = sc_add(sc_neg(rz), t);
  h = sc_add(rz, sc_add(tr, tz));
}
