"""Kernel K2's schedule (`ops/verify.emit_schedule`, run by `csrc/emit.cuh`
as `csrc/emit.cu` launches it) against its plain version
`ops/verify.emit_plain`, on the CPU: digits and tile partials equal,
tolerance 0.

The header is compiled with the host g++ behind a small C harness that
defines the CUDA qualifiers away and runs the kernel's pieces one tile of
8 proofs at a time: each proof's load, schedule steps and digits in
order, every lane of a step before the next step (the card's
__syncwarp), then each index i's terms summed over the tile's proofs.
The lanes of a step run in ascending and in descending order over proof
state filled with garbage first, so a lane that read what another lane
writes in the same step, or what no step writes, would disagree with the
plain version.  The shapes cover tiles
cut short, nm below a warp, and nm = 128 and 1024, where the tables split
in lo and hi rows.  The schedule's own rules are checked at every shape
the wrapper takes.
"""

import ctypes
import random
import subprocess

import numpy as np
import pytest
import torch

from bulletproofs_tpu_torch.core.scalar import L as ELL
from bulletproofs_tpu_torch.ops import verify as V
from bulletproofs_tpu_torch.ops._cuda import CSRC

HARNESS = r"""
#include <stdint.h>
#include <string.h>
#include <vector>
#define __device__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#include "emit.cuh"

extern "C" {
// blk (P, lg + 8, 32), pow2 (log2 n, 9), sched (verify.emit_schedule) ->
// digits (64, P n_dyn), partial (ceil(P / 8), 2, nm, 9); tiles of 8
// proofs, lanes 31..0 when `descending`
void h_emit(const uint8_t* blk, const uint32_t* pow2, const int32_t* sched,
            int8_t* digits, int32_t* partial, int64_t P, int n, int m,
            int descending) {
  const EmitShape s = emit_shape(P, n, m, sched);
  std::vector<sc> slots(8 * (size_t)s.slots);
  for (int64_t p0 = 0; p0 < P; p0 += 8) {
    memset(slots.data(), 0xa5, sizeof(sc) * slots.size());
    const int count = P - p0 < 8 ? (int)(P - p0) : 8;
    for (int q = 0; q < count; ++q) {
      const int64_t p = p0 + q;
      sc* v = slots.data() + q * s.slots;
      for (int l = 0; l < 32; ++l)
        emit_load(v, s, descending ? 31 - l : l, blk + p * (s.lg + 8) * 32,
                  pow2);
      for (int step = 0; step < s.steps; ++step)
        for (int l = 0; l < 32; ++l)
          emit_step(v, s, step, descending ? 31 - l : l);
      for (int l = 0; l < 32; ++l)
        emit_out(v, s, descending ? 31 - l : l, p, digits);
    }
    for (int i = 0; i < s.nm; ++i) {
      sc g = sc_zero(), h = sc_zero();
      for (int q = 0; q < count; ++q) {
        sc gq, hq;
        emit_terms(slots.data() + q * s.slots, s, i, gq, hq);
        g = sc_add(g, gq);
        h = sc_add(h, hq);
      }
      const sc out[2] = {g, h};
      for (int gh = 0; gh < 2; ++gh)
        for (int k = 0; k < 9; ++k)
          partial[((p0 / 8 * 2 + gh) * s.nm + i) * 9 + k] = out[gh].v[k];
    }
  }
}
}
"""

# (n, m, P): a whole tile and one cut short; nm = 16 below a warp with a
# short tile; nm = 128 (one hi bit) and the fused route's m = 16, nm = 1024
SHAPES = [(8, 1, 9), (8, 2, 13), (64, 1, 16), (16, 8, 3), (64, 16, 5)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("emit_header")
    src, so = d / "harness.cpp", d / "libemit.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=120)
    return ctypes.CDLL(str(so))


def _blocks(n, m, P, seed, low=0, high=ELL):
    _, nblk, _ = V.shape(n, m)
    r = random.Random(seed)
    return torch.as_tensor(np.frombuffer(
        b"".join(r.randrange(low, high).to_bytes(32, "little")
                 for _ in range(P * nblk)), np.uint8
    ).reshape(P, nblk, 32).copy())


def _emit(lib, n, m, blk, descending):
    P = blk.shape[0]
    _, _, n_dyn = V.shape(n, m)
    digits = np.zeros((64, P * n_dyn), np.int8)
    partial = np.zeros((-(-P // V.EMIT_TILE), 2, n * m, 9), np.int32)
    pow2 = np.ascontiguousarray(
        V._emit_inputs(n, m, "cpu")[0].numpy().astype(np.uint32))
    sched = np.ascontiguousarray(V.emit_schedule(n, m).numpy())
    blk_np = np.ascontiguousarray(blk.numpy())
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.h_emit(ptr(blk_np), ptr(pow2), ptr(sched), ptr(digits), ptr(partial),
               ctypes.c_int64(P), ctypes.c_int(n), ctypes.c_int(m),
               ctypes.c_int(int(descending)))
    return torch.as_tensor(digits), torch.as_tensor(partial)


@pytest.mark.parametrize("n,m,P", SHAPES)
def test_emit_schedule_matches_plain(lib, n, m, P):
    blk = _blocks(n, m, P, 300 + n * m + P)
    want = V.emit_plain(n, m, blk)
    for descending in (False, True):
        got = _emit(lib, n, m, blk, descending)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


def test_emit_schedule_on_scalars_not_below_l(lib):
    """Challenge scalars in [l, 2^256), where the ones the schedule takes
    as read (rc, -a, -b, r) are not canonical: still the plain version's
    bytes."""
    blk = _blocks(8, 2, 9, 77, ELL, 1 << 256)
    want = V.emit_plain(8, 2, blk)
    got = _emit(lib, 8, 2, blk, False)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
def test_schedule_writes_each_slot_once_before_reading_it(m):
    """Every n with nm a power of two up to 1024: each slot is written by
    one op, a step never reads a slot written in that step or later, a
    step has at most 32 ops, a scalar as read (rc, -a, -b, r: below 2^256,
    maybe not below l) is only ever a first operand, and every slot that
    the digits and the terms read is written or an input."""
    for lg in range(m.bit_length() - 1, 11):
        n = (1 << lg) // m
        sched = V.emit_schedule(n, m).tolist()
        steps, slots, lo, hi, rz, lo_bits = sched[:6]
        _, _, n_dyn = V.shape(n, m)
        dyn, words = sched[6: 6 + n_dyn], sched[6 + n_dyn:]
        assert len(words) == 32 * steps and slots < 1024
        # inputs: the block, one, r as read, 2^(2^b) R for b < log2 n
        written = {k: -1 for k in range(lg + 10 + n.bit_length() - 1)}
        for k in range(steps):
            step = [w for w in words[32 * k: 32 * k + 32] if w >= 0]
            for w in step:
                dst, a, b = w & 1023, (w >> 10) & 1023, (w >> 20) & 1023
                assert written.get(a, k) < k and written.get(b, k) < k
                assert b not in (lg + 2, lg + 5, lg + 6, lg + 9)
            for w in step:
                assert (w & 1023) not in written
                written[w & 1023] = k
        hi_bits = lg - lo_bits
        need = set(dyn) | {rz} \
            | {lo + (tb << lo_bits) + i for tb in range(3)
               for i in range(1 << lo_bits)} \
            | {hi + (tb << hi_bits) + i for tb in range(3)
               for i in range(1, 1 << hi_bits)}
        assert need <= set(written)


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
def test_bound_and_floor_count_the_schedule(m):
    """K2's operations bound and latency floor (benches/field_kernels) at
    every n with nm a power of two up to 1024 against the schedule: its
    products, the load's lg + 5 conversions in, less the tree of prod(u)'s
    lg - 2 extra and with whole tables in place of the split ones, are the
    bound's count; its dependency depth, with the load's conversion and a
    hi row's product above nm = 64, is the floor's chain."""
    from bulletproofs_tpu_torch.benches import field_kernels as FK
    for lg in range(max(m.bit_length() - 1, 2), 11):
        n = (1 << lg) // m
        ops, header, _ = V._emit_products(n, m)
        lo_bits = header[-1]
        hi_bits = lg - lo_bits
        split = 3 * ((1 << lo_bits) - 1) + 3 * ((1 << hi_bits) - 1 - hi_bits)
        assert FK.emit_mont_muls(n, m, 1) == \
            len(ops) + (lg + 5) - (lg - 2) - split + 3 * (n * m - 1)
        depth, inputs = {}, lg + 10 + n.bit_length() - 1
        for dst, a, b in ops:
            depth[dst] = 1 + max(depth.get(a, 0) if a >= inputs else 0,
                                 depth.get(b, 0) if b >= inputs else 0)
        want = 1 + max(depth.values()) + (lg > lo_bits)
        assert FK.emit_latency_floor_ms(n, m, 1.0) == \
            FK.LEAST_LATENCY * want * FK.SC_MUL_CHAIN / 1e3
