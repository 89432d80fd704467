"""The chain steps of kernels K15 and K16 (`csrc/fmul13.cuh`, launched by
`csrc/fmul13.cu`) against their plain versions `ops/fmul13.chain_vpu_plain`
/ `chain_mxu_plain`, on the CPU.

The header is compiled with the host g++ behind a C harness that runs a
block as the card does: a std::thread per CUDA thread, a std::barrier per
warp for `__shfl_sync` (a value a lane, exchanged between two arrivals) and
one per block for `__syncthreads`, vectors for the shared memory, and
`mma.sync.m16n8k32` as the integer product of PTX's fragment map (which
lane, register and byte holds each element of A, B and D), written here
apart from the header's tiles.  K15 runs a warp a lane (thread k = limb
k); K16 runs a block's lane warps (three lanes a warp, ten threads a
lane, two limbs a thread), each taking its (operand, column group) pairs'
mma, then its lanes' tails, at 4, 8 and 16 lanes a block.  Exact, limb for
limb, with limbs near 2^14 on some lanes (where the int8 split wraps).
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from bulletproofs_tpu_torch.ops import fmul13 as F
from bulletproofs_tpu_torch.ops._cuda import CSRC

HARNESS = r"""
#include <stdint.h>
#include <string.h>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>
#define __device__
#define __forceinline__ inline
#define FMUL13_HOST

struct Warp {
  std::barrier<> bar{32};
  int32_t x[32];
  uint32_t fa[32][4], fb[32][2];
};
thread_local Warp* tw;
thread_local int tlane;

static int32_t fm_shfl(int32_t v, int src) {
  tw->x[tlane] = v;
  tw->bar.arrive_and_wait();
  const int32_t r = tw->x[src & 31];
  tw->bar.arrive_and_wait();
  return r;
}
static int32_t fm_shfl_up1(int32_t v) {
  tw->x[tlane] = v;
  tw->bar.arrive_and_wait();
  const int32_t r = tlane ? tw->x[tlane - 1] : v;
  tw->bar.arrive_and_wait();
  return r;
}
static void fm_ld4(const int32_t* p, uint32_t v[4]) {
  for (int i = 0; i < 4; ++i) v[i] = (uint32_t)p[i];
}
static uint32_t fm_ld32(const uint8_t* p) {
  uint32_t x;
  memcpy(&x, p, 4);
  return x;
}
// PTX's m16n8k32 .s8 fragments: A (16 x 32) element (row, k) is byte k % 4
// of register (row >= 8) + 2 (k >= 16) of lane 4 (row % 8) + (k % 16) / 4;
// B (32 x 8) element (k, n) byte k % 4 of register (k >= 16) of lane
// 4 n + (k % 16) / 4; D (16 x 8, int32) element (row, n) register
// 2 (row >= 8) + n % 2 of lane 4 (row % 8) + n / 2
static void fm_mma(int32_t d[4], const uint32_t a[4], const uint32_t b[2]) {
  memcpy(tw->fa[tlane], a, 16);
  memcpy(tw->fb[tlane], b, 8);
  tw->bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const int row = (tlane >> 2) + 8 * (i >> 1), n = 2 * (tlane & 3) + (i & 1);
    uint32_t acc = (uint32_t)d[i];
    for (int k = 0; k < 32; ++k) {
      const uint32_t aw = tw->fa[4 * (row % 8) + (k % 16) / 4]
                                [(row >= 8) + 2 * (k >= 16)];
      const uint32_t bw = tw->fb[4 * n + (k % 16) / 4][k >= 16];
      acc += (uint32_t)((int32_t)(int8_t)(aw >> (8 * (k % 4))) *
                        (int32_t)(int8_t)(bw >> (8 * (k % 4))));
    }
    d[i] = (int32_t)acc;
  }
  tw->bar.arrive_and_wait();
}
#include "fmul13.cuh"

template <class F>
static void run_block(int warps, F f) {
  std::unique_ptr<Warp[]> W(new Warp[warps]);
  std::vector<std::thread> th;
  for (int w = 0; w < warps; ++w)
    for (int k = 0; k < 32; ++k)
      th.emplace_back([&, w, k] {
        tw = &W[w];
        tlane = k;
        f(w, k);
      });
  for (auto& x : th) x.join();
}

extern "C" {
int h_tile_row(int G, int h, int r) { return fm_tile_row(G, h, r); }
int h_col(int G, int g) { return fm_col(G, g); }

// cols (n, 3, 39) column sums -> (n, 20) limbs of carry(sum fold_tail)
void h_tail(const int32_t* cols, int32_t* out, int n) {
  for (int q = 0; q < n; ++q)
    run_block(1, [&](int, int k) {
      uint32_t lo[3], hi[3];
      for (int j = 0; j < 3; ++j) {
        const int32_t* c = cols + (q * 3 + j) * FN;
        lo[j] = k < FL ? (uint32_t)c[k] : 0u;
        hi[j] = k < FL - 1 ? (uint32_t)c[FL + k] : 0u;
      }
      const uint32_t v = fm_tail(lo, hi, k);
      if (k < FL) out[q * FL + k] = (int32_t)v;
    });
}

// K15: a (20, Q), b3 (3, 20, T) -> out (20, Q); `warps` lanes a block
void h_chain_vpu(const int32_t* a_in, const int32_t* b3, int32_t* out, int Q,
                 int T, int warps) {
  for (int blk = 0; blk * warps < Q; ++blk)
    run_block(warps, [&](int w, int k) {
      const int64_t q = (int64_t)blk * warps + w;
      const bool live = q < Q && k < FL;
      uint32_t a = live ? (uint32_t)a_in[k * Q + q] : 0u;
      alignas(16) int32_t bs[3 * FL];
      for (int t = 0; t < T; ++t) {
        for (int r = 0; r < 3 * FL; ++r) bs[r] = b3[r * T + t];
        uint32_t lo[3], hi[3];
        fm_columns_vpu(a, bs, k, lo, hi);
        a = fm_tail(lo, hi, k);
      }
      if (live) out[k * Q + q] = (int32_t)a;
    });
}

// K16: a (20, Q), m3 (3, T, 156, 40) -> out (20, Q); `lanes` % 100 lanes
// a block on ceil(lanes / 3) lane warps, three lanes a warp on threads
// 10 s + u, and lanes / 100 warps more that run the products in the lane
// warps' place; the kernel's two phases between block barriers
void h_chain_mxu(const int32_t* a_in, const int8_t* m3, int32_t* out, int Q,
                 int T, int lanes) {
  const int extra = lanes / 100;
  lanes %= 100;
  const int groups = (lanes + MMA_LANES - 1) / MMA_LANES;
  const int lw = (lanes + 2) / 3, warps = lw + extra;
  const int pairs = MMA_PAIRS * groups;
  // each step's three matrices as a stage of the ring: side by side, then
  // a zero row
  const int pitch = 3 * MSTEP_BYTES + 32;
  std::vector<uint8_t> stages((size_t)T * pitch, 0);
  for (int t = 0; t < T; ++t)
    for (int j = 0; j < 3; ++j)
      memcpy(stages.data() + (size_t)t * pitch + j * MSTEP_BYTES,
             m3 + ((int64_t)j * T + t) * MSTEP_BYTES, MSTEP_BYTES);
  for (int blk = 0; blk * lanes < Q; ++blk) {
    std::barrier<> all(32 * warps);
    std::vector<uint32_t> cs(groups * MMA_LANES * 3 * CS_PITCH, 0xdeadbeefu);
    alignas(16) static uint8_t sp[4 * MMA_LANES * SP_PITCH];
    memset(sp, 0, sizeof(sp));
    run_block(warps, [&](int w, int lane) {
      const int s = lane / 10, u = lane - 10 * s, L = 3 * w + s;
      const bool mine = w < lw && s < 3 && L < lanes;
      const int64_t q = (int64_t)blk * lanes + L;
      uint32_t a0 = 0, a1 = 0;
      if (mine && q < Q) {
        a0 = (uint32_t)a_in[2 * u * Q + q];
        a1 = (uint32_t)a_in[(2 * u + 1) * Q + q];
      }
      if (mine) fm_put_split2(sp, L, u, a0, a1);
      all.arrive_and_wait();
      FmPlan<8> pl;
      const int pw = extra ? (w < lw ? pairs : w - lw) : w;
      fm_plan(pw, extra ? extra : lw, pairs, MSTEP_BYTES, lane, pl);
      FmFrags<8> f;
      fm_load_frags(stages.data(), pl, f);
      for (int t = 0; t < T; ++t) {
        if (groups == 1)
          fm_mma_phase<8, 1>(f, pl, sp, cs.data(), lane);
        else
          fm_mma_phase<8, 2>(f, pl, sp, cs.data(), lane);
        all.arrive_and_wait();
        if (t + 1 < T)
          fm_load_frags(stages.data() + (size_t)(t + 1) * pitch, pl, f);
        if (w < lw) {
          fm_tail2(cs.data(), mine ? L : 0, s, u, a0, a1);
          if (mine) fm_put_split2(sp, L, u, a0, a1);
        }
        all.arrive_and_wait();
      }
      if (mine && q < Q) {
        out[2 * u * Q + q] = (int32_t)a0;
        out[(2 * u + 1) * Q + q] = (int32_t)a1;
      }
    });
  }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("fmul13_header")
    src, so = d / "harness.cpp", d / "libfmul13.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++20", "-pthread", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=180)
    return ctypes.CDLL(str(so))


def _ptr(x):
    return x.ctypes.data_as(ctypes.c_void_p)


def _chain_inputs(q, t, seed):
    """Seeded lanes (canonical limbs, and on every third lane limbs in
    [2^14 - 64, 2^14 + 64): the int8 split's wrap) and 3 t operands."""
    rng = np.random.RandomState(seed)
    vals = [int.from_bytes(rng.bytes(31), "little") % F.P25519
            for _ in range(q + 3 * t)]
    a = F.ints_to_limbs(vals[:q])
    a[:, ::3] = rng.randint((1 << 14) - 64, (1 << 14) + 64, (F.L, len(a[0, ::3])))
    bl = np.stack([F.to_limbs(v) for v in vals[q:]])           # (3 t, 20)
    b3 = np.ascontiguousarray(bl.reshape(3, t, F.L).transpose(0, 2, 1)
                              .astype(np.int32))
    m3 = np.ascontiguousarray(F.band_matrices(bl).reshape(3, t, F.MROWS,
                                                          F.MCOLS))
    return np.ascontiguousarray(a), b3, m3


def _run(fn, a, x, t, shape_arg):
    out = np.full_like(a, -1)
    fn(_ptr(a), _ptr(x), _ptr(out), ctypes.c_int(a.shape[1]), ctypes.c_int(t),
       ctypes.c_int(shape_arg))
    return out


def test_tail_matches_fold_tail_and_carry_on_any_int32(lib):
    """The spread tail on column sums over the whole int32 range (the
    arithmetic shifts of negative values, the wrap of the fold's products),
    against the plain fold_tail of each product, summed, carried."""
    rng = np.random.RandomState(151)
    n = 6
    cols = rng.randint(-(1 << 31), 1 << 31, (n, 3, F.NCOL), dtype=np.int64) \
        .astype(np.int32)
    cols[0] = 0
    cols[1] = -1
    cols[2] = (1 << 31) - 1
    got = np.zeros((n, F.L), np.int32)
    lib.h_tail(_ptr(cols), _ptr(got), ctypes.c_int(n))
    c = torch.as_tensor(cols).permute(1, 2, 0)                  # (3, 39, n)
    y = F.fold_tail(c)
    want = F.carry(y[0] + y[1] + y[2])
    assert np.array_equal(got, want.numpy().T)


@pytest.mark.parametrize("q,warps", [(8, 4), (13, 4), (13, 1), (20, 2)])
def test_k15_step_matches_chain_vpu_plain(lib, q, warps):
    a, b3, _ = _chain_inputs(q, 3, 150 + q)
    got = _run(lib.h_chain_vpu, a, b3, 3, warps)
    want = F.chain_vpu_plain(torch.as_tensor(a), torch.as_tensor(b3))
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("q,lanes", [(8, 8), (13, 8), (13, 4), (13, 16),
                                     (13, 1508)])
def test_k16_step_matches_chain_mxu_plain(lib, q, lanes):
    """lanes % 100 lanes a block, lanes // 100 warps that run products
    only."""
    a, b3, m3 = _chain_inputs(q, 3, 160 + q)
    got = _run(lib.h_chain_mxu, a, m3, 3, lanes)
    want = F.chain_mxu_plain(torch.as_tensor(a), torch.as_tensor(m3))
    assert np.array_equal(got, want.numpy())
    # without the wrap (canonical limbs) the two forms agree
    a[:, ::3] = F.ints_to_limbs([5] * a[:, ::3].shape[1])
    assert np.array_equal(_run(lib.h_chain_mxu, a, m3, 3, lanes),
                          _run(lib.h_chain_vpu, a, b3, 3, 4))


def test_tiles_hold_p1_to_p4_of_a_column_in_one_thread(lib):
    """Rows g and g + 8 of tile (G, 0) are P1 and P3, of tile (G, 1) P2 and
    P4, all of column fm_col(G, g) (a zero row past 38); in PTX's D
    fragment both rows of column n of a tile are in lane 4 g + n / 2, so
    each thread holds P1..P4 of its columns and lanes.  The 40 places hold
    every column once."""
    seen, cols = set(), []
    for G in range(5):
        for g in range(8):
            col = lib.h_col(G, g)
            cols.append(col)
            rows = [lib.h_tile_row(G, h, r) for h in (0, 1) for r in (g, g + 8)]
            if col >= F.NCOL:
                assert rows == [-1] * 4
                continue
            # P1, P3 (tile h = 0), P2, P4 (h = 1)
            assert rows == [col, 2 * F.NCOL + col, F.NCOL + col,
                            3 * F.NCOL + col]
            seen.update(rows)
    assert sorted(cols) == list(range(F.NCOL + 1))
    assert seen == set(range(F.MROWS))


def test_a_fragment_loads_hit_distinct_banks(lib):
    """A word a thread: thread (g, t) of tile (G, h) loads word 10 row +
    5h + t of a step's matrix, so in groups 0-3 the 32 words of a load (8
    rows by 4 threads) fall in 32 banks, for every operand and row half;
    group 4's 7 columns mix parities (20 and 19 columns of each: one group
    must), and its 28 words fall in 20 banks."""
    for G in range(5):
        for h in (0, 1):
            for r in (0, 1):
                for j in range(3):
                    banks = set()
                    for g in range(8):
                        row = lib.h_tile_row(G, h, g + 8 * r)
                        if row < 0:
                            continue
                        for t in range(4):
                            word = (j * F.MROWS * F.MCOLS + row * F.MCOLS
                                    + 20 * h + 4 * t) // 4
                            banks.add(word % 32)
                    assert len(banks) == (32 if G < 4 else 20), (G, h, r, j)


def test_skipped_k_tiles_of_band_matrices_are_zero(lib):
    """The tiles read columns 0-19 of P1 / P3 rows and 20-39 of P2 / P4
    rows (thread t of half h: columns 20h + 4t .. + 3, and 20h + 16 .. 19
    at t = 0): every entry they skip is zero in band_matrices, at
    canonical limbs and at 2^13 - 1."""
    for h in (0, 1):
        read = {20 * h + 4 * t + i for t in range(4) for i in range(4)}
        read |= {20 * h + 16 + i for i in range(4)}
        assert sorted(read) == list(range(F.L * h, F.L * (h + 1)))
    rng = np.random.RandomState(152)
    limbs = np.concatenate([rng.randint(0, 1 << 13, (6, F.L)),
                            np.full((1, F.L), (1 << 13) - 1)])
    m = F.band_matrices(limbs).astype(np.int64)
    for G in range(5):
        for h in (0, 1):
            for r in range(16):
                row = lib.h_tile_row(G, h, r)
                if row < 0:
                    continue
                skipped = m[:, row, F.L * (1 - h): F.L * (2 - h)]
                assert not skipped.any(), (G, h, r)
