"""The binning of kernels K3 and K11 (`csrc/msm_bin.cuh`, launched by
`csrc/msm.cu` bin_kernel and rank_kernel) against its plain versions
`ops/msm.bin_points_plain` and `bin_plain`, on the CPU.

The header is compiled with the host g++ behind a C harness that runs it
as the card does: `row_words` once per point (a Niels prefix, then Z = 1
extended points made Y+X, Y-X, 2dT; or extended points copied), `bin_step`
once per (window, lane step, lane), and `rank_lanes` as one bucket's block, a std::thread per CUDA thread, a
std::barrier for `__syncthreads` and one per warp for `__syncwarp`,
`__match_any_sync` and `__shfl_down_sync` (a value a lane, exchanged
between two arrivals), an atomic add for the shared histogram.  The
masks and signs must be bin_plain's bit for bit, and the ranks its
permutation: lanes by count, largest first, ties by the lower lane, at
every lane count 32-512 and nm = 1-12 words a lane (counts up to 32 nm,
ties everywhere, the extremes 0 and 32 nm).
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from bulletproofs_tpu_torch.benches import accumulate_z as AZ
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops._cuda import CSRC

HARNESS = r"""
#include <stdint.h>
#include <barrier>
#include <thread>
#include <vector>
#define __device__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#define MSM_BIN_HOST

struct Warp {
  std::barrier<> bar{32};
  int x[32];
};
thread_local Warp* tw;
thread_local int tlane;

static uint32_t br_match(int v) {
  tw->x[tlane] = v;
  tw->bar.arrive_and_wait();
  uint32_t m = 0;
  for (int i = 0; i < 32; ++i) m |= (uint32_t)(tw->x[i] == v) << i;
  tw->bar.arrive_and_wait();
  return m;
}
static int br_shfl_down(int v, int d) {
  tw->x[tlane] = v;
  tw->bar.arrive_and_wait();
  const int r = tlane + d < 32 ? tw->x[tlane + d] : v;
  tw->bar.arrive_and_wait();
  return r;
}
static void br_syncwarp() { tw->bar.arrive_and_wait(); }
static void br_add(int* p, int v) { __atomic_fetch_add(p, v, __ATOMIC_RELAXED); }
static int br_popc(uint32_t x) { return __builtin_popcount(x); }
#include "msm_bin.cuh"

extern "C" {
// pre (3, 10, n0), pts (4, 10, n - n0) (w = 30) or pts (4, 10, n) (w =
// 40) -> rows (n, w)
void h_rows(const int32_t* pre, int64_t n0, const int32_t* pts, int64_t n,
            int w, int32_t* rows) {
  for (int64_t k = 0; k < n; ++k)
    if (w == 30)
      row_words<30>(pre, n0, pts, n, k, rows + 30 * k);
    else
      row_words<40>(pre, n0, pts, n, k, rows + 40 * k);
}
// digits (64, n) -> mask (64, 8, nm, lanes), sign (64, nm, lanes)
void h_bin(const int8_t* digits, int64_t n, int lanes, int nm,
           uint32_t* mask, uint32_t* sign) {
  for (int w = 0; w < 64; ++w)
    for (int m = 0; m < nm; ++m)
      for (int j = 0; j < lanes; ++j) {
        uint32_t bits[BIN_BUCKETS], neg;
        const int64_t k0 = j + (int64_t)32 * m * lanes;
        bin_step(digits + (int64_t)w * n + k0, n - k0, lanes, bits, neg);
        for (int b = 0; b < BIN_BUCKETS; ++b)
          mask[(((int64_t)w * BIN_BUCKETS + b) * nm + m) * lanes + j] = bits[b];
        sign[((int64_t)w * nm + m) * lanes + j] = neg;
      }
}
// one bucket's block: counts (lanes) -> perm (lanes)
void h_rank(const int32_t* counts, int lanes, int nm, int32_t* perm) {
  const int bins = 32 * nm + 1;
  std::vector<int> cs(lanes), hist(bins);
  std::barrier<> all(lanes);
  std::vector<Warp> warps(lanes / 32);
  std::vector<std::thread> th;
  for (int j = 0; j < lanes; ++j)
    th.emplace_back([&, j] {
      tw = &warps[j / 32];
      tlane = j % 32;
      rank_lanes(j, lanes, counts[j], bins, cs.data(), hist.data(), perm,
                 [&] { all.arrive_and_wait(); });
    });
  for (auto& t : th) t.join();
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("msm_bin_header")
    src, so = d / "harness.cpp", d / "libmsmbin.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++20", "-pthread", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(so))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("n0,n1,form", [
    (130, 170, "niels"), (0, 300, "niels"), (300, 0, "niels"),
    (0, 300, "extended")])
def test_row_words_match_the_plain_rows(lib, n0, n1, form):
    """A Niels prefix then Z = 1 points made Y+X, Y-X, 2dT (the rows of
    bin_niels' plain version: curve.to_niels' limbs), and extended points
    of any Z copied (bin_points_plain's), limb for limb."""
    if form == "niels":
        pre = (AZ.make_niels(n0, 31, "cpu") if n0
               else torch.zeros((3, 10, 0), dtype=torch.int32))
        pts = (M.normalize_z(AZ.make_points(n1, 32, "cpu")) if n1
               else torch.zeros((4, 10, 0), dtype=torch.int32))
        want = M.bin_niels(pre, pts, torch.zeros((64, n0 + n1),
                                                 dtype=torch.int8))[0][:, :30]
        w = 30
    else:
        pre, pts = torch.zeros((3, 10, 0), dtype=torch.int32), \
            AZ.make_points(n1, 33, "cpu")
        want = M.bin_points_plain(pts, torch.zeros((64, n1),
                                                   dtype=torch.int8))[0]
        w = 40
    n = n0 + n1
    rows = np.zeros((n, w), np.int32)
    lib.h_rows(_ptr(np.ascontiguousarray(pre.numpy())), ctypes.c_int64(n0),
               _ptr(np.ascontiguousarray(pts.numpy())), ctypes.c_int64(n),
               ctypes.c_int(w), _ptr(rows))
    assert np.array_equal(rows, want.numpy())


def _rank(lib, counts: np.ndarray, nm: int) -> np.ndarray:
    counts = np.ascontiguousarray(counts, np.int32)
    perm = np.full(counts.shape[0], -1, np.int32)
    lib.h_rank(_ptr(counts), ctypes.c_int(counts.shape[0]), ctypes.c_int(nm),
               _ptr(perm))
    return perm


@pytest.mark.parametrize("case", [c for c, _ in AZ.CASES] + ["34946 points"])
def test_masks_and_ranks_match_bin_plain(lib, case):
    """bin_step's words and rank_lanes' order over the lanes' popcounts
    against bin_plain, on the edge cases and a verify sub-batch's 34,946
    points (512 lanes, 3 words a lane; 16 of its 512 buckets ranked)."""
    if case == "34946 points":
        dig = AZ.make_digits(34946, 21, "cpu")
    else:
        dig = AZ.edge_inputs(case, 7, "cpu")[1]
    n = dig.shape[-1]
    lanes = M.pick_lanes(n)
    mask, sign, cnt, perm = M.bin_plain(dig, lanes)
    nm = mask.shape[2]
    got_mask = np.zeros((64, 8, nm, lanes), np.uint32)
    got_sign = np.zeros((64, nm, lanes), np.uint32)
    lib.h_bin(_ptr(np.ascontiguousarray(dig.numpy())), ctypes.c_int64(n),
              ctypes.c_int(lanes), ctypes.c_int(nm), _ptr(got_mask),
              _ptr(got_sign))
    assert np.array_equal(got_mask.view(np.int32), mask.numpy())
    assert np.array_equal(got_sign.view(np.int32), sign.numpy())
    counts = np.vectorize(lambda x: bin(int(x)).count("1"))(got_mask).sum(2)
    assert np.array_equal(counts, cnt.numpy())
    groups = range(512) if lanes < 512 else range(0, 512, 32)
    for g in groups:
        w, b = divmod(g, 8)
        assert np.array_equal(_rank(lib, counts[w, b], nm),
                              perm[w, b].numpy()), (w, b)


def test_masks_take_any_int8_digit_as_bin_plain(lib):
    """Every int8 value as a digit (a magnitude above 8 is in no bucket,
    its sign still set), at 2,000 points over 64 windows."""
    g = np.random.default_rng(22)
    dig = torch.as_tensor(g.integers(-128, 128, (64, 2000)).astype(np.int8))
    dig[0, :256] = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    lanes = M.pick_lanes(2000)
    mask, sign, _, _ = M.bin_plain(dig, lanes)
    nm = mask.shape[2]
    got_mask = np.zeros((64, 8, nm, lanes), np.uint32)
    got_sign = np.zeros((64, nm, lanes), np.uint32)
    lib.h_bin(_ptr(np.ascontiguousarray(dig.numpy())), ctypes.c_int64(2000),
              ctypes.c_int(lanes), ctypes.c_int(nm), _ptr(got_mask),
              _ptr(got_sign))
    assert np.array_equal(got_mask.view(np.int32), mask.numpy())
    assert np.array_equal(got_sign.view(np.int32), sign.numpy())


@pytest.mark.parametrize("lanes", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("nm", [1, 2, 3, 4, 7, 12])
def test_rank_orders_lanes_as_bin_plain(lib, lanes, nm):
    """Counts in [0, 32 nm] with many ties, the extremes included: the
    rank is a stable sort by count, largest first (bin_plain's perm)."""
    rng = np.random.default_rng(lanes * 100 + nm)
    top = 32 * nm
    for counts in (rng.integers(0, top + 1, lanes),
                   rng.integers(0, 4, lanes) * (top // 3),
                   np.full(lanes, top), np.zeros(lanes, int),
                   np.where(np.arange(lanes) % 3 == 0, top, 0)):
        want = np.argsort(-counts, kind="stable")
        assert np.array_equal(_rank(lib, counts, nm), want)
        c = torch.as_tensor(counts, dtype=torch.int32)
        assert np.array_equal(
            want, torch.sort(-c, stable=True).indices.numpy())
