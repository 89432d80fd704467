"""Kernel K4a's schedule (`csrc/reduce.cuh`, launched by `csrc/msm.cu`
`reduce_kernel`) against its plain version `ops/msm.reduce_plain`, on the
CPU.

The header is compiled with the host g++ behind a C harness that runs one
bucket's block as the card does: a std::thread per CUDA thread (two
warps), a std::barrier for `__syncthreads` and one per warp for
`__syncwarp`, arrays for the shared memory.  Run on symbolic nodes (a
lane's index, or the pair of nodes an addition took), it gives the tree
of pairs that the schedule adds, which must be reduce_plain's (lane j +
lane j + h at every level, h half the width) at every lane count the
wrapper takes, 2 to 512.  Run on points, with `ge_add` in registers and
`ge_add_on_four_lanes` for the last levels, its sums must equal
reduce_plain's limb for limb.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops._cuda import CSRC

HARNESS = r"""
#include <stdint.h>
#include <barrier>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#include "reduce.cuh"

struct Block {
  std::barrier<> all{REDUCE_THREADS};
  std::barrier<> warp[2] = {std::barrier<>(32), std::barrier<>(32)};
  int32_t nodes[40 * REDUCE_THREADS];
  int32_t scratch[40 * REDUCE_GROUPS];
  int ids[REDUCE_THREADS];
};

// symbolic nodes: lane j is node j; an addition appends node (a, b)
struct Symbolic {
  using value = int;
  Block* blk;
  std::mutex* mu;
  std::vector<int>* pairs;
  int lanes;
  int load(int j) { return j; }
  int add(int a, int b) {
    std::lock_guard<std::mutex> g(*mu);
    pairs->push_back(a);
    pairs->push_back(b);
    return lanes + (int)pairs->size() / 2 - 1;
  }
  void put(int t, int v) { blk->ids[t] = v; }
  void add_nodes(int dst, int from, int role, bool active, int) {
    if (active && role == 0) blk->ids[dst] = add(blk->ids[dst], blk->ids[from]);
  }
  void sync() { blk->all.arrive_and_wait(); }
};

// points: the kernel's B with host barriers
struct Points {
  using value = ge;
  Block* blk;
  const int32_t* src;  // one bucket's (4, 10, lanes) slab
  int lanes, t;
  ge load(int j) { return ge_load(src + j, lanes); }
  ge add(const ge& a, const ge& b) { return ge_add(a, b); }
  void put(int k, const ge& p) { ge_store(blk->nodes + 40 * k, 1, p); }
  void add_nodes(int dst, int from, int role, bool active, int group) {
    std::barrier<>& w = blk->warp[t / 32];
    ge_add_on_four_lanes(blk->nodes, blk->scratch + 40 * group, dst, from,
                         role, active, [&w] { w.arrive_and_wait(); });
  }
  void sync() { blk->all.arrive_and_wait(); }
};

template <class F>
void run_threads(F f) {
  std::vector<std::thread> th;
  for (int t = 0; t < REDUCE_THREADS; ++t) th.emplace_back(f, t);
  for (auto& x : th) x.join();
}

extern "C" {
// the tree of one bucket of `lanes` lanes: pairs[2 k], pairs[2 k + 1] are
// the nodes that made node lanes + k; returns the root
int h_tree(int lanes, int* pairs) {
  Block blk;
  std::mutex mu;
  std::vector<int> made;
  run_threads([&](int t) {
    Symbolic b{&blk, &mu, &made, lanes};
    reduce_bucket(b, t, lanes);
  });
  for (size_t k = 0; k < made.size(); ++k) pairs[k] = made[k];
  return blk.ids[0];
}
// buckets (B, 4, 10, lanes) -> sums (B, 4, 10)
void h_reduce(const int32_t* slab, int32_t* sums, int buckets, int lanes) {
  for (int q = 0; q < buckets; ++q) {
    Block blk;
    run_threads([&](int t) {
      Points b{&blk, slab + (int64_t)q * 40 * lanes, lanes, t};
      reduce_bucket(b, t, lanes);
    });
    for (int k = 0; k < 40; ++k) sums[40 * q + k] = blk.nodes[k];
  }
}
}
"""

LANES = [1 << k for k in range(1, 10)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("reduce_header")
    src, so = d / "harness.cpp", d / "libreduce.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++20", "-pthread", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(so))


def plain_tree(lanes):
    """reduce_plain's loop on lane indices: the nested pairs it adds."""
    v = list(range(lanes))
    while len(v) > 1:
        h = len(v) // 2
        v = [(v[j], v[j + h]) for j in range(h)]
    return v[0]


@pytest.mark.parametrize("lanes", LANES)
def test_schedule_adds_reduce_plains_pairs(lib, lanes):
    pairs = np.full(2 * lanes, -1, np.int32)
    root = lib.h_tree(ctypes.c_int(lanes),
                      pairs.ctypes.data_as(ctypes.c_void_p))

    def expand(node):
        if node < lanes:
            return node
        k = node - lanes
        return (expand(int(pairs[2 * k])), expand(int(pairs[2 * k + 1])))

    assert root == 2 * lanes - 2                     # lanes - 1 additions
    assert expand(root) == plain_tree(lanes)


@pytest.mark.parametrize("lanes", [2, 64, 128, 512])
def test_schedule_sums_match_reduce_plain(lib, lanes):
    """Two buckets of seeded limbs in the carried range of every slab
    (|limb| < 2^25), summed by the header's schedule and ge_add."""
    g = torch.Generator().manual_seed(700 + lanes)
    slab = torch.randint(-(1 << 25), 1 << 25, (1, 2, 4, 10, lanes),
                         generator=g, dtype=torch.int32)
    want = M.reduce_plain(slab)
    got = np.zeros((2, 4, 10), np.int32)
    src = np.ascontiguousarray(slab.numpy())
    lib.h_reduce(src.ctypes.data_as(ctypes.c_void_p),
                 got.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(2),
                 ctypes.c_int(lanes))
    assert np.array_equal(got, want[0].numpy())
