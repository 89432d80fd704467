"""K6's direct form (`csrc/fixed_direct.cuh`: one lane's chunk of public
rows as signed multiples read from a table into one accumulator) against
its plain version (`ops/fixed_msm._accumulate_direct_plain`), limb for
limb, on the CPU.

The header is compiled with the host g++ behind a small C harness that
defines the CUDA qualifiers away and gives `int4`, `int2` and `__ldg`
their plain C forms; the harness runs `direct_chunk` for every (chunk,
lane) of a slab, as `fixed_direct_kernel` does a thread each.  The table
is a real one (`make_multiples` of seeded bases), the digits seeded draws
with zero lanes, zero rows and every digit value; the row map is none, a
random one, or an IPP round's."""

import ctypes
import random
import subprocess

import numpy as np
import pytest
import torch

from bulletproofs_tpu_torch.core.ristretto import RISTRETTO_BASEPOINT
from bulletproofs_tpu_torch.core.scalar import L as ELL, Scalar
from bulletproofs_tpu_torch.ops import fixed_msm as FM
from bulletproofs_tpu_torch.ops import prover_stages as PS
from bulletproofs_tpu_torch.ops._cuda import CSRC

HARNESS = r"""
#include <stdint.h>
#define __device__
#define __constant__
#define __forceinline__ inline
#define __noinline__
struct int4 { int x, y, z, w; };
struct int2 { int x, y; };
template <class T> static inline T __ldg(const T* p) { return *p; }
#include "fixed_direct.cuh"

// slab (splits, 1, 4, 10, Q): chunk c of `rows` digit rows of lane q
extern "C" void h_direct(const int32_t* mult, const int64_t* sel,
                         const int8_t* digits, int32_t* slab, int64_t S,
                         int64_t Q, int64_t splits, int64_t rows) {
  for (int64_t c = 0; c < splits; ++c)
    for (int64_t q = 0; q < Q; ++q) {
      const int64_t s0 = c * rows, s1 = s0 + rows < S ? s0 + rows : S;
      const ge p = direct_chunk(mult, sel, digits, Q, q, s0, s1);
      const fe* co[4] = {&p.X, &p.Y, &p.Z, &p.T};
      for (int k = 0; k < 4; ++k)
        for (int l = 0; l < 10; ++l)
          slab[((c * 4 + k) * 10 + l) * Q + q] = co[k]->v[l];
    }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixed_direct_header")
    src, so = d / "harness.cpp", d / "libdirect.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-fno-strict-aliasing", "-std=c++17",
                    "-shared", "-fPIC", "-I", CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def mult():
    """The multiples table of 6 seeded bases (2N + 2 at N = 2)."""
    r = random.Random(71)
    bases = [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
             for _ in range(6)]
    return FM.FixedBaseTables(bases, "cpu").mult


def _run(lib, mult, sel, digits, splits):
    S, Q = digits.shape
    rows = -(-S // splits)
    slab = np.zeros((splits, 1, 4, 10, Q), np.int32)
    m = np.ascontiguousarray(mult.numpy())
    d = np.ascontiguousarray(digits)
    s = None if sel is None else np.ascontiguousarray(sel, np.int64)
    ptr = ctypes.c_void_p
    lib.h_direct(m.ctypes.data_as(ptr),
                 None if s is None else s.ctypes.data_as(ptr),
                 d.ctypes.data_as(ptr), slab.ctypes.data_as(ptr),
                 ctypes.c_int64(S), ctypes.c_int64(Q), ctypes.c_int64(splits),
                 ctypes.c_int64(rows))
    return slab


@pytest.mark.parametrize("rows, lanes, splits, sel", [
    (384, 5, 1, "none"), (384, 37, 7, "none"), (200, 13, 3, "random"),
    (100, 9, 40, "random"), (192, 16, 4, "round_l"), (192, 3, 2, "round_r")])
def test_direct_chunk_matches_plain(lib, mult, rows, lanes, splits, sel):
    """The header's chunks equal the plain version's slab limb for limb:
    no row map over the whole table (one chunk; seven, the last short), a
    random row map (40 chunks of 3 rows over 100: the last 6 empty), round
    0's L / R maps at N = 2; lane 1 all zero, rows 10-29 all zero, every
    digit value in [-7, 8] present."""
    g = np.random.default_rng(rows + lanes + splits)
    digits = g.integers(-7, 9, (rows, lanes)).astype(np.int8)
    digits[:, min(1, lanes - 1)] = 0
    digits[10:30] = 0
    digits[30:46, 0] = np.arange(-7, 9)
    if sel == "none":
        sel = None
    elif sel == "random":
        sel = g.integers(0, mult.shape[0], rows)
    else:
        sel = PS._dyn_round_maps(2)[0][0]["sel_l" if sel == "round_l"
                                         else "sel_r"]
    got = _run(lib, mult, sel, digits, splits)
    want = FM._accumulate_direct_plain(
        mult, torch.as_tensor(digits),
        None if sel is None else torch.as_tensor(sel), splits)
    assert np.array_equal(got, want.numpy())
