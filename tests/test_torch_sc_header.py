"""The CUDA kernels' inversion mod l (`sc_invert` in `csrc/sc25519.cuh`,
kernel K14's arithmetic) against Python's `pow(x, -1, l)` and the plain
version `scalar.sinv_plain`, limb for limb, on the CPU; and K8's fold
arithmetic (`sc_mont_mul_sum`, two products under one Montgomery
reduction, with u R and v R made by `sc_mont_mul`) against Python ints.

The header is compiled with the host g++ (the compiler `core/_native.py`
uses) behind a small C harness that defines the CUDA qualifiers away.
`sc_invert` is a safegcd inversion with a fixed count of divsteps;
`sinv_plain` is the Fermat ladder x^(l-2), a different algorithm, so the
two agree only if both are exact.  The inputs: 0 (-> 0), small values,
l - 1, l - 2, powers of two and 2^k - 1 below l, seeded random values, and
the values of a seeded pool that need the most divsteps to bring g to 0.
"""

import ctypes
import random
import subprocess

import numpy as np
import pytest
import torch

from bulletproofs_tpu_torch.core.scalar import L as ELL
from bulletproofs_tpu_torch.ops import scalar as S
from bulletproofs_tpu_torch.ops._cuda import CSRC
from bulletproofs_tpu_torch.ops.limbs import sc_ints_to_limbs, \
    sc_limbs_to_ints

HARNESS = r"""
#include <stdint.h>
#define __device__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#include "sc25519.cuh"

extern "C" {
// x, o: (n, 9) 29-bit limbs
void h_invert(const int64_t* x, int64_t* o, int n) {
  for (int i = 0; i < n; ++i) {
    sc a;
    for (int k = 0; k < 9; ++k) a.v[k] = (uint32_t)x[9 * i + k];
    const sc r = sc_invert(a);
    for (int k = 0; k < 9; ++k) o[9 * i + k] = r.v[k];
  }
}
// x, y, u, v, o: (n, 9); o = (x u + y v) R^-1 (raw = 1) or, as K8 folds,
// sc_mont_mul_sum(x, u R, y, v R) = u x + v y (raw = 0)
void h_mont_mul_sum(const int64_t* x, const int64_t* y, const int64_t* u,
                    const int64_t* v, int64_t* o, int n, int raw) {
  for (int i = 0; i < n; ++i) {
    sc a, b, c, d;
    for (int k = 0; k < 9; ++k) {
      a.v[k] = (uint32_t)x[9 * i + k];
      c.v[k] = (uint32_t)y[9 * i + k];
      b.v[k] = (uint32_t)u[9 * i + k];
      d.v[k] = (uint32_t)v[9 * i + k];
    }
    if (!raw) {
      b = sc_mont_mul(b, sc_const(SC_R2));
      d = sc_mont_mul(d, sc_const(SC_R2));
    }
    const sc r = sc_mont_mul_sum(a, b, c, d);
    for (int k = 0; k < 9; ++k) o[9 * i + k] = r.v[k];
  }
}
// the 30-bit limbs of l, then l^-1 mod 2^30
void h_consts(int64_t* o) {
  for (int k = 0; k < 9; ++k) o[k] = SC30_ELL[k];
  o[9] = SC30_LINV;
}
}
"""

# the divsteps sc_invert runs: 20 batches of 30
DIVSTEPS = 20 * 30


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("sc_header")
    src, so = d / "harness.cpp", d / "libsc.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=120)
    return ctypes.CDLL(str(so))


def _invert(lib, vals):
    x = np.ascontiguousarray(sc_ints_to_limbs(vals).T)
    out = np.zeros_like(x)
    lib.h_invert(x.ctypes.data_as(ctypes.c_void_p),
                 out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(len(vals)))
    return out


def divsteps_needed(x: int) -> int:
    """Divsteps of the half-delta variant (zeta = -(delta + 1/2), delta
    starting at 1/2) from f = l, g = x until g = 0: what sc_invert's fixed
    count must cover."""
    zeta, f, g, n = -1, ELL, x, 0
    while g:
        if g & 1 and zeta < 0:
            zeta, f, g = -zeta - 2, g, (g - f) // 2
        elif g & 1:
            zeta, g = zeta - 1, (g + f) // 2
        else:
            zeta, g = zeta - 1, g // 2
        n += 1
    return n


def _edge_values():
    vals = [0, 1, 2, 3, ELL - 1, ELL - 2, ELL - 3, (ELL - 1) // 2,
            (ELL + 1) // 2, 1 << 252, (1 << 252) - 1, ELL - (1 << 252)]
    vals += [1 << k for k in range(253)]
    vals += [(1 << k) - 1 for k in range(2, 253)]
    return vals


def test_constants(lib):
    o = np.zeros(10, np.int64)
    lib.h_consts(o.ctypes.data_as(ctypes.c_void_p))
    assert sum(int(v) << (30 * k) for k, v in enumerate(o[:9])) == ELL
    assert all(0 <= v < 1 << 30 for v in o[:8])
    assert (int(o[9]) * ELL) % (1 << 30) == 1


@pytest.mark.parametrize("which", ["edges", "random", "most divsteps"])
def test_invert_matches_pow_and_plain(lib, which):
    r = random.Random(91)
    if which == "edges":
        vals = _edge_values()
    elif which == "random":
        vals = [r.randrange(ELL) for _ in range(2000)]
    else:
        # trailing zeros and random values; keep the 200 slowest to finish
        pool = [r.randrange(ELL) >> s << s for s in range(0, 200, 2)
                for _ in range(8)] + [r.randrange(ELL) for _ in range(800)]
        need = sorted(pool, key=divsteps_needed)[-200:]
        assert divsteps_needed(need[-1]) <= DIVSTEPS
        vals = need
    got = _invert(lib, vals)
    assert sc_limbs_to_ints(got.T) == [pow(v, -1, ELL) if v else 0
                                       for v in vals]
    x = torch.as_tensor(sc_ints_to_limbs(vals))
    assert np.array_equal(got.T, S.sinv_plain(x).numpy())


# -- K8: sc_mont_mul_sum ---------------------------------------------------------------

R_MONT = 1 << 261
EDGES = [0, 1, 2, ELL - 1, ELL - 2, (ELL - 1) // 2, 1 << 252, (1 << 252) - 1,
         (1 << 29) - 1, 1 << 29, (1 << 232) - 1]


def _mont_mul_sum(lib, x, y, u, v, raw):
    cols = [np.ascontiguousarray(sc_ints_to_limbs(t).T) for t in (x, y, u, v)]
    out = np.zeros_like(cols[0])
    lib.h_mont_mul_sum(*(c.ctypes.data_as(ctypes.c_void_p) for c in cols),
                       out.ctypes.data_as(ctypes.c_void_p),
                       ctypes.c_int(len(x)), ctypes.c_int(raw))
    return sc_limbs_to_ints(out.T)


@pytest.mark.parametrize("which", ["edges", "random"])
def test_mont_mul_sum_matches_ints(lib, which):
    """(x u + y v) R^-1 mod l, canonical, on every combination of edge
    values for x, y and u, v (the largest column sums: all four l - 1) and
    on seeded random ones; then the fold K8 makes, x (u R) + y (v R) under
    one reduction, against u x + v y mod l."""
    r = random.Random(92)
    if which == "edges":
        quads = [(a, b, c, d) for a in EDGES for b in EDGES
                 for c in (0, ELL - 1, a) for d in (ELL - 1, b)]
    else:
        quads = [tuple(r.randrange(ELL) for _ in range(4))
                 for _ in range(3000)]
    x, y, u, v = (list(t) for t in zip(*quads))
    rinv = pow(R_MONT, -1, ELL)
    assert _mont_mul_sum(lib, x, y, u, v, 1) == [
        (a * c + b * d) * rinv % ELL for a, b, c, d in zip(x, y, u, v)]
    assert _mont_mul_sum(lib, x, y, u, v, 0) == [
        (a * c + b * d) % ELL for a, b, c, d in zip(x, y, u, v)]
