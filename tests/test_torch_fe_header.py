"""The CUDA kernels' field arithmetic (`csrc/fe25519.cuh`) against its plain
PyTorch version (`ops/field.py`), limb for limb, on the CPU.

The header is compiled with the host g++ (the compiler `core/_native.py`
uses) behind a small C harness that defines the CUDA qualifiers away; on
the host `mad_wide` takes its C form, the same integer as the card's
`mad.wide.s32`.  `fe_mul`, `fe_sq`, `fe_carry`, `fe_mul_small`,
`fe_pow_p58` and `fe_canon` are held to `mul`, `square`, `carry`,
`mul_small`, `pow_p58` and `canonicalize` over the full range their
callers feed them: random limbs and limbs at +-2^27 (the bound of every
`fe_mul` input), the operands whose column sums push round 1's carries to
their largest, arbitrary int32 limbs (as `fe_canon` and `fe_mul_small`
take them) and int64 column sums up to 2^62.6 for `fe_carry`.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.ops._cuda import CSRC

HARNESS = r"""
#include <stdint.h>
#define __device__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#include "fe25519.cuh"

static fe get(const int32_t* p) {
  fe r;
  for (int k = 0; k < 10; ++k) r.v[k] = p[k];
  return r;
}
static void put(const fe& a, int32_t* p) {
  for (int k = 0; k < 10; ++k) p[k] = a.v[k];
}

extern "C" {
void h_mul(const int32_t* a, const int32_t* b, int32_t* o, int n) {
  for (int i = 0; i < n; ++i)
    put(fe_mul(get(a + 10 * i), get(b + 10 * i)), o + 10 * i);
}
void h_sq(const int32_t* a, int32_t* o, int n) {
  for (int i = 0; i < n; ++i) put(fe_sq(get(a + 10 * i)), o + 10 * i);
}
void h_carry(const int64_t* h, int32_t* o, int n) {
  for (int i = 0; i < n; ++i) put(fe_carry(h + 10 * i), o + 10 * i);
}
void h_mul_small(const int32_t* a, int32_t s, int32_t* o, int n) {
  for (int i = 0; i < n; ++i)
    put(fe_mul_small(get(a + 10 * i), s), o + 10 * i);
}
void h_pow_p58(const int32_t* a, int32_t* o, int n) {
  for (int i = 0; i < n; ++i) put(fe_pow_p58(get(a + 10 * i)), o + 10 * i);
}
void h_canon(const int32_t* a, int32_t* o, int n) {
  for (int i = 0; i < n; ++i) put(fe_canon(get(a + 10 * i)), o + 10 * i);
}
}
"""

B27 = (1 << 27) - 1                       # |limb| < 2^27: fe_mul's inputs
ODD = np.arange(10) % 2 == 1


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("fe_header")
    src, so = d / "harness.cpp", d / "libfe.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=120)
    return ctypes.CDLL(str(so))


def _call(lib, name, out_n, *arrays, scalar=None):
    args = [np.ascontiguousarray(a) for a in arrays]
    out = np.zeros((out_n, 10), np.int32)
    ptrs = [a.ctypes.data_as(ctypes.c_void_p) for a in args]
    if scalar is not None:
        ptrs.append(ctypes.c_int32(scalar))
    getattr(lib, name)(*ptrs, out.ctypes.data_as(ctypes.c_void_p),
                       ctypes.c_int(out_n))
    return out


def _plain(fn, *arrays):
    """(n, 10) limb rows through an ops/field function -> (n, 10) int64."""
    ts = [torch.from_numpy(np.asarray(a, np.int64).T.copy()) for a in arrays]
    return fn(*ts).numpy().T


def _operands(seed: int, n: int) -> np.ndarray:
    """(n, 10) int32 operands within +-2^27: random limbs, random limbs at
    the bound, and the signs that make each column's products all of one
    sign (the largest column sums and round-1 carries)."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(-B27, B27 + 1, (n, 10))
    edge = rng.choice([-B27, B27], (n, 10))
    fixed = np.array([np.full(10, B27), np.full(10, -B27),
                      np.where(ODD, B27, -B27), np.where(ODD, -B27, B27),
                      np.where(ODD, B27, 0), np.zeros(10, int),
                      np.full(10, 1 << 26), np.full(10, -(1 << 26))])
    return np.concatenate([fixed, rand, edge]).astype(np.int32)


def test_mul_matches_plain(lib):
    a = _operands(1, 200)
    b = np.concatenate([a[:8], _operands(2, 200)[8:]])
    # every fixed pattern against every other, too
    fa = np.repeat(a[:8], 8, axis=0)
    fb = np.tile(a[:8], (8, 1))
    a, b = np.concatenate([a, fa]), np.concatenate([b, fb])
    got = _call(lib, "h_mul", len(a), a, b)
    assert np.array_equal(got, _plain(F.mul, a, b))


def test_sq_matches_plain_mul(lib):
    a = _operands(3, 400)
    got = _call(lib, "h_sq", len(a), a)
    assert np.array_equal(got, _plain(F.square, a))
    assert np.array_equal(got, _call(lib, "h_mul", len(a), a, a))


def test_carry_matches_plain(lib):
    rng = np.random.default_rng(4)
    top = int(2 ** 62.6)
    h = np.concatenate([
        rng.integers(-top, top, (200, 10), dtype=np.int64),
        rng.integers(-(1 << 31), 1 << 31, (200, 10), dtype=np.int64),
        np.array([np.full(10, top), np.full(10, -top),
                  np.where(ODD, top, -top), np.full(10, (1 << 31) - 1),
                  np.full(10, -(1 << 31)), np.full(10, 1 << 25),
                  np.full(10, -(1 << 25)), np.full(10, (1 << 24) - 1)],
                 dtype=np.int64)])
    got = _call(lib, "h_carry", len(h), h)
    assert np.array_equal(got, _plain(F.carry, h))


def test_canon_on_arbitrary_int32_limbs(lib):
    rng = np.random.default_rng(5)
    a = np.concatenate([
        rng.integers(-(1 << 31), 1 << 31, (200, 10)),
        np.array([np.full(10, (1 << 31) - 1), np.full(10, -(1 << 31)),
                  np.zeros(10, int)])]).astype(np.int32)
    got = _call(lib, "h_canon", len(a), a)
    assert np.array_equal(got, _plain(F.canonicalize, a))


@pytest.mark.parametrize("s", [2, 19, 121666])
def test_mul_small_matches_plain(lib, s):
    rng = np.random.default_rng(6)
    a = np.concatenate([
        rng.integers(-(1 << 31), 1 << 31, (100, 10)),
        _operands(7, 50)]).astype(np.int32)
    got = _call(lib, "h_mul_small", len(a), a, scalar=s)
    assert np.array_equal(got, _plain(lambda t: F.mul_small(t, s), a))


def test_pow_p58_matches_plain(lib):
    a = F.carry(torch.from_numpy(_operands(8, 24).T.astype(np.int64)))
    a = a.numpy().T.astype(np.int32)
    got = _call(lib, "h_pow_p58", len(a), a)
    assert np.array_equal(got, _plain(F.pow_p58, a))
