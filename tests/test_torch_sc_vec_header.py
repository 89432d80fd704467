"""The per-element bodies of kernels K17-K20 (`csrc/sc_vec.cuh`, launched
by `csrc/scalar.cu`) against the plain versions of ops/scalar.py and
ops/chacha.py limb for limb, and against the JAX package's
`chacha.random_scalars` / `vec_scalar.from_wide_bytes` (mod l), on the
CPU.

The header is compiled with the host g++ behind a C harness that defines
the CUDA qualifiers away.  The harness runs each body as the kernel does:
K17 (both modes) and K18 (both ops) an element at a time, K19 a column at
a time in the kernel's 8 row slices and then their partial sums, over
rows of any stride (and as its launches run it: the rows cut into
`sc_slice` parts, a block's sum each, then the parts' sums; its prefix
form over two operands), and K20 a draw at a time, from a key (the ChaCha20
block, then the wide reduction) or from 64-byte rows `bs` bytes apart.
Inputs: 0, 1, l - 1, l - 2, 2^252 +- 1, values with all-ones 256-bit
halves, and seeded draws.  Exact limbs.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

import jax
from bulletproofs_tpu.ops import chacha as JCH
from bulletproofs_tpu.ops import vec_scalar as JVS

from bulletproofs_tpu_torch.core.scalar import L as ELL
from bulletproofs_tpu_torch.ops import chacha as CH
from bulletproofs_tpu_torch.ops import scalar as S
from bulletproofs_tpu_torch.ops._cuda import CSRC
from bulletproofs_tpu_torch.ops.limbs import sc_ints_to_limbs, \
    sc_limbs_to_ints

HARNESS = r"""
#include <stdint.h>
#define __device__
#define __constant__
#define __forceinline__ inline
#include "sc_vec.cuh"

// K19's block shape (csrc/scalar.cu)
#define TS_SLICES 8

static sc ld(const int64_t* x, int i) { return sc_load(x + 9 * i, 1); }
static void st(int64_t* o, int i, const sc& r) { sc_store(o + 9 * i, 1, r); }

extern "C" {
// a, b, o: (n, 9); mode 0: a b R^-1, mode 1: a b mod l (K17)
void h_mul(const int64_t* a, const int64_t* b, int64_t* o, int n, int mode) {
  for (int i = 0; i < n; ++i)
    st(o, i, mode == 0 ? sc_mul_elem<0>(ld(a, i), ld(b, i))
                       : sc_mul_elem<1>(ld(a, i), ld(b, i)));
}
// op 0: a + b, op 1: -a (K18)
void h_add(const int64_t* a, const int64_t* b, int64_t* o, int n, int op) {
  for (int i = 0; i < n; ++i)
    st(o, i, op == 0 ? sc_add_elem<0>(ld(a, i), ld(b, i))
                     : sc_add_elem<1>(ld(a, i), ld(b, i)));
}
// one column's rows [r0, r1) (row i at p + i s0) as K19's block sums
// them: TS_SLICES threads' sums, then the partial sums in thread order
static sc block_sum(const int64_t* p, int64_t s0, int64_t sl, int64_t r0,
                    int64_t r1) {
  sc part[TS_SLICES];
  for (int s = 0; s < TS_SLICES; ++s)
    part[s] = sc_sum_rows(p + r0 * s0, s0, sl, r1 - r0, s, TS_SLICES);
  sc acc = part[0];
  for (int s = 1; s < TS_SLICES; ++s) acc = sc_add(acc, part[s]);
  return acc;
}
// v: (n, 9, P) with strides (s0, sl, sc) in elements; o: (9, P): one
// launch of one slice
void h_tree_sum(const int64_t* v, int64_t s0, int64_t sl, int64_t scol,
                int64_t* o, int64_t n, int64_t P) {
  for (int64_t c = 0; c < P; ++c)
    sc_store(o + c, P, block_sum(v + c * scol, s0, sl, 0, n));
}
// K19's launches (csrc/scalar.cu bp_sc_tree_sum, then ops/scalar.py's
// second call where slices > 1): columns [0, Pa) of a, [Pa, Pt) of b,
// rows [0, min(n, h)) (h < 0: n) in `slices` parts -> o (9, Pt)
void h_tree_sum_sliced(const int64_t* a, int64_t as0, int64_t asl,
                       int64_t asc, const int64_t* b, int64_t bs0,
                       int64_t bsl, int64_t bsc, int64_t Pa, int64_t Pt,
                       int64_t n, int64_t h, int64_t slices, int64_t* part,
                       int64_t* o) {
  const int64_t rows = h < 0 ? n : h < n ? h : n;
  for (int64_t s = 0; s < slices; ++s) {
    int64_t r0, r1;
    sc_slice(rows, slices, s, r0, r1);
    for (int64_t c = 0; c < Pt; ++c) {
      const bool in_a = c < Pa;
      const int64_t* p = in_a ? a + c * asc : b + (c - Pa) * bsc;
      sc_store(part + s * 9 * Pt + c, Pt,
               block_sum(p, in_a ? as0 : bs0, in_a ? asl : bsl, r0, r1));
    }
  }
  for (int64_t c = 0; c < Pt; ++c)
    sc_store(o + c, Pt, slices == 1 ? sc_load(part + c, Pt)
                                    : block_sum(part + c, 9 * Pt, Pt, 0,
                                                slices));
}
// key (8 words), counters ctr[i] -> blocks (n, 16 words)
void h_block(const uint32_t* key, const uint32_t* ctr, uint32_t* out,
             int n) {
  for (int i = 0; i < n; ++i) chacha20_block(key, ctr[i], out + 16 * i);
}
// draws 0 .. n - 1 of key -> o (9, n), as K20's threads store them
void h_chacha(const uint32_t* key, int64_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    sc_store(o + i, n, chacha_scalar(key, (uint32_t)i));
}
// rows: byte j of row i at rows[i rs + j bs] -> o (9, n) (K20, wide form)
void h_wide(const uint8_t* rows, int64_t rs, int64_t bs, int64_t* o,
            int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t w[16];
    wide_words(rows + i * rs, bs, w);
    sc_store(o + i, n, sc_from_wide(w));
  }
}
void h_consts(int64_t* o) {
  for (int k = 0; k < 9; ++k) o[k] = SC_W256_M[k];
}
}
"""

U64 = ctypes.c_int64


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("sc_vec_header")
    src, so = d / "harness.cpp", d / "libscvec.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=120)
    return ctypes.CDLL(str(so))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _values(seed: int, k: int, below: int = ELL):
    """Edge values below `below`, then seeded ones: k in all."""
    edge = [0, 1, 2, ELL - 1, ELL - 2, (1 << 252) - 1, 1 << 252,
            (1 << 252) + 1, (ELL - 1) // 2]
    edge = [v for v in edge if v < below]
    rng = np.random.default_rng(seed)
    rest = [int.from_bytes(rng.bytes(33), "little") % below
            for _ in range(k - len(edge))]
    return (edge + rest)[:k]


def _limbs(vals) -> np.ndarray:
    """(n, 9) int64 limbs, a scalar a row (the harness's layout)."""
    return np.ascontiguousarray(sc_ints_to_limbs(vals).T)


def _binary(lib, fn, a_vals, b_vals, code):
    a, b = _limbs(a_vals), _limbs(b_vals)
    out = np.zeros_like(a)
    getattr(lib, fn)(_ptr(a), _ptr(b), _ptr(out), ctypes.c_int(len(a)),
                     ctypes.c_int(code))
    return out.T


def test_constant(lib):
    o = np.zeros(9, np.int64)
    lib.h_consts(_ptr(o))
    assert sc_limbs_to_ints(o[:, None]) == [S.W256_M] == [
        (1 << 256) * (1 << 261) % ELL]


@pytest.mark.parametrize("mode", [0, 1])
def test_sc_mul_matches_plain(lib, mode):
    """K17: a b R^-1 (a up to 2^256, as to_mont takes it) and a b mod l,
    against mont_mul_plain / smul_plain and Python ints."""
    a_vals = _values(1, 300, (1 << 256) if mode == 0 else ELL)
    b_vals = _values(2, 300)[::-1]
    got = _binary(lib, "h_mul", a_vals, b_vals, mode)
    a, b = (torch.as_tensor(sc_ints_to_limbs(v)) for v in (a_vals, b_vals))
    plain = S.mont_mul_plain(a, b) if mode == 0 else S.smul_plain(a, b)
    assert np.array_equal(got, plain.numpy())
    rinv = pow(1 << 261, -1, ELL)
    assert sc_limbs_to_ints(got) == [
        x * y * (rinv if mode == 0 else 1) % ELL
        for x, y in zip(a_vals, b_vals)]


@pytest.mark.parametrize("op", [0, 1])
def test_sc_add_matches_plain(lib, op):
    """K18: a + b and -a mod l against sadd_plain / sneg_plain."""
    a_vals, b_vals = _values(3, 300), _values(4, 300)[::-1]
    got = _binary(lib, "h_add", a_vals, b_vals, op)
    a, b = (torch.as_tensor(sc_ints_to_limbs(v)) for v in (a_vals, b_vals))
    plain = S.sadd_plain(a, b) if op == 0 else S.sneg_plain(a)
    assert np.array_equal(got, plain.numpy())
    assert sc_limbs_to_ints(got) == [
        (x + y if op == 0 else -x) % ELL for x, y in zip(a_vals, b_vals)]


@pytest.mark.parametrize("n, P, layout", [
    (1, 5, "contiguous"), (7, 3, "contiguous"), (13, 37, "contiguous"),
    (64, 6, "columns of a wider tensor"), (33, 4, "limb-major")])
def test_sc_tree_sum_matches_plain(lib, n, P, layout):
    """K19 in its 8 row slices (n below, at and above 8, odd n) over
    contiguous rows, a column slice of a wider tensor and a (9, n, P)
    tensor transposed, against tree_sum_plain."""
    vals = _values(5 + n, n * P)
    rows = torch.as_tensor(sc_ints_to_limbs(vals)).reshape(9, n, P)
    if layout == "contiguous":
        v = rows.transpose(0, 1).contiguous()
    elif layout == "columns of a wider tensor":
        wide = torch.cat([rows, rows.flip(2)], dim=2).transpose(0, 1)
        v = wide.contiguous()[:, :, 1: P + 1]
    else:
        v = rows.transpose(0, 1)
    assert v.shape == (n, 9, P)
    out = np.zeros((9, P), np.int64)
    arr = v.numpy()                            # a strided view, no copy
    s0, sl, sc = (s // 8 for s in arr.strides)
    lib.h_tree_sum(ctypes.c_void_p(arr.ctypes.data), U64(s0), U64(sl),
                   U64(sc), _ptr(out), U64(n), U64(P))
    assert np.array_equal(out, S.tree_sum_plain(v).numpy())
    assert sc_limbs_to_ints(out) == [
        sum(sc_limbs_to_ints(v[i].numpy())[c] for i in range(n)) % ELL
        for c in range(P)]


@pytest.mark.parametrize("n, P, slices, h", [
    (64, 5, None, None), (1024, 3, None, None), (63, 4, 3, None),
    (1024, 2, 33, 512), (1024, 2, 33, 1), (64, 3, 3, 32), (37, 2, 64, 20),
    (16, 3, 2, 0)])
def test_sc_tree_sum_slices_and_prefix_match_plain(lib, n, P, slices, h):
    """K19's two launches (row slices, then their sums; `slices` None:
    tree_slices' count at a P of 256, as at the provers' shapes) and its
    prefix form (h rows of two column slices of one tensor, side by side)
    against tree_sum_plain and tree_sum_prefix_plain: more slices than
    rows, h = 0 and h = 1 included."""
    k = S.tree_slices(n, 256) if slices is None else slices
    vals = _values(11 + n + P, 2 * n * P)
    rows = torch.as_tensor(sc_ints_to_limbs(vals)).reshape(9, n, 2 * P)
    v = rows.transpose(0, 1).contiguous()                   # (n, 9, 2P)
    x, y = v[:, :, :P], v[:, :, P:]
    arr = v.numpy()
    s0, sl, sc = (s // 8 for s in arr.strides)
    Pt = P if h is None else 2 * P
    part = np.zeros((k, 9, Pt), np.int64)
    out = np.zeros((9, Pt), np.int64)
    lib.h_tree_sum_sliced(
        ctypes.c_void_p(arr.ctypes.data), U64(s0), U64(sl), U64(sc),
        ctypes.c_void_p(arr.ctypes.data + 8 * P), U64(s0), U64(sl), U64(sc),
        U64(P), U64(Pt), U64(n), U64(-1 if h is None else h), U64(k),
        _ptr(part), _ptr(out))
    want = (S.tree_sum_plain(x) if h is None
            else S.tree_sum_prefix_plain(x, y, torch.tensor(h)))
    assert np.array_equal(out, want.numpy())


def _key(seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, 32,
                                                np.uint8).tobytes()


def test_chacha_block_matches_rfc_and_plain(lib):
    """The ChaCha20 block: RFC 8439 A.1 (key 0, counters 0 and 1) and the
    plain keystream_blocks of a seeded key at counters up to 2^32 - 1."""
    ctr = np.array([0, 1, 2, 1000, (1 << 32) - 2, (1 << 32) - 1], np.uint32)
    for key in (bytes(32), _key(11)):
        kw = np.frombuffer(key, "<u4").copy()
        out = np.zeros((len(ctr), 16), np.uint32)
        lib.h_block(_ptr(kw), _ptr(ctr), _ptr(out), ctypes.c_int(len(ctr)))
        got = out.astype("<u4").view(np.uint8).reshape(len(ctr), 64)
        if key == bytes(32):
            assert got[0].tobytes().hex().startswith("76b8e0ada0f13d90")
            assert got[1].tobytes().hex().startswith("9f07e7be5551387a")
        head = CH.keystream_blocks(key, 1001, "cpu").numpy()
        assert np.array_equal(got[:4], head[[0, 1, 2, 1000]])


@pytest.mark.parametrize("seed", [0, 1])
def test_chacha_scalars_match_plain_and_jax(lib, seed):
    """K20 from a key: random_scalars_plain limb for limb, the JAX
    package's random_scalars mod l."""
    key, n = _key(seed), 700
    kw = np.frombuffer(key, "<u4").copy()
    out = np.zeros((9, n), np.int64)
    lib.h_chacha(_ptr(kw), _ptr(out), U64(n))
    assert np.array_equal(out, CH.random_scalars_plain(key, n, "cpu")
                          .numpy())
    jl = np.asarray(jax.device_get(JCH.random_scalars(key, n)), np.int64)
    assert sc_limbs_to_ints(out) == [
        sum(int(jl[k, i]) << (13 * k) for k in range(jl.shape[0])) % ELL
        for i in range(n)]


@pytest.mark.parametrize("layout", ["rows", "transposed"])
def test_wide_reduction_matches_plain_and_jax(lib, layout):
    """K20's wide form over (n, 64) rows, contiguous and as the device
    transcript passes them (a (64, n) tensor transposed): halves of 0,
    1, l - 1, l - 2 and 2^256 - 1, and seeded rows; against
    from_wide_bytes_plain, Python ints and the JAX package's
    from_wide_bytes mod l."""
    halves = [0, 1, ELL - 1, ELL - 2, (1 << 256) - 1, 1 << 255]
    rows = [lo.to_bytes(32, "little") + hi.to_bytes(32, "little")
            for lo in halves for hi in halves]
    rng = np.random.default_rng(21)
    rows += [rng.bytes(64) for _ in range(200)]
    raw = np.frombuffer(b"".join(rows), np.uint8).reshape(len(rows),
                                                          64).copy()
    n = raw.shape[0]
    if layout == "rows":
        store, rs, bs = np.ascontiguousarray(raw), 64, 1
    else:
        store, rs, bs = np.ascontiguousarray(raw.T), 1, n
    out = np.zeros((9, n), np.int64)
    lib.h_wide(_ptr(store), U64(rs), U64(bs), _ptr(out), U64(n))
    assert np.array_equal(out, S.from_wide_bytes_plain(
        torch.as_tensor(raw)).numpy())
    assert sc_limbs_to_ints(out) == [
        int.from_bytes(r, "little") % ELL for r in rows]
    jl = np.asarray(jax.device_get(JVS.from_wide_bytes(raw)), np.int64)
    assert sc_limbs_to_ints(out) == [
        sum(int(jl[k, i]) << (13 * k) for k in range(jl.shape[0])) % ELL
        for i in range(n)]
