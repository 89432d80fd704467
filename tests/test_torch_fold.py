"""Kernels K8 fold, K9 smul and K10 digits of the PyTorch port
(ops/fold.py), through their plain PyTorch versions on the CPU, against
the JAX package's ops/fold_pallas.py kernels in interpret mode (512 and
1024 columns) and its XLA vec_scalar path (a ragged 300 columns, which
the Pallas kernels do not take); and the prover's three fold forms, each
one K8 launch for a and b (`fold_dyn` through every round's maps,
`round_fold` at every width, `prove_fin_fused`), against the JAX
package's prover_stages.

Tolerance 0: the values are compared as integers mod l (the JAX kernels'
outputs are lazy, the port's canonical), digits after decoding both
encodings to integers."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bulletproofs_tpu.ops import fold_pallas as FP
from bulletproofs_tpu.ops import msm_pallas as JMP
from bulletproofs_tpu.ops import prover_stages as JPS
from bulletproofs_tpu.ops import vec_scalar as VS

from bulletproofs_tpu_torch.core.scalar import L as ELL
from bulletproofs_tpu_torch.ops import fold as FO
from bulletproofs_tpu_torch.ops import prover_stages as PS
from bulletproofs_tpu_torch.ops import scalar as S
from bulletproofs_tpu_torch.ops.limbs import sc_ints_to_limbs, \
    sc_limbs_to_ints


@pytest.fixture
def interpret():
    old = FP._INTERPRET
    FP._INTERPRET = True
    yield
    FP._INTERPRET = old


def _vals(k, seed, top=ELL):
    """k scalars below `top`, the first three 0, 1 and l - 1."""
    r = random.Random(seed)
    return ([0, 1, ELL - 1] + [r.randrange(top) for _ in range(k)])[:k]


def _jax_cols(vals):
    """ints -> the JAX package's (20, N) int32 limb columns."""
    return jnp.asarray(np.stack([np.asarray(VS._to_limbs(v, VS.L))
                                 for v in vals], axis=-1).astype(np.int32))


def _jax_ints(arr):
    a = np.asarray(VS.exact_limbs(jnp.asarray(arr)), np.int64)
    return [sum(int(a[k, i]) << (VS.LIMB_BITS * k)
                for k in range(a.shape[0])) % ELL for i in range(a.shape[1])]


def _vectors(vals, rows, cols):
    """ints (row-major) -> the port's (rows, 9, cols) int64 vector."""
    return torch.as_tensor(sc_ints_to_limbs(vals)).reshape(
        9, rows, cols).permute(1, 0, 2).contiguous()


def _ints(t):
    """(R, 9, P) or (9, N) limbs -> ints mod l, row-major."""
    if t.dim() == 3:
        t = t.permute(1, 0, 2).reshape(9, -1)
    return [v % ELL for v in sc_limbs_to_ints(t.numpy())]


def _per_proof(vals, rows):
    """The JAX layout of a per-proof scalar broadcast over the rows
    (prover_stages.round_fold's broadcast_to: column r * P + p)."""
    return vals * rows


def _jax_digit_ints(d):
    d = np.asarray(d)
    return [sum((-1 if d[w, i] >= 16 else 1) * int(d[w, i] & 15) << (4 * w)
                for w in range(64)) % ELL for i in range(d.shape[1])]


def _port_digit_ints(d):
    d = d.numpy().astype(np.int64)
    return [sum(int(d[w, i]) << (4 * w) for w in range(64)) % ELL
            for i in range(d.shape[1])]


@pytest.mark.parametrize("cols", [512, 1024])
def test_fold_matches_jax_interpret(interpret, cols):
    rows = 4
    P = cols // rows
    x, y = _vals(cols, 1 + cols), _vals(cols, 2 + cols)
    u, v = _vals(P, 3 + cols), _vals(P, 4 + cols)
    got = FO.fold_lanes(_vectors(x, rows, P), _vectors(y, rows, P),
                        _vectors(u, 1, P)[0], _vectors(v, 1, P)[0])
    want = FP.fold_lanes(_jax_cols(x), _jax_cols(y),
                         _jax_cols(_per_proof(u, rows)),
                         _jax_cols(_per_proof(v, rows)))
    assert _ints(got) == _jax_ints(want)
    assert _ints(got)[:3] == [(a * c + b * d) % ELL for a, b, c, d in
                              zip(x[:3], y[:3], u[:3], v[:3])]


@pytest.mark.parametrize("cols", [512, 1024])
def test_smul_matches_jax_interpret(interpret, cols):
    rows = 8
    P = cols // rows
    x = _vals(cols, 5 + cols)
    m1, m0 = _vals(P, 6 + cols), _vals(P, 7 + cols)
    mask = torch.tensor([r % 3 == 0 for r in range(rows)])
    got = FO.smul_lanes(_vectors(x, rows, P), mask, _vectors(m1, 1, P)[0],
                        _vectors(m0, 1, P)[0])
    mult = [(m1 if mask[r] else m0)[p] for r in range(rows) for p in range(P)]
    want = FP.smul_lanes(_jax_cols(x), _jax_cols(mult))
    assert _ints(got) == _jax_ints(want)


@pytest.mark.parametrize("cols", [512, 1024])
def test_smul_pair_matches_jax_interpret(interpret, cols):
    """K9's pair form (one launch for gw and hw on the card; its plain
    version here): both vectors against the JAX kernel, hw with the
    multipliers swapped, under a mask that is neither all set nor all
    clear."""
    rows = 8
    P = cols // rows
    x, y = _vals(cols, 15 + cols), _vals(cols, 16 + cols)
    m1, m0 = _vals(P, 17 + cols), _vals(P, 18 + cols)
    mask = torch.tensor([r % 4 < 2 for r in range(rows)])
    xv, yv = _vectors(x, rows, P), _vectors(y, rows, P)
    m1v, m0v = _vectors(m1, 1, P)[0], _vectors(m0, 1, P)[0]
    got = FO.smul_pair(xv, yv, mask, m1v, m0v)
    for g, w in zip(got, FO.smul_pair_plain(xv, yv, mask, m1v, m0v)):
        assert torch.equal(g, w)
    mx = [(m1 if mask[r] else m0)[p] for r in range(rows) for p in range(P)]
    my = [(m0 if mask[r] else m1)[p] for r in range(rows) for p in range(P)]
    assert _ints(got[0]) == _jax_ints(FP.smul_lanes(_jax_cols(x),
                                                    _jax_cols(mx)))
    assert _ints(got[1]) == _jax_ints(FP.smul_lanes(_jax_cols(y),
                                                    _jax_cols(my)))


@pytest.mark.parametrize("cols", [512, 1024])
def test_digits_match_jax_interpret(interpret, cols):
    """Canonical values and, as JAX's own test does, values in [l, 2^256),
    which the guard reduces before the recode."""
    vals = _vals(cols - 8, 8 + cols) + [ELL, ELL + 1, 8 << 252,
                                        (8 << 252) - 1, (1 << 256) - 1,
                                        2 * ELL, 15 * ELL, (1 << 252) - 1]
    got = FO.digits_lanes(torch.as_tensor(sc_ints_to_limbs(vals)))
    want = FP.digits_lanes(_jax_cols(vals))
    assert got.shape == (64, cols) and got.dtype == torch.int8
    assert int(got.min()) >= -7 and int(got.max()) <= 8
    assert _port_digit_ints(got) == _jax_digit_ints(want) \
        == [v % ELL for v in vals]


def test_ragged_columns_match_jax_xla():
    """300 columns (no 512-column tile): against vec_scalar, the XLA path
    the JAX package takes where its kernels do not fit."""
    rows, P = 3, 100
    x, y = _vals(300, 11), _vals(300, 12)
    u, v = _vals(P, 13), _vals(P, 14)
    xv, yv = _vectors(x, rows, P), _vectors(y, rows, P)
    uv, vv = _vectors(u, 1, P)[0], _vectors(v, 1, P)[0]
    got = FO.fold_lanes(xv, yv, uv, vv)
    want = VS.sadd(VS.smul(_jax_cols(x), _jax_cols(_per_proof(u, rows))),
                   VS.smul(_jax_cols(y), _jax_cols(_per_proof(v, rows))))
    assert _ints(got) == _jax_ints(want)
    mask = torch.tensor([True, False, True])
    got = FO.smul_lanes(xv, mask, uv, vv)
    mult = [(u if mask[r] else v)[p] for r in range(rows) for p in range(P)]
    assert _ints(got) == _jax_ints(VS.smul(_jax_cols(x), _jax_cols(mult)))
    got = FO.digits_lanes(torch.as_tensor(sc_ints_to_limbs(x)))
    want = JMP.to_signed_digits(VS.digits64(VS.sreduce(_jax_cols(x))))
    assert _port_digit_ints(got) == _jax_digit_ints(want)


def test_digit_stream_rows_match_jax_coef_digits():
    """(nb, 9, Q) coefficients -> the fixed-base stream, row j * 64 + w,
    equal in value to the JAX package's prover_stages._coef_digits."""
    nb, Q = 5, 7
    vals = _vals(nb * Q, 15)
    got = PS._coef_digits(_vectors(vals, nb, Q))
    jcoef = _jax_cols(vals).reshape(VS.L, nb, Q)
    want = np.asarray(JPS._coef_digits(jcoef))
    assert got.shape == want.shape == (nb * 64, Q)
    for j in range(nb):
        assert _port_digit_ints(got[j * 64: (j + 1) * 64]) \
            == _jax_digit_ints(want[j * 64: (j + 1) * 64]) \
            == [v % ELL for v in vals[j * Q: (j + 1) * Q]]


def test_round_fold_matches_jax(interpret):
    """One IPP round's fold of a, b and update of gw, hw against the JAX
    package's round_fold with its fold kernels (interpret mode): n = 64,
    nk = 32, 16 proofs."""
    n, nk, P = 64, 32, 16
    a, b, gw, hw = (_vals(n * P, 20 + k) for k in range(4))
    u = _vals(P, 24)
    uinv = [pow(w, -1, ELL) if w else 0 for w in u]
    got = PS.round_fold(n, nk, *(_vectors(t, n, P) for t in (a, b, gw, hw)),
                        _vectors(u, 1, P)[0], _vectors(uinv, 1, P)[0])
    jv = [_jax_cols(t).reshape(VS.L, n, P) for t in (a, b, gw, hw)]
    want = JPS.round_fold(n, nk, *jv, _jax_cols(u), _jax_cols(uinv))
    for g, w in zip(got, want):
        assert _ints(g)[: nk // 2 * P] == \
            _jax_ints(np.asarray(w).reshape(VS.L, n * P))[: nk // 2 * P]
    for g, w in zip(got[2:], want[2:]):                 # gw, hw: every row
        assert _ints(g) == _jax_ints(np.asarray(w).reshape(VS.L, n * P))


def _challenges(P, seed):
    """(port u, port u^-1, JAX u, JAX u^-1) of P nonzero seeded scalars."""
    u = [v or 1 for v in _vals(P, seed)]
    uinv = [pow(v, -1, ELL) for v in u]
    return (_vectors(u, 1, P)[0], _vectors(uinv, 1, P)[0], _jax_cols(u),
            _jax_cols(uinv))


def _same_rows(got, want, N, P):
    """Every row of the port's (N, 9, P) vectors equal mod l to the JAX
    package's (20, N, P) ones, the stale rows above the fold included."""
    for g, w in zip(got, want):
        assert _ints(g) == _jax_ints(np.asarray(w).reshape(VS.L, N * P))


@pytest.mark.parametrize("P", [32, 5])
def test_fold_dyn_matches_jax_every_round(interpret, P):
    """The device route's fold (a and b by fold_pair, one K8 launch; gw, hw
    by K9) through every round's maps at N = 16, chained round to round,
    against the JAX package's fold_dyn: its Pallas kernels in interpret
    mode at P = 32 (N P = 512 columns), its XLA path at a ragged P = 5.
    All rows compared, the stale ones above nk included."""
    N = 16
    vecs = [_vals(N * P, 30 + k + P) for k in range(4)]
    port = [_vectors(t, N, P) for t in vecs]
    jax_ = [_jax_cols(t).reshape(VS.L, N, P) for t in vecs]
    xs = PS.dyn_round_xs(N, torch.device("cpu"))
    _, jfolds = JPS._dyn_round_maps(N)
    assert len(jfolds) == xs["k"].shape[0] == 3
    for k, jf in enumerate(jfolds):
        u, uinv, ju, juinv = _challenges(P, 40 + k + P)
        port = PS.fold_dyn(*port, u, uinv, xs["mask_fold"][k],
                           xs["idx_fold"][k], xs["glo"][k])
        jax_ = JPS.fold_dyn(*jax_, ju, juinv,
                            *(jnp.asarray(jf[key]) for key in
                              ("mask_fold", "idx_fold", "glo")))
        _same_rows(port, jax_, N, P)


def test_round_fold_matches_jax_every_width(interpret):
    """The per-stage route's fold (one K8 launch for a and b over all N
    rows, the maps of width nk / 2) at every width 16 -> 8 -> 4 -> 2 -> 1,
    chained, against the JAX package's round_fold (Pallas, interpret mode,
    where its 512-column tiles fit; XLA below): every row of a, b, gw,
    hw."""
    N, P = 16, 64
    vecs = [_vals(N * P, 50 + k) for k in range(4)]
    port = [_vectors(t, N, P) for t in vecs]
    jax_ = [_jax_cols(t).reshape(VS.L, N, P) for t in vecs]
    nk = N
    while nk > 1:
        u, uinv, ju, juinv = _challenges(P, 60 + nk)
        port = PS.round_fold(N, nk, *port, u, uinv)
        jax_ = JPS.round_fold(N, nk, *jax_, ju, juinv)
        _same_rows(port, jax_, N, P)
        nk //= 2


def test_prove_fin_fused_matches_jax():
    """The last fold 2 -> 1 (a and b in one K8 launch) and the output
    block: lr_all and the canonical rows of t_x .. b0 byte for byte
    against the JAX package's prove_fin_fused, with 0 and l - 1 among
    a0, b0."""
    N, P = 4, 6
    a, b = _vals(N * P, 70), _vals(N * P, 71)
    u, uinv, ju, juinv = _challenges(P, 72)
    r = np.random.default_rng(73)
    lrs = [r.integers(0, 256, (2 * P, 32)).astype(np.uint8) for _ in range(2)]
    tx = [r.integers(0, 256, (P, 32)).astype(np.uint8) for _ in range(3)]
    got = PS.prove_fin_fused([torch.as_tensor(x) for x in lrs],
                             _vectors(a, N, P), _vectors(b, N, P), u, uinv,
                             *(torch.as_tensor(t) for t in tx))
    want = JPS.prove_fin_fused([jnp.asarray(x) for x in lrs],
                               _jax_cols(a).reshape(VS.L, N, P),
                               _jax_cols(b).reshape(VS.L, N, P), ju, juinv,
                               *(jnp.asarray(t) for t in tx))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_fold_pair_is_the_masked_gather_fold():
    """fold_pair against its definition on Python ints: a ragged shape, a
    map that is not a round's (rows gathered from anywhere, the mask
    scattered), u and u^-1 swapped for b."""
    R, P = 7, 3
    a, b = _vals(R * P, 80), _vals(R * P, 81)
    u, v = _vals(P, 82), _vals(P, 83)
    idx = [3, 0, 6, 6, 1, 2, 5]
    mask = [True, False, True, True, False, True, False]
    got = FO.fold_pair(_vectors(a, R, P), _vectors(b, R, P),
                       _vectors(u, 1, P)[0], _vectors(v, 1, P)[0],
                       torch.tensor(idx), torch.tensor(mask))
    for out, x, (c, d) in zip(got, (a, b), ((u, v), (v, u))):
        assert _ints(out) == [
            (c[p] * x[j * P + p] + d[p] * x[idx[j] * P + p]) % ELL
            if mask[j] else x[j * P + p] for j in range(R) for p in range(P)]


@pytest.mark.parametrize("v", [0, 1, ELL - 1, ELL, (1 << 252) - 1, 1 << 252,
                               8 << 252, (1 << 256) - 1, (1 << 261) - 1])
def test_reduce_top_is_mod_l(v):
    got = S.reduce_top(torch.as_tensor(sc_ints_to_limbs([v])))
    assert sc_limbs_to_ints(got.numpy()) == [v % ELL]


def test_wrappers_reject_bad_arguments():
    x = torch.zeros((4, 9, 8), dtype=torch.int64)
    u = torch.zeros((9, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        FO.fold_lanes(x, x, u, torch.zeros((9, 7), dtype=torch.int64))
    with pytest.raises(ValueError):
        FO.fold_lanes(x.to(torch.int32), x, u, u)
    with pytest.raises(ValueError):                   # not contiguous
        FO.fold_lanes(x.transpose(0, 2).contiguous().transpose(0, 2), x, u,
                      u)
    idx, mask = torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        FO.fold_pair(x, x, u, u, idx.to(torch.int32), mask)
    with pytest.raises(ValueError):
        FO.fold_pair(x, x, u, u, idx, mask[:3])
    with pytest.raises(ValueError):
        FO.fold_pair(x, x[:3], u, u, idx, mask)
    with pytest.raises(ValueError):
        FO.smul_lanes(x, torch.zeros(3, dtype=torch.bool), u, u)
    with pytest.raises(ValueError):
        FO.digits_lanes(torch.zeros((2, 10, 8), dtype=torch.int64))
    assert FO.digits_lanes(torch.zeros((0, 9, 8), dtype=torch.int64)) \
        .shape == (0, 8)


def test_smul_pair_rejects_bad_arguments():
    x = torch.zeros((4, 9, 8), dtype=torch.int64)
    u = torch.zeros((9, 8), dtype=torch.int64)
    mask = torch.ones(4, dtype=torch.bool)
    bad = [(x, x[:3], mask, u, u),                     # rows differ
           (x, x, mask, u, torch.zeros((9, 7), dtype=torch.int64)),
           (x.to(torch.int32), x, mask, u, u),
           (x, x, mask.to(torch.uint8), u, u),
           (x, x, mask[:3], u, u),
           (x, x.transpose(0, 2).contiguous().transpose(0, 2), mask, u, u),
           (x[..., None], x, mask, u, u)]
    for args in bad:
        with pytest.raises(ValueError):
            FO.smul_pair(*args)
    got = FO.smul_pair(x[:0], x[:0], mask[:0], u, u)
    assert got[0].shape == got[1].shape == (0, 9, 8)


# -- K14: sinv (vec_scalar.sinv, XLA in the JAX package) -------------------------------

def _canonical_bytes(ints):
    return [v.to_bytes(32, "little") for v in ints]


def test_sinv_matches_jax_and_pow():
    """x^(l-2) mod l on 0, 1, l - 1 and seeded values: the port's plain
    ladder against JAX vec_scalar.sinv (compared as canonical bytes) and
    Python's pow."""
    vals = _vals(12, 97)
    got = S.sinv(torch.as_tensor(sc_ints_to_limbs(vals)))
    ints = sc_limbs_to_ints(got.numpy())
    assert _canonical_bytes(ints) == _canonical_bytes(
        _jax_ints(VS.sinv(_jax_cols(vals))))
    assert ints == [pow(v, ELL - 2, ELL) for v in vals]
    assert all(0 <= v < ELL for v in ints)


def test_sinv_times_x_is_one():
    vals = _vals(8, 98)[1:]                          # all nonzero
    x = torch.as_tensor(sc_ints_to_limbs(vals))
    one = sc_limbs_to_ints(S.smul(x, S.sinv(x)).numpy())
    assert one == [1] * len(vals)


def test_sinv_rejects_bad_shapes():
    with pytest.raises(ValueError):
        S.sinv(torch.zeros((8, 3), dtype=torch.int64))
    with pytest.raises(ValueError):
        S.sinv(torch.zeros((9, 3), dtype=torch.int32))


@pytest.mark.parametrize("N", [8, 64, 1024])
def test_dyn_round_maps_match_jax(N):
    """The device-transcript route's per-round gather maps equal the JAX
    package's (its masks are int32 0 / 1, the port's bool).  Where the JAX
    package masks the cross terms' rows by `mask_half`, the prefix j < h,
    the port keeps h as `half` (K19's prefix form reads it)."""
    emit, folds = PS._dyn_round_maps(N)
    jemit, jfolds = JPS._dyn_round_maps(N)
    assert len(emit) == len(jemit) and len(folds) == len(jfolds)
    for mine, theirs in zip(emit + folds, jemit + jfolds):
        if "half" in mine:
            mask = theirs["mask_half"].astype(bool)
            assert np.array_equal(mask, np.arange(N) < mine["half"])
            theirs = {k: v for k, v in theirs.items() if k != "mask_half"}
            mine = {k: v for k, v in mine.items() if k != "half"}
        assert mine.keys() == theirs.keys()
        for k in mine:
            assert np.array_equal(mine[k].astype(np.int64),
                                  theirs[k].astype(np.int64)), k
