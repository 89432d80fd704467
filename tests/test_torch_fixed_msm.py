"""Kernels K6 / K7 (the prover's fixed-base MSM: bucket accumulation and
bucket reduction) of the PyTorch port, through their plain PyTorch
versions on the CPU, against the JAX package's ops/fixed_msm.py: its table
build `_make_tables`, its XLA twin `_msm_digits_xla` and its Pallas
kernels `_fixed_msm` in interpret mode, and against the host curve
library's multiscalar_mul.

Tables are compared limb for limb (both canonical after tables_from_jax);
points by their compressed bytes (ristretto equality).  Inputs are seeded
numpy draws."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bulletproofs_tpu.ops import fixed_msm as JFM
from bulletproofs_tpu.ops import pallas_math as PM
from bulletproofs_tpu.ops import vec_curve as JC

from bulletproofs_tpu_torch.core.ristretto import (RISTRETTO_BASEPOINT,
                                                   multiscalar_mul)
from bulletproofs_tpu_torch.core.scalar import L as ELL, Scalar
from bulletproofs_tpu_torch import tracing
from bulletproofs_tpu_torch.ops import curve as C
from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.ops import fixed_msm as FM
from bulletproofs_tpu_torch.ops import prover_stages as PS
from bulletproofs_tpu_torch.ops.limbs import sc_ints_to_limbs

NB = 5


def _bases():
    r = random.Random(int(np.random.default_rng(51).integers(1 << 31)))
    return [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
            for _ in range(NB)]


@pytest.fixture(scope="module")
def tables():
    """(port FixedBaseTables, JAX FixedBaseTables) over the same bases."""
    bases = _bases()
    jt = JFM.FixedBaseTables(bases)
    jt.ensure_niels()
    return FM.FixedBaseTables(bases, "cpu"), jt


def _encode(d: np.ndarray) -> np.ndarray:
    """The port's signed digits in [-7, 8] -> the JAX stream's mag | 16 neg."""
    return (np.abs(d) | np.where(d < 0, 16, 0)).astype(np.int32)


def _compressed(pts) -> list:
    return [p.compress() for p in C.lanes_to_points(np.asarray(pts))]


def _jax_compressed(pts) -> list:
    return [p.compress() for p in JC.lanes_to_points(np.asarray(pts))]


def test_tables_match_jax(tables):
    port, jt = tables
    assert port.niels.shape == (3, 10, NB * 64)
    assert torch.equal(port.niels, FM.tables_from_jax(np.asarray(jt.niels)))


def test_subset_tables_select_the_same_rows(tables):
    port, jt = tables
    idx = [4, 0, 2]
    sel = [0, 64, 65, 3 * 64 + 7, 4 * 64 + 63]
    ps, js = FM.SubsetTables(port, idx), JFM.SubsetTables(jt, idx)
    assert np.array_equal(ps._sel, js._sel)
    assert ps.niels.shape[-1] == js.stream_len == 3 * 64
    assert torch.equal(ps.niels, FM.tables_from_jax(np.asarray(js.ensure_niels())))
    pss, jss = FM.StreamSubsetTables(port, sel), JFM.StreamSubsetTables(jt, sel)
    assert np.array_equal(pss._sel, jss._sel)
    assert torch.equal(pss.niels,
                       FM.tables_from_jax(np.asarray(jss.ensure_niels())))


@pytest.fixture(scope="module")
def small_stream(tables):
    """S = 32 stream rows (bases 1 and 4, 16 windows each), Q = 256 lanes of
    signed digits in [-7, 8]; and the port's plain accumulate + reduce."""
    port, jt = tables
    sel = [64 + w for w in range(0, 64, 4)] + [4 * 64 + w for w in range(16)]
    digits = np.random.default_rng(52).integers(-7, 9, (32, 256)).astype(np.int8)
    niels = FM.StreamSubsetTables(port, sel).niels
    out = FM.reduce(FM.accumulate(niels, torch.as_tensor(digits)))
    jniels = JFM.StreamSubsetTables(jt, sel).ensure_niels()
    return sel, digits, jniels, out


def test_plain_msm_matches_jax_xla(small_stream):
    _, digits, jniels, out = small_stream
    j = JFM._msm_digits_xla(jniels, jnp.asarray(_encode(digits)))
    assert _compressed(out) == _jax_compressed(jax.device_get(j))


def test_plain_msm_matches_jax_pallas_interpret(small_stream):
    _, digits, jniels, out = small_stream
    old = JFM._INTERPRET
    JFM._INTERPRET = True
    try:
        j = JFM._fixed_msm(jniels, jnp.asarray(_encode(digits)),
                           jnp.asarray(PM.CONSTS), 256, 16)
        j = jax.device_get(j)
    finally:
        JFM._INTERPRET = old
    assert _compressed(out) == _jax_compressed(j)


def _host_lanes(sel, digits, bases=None):
    """Host multiscalar_mul of each lane: row s = j * 64 + w holds 16^w
    Base_j, so lane q is sum_s digit[s, q] 16^w_s Base_j_s."""
    bases = bases or _bases()
    out = []
    for q in range(digits.shape[1]):
        acc = [0] * len(bases)
        for s, row in enumerate(map(int, sel)):
            acc[row // 64] += int(digits[s, q]) * 16 ** (row % 64)
        out.append(multiscalar_mul([Scalar(a % ELL) for a in acc],
                                   bases).compress())
    return out


def test_plain_msm_matches_host(small_stream):
    sel, digits, _, out = small_stream
    lanes = [0, 7, 128, 255]
    assert [_compressed(out)[q] for q in lanes] == _host_lanes(
        sel, digits[:, lanes])


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 40])
def test_splits_give_the_same_point(small_stream, tables, splits):
    """Any split of the stream into chunks sums to the same point (16
    lanes, so that pick_splits alone would choose a split of 1).  40: a
    stream of 40 x 32 rows over 2 lanes, where pick_splits itself takes
    40 chunks (above the old cap of 16) and reduce_plain folds them in four
    groups, through the one-hot and the direct form's wrappers (the direct
    form over a row map of the full tables), each against the host MSM:
    the two slabs differ, their reduced points' bytes do not."""
    if splits == 40:
        sel = np.random.default_rng(58).integers(0, NB * 64, 40 * 32)
        digits = np.random.default_rng(59).integers(
            -7, 9, (40 * 32, 2)).astype(np.int8)
        digits[:64] = 0
        assert FM.pick_splits(40 * 32, 2) == 40
        assert FM.pick_splits(40 * 32, 2, FM.TARGET_THREADS_DIRECT) == 40
        sub = FM.StreamSubsetTables(tables[0], sel)
        slab = FM.accumulate(sub.niels, torch.as_tensor(digits))
        vt = FM.accumulate_direct(tables[0].mult, torch.as_tensor(digits),
                                  sub.row_map)
        assert slab.shape == (40, 8, 4, 10, 2)
        assert vt.shape == (40, 1, 4, 10, 2)
        want = _host_lanes(sel, digits)
        assert _compressed(FM.reduce(slab)) == want
        assert _compressed(FM.reduce(vt)) == want
        return
    sel, digits, _, out = small_stream
    niels = FM.StreamSubsetTables(tables[0], sel).niels
    slab = FM._accumulate_plain(niels, torch.as_tensor(digits[:, :16]), splits)
    assert slab.shape == (splits, 8, 4, 10, 16)
    assert _compressed(FM.reduce(slab)) == _compressed(out[..., :16])


def _reduce_sequential(slab):
    """K7's order before the grouped merge: per bucket the chunks summed in
    order, then the running double sum from the top bucket down."""
    v = slab.to(torch.int64)
    merged = tuple(v[0, :, c] for c in range(4))
    for k in range(1, v.shape[0]):
        merged = C.add(merged, tuple(v[k, :, c] for c in range(4)))
    running = total = tuple(c[7] for c in merged)
    for b in range(6, -1, -1):
        running = C.add(running, tuple(c[b] for c in merged))
        total = C.add(total, running)
    return torch.stack(total).to(torch.int32)


@pytest.mark.parametrize("splits, rows", [(1, 30), (6, 30), (20, 40),
                                         (34, 68)])
def test_reduce_order_gives_the_sequential_points(tables, splits, rows):
    """reduce_plain (red_groups chunk groups, a tree, a suffix scan and a
    tree over the buckets) and the sequential merge and running double sum
    give the same compressed points: one group (1, 6 chunks), two (20) and
    four with partial groups (34)."""
    niels = FM.StreamSubsetTables(tables[0], range(rows)).niels
    digits = torch.as_tensor(np.random.default_rng(61).integers(
        -7, 9, (rows, 16)).astype(np.int8))
    assert FM.red_groups(splits) == {1: 1, 6: 1, 20: 2, 34: 4}[splits]
    slab = FM._accumulate_plain(niels, digits, splits)
    assert _compressed(FM.reduce_plain(slab)) == _compressed(
        _reduce_sequential(slab))


def test_padded_split_gives_the_same_point(tables):
    """100 rows over 16 lanes split 3 ways: the wrapper pads the stream
    with two Niels identities and zero digits."""
    niels = FM.StreamSubsetTables(tables[0], range(100)).niels
    digits = torch.as_tensor(np.random.default_rng(54).integers(
        -7, 9, (100, 16)).astype(np.int8))
    assert FM.pick_splits(100, 16) == 3
    slab = FM.accumulate(niels, digits)
    assert slab.shape == (3, 8, 4, 10, 16)
    assert _compressed(FM.reduce(slab)) == _compressed(
        FM.reduce(FM._accumulate_plain(niels, digits, 1)))


def test_msm_digits_of_coefficients_matches_host(tables):
    """Full-width coefficients through the prover's digit stream
    (prover_stages._coef_digits) and msm_digits_niels, against
    multiscalar_mul."""
    port, _ = tables
    g = np.random.default_rng(53)
    Q = 6
    coef = [[int.from_bytes(g.integers(0, 256, 32, np.uint8).tobytes(),
                            "little") % ELL for _ in range(NB)]
            for _ in range(Q)]
    coef[0] = [0] * NB
    coef[1][2] = ELL - 1
    limbs = torch.as_tensor(sc_ints_to_limbs(
        [coef[q][j] for j in range(NB) for q in range(Q)])).reshape(9, NB, Q)
    out = FM.msm_digits_niels(port.niels, PS._coef_digits(limbs.permute(1, 0, 2)))
    bases = _bases()
    assert _compressed(out) == [
        multiscalar_mul([Scalar(c) for c in row], bases).compress()
        for row in coef]


def test_wrappers_reject_bad_shapes(tables):
    niels, mult = tables[0].niels, tables[0].mult
    with pytest.raises(ValueError):
        FM.accumulate(niels, torch.zeros((10, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        FM.accumulate(torch.cat([niels, niels], dim=1),
                      torch.zeros((NB * 64, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        FM.reduce(torch.zeros((2, 9, 4, 10, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        FM.msm_digits_niels(niels, torch.zeros((64, 4), dtype=torch.int8))
    with pytest.raises(ValueError):            # the direct form: no table
        FM.msm_digits_niels(niels, torch.zeros((NB * 64, 4),
                                               dtype=torch.int8),
                            consttime=False)
    with pytest.raises(ValueError):            # rows without a row map
        FM.accumulate_direct(mult, torch.zeros((64, 4), dtype=torch.int8))
    with pytest.raises(ValueError):            # a row map of another length
        FM.accumulate_direct(mult, torch.zeros((64, 4), dtype=torch.int8),
                             torch.zeros(63, dtype=torch.int64))
    with pytest.raises(ValueError):
        FM.accumulate_direct(mult[:, :4].contiguous(),
                             torch.zeros((NB * 64, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        FM.reduce(torch.zeros((2, 2, 4, 10, 4), dtype=torch.int32))


# -- K12: the two-set accumulation (_fixed_accum_kernel2 under _ILP2) -------------

def _jax_fixed_msm2(niels, digits, qblk, kchunk):
    """The JAX package's _fixed_msm with its _ILP2 kernel forced, in
    interpret mode: the two pallas_calls of fixed_msm.py:387-419 with
    _fixed_accum_kernel2 (which _fixed_msm never selects in interpret
    mode) and _fixed_reduce_kernel."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    S, Q, B, L = niels.shape[2], digits.shape[-1], JFM.NUM_BUCKETS, JFM.L
    n_qblk, n_chunks = Q // qblk, S // kchunk
    consts = jnp.asarray(PM.CONSTS)
    slabs = pl.pallas_call(
        JFM._fixed_accum_kernel2,
        grid=(n_qblk, n_chunks),
        in_specs=[
            pl.BlockSpec((PM.NCONST, L, 1), lambda qb, ck: (0, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((3, L, kchunk, 1), lambda qb, ck: (0, 0, ck, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((kchunk, 1, qblk), lambda qb, ck: (ck, 0, qb),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, B, 4, L, qblk),
                               lambda qb, ck: (qb, 0, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_qblk, B, 4, L, qblk), jnp.int32),
        scratch_shapes=[pltpu.VMEM((2, B, 4, L, qblk), jnp.int32)],
        interpret=True,
    )(consts, niels, digits.reshape(S, 1, Q))
    out = pl.pallas_call(
        JFM._fixed_reduce_kernel,
        grid=(n_qblk,),
        in_specs=[
            pl.BlockSpec((PM.NCONST, L, 1), lambda qb: (0, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, B, 4, L, qblk), lambda qb: (qb, 0, 0, 0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, 4, L, qblk), lambda qb: (qb, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_qblk, 4, L, qblk), jnp.int32),
        interpret=True,
    )(consts, slabs)
    return jnp.transpose(out, (1, 2, 0, 3)).reshape(4, L, Q)


def test_accumulate2_plain_matches_jax_kernel2_interpret(small_stream, tables):
    """32 rows in two chunks of 16 (the JAX kernel needs an even chunk),
    256 lanes: the port's two-set plain version, reduced, gives the JAX
    two-slab kernel's points."""
    sel, digits, jniels, out = small_stream
    niels = FM.StreamSubsetTables(tables[0], sel).niels
    got = FM.reduce(FM.accumulate2_plain(niels, torch.as_tensor(digits)))
    j = jax.device_get(_jax_fixed_msm2(jniels, jnp.asarray(_encode(digits)),
                                       256, 16))
    assert _compressed(got) == _jax_compressed(j) == _compressed(out)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_accumulate2_splits_match_k6(tables, splits):
    """96 rows over 16 lanes, any split into even chunks: the same points as
    K6's plain version; zero and negative digits included."""
    niels = FM.StreamSubsetTables(tables[0], range(96)).niels
    d = np.random.default_rng(55).integers(-7, 9, (96, 16)).astype(np.int8)
    d[:, 0] = 0
    d[:, 1] = -7
    digits = torch.as_tensor(d)
    slab = FM._accumulate2_plain(niels, digits, splits)
    assert slab.shape == (splits, 8, 4, 10, 16)
    assert _compressed(FM.reduce(slab)) == _compressed(
        FM.reduce(FM.accumulate_plain(niels, digits)))


def test_accumulate2_pads_odd_streams(tables):
    """101 rows over 16 lanes: pick_splits with K12's thread target gives 3
    chunks, and the wrapper pads the stream to 102 rows (even chunks of 34)
    with Niels identities and zero digits."""
    niels = FM.StreamSubsetTables(tables[0], range(101)).niels
    digits = torch.as_tensor(np.random.default_rng(56).integers(
        -7, 9, (101, 16)).astype(np.int8))
    assert FM.pick_splits(101, 16, FM.TARGET_THREADS2) == 3
    slab = FM.accumulate2(niels, digits)
    assert slab.shape == (3, 8, 4, 10, 16)
    assert _compressed(FM.reduce(slab)) == _compressed(
        FM.reduce(FM.accumulate_plain(niels, digits)))


@pytest.mark.parametrize("rows, lanes", [(4160, 4096), (8256, 4096),
                                         (65600, 256), (131136, 256)])
def test_k12_split_fills_one_wave(rows, lanes):
    """At the prover's four fixed-base shapes (m=1 IPP L and S streams over
    one half's 4096 proofs, m=16 over 256), K12's 2 * splits * lanes
    threads (a lane's two bucket sets on two threads) are the most that
    put one warp on each scheduler of an H100's 132 SMs (4 each), and its
    chunks have an even row count."""
    splits = FM.pick_splits(rows, lanes, FM.TARGET_THREADS2)
    assert 2 * splits * lanes <= 132 * 4 * 32 < 2 * (splits + 1) * lanes
    assert (rows + (-rows) % (2 * splits)) // splits % 2 == 0


def test_ilp2_switches_accumulate_to_k12(tables, monkeypatch):
    niels = FM.StreamSubsetTables(tables[0], range(64)).niels
    digits = torch.as_tensor(np.random.default_rng(57).integers(
        -7, 9, (64, 8)).astype(np.int8))
    monkeypatch.setattr(FM, "_ILP2", True)
    assert torch.equal(FM.accumulate(niels, digits),
                       FM.accumulate2_plain(niels, digits))
    monkeypatch.setattr(FM, "_ILP2", False)
    assert torch.equal(FM.accumulate(niels, digits),
                       FM.accumulate_plain(niels, digits))


@pytest.mark.parametrize("m", [1, 2])
def test_prover_sends_only_ipp_rows_to_the_direct_form(monkeypatch, m):
    """One proof at n = 8 on the device-transcript route (m = 1, 2) and, at
    m = 1, on the per-stage route: every IPP round's L / R MSM takes K6's
    direct form (`accumulate_direct`), every V / A / S / T MSM the one-hot
    form (`accumulate`); the proofs verify on the host, and at m = 1 both
    routes give the same bytes."""
    import sys
    from bulletproofs_tpu_torch import (BatchProver, BulletproofGens,
                                        PedersenGens, Transcript)
    bp, pc = BulletproofGens(8, m), PedersenGens()
    prover = BatchProver(bp, pc, 8, m, device="cpu")
    values, blinds = [[3, 250][:m]], [[Scalar(5), Scalar(6)][:m]]
    if m == 1:
        values, blinds = [values[0][0]], [blinds[0][0]]
    calls = []
    stages = ("_emit_lr", "round_emit", "stage0_fused", "stage1_fused",
              "prove_mid_fused")

    def recording(real, consttime):
        def inner(*args):
            f = sys._getframe(1)
            while f.f_code.co_name not in stages:
                f = f.f_back
            calls.append((f.f_code.co_name, consttime))
            return real(*args)
        return inner

    monkeypatch.setattr(FM, "accumulate", recording(FM.accumulate, True))
    monkeypatch.setattr(FM, "accumulate_direct",
                        recording(FM.accumulate_direct, False))
    out = []
    for fused in (True, False)[:3 - m]:
        calls.clear()
        prover.fused = fused
        ts = [Transcript(b"routing")]
        ps, vs = prover.prove_batch(values, blinds, ts, rng=random.Random(60))
        out.append(([p.to_bytes() for p in ps], vs, ts[0].strobe.buf.raw))
        ipp = [c for f, c in calls if f in ("_emit_lr", "round_emit")]
        witness = [c for f, c in calls
                   if f in ("stage0_fused", "stage1_fused", "prove_mid_fused")]
        assert len(ipp) == 2 * (8 * m).bit_length() - 2 and not any(ipp)
        assert len(witness) == 4 and all(witness)
        assert len(calls) == len(ipp) + len(witness)
    assert out[0] == out[-1]
    if m == 1:
        ps[0].verify_single(bp, pc, Transcript(b"routing"), vs[0], 8)
    else:
        ps[0].verify_multiple(bp, pc, Transcript(b"routing"), vs[0], 8)


# -- K6's direct form: signed multiples from a table into one accumulator --------


@pytest.mark.parametrize("j, w", [(0, 0), (1, 1), (3, 17), (4, 63)])
def test_multiples_table_matches_host_multiples(tables, j, w):
    """make_multiples' row j * 64 + w holds k 16^w Base_j for k = 1..8 as
    canonical Niels limbs (Y+X, Y-X, 2dT) and two zero words: against the
    host's scalar multiples at Z = 1."""
    got = tables[0].mult[j * 64 + w]
    assert got.shape == (8, 32) and not got[:, 30:].any()
    base = _bases()[j]
    for k in range(1, 9):
        pt = base.scalar_mul(Scalar(k * 16 ** w % ELL))
        niels = C.to_niels(torch.as_tensor(C.points_to_lanes(
            C.normalized([pt]))))
        want = torch.cat([F.canonicalize(c.to(torch.int64)) for c in niels])
        assert torch.equal(got[k - 1, :30].to(torch.int64), want[:, 0])


@pytest.fixture(scope="module")
def round_tables():
    """Tables over 2N + 2 = 6 bases (N = 2) and round 0's row maps as
    prover_stages._emit_lr reads them (sel_l, sel_r)."""
    r = random.Random(62)
    bases = [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
             for _ in range(6)]
    emit, _ = PS._dyn_round_maps(2)
    return bases, FM.FixedBaseTables(bases, "cpu"), emit[0]


def _direct_case(case, tables, round_tables):
    """-> (bases, tables, row map (numpy; None: every row), digits (S, Q)
    int8 numpy, splits) of one case of the direct form."""
    g = np.random.default_rng(63 + len(case))
    full = tables[0]
    if case.startswith("round"):
        bases, full, em = round_tables
        sel = em["sel_l" if case == "round_l" else "sel_r"]
        digits = g.integers(-7, 9, (len(sel), 16)).astype(np.int8)
        return bases, full, sel, digits, None
    S, Q, splits, sel = {"split1": (NB * 64, 8, 1, None),
                         "split2": (150, 16, 2, True),
                         "split40": (40 * 32, 2, None, True),
                         "zeros": (300, 33, 7, True),
                         "empty_chunks": (100, 45, 40, True)}[case]
    if sel:
        sel = g.integers(0, NB * 64, S)
    digits = g.integers(-7, 9, (S, Q)).astype(np.int8)
    if case == "zeros":
        digits[:, 5] = 0                     # a whole lane
        digits[100:180] = 0                  # a run of rows
    return _bases(), full, sel, digits, splits


@pytest.mark.parametrize("case", ["split1", "split2", "split40", "zeros",
                                  "empty_chunks", "round_l", "round_r"])
def test_direct_form_matches_host(tables, round_tables, case):
    """K6's direct form (plain) and K7's chunk merge against the host MSM
    of every lane: splits 1, 2 and 40 (pick_splits' own, at 2 lanes), a
    zero lane and a zero run of rows (split 7: a short last chunk), 45
    lanes in 40 chunks of 3 rows of which the last 6 are empty, and round
    0's L / R row maps of the full tables at N = 2."""
    bases, full, sel, digits, splits = _direct_case(case, tables,
                                                    round_tables)
    rows = None if sel is None else torch.as_tensor(np.asarray(sel))
    dig = torch.as_tensor(digits)
    if splits is None:
        slab = FM.accumulate_direct(full.mult, dig, rows)
        splits = FM.pick_splits(len(digits), digits.shape[1],
                                FM.TARGET_THREADS_DIRECT)
    else:
        slab = FM._accumulate_direct_plain(full.mult, dig, rows, splits)
    assert slab.shape == (splits, 1, 4, 10, digits.shape[1])
    rsel = np.arange(len(digits)) if sel is None else sel
    assert _compressed(FM.reduce(slab)) == _host_lanes(rsel, digits, bases)


def test_direct_entry_counts_rows_and_matches_one_hot(tables):
    """msm_digits_niels(consttime=False) over a row map (TableRows) gives
    the one-hot form's points on the same rows, and with the recorder on
    counts its rows x lanes as `fixed_direct_rows` in the open span."""
    port = tables[0]
    sel = torch.as_tensor(np.random.default_rng(64).integers(0, NB * 64, 90))
    dig = torch.as_tensor(np.random.default_rng(65).integers(
        -7, 9, (90, 12)).astype(np.int8))
    tracing.reset()
    tracing.enable()
    try:
        with tracing.span("prove"):
            got = FM.msm_digits_niels(port.table_rows(sel), dig,
                                      consttime=False)
    finally:
        tracing.disable()
    counts = dict(tracing.records()[0].counts)
    tracing.reset()
    assert counts == {"fixed_direct_rows": 90 * 12}
    want = FM.msm_digits_niels(port.table_rows(sel), dig)
    assert _compressed(got) == _compressed(want)
