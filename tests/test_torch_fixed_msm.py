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
from bulletproofs_tpu_torch.ops import curve as C
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


def test_plain_msm_matches_host(small_stream):
    """Row s = j * 64 + w holds 16^w Base_j: lane q is
    sum_s digit[s, q] 16^w_s Base_j_s."""
    sel, digits, _, out = small_stream
    bases = _bases()
    got = _compressed(out)
    for q in (0, 7, 128, 255):
        acc = [0] * NB
        for s, row in enumerate(sel):
            acc[row // 64] += int(digits[s, q]) * 16 ** (row % 64)
        ref = multiscalar_mul([Scalar(a % ELL) for a in acc], bases)
        assert got[q] == ref.compress()


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_splits_give_the_same_point(small_stream, tables, splits):
    """Any split of the stream into chunks sums to the same point (16
    lanes, so that pick_splits alone would choose a split of 1)."""
    sel, digits, _, out = small_stream
    niels = FM.StreamSubsetTables(tables[0], sel).niels
    slab = FM._accumulate_plain(niels, torch.as_tensor(digits[:, :16]), splits)
    assert slab.shape == (splits, 8, 4, 10, 16)
    assert _compressed(FM.reduce(slab)) == _compressed(out[..., :16])


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
    niels = tables[0].niels
    with pytest.raises(ValueError):
        FM.accumulate(niels, torch.zeros((10, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        FM.accumulate(torch.cat([niels, niels], dim=1),
                      torch.zeros((NB * 64, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        FM.reduce(torch.zeros((2, 9, 4, 10, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        FM.msm_digits_niels(niels, torch.zeros((64, 4), dtype=torch.int8))


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
