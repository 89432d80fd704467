"""Aggregated range proofs (m > 1) on the PyTorch port: the batch prover
(BatchProver(m=2, device="cpu"): plain PyTorch versions of its kernels),
on its per-stage route and on its device-transcript route (with K6's or
K12's plain version), against the JAX package's
BatchProver(force_device=True), and the chunked
verifier route (BatchVerifier, nm above fused_verify_max_nm: K1, K10, K11,
K4) against the JAX package's _verify_native_chunked, on the same proofs
and rng bytes.

Compared exactly: proof bytes, value-commitment lists and transcript
states after proving; accept / reject and transcript bytes after the
verifier's replay.  The JAX reference runs share one module fixture (its
CPU compiles take minutes)."""

import random

import numpy as np
import pytest

import bulletproofs_tpu as J
from bulletproofs_tpu.config import settings as JSET
from bulletproofs_tpu.parallel import BatchVerifier as JBatchVerifier
from bulletproofs_tpu.proofs.batch_prover import BatchProver as JBatchProver

import bulletproofs_tpu_torch as T
from bulletproofs_tpu_torch.config import settings as TSET
from bulletproofs_tpu_torch.ops import fixed_msm as FM
from bulletproofs_tpu_torch.parallel.batch_verify import BatchVerifier

N_BITS, M_AGG, COUNT = 8, 2, 3
CHUNK_PTS = 28          # 14 dynamic points per proof: 2 proofs per chunk

T_BP, T_PC = T.BulletproofGens(N_BITS, 4), T.PedersenGens()
J_BP, J_PC = J.BulletproofGens(N_BITS, 4), J.PedersenGens()


class Rng:
    def __init__(self, seed):
        self.r = random.Random(seed)

    def randbytes(self, n):
        return self.r.randbytes(n)


def _inputs(n, m, count, seed):
    g = np.random.default_rng(seed)
    values = [[int(v) for v in g.integers(0, 1 << n, m, dtype=np.uint64)]
              for _ in range(count)]
    values[0][0], values[-1][-1] = 0, (1 << n) - 1
    blinds = [[int.from_bytes(g.integers(0, 256, 64, np.uint8).tobytes(),
                              "little") for _ in range(m)]
              for _ in range(count)]
    labels = [b"torch aggregated %d" % i for i in range(count)]
    return values, blinds, labels


def _prove(pkg, prover, n, m, count, seed):
    values, blinds, labels = _inputs(n, m, count, seed)
    ts = [pkg.Transcript(l) for l in labels]
    proofs, vcs = prover.prove_batch(
        values, [[pkg.Scalar(b) for b in bs] for bs in blinds], ts,
        rng=Rng(seed))
    return proofs, vcs, ts, labels


def _jax_chunked(wires, vcss, labels, seed):
    """JAX _verify_native_chunked -> (accepted, transcript bytes after)."""
    bv = JBatchVerifier(J_BP, J_PC, n=N_BITS, m=M_AGG)
    ts = [J.Transcript(l) for l in labels]
    old = JSET.verify_chunk_pts
    JSET.verify_chunk_pts = CHUNK_PTS
    try:
        bv._verify_native_chunked([J.RangeProof.from_bytes(w) for w in wires],
                                  vcss, ts, Rng(seed))
        ok = True
    except J.ProofError:
        ok = False
    finally:
        JSET.verify_chunk_pts = old
    return ok, [t.challenge_bytes(b"after", 32) for t in ts]


def _tampered(wires, vcss):
    bad = bytearray(wires[1])
    bad[128] ^= 1                                     # low byte of t_x
    return {"flipped": ([wires[0], bytes(bad), wires[2]], vcss),
            "swapped": (wires, [vcss[0], vcss[1][::-1], vcss[2]])}


def _port_prover(fused):
    prover = T.BatchProver(T_BP, T_PC, N_BITS, m=M_AGG, device="cpu")
    prover.fused = fused
    return prover


@pytest.fixture(scope="module")
def runs():
    """The port's (per-stage route) and JAX's proofs of the same
    statements, and the JAX chunked verifier on the port's proofs: valid,
    flipped, swapped."""
    port = _prove(T, _port_prover(False), N_BITS, M_AGG, COUNT, 71)
    jp = JBatchProver(J_BP, J_PC, N_BITS, m=M_AGG)
    jp.force_device = True
    jax_run = _prove(J, jp, N_BITS, M_AGG, COUNT, 71)
    wires = [p.to_bytes() for p in port[0]]
    cases = {"valid": (wires, port[1])}
    cases.update(_tampered(wires, port[1]))
    jverify = {k: _jax_chunked(w, v, port[3], 72) for k, (w, v) in
               cases.items()}
    return port, jax_run, cases, jverify


def _port_chunked(wires, vcss, labels, seed, monkeypatch):
    """The port's BatchVerifier on its chunked route -> (accepted,
    transcript bytes after, number of chunks)."""
    monkeypatch.setattr(TSET, "verify_chunk_pts", CHUNK_PTS)
    monkeypatch.setattr(TSET, "fused_verify_max_nm", N_BITS * M_AGG - 1)
    bv = BatchVerifier(T_BP, T_PC, n=N_BITS, m=M_AGG, device="cpu")
    chunks = []
    real_prep = bv.prep
    monkeypatch.setattr(bv, "prep", lambda *a: chunks.append(1) or
                        real_prep(*a))
    ts = [T.Transcript(l) for l in labels]
    try:
        bv.verify_batch([T.RangeProof.from_bytes(w) for w in wires], vcss, ts,
                        rng=Rng(seed))
        ok = True
    except T.ProofError:
        ok = False
    return ok, [t.challenge_bytes(b"after", 32) for t in ts], len(chunks)


def test_proofs_byte_identical_to_jax(runs):
    (pp, _, _, _), (jp, _, _, _), _, _ = runs
    assert [p.to_bytes() for p in pp] == [p.to_bytes() for p in jp]


def test_value_commitment_lists_identical_to_jax(runs):
    (_, pv, _, _), (_, jv, _, _), _, _ = runs
    assert pv == jv
    assert len(pv) == COUNT and all(len(v) == M_AGG for v in pv)


def test_transcripts_advance_as_jax(runs):
    (_, _, pts, _), (_, _, jts, _), _, _ = runs
    assert [t.strobe.buf.raw for t in pts] == [t.strobe.buf.raw for t in jts]


def test_proofs_verify_multiple_on_the_port(runs):
    proofs, vcs, _, labels = runs[0]
    for p, v, l in zip(proofs, vcs, labels):
        p.verify_multiple(T_BP, T_PC, T.Transcript(l), v, N_BITS)


@pytest.mark.parametrize("case", ["valid", "flipped", "swapped"])
def test_chunked_verify_matches_jax(runs, case, monkeypatch):
    """Same accept / reject and the same post-replay transcript bytes as
    the JAX chunked route, over two chunks."""
    labels = runs[0][3]
    wires, vcss = runs[2][case]
    ok, ts, chunks = _port_chunked(wires, vcss, labels, 72, monkeypatch)
    jok, jts = runs[3][case]
    assert chunks == 2
    assert ok is jok is (case == "valid")
    assert ts == jts


def test_chunked_and_fused_routes_agree(runs, monkeypatch):
    """The port's two routes accept the same batch and leave the same
    transcripts (both draw 128 rng bytes per proof in proof order)."""
    proofs, vcs, _, labels = runs[0]
    wires = [p.to_bytes() for p in proofs]
    chunked = _port_chunked(wires, vcs, labels, 73, monkeypatch)
    monkeypatch.setattr(TSET, "fused_verify_max_nm", 256)
    ts = [T.Transcript(l) for l in labels]
    BatchVerifier(T_BP, T_PC, n=N_BITS, m=M_AGG, device="cpu").verify_batch(
        proofs, vcs, ts, rng=Rng(73))
    assert chunked[0] is True
    assert chunked[1] == [t.challenge_bytes(b"after", 32) for t in ts]


@pytest.mark.parametrize("ilp2", [True, False])
def test_fused_route_byte_identical_to_jax(runs, ilp2, monkeypatch):
    """The device-transcript route (its segmented rest: prove_mid_fused,
    round_step_fused, prove_fin_fused), its fixed-base MSMs through K6's
    or, under _ILP2, K12's plain version, on the same inputs and rng:
    proofs, commitment lists and transcripts equal the JAX package's."""
    monkeypatch.setattr(FM, "_ILP2", ilp2)
    fp, fv, fts, _ = _prove(T, _port_prover(True), N_BITS, M_AGG, COUNT, 71)
    jp, jv, jts, _ = runs[1]
    assert [p.to_bytes() for p in fp] == [p.to_bytes() for p in jp]
    assert fv == jv
    assert [t.strobe.buf.raw for t in fts] == [t.strobe.buf.raw for t in jts]


def test_m4_on_the_port_alone():
    proofs, vcs, _, labels = _prove(
        T, T.BatchProver(T_BP, T_PC, N_BITS, m=4, device="cpu"), N_BITS, 4,
        2, 74)
    for p, v, l in zip(proofs, vcs, labels):
        assert len(v) == 4
        p.verify_multiple(T_BP, T_PC, T.Transcript(l), v, N_BITS)


def test_rejects_statements_of_the_wrong_size():
    prover = T.BatchProver(T_BP, T_PC, N_BITS, m=M_AGG, device="cpu")
    with pytest.raises(ValueError):
        prover.prove_batch([[1, 2, 3]], [[T.Scalar(1)] * 3],
                           [T.Transcript(b"x")])
    with pytest.raises(ValueError):
        prover.prove_batch([[1, 256]], [[T.Scalar(1)] * 2],
                           [T.Transcript(b"x")])
