"""The PyTorch port's m = 1 batch prover as a whole
(BatchProver(device="cpu"): plain PyTorch versions of kernels K5-K7)
against the JAX package's BatchProver(force_device=True), and against the
port's own verifiers.

For fewer than 1024 proofs the JAX package's device routes (the per-stage
route the port follows, and the default device route run here because it
compiles faster on the CPU) draw the same ChaCha key from the rng and
make the same transcript bytes, so the port must give byte-identical
proofs, value commitments and post-prove transcript states.  Inputs come
from seeded generators."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import bulletproofs_tpu as J
from bulletproofs_tpu.proofs.batch_prover import BatchProver as JBatchProver

import bulletproofs_tpu_torch as T
from bulletproofs_tpu_torch.parallel.batch_verify import BatchVerifier

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

T_BP, T_PC = T.BulletproofGens(64, 1), T.PedersenGens()
J_BP, J_PC = J.BulletproofGens(64, 1), J.PedersenGens()


class Rng:
    def __init__(self, seed):
        self.r = random.Random(seed)

    def randbytes(self, n):
        return self.r.randbytes(n)


def _inputs(n, count, seed):
    g = np.random.default_rng(seed)
    values = [0, (1 << n) - 1] + [int(v) for v in g.integers(
        0, 1 << n, count - 2, dtype=np.uint64)]
    blinds = [int.from_bytes(g.integers(0, 256, 64, np.uint8).tobytes(),
                             "little") for _ in range(count)]
    labels = [b"torch batch prove %d" % i for i in range(count)]
    return values[:count], blinds, labels


def _prove(pkg, prover, n, count, seed):
    values, blinds, labels = _inputs(n, count, seed)
    ts = [pkg.Transcript(l) for l in labels]
    proofs, vcs = prover.prove_batch(
        values, [pkg.Scalar(b) for b in blinds], ts, rng=Rng(seed))
    return proofs, vcs, ts, labels


@pytest.fixture(scope="module")
def both_n8():
    """n = 8, 3 proofs on the same inputs: (port, jax) results."""
    port = _prove(T, T.BatchProver(T_BP, T_PC, 8, device="cpu"), 8, 3, 61)
    jp = JBatchProver(J_BP, J_PC, 8)
    jp.force_device = True
    return port, _prove(J, jp, 8, 3, 61)


def test_proofs_byte_identical_to_jax(both_n8):
    (pp, _, _, _), (jp, _, _, _) = both_n8
    assert [p.to_bytes() for p in pp] == [p.to_bytes() for p in jp]


def test_value_commitments_identical_to_jax(both_n8):
    (_, pv, _, _), (_, jv, _, _) = both_n8
    assert pv == jv and len(pv) == 3


def test_transcripts_advance_as_jax(both_n8):
    (_, _, pts, _), (_, _, jts, _) = both_n8
    assert [t.strobe.buf.raw for t in pts] == [t.strobe.buf.raw for t in jts]
    assert [t.clone().challenge_bytes(b"after", 32) for t in pts] == \
        [t.clone().challenge_bytes(b"after", 32) for t in jts]


def test_proofs_verify_on_the_port(both_n8):
    """verify_single ends in the prover's transcript state, and the batch
    verifier accepts the batch and rejects a flipped byte."""
    proofs, vcs, ts, labels = both_n8[0]
    for p, v, t, l in zip(proofs, vcs, ts, labels):
        tv = T.Transcript(l)
        p.verify_single(T_BP, T_PC, tv, v, 8)
        assert tv.challenge_bytes(b"x", 32) == t.clone().challenge_bytes(b"x", 32)
    bv = BatchVerifier(T_BP, T_PC, n=8, m=1, device="cpu")
    bv.verify_batch(proofs, [[v] for v in vcs],
                    [T.Transcript(l) for l in labels], rng=Rng(1))
    bad = bytearray(proofs[1].to_bytes())
    bad[100] ^= 1
    with pytest.raises(T.ProofError):
        bv.verify_batch([proofs[0], T.RangeProof.from_bytes(bytes(bad))],
                        [[v] for v in vcs[:2]],
                        [T.Transcript(l) for l in labels[:2]], rng=Rng(2))


def test_n16_on_the_port_alone():
    proofs, vcs, _, labels = _prove(
        T, T.BatchProver(T_BP, T_PC, 16, device="cpu"), 16, 3, 62)
    for p, v, l in zip(proofs, vcs, labels):
        p.verify_single(T_BP, T_PC, T.Transcript(l), v, 16)
    BatchVerifier(T_BP, T_PC, n=16, m=1, device="cpu").verify_batch(
        proofs, [[v] for v in vcs], [T.Transcript(l) for l in labels],
        rng=Rng(3))


def test_halves_draw_a_key_each_and_verify():
    """A batch large enough for two interleaved halves (the threshold
    lowered to 2) proves as two halves of 2 with one 32-byte key each."""
    prover = T.BatchProver(T_BP, T_PC, 8, device="cpu")
    prover.HALVES_FROM = 2
    values, blinds, labels = _inputs(8, 4, 63)
    rng = Rng(63)
    proofs, vcs = prover.prove_batch(values, [T.Scalar(b) for b in blinds],
                                     [T.Transcript(l) for l in labels],
                                     rng=rng)
    assert rng.r.randbytes(8) == Rng(63).r.randbytes(72)[64:]
    for p, v, l in zip(proofs, vcs, labels):
        p.verify_single(T_BP, T_PC, T.Transcript(l), v, 8)


def test_rejects_out_of_range_and_unsupported():
    prover = T.BatchProver(T_BP, T_PC, 8, device="cpu")
    with pytest.raises(ValueError):
        prover.prove_batch([1 << 8], [T.Scalar(1)], [T.Transcript(b"x")])
    with pytest.raises(ValueError):
        prover.prove_batch([-1], [T.Scalar(1)], [T.Transcript(b"x")])
    with pytest.raises(T.MPCError):
        T.BatchProver(T_BP, T_PC, 12, device="cpu")
    with pytest.raises(T.MPCError):
        T.BatchProver(T.BulletproofGens(8, 4), T_PC, 8, m=3, device="cpu")


def test_default_device_is_cuda():
    """With no card, the default device raises instead of falling back."""
    if torch.cuda.is_available():
        assert T.BatchProver(T_BP, T_PC, 8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            T.BatchProver(T_BP, T_PC, 8)


def test_prover_path_imports_neither_jax_nor_the_jax_package():
    code = """
import random, sys
import bulletproofs_tpu_torch as T
class R:
    def __init__(s, seed): s.r = random.Random(seed)
    def randbytes(s, n): return s.r.randbytes(n)
rng = R(5)
bp, pc = T.BulletproofGens(8, 1), T.PedersenGens()
ps, vs = T.BatchProver(bp, pc, 8, device="cpu").prove_batch(
    [3, 200], [T.Scalar(7), T.Scalar(9)],
    [T.Transcript(b"iso"), T.Transcript(b"iso")], rng=rng)
ps[1].verify_single(bp, pc, T.Transcript(b"iso"), vs[1], 8)
bad = [k for k in sys.modules
       if k == "jax" or k.startswith("jax.") or k == "bulletproofs_tpu"
       or k.startswith("bulletproofs_tpu.")]
assert not bad, bad
print("isolated")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout
