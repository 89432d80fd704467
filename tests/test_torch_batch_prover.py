"""The PyTorch port's m = 1 batch prover as a whole
(BatchProver(device="cpu"): plain PyTorch versions of its kernels) on
both its routes, the per-stage one and the device-transcript one (the
default), against the JAX package's BatchProver(force_device=True), and
against the port's own verifiers.

For fewer than 1024 proofs the JAX package's device routes (the
per-stage route, and the device-transcript route that force_device runs)
draw the same ChaCha key from the
rng and make the same transcript bytes, so the port must give
byte-identical proofs, value commitments and post-prove transcript
states on either route.  Inputs come from seeded generators."""

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


def _port_prover(n, fused):
    prover = T.BatchProver(T_BP, T_PC, n, device="cpu")
    prover.fused = fused
    return prover


@pytest.fixture(scope="module")
def both_n8():
    """n = 8, 3 proofs on the same inputs: (port on its per-stage route,
    jax, port on its device-transcript route) results."""
    port = _prove(T, _port_prover(8, False), 8, 3, 61)
    jp = JBatchProver(J_BP, J_PC, 8)
    jp.force_device = True
    return port, _prove(J, jp, 8, 3, 61), _prove(T, _port_prover(8, True), 8,
                                                 3, 61)


def test_proofs_byte_identical_to_jax(both_n8):
    (pp, _, _, _), (jp, _, _, _), _ = both_n8
    assert [p.to_bytes() for p in pp] == [p.to_bytes() for p in jp]


def test_value_commitments_identical_to_jax(both_n8):
    (_, pv, _, _), (_, jv, _, _), _ = both_n8
    assert pv == jv and len(pv) == 3


def test_transcripts_advance_as_jax(both_n8):
    (_, _, pts, _), (_, _, jts, _), _ = both_n8
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
    """A batch large enough for two interleaved halves of the per-stage
    route (the threshold lowered to 2) proves as two halves of 2 with one
    32-byte key each."""
    prover = _port_prover(8, False)
    prover.HALVES_FROM = 2
    values, blinds, labels = _inputs(8, 4, 63)
    rng = Rng(63)
    proofs, vcs = prover.prove_batch(values, [T.Scalar(b) for b in blinds],
                                     [T.Transcript(l) for l in labels],
                                     rng=rng)
    assert rng.r.randbytes(8) == Rng(63).r.randbytes(72)[64:]
    for p, v, l in zip(proofs, vcs, labels):
        p.verify_single(T_BP, T_PC, T.Transcript(l), v, 8)


def test_fused_route_byte_identical_to_jax(both_n8):
    """The device-transcript route (the default) on the same inputs and rng:
    proofs, commitments and post-prove transcripts equal the JAX
    package's, which ran its own device-transcript route."""
    (fp, fv, fts, _), (jp, jv, jts, _) = both_n8[2], both_n8[1]
    assert [p.to_bytes() for p in fp] == [p.to_bytes() for p in jp]
    assert fv == jv
    assert [t.strobe.buf.raw for t in fts] == [t.strobe.buf.raw for t in jts]
    assert [t.clone().challenge_bytes(b"after", 32) for t in fts] == \
        [t.clone().challenge_bytes(b"after", 32) for t in jts]


def test_default_route_is_the_device_transcript_one():
    prover = T.BatchProver(T_BP, T_PC, 8, device="cpu")
    assert prover.fused is True


@pytest.mark.parametrize("where", ["prove_rest", "second_half"])
def test_fused_route_restores_transcripts_on_error(where, monkeypatch):
    """An error part way through the device-transcript route propagates and
    leaves every caller transcript at its bytes before the call: raised
    in the device rest, or after the first of two halves has already
    written its transcripts back."""
    from bulletproofs_tpu_torch.ops import prover_stages as PS
    prover = _port_prover(8, True)
    values, blinds, labels = _inputs(8, 4, 64)
    ts = [T.Transcript(l) for l in labels]
    for t in ts:
        t.append_message(b"prior", b"content")
    before = [t.strobe.buf.raw for t in ts]
    if where == "prove_rest":
        def boom(*a):
            raise RuntimeError("rest failed")
        monkeypatch.setattr(PS, "prove_rest", boom)
    else:
        prover.FUSED_HALVES_FROM = 2
        real, calls = prover._assemble, []

        def assemble(*a):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("second half failed")
            return real(*a)
        monkeypatch.setattr(prover, "_assemble", assemble)
    with pytest.raises(RuntimeError):
        prover.prove_batch(values, [T.Scalar(b) for b in blinds], ts,
                           rng=Rng(64))
    assert [t.strobe.buf.raw for t in ts] == before


@pytest.mark.parametrize("count, keys", [(3, 1), (4, 2)])
def test_fused_route_draws_a_key_per_half(count, keys):
    """With the halves threshold at 4, the device-transcript route draws one
    32-byte key below it and two at it, and the proofs verify."""
    prover = _port_prover(8, True)
    prover.FUSED_HALVES_FROM = 4
    values, blinds, labels = _inputs(8, count, 65)
    rng = Rng(65)
    proofs, vcs = prover.prove_batch(values, [T.Scalar(b) for b in blinds],
                                     [T.Transcript(l) for l in labels],
                                     rng=rng)
    assert rng.r.randbytes(8) == Rng(65).r.randbytes(32 * keys + 8)[-8:]
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
