"""The PyTorch port's R1CS prover and verifier against the JAX package's, on
the k-shuffle gadget (the JAX package's tests/test_r1cs.py:29-49; the port
keeps its copy in benches/shuffle.py).

Compared exactly: proof bytes and commitments (same values, same rng),
verdicts, and the verifier transcripts' bytes after verification, on the
Python, the native (C++ vector stages) and the device route (the port's
mega-MSM on device="cpu": the plain PyTorch versions of K1, K10, K11,
K4a and K4b), and the device route's verdicts against the JAX package's
`_device_msm_is_identity` on the same inputs."""

import random

import pytest
import torch

import bulletproofs_tpu as J
from bulletproofs_tpu.errors import R1CSError as JR1CSError
from bulletproofs_tpu.proofs import r1cs as JR
from bulletproofs_tpu.proofs.r1cs import prover as JPM
from bulletproofs_tpu.proofs.r1cs import verifier as JVM
from test_r1cs import shuffle_gadget as jax_shuffle_gadget

import bulletproofs_tpu_torch as T
from bulletproofs_tpu_torch.benches import shuffle as SH
from bulletproofs_tpu_torch.config import settings
from bulletproofs_tpu_torch.proofs import r1cs as TR
from bulletproofs_tpu_torch.proofs.r1cs import prover as TPM
from bulletproofs_tpu_torch.proofs.r1cs import verifier as TVM

J_PC, J_BP = J.PedersenGens(), J.BulletproofGens(128, 1)
T_PC, T_BP = T.PedersenGens(), T.BulletproofGens(128, 1)
LABEL = b"port r1cs shuffle"


class Rng:
    def __init__(self, seed):
        self.r = random.Random(seed)

    def randbytes(self, n):
        return self.r.randbytes(n)


def port_prove(k, seed, tamper=False):
    return SH.prove_shuffle(T_PC, T_BP, LABEL,
                            *SH.shuffle_values(k, seed, tamper), Rng(seed))


def jax_prove(k, seed, tamper=False):
    """The same steps in the JAX package: batched commitments, the gadget,
    prove, with the same values and rng."""
    ins, outs = SH.shuffle_values(k, seed, tamper)
    rng = Rng(seed)
    p = JR.Prover(J_PC, J.Transcript(LABEL))
    pairs = p.commit_many([J.Scalar(s.v) for s in ins + outs],
                          [J.Scalar.random(rng) for _ in range(2 * k)])
    jax_shuffle_gadget(p, [v for _, v in pairs[:k]], [v for _, v in pairs[k:]])
    proof = p.prove(J_BP, rng=rng)
    return [c for c, _ in pairs[:k]], [c for c, _ in pairs[k:]], proof


def port_verify(ins, outs, proof_bytes, seed):
    """-> (accepted, transcript bytes after)."""
    v = SH.shuffle_verifier(LABEL, ins, outs)
    try:
        v.verify(TR.R1CSProof.from_bytes(proof_bytes), T_PC, T_BP,
                 rng=Rng(seed), device="cpu")
        ok = True
    except T.R1CSError:
        ok = False
    return ok, v._transcript.strobe.buf.raw


def jax_verify(ins, outs, proof_bytes, seed):
    v = JR.Verifier(J.Transcript(LABEL))
    jax_shuffle_gadget(v, v.commit_many(ins), v.commit_many(outs))
    try:
        v.verify(JR.R1CSProof.from_bytes(proof_bytes), J_PC, J_BP,
                 rng=Rng(seed))
        ok = True
    except JR1CSError:
        ok = False
    return ok, v._transcript.strobe.buf.raw


@pytest.mark.parametrize("path", ["python", "native"])
def test_proofs_byte_identical_to_jax(path, monkeypatch):
    if path == "native":
        monkeypatch.setattr(TPM, "_NATIVE_MIN_N", 4)
        monkeypatch.setattr(JPM, "_NATIVE_MIN_N", 4)
    for k, seed in ((4, 1), (9, 2)):
        ti, to, tp = port_prove(k, seed)
        ji, jo, jp = jax_prove(k, seed)
        assert (ti, to) == (ji, jo)
        assert tp.to_bytes() == jp.to_bytes()


@pytest.mark.parametrize("route", ["python", "native", "device"])
def test_verdicts_and_transcripts_agree_with_jax(route, monkeypatch):
    """A valid k = 9 and a tampered k = 5 shuffle.  python: the Scalar
    path; native: the C++ vector stages and the host C++ mega-MSM (both
    packages); device: the port's device mega-MSM on device="cpu" against
    the JAX package's native route."""
    if route != "python":
        monkeypatch.setattr(TVM, "_NATIVE_MIN_N", 8)
        monkeypatch.setattr(JVM, "_NATIVE_MIN_N", 8)
    calls = []
    if route == "device":
        monkeypatch.setattr(settings, "r1cs_device_msm_floor", 8)
        real = TVM._device_msm_is_identity
        monkeypatch.setattr(TVM, "_device_msm_is_identity",
                            lambda *a: calls.append(a[-1]) or real(*a))
    for k, seed, tamper, want in ((9, 3, False, True), (5, 4, True, False)):
        ins, outs, proof = port_prove(k, seed, tamper)
        got = port_verify(ins, outs, proof.to_bytes(), seed + 10)
        ref = jax_verify(ins, outs, proof.to_bytes(), seed + 10)
        assert got == ref
        assert got[0] is want
    assert calls == ([torch.device("cpu")] * 2 if route == "device" else [])


def test_device_route_on_cpu(monkeypatch):
    """tests/test_r1cs.py:325-347 on the port: the device route accepts
    k = 9, rejects a tampered k = 5, and batch_verify takes it over mixed
    sizes (one tampered member poisons the batch)."""
    monkeypatch.setattr(TVM, "_NATIVE_MIN_N", 8)
    monkeypatch.setattr(settings, "r1cs_device_msm_floor", 8)
    calls = []
    real = TVM._device_msm_is_identity
    monkeypatch.setattr(TVM, "_device_msm_is_identity",
                        lambda *a: calls.append(a[2]) or real(*a))
    ins, outs, proof = port_prove(9, 5)
    SH.shuffle_verifier(LABEL, ins, outs).verify(proof, T_PC, T_BP,
                                                 rng=Rng(6), device="cpu")
    ins, outs, proof = port_prove(5, 7, tamper=True)
    with pytest.raises(T.R1CSError):
        SH.shuffle_verifier(LABEL, ins, outs).verify(proof, T_PC, T_BP,
                                                     rng=Rng(8), device="cpu")

    def items(spec):
        out = []
        for k, seed, tamper in spec:
            ins, outs, proof = port_prove(k, seed, tamper)
            out.append((SH.shuffle_verifier(LABEL, ins, outs), proof))
        return out

    # a Python-path proof (k = 3, padded 4) first: a batch that ENDS with
    # one folds the byte accumulators back and takes the Scalar MSM
    TR.batch_verify(items([(3, 13, False), (9, 11, False), (17, 12, False)]),
                    T_PC, T_BP, rng=Rng(14), device="cpu")
    with pytest.raises(T.R1CSError):
        TR.batch_verify(items([(9, 15, False), (9, 16, True)]), T_PC, T_BP,
                        rng=Rng(17), device="cpu")
    # padded multiplier counts: k = 9 -> 16, k = 5 -> 8; the batches'
    # accumulators 32 and 16
    assert calls == [16, 8, 32, 16]


def test_device_msm_verdicts_match_jax():
    """The port's _device_msm_is_identity (device="cpu") and the JAX
    package's, on one proof's mega-MSM inputs: valid; a wrong B scalar;
    an undecodable head point; an undecodable tail point whose scalar is
    0, so the MSM alone is the identity (the verdict is valid AND
    identity).  The extra tail point of the other cases is the identity's
    encoding with scalar 0."""
    TVM._NATIVE_MIN_N, old = 8, TVM._NATIVE_MIN_N
    try:
        ins, outs, proof = port_prove(9, 18)
        v = SH.shuffle_verifier(LABEL, ins, outs)
        ds, dc, bs, bbs, gs, hs, pn = v.verification_scalars(proof, T_BP,
                                                             Rng(19))
    finally:
        TVM._NATIVE_MIN_N = old
    assert isinstance(gs, TVM.PackedScalarVec)
    k = len(dc) - 2 * len(proof.ipp_proof.L_vec)
    head_sc = b"".join(s.to_bytes() for s in ds[:k])
    tail_sc = b"".join(s.to_bytes() for s in ds[k:]) + bytes(32)
    bb = bs.to_bytes() + bbs.to_bytes()
    bad_bb = (bs + T.Scalar.one()).to_bytes() + bbs.to_bytes()
    garbage = b"\xff" * 32
    cases = [(dc[:k], bb, dc[k:] + [bytes(32)], True),
             (dc[:k], bad_bb, dc[k:] + [bytes(32)], False),
             ([garbage] + dc[1:k], bb, dc[k:] + [bytes(32)], False),
             (dc[:k], bb, dc[k:] + [garbage], False)]
    for head, bbsc, tail, want in cases:
        got = TVM._device_msm_is_identity(
            T_BP, T_BP.share(0), pn, head, head_sc, [T_PC.B, T_PC.B_blinding],
            bbsc, gs.raw + hs.raw, tail, tail_sc, torch.device("cpu"))
        ref = JVM._device_msm_is_identity(
            J_BP, J_BP.share(0), pn, head, head_sc, [J_PC.B, J_PC.B_blinding],
            bbsc, gs.raw + hs.raw, tail, tail_sc)
        assert got is ref is want


def test_verifier_is_one_shot():
    ins, outs, proof = port_prove(4, 20)
    v = SH.shuffle_verifier(LABEL, ins, outs)
    v.verify(proof, T_PC, T_BP, rng=Rng(21), device="cpu")
    with pytest.raises(RuntimeError):
        v.verify(proof, T_PC, T_BP, rng=Rng(21), device="cpu")
    SH.shuffle_verifier(LABEL, ins, outs).verify(proof, T_PC, T_BP,
                                                 rng=Rng(21), device="cpu")


def test_default_device_is_cuda():
    """Without a card, the default device raises before the verifier's
    transcript is touched (no fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ins, outs, proof = port_prove(4, 22)
    v = SH.shuffle_verifier(LABEL, ins, outs)
    with pytest.raises(RuntimeError):
        v.verify(proof, T_PC, T_BP, rng=Rng(23))
    with pytest.raises(RuntimeError):
        TR.batch_verify([(v, proof)], T_PC, T_BP, rng=Rng(23))
    v.verify(proof, T_PC, T_BP, rng=Rng(23), device="cpu")


def test_module_surface_matches_jax():
    assert sorted(TR.__all__) == sorted(JR.__all__)
    assert T.r1cs is TR and T.R1CSError is T.errors.R1CSError
    assert T.range_proof_mpc.__all__ == J.range_proof_mpc.__all__


def _flatten_gadget(mod, scalar, transcript, commitments):
    """A verifier of `mod` with committed variables, multipliers, allocated
    variables and constants in its constraints (every kind of term, a
    variable twice in one constraint), before any randomized phase."""
    v = mod.Verifier(transcript(b"port r1cs flatten"))
    a, b, c = v.commit_many(commitments)
    l, r, o = v.multiply(a - scalar(3), b + a + a)
    v.constrain(o - c * scalar(5) + scalar(7))
    x, y, _ = v.multiply(l + r, c * scalar(2) - 1)
    v.constrain(x - y)
    p = v.allocate()
    q = v.allocate()
    v.constrain(p + q - o)
    return v


def test_flattened_constraints_equal_jax():
    """The verifier's compact constraint store folds to the JAX verifier's
    weights: the Scalar form and the packed form, the padding included."""
    ins, _, _ = port_prove(3, 24)
    tv = _flatten_gadget(TVM, T.Scalar, T.Transcript, ins)
    jv = _flatten_gadget(JVM, J.Scalar, J.Transcript, ins)
    z = 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321
    got = tv.flattened_constraints(T.Scalar(z))
    want = jv.flattened_constraints(J.Scalar(z))
    for g, w in zip(got[:4], want[:4]):
        assert [s.v for s in g] == [s.v for s in w]
    assert got[4].v == want[4].v
    assert tv.flattened_constraints_packed(T.Scalar(z), 8)[:3] \
        == jv.flattened_constraints_packed(J.Scalar(z), 8)[:3]
