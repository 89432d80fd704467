"""Decode-path fuzzing of the port against the JAX package (tests/
test_fuzz_decode.py, without its 200-trial loop): 16 seeded mutations each
of the Rust crate's golden range proof, a linear proof and an R1CS proof
get the same verdict in both packages (a rejection, with the same error
class and message), and truncated or extended proofs raise the same
error in both."""

import importlib
import json
import os
import random

import pytest

PACKAGES = ("bulletproofs_tpu", "bulletproofs_tpu_torch")
TRIALS = 16


class Rng:
    def __init__(self, seed):
        self.r = random.Random(seed)

    def randbytes(self, n):
        return self.r.randbytes(n)


def _golden():
    path = os.path.join(os.path.dirname(__file__), "golden_vectors.json")
    gv = json.load(open(path))
    return (bytes.fromhex(gv["proofs"][0][0]),
            [bytes.fromhex(h) for h in gv["value_commitments"]][:1])


def _device(root):
    """The port's verifiers take the torch device; the JAX package's none."""
    return {"device": "cpu"} if root.endswith("_torch") else {}


def _verdict(root, check):
    """check() -> "accepted", or the class name and message of the
    ProofError / R1CSError it raised (anything else propagates)."""
    E = importlib.import_module(root + ".errors")
    try:
        check()
    except (E.ProofError, E.R1CSError) as e:
        return type(e).__name__, str(e)
    return "accepted"


def _mutations(pbytes, seed):
    rr = random.Random(seed)
    out = []
    for _ in range(TRIALS):
        mutated = bytearray(pbytes)
        for _ in range(rr.randrange(1, 4)):
            mutated[rr.randrange(len(mutated))] ^= 1 << rr.randrange(8)
        out.append(bytes(mutated))
    return out


def _same_rejections(verifiers, mutated):
    """Every mutated proof: the same verdict from each package's verifier,
    and never "accepted"."""
    for blob in mutated:
        got = [_verdict(root, lambda: verify(blob))
               for root, verify in verifiers.items()]
        assert got[0] == got[1] and got[0] != "accepted", (blob.hex(), got)


def _range_verifier(root):
    P = importlib.import_module(root)
    bp, pc = P.BulletproofGens(64, 8), P.PedersenGens()
    _, vcs = _golden()

    def verify(blob):
        P.RangeProof.from_bytes(blob).verify_multiple(
            bp, pc, P.Transcript(b"Deserialize-And-Verify Test"), vcs, 8,
            rng=Rng(24))
    return verify


def test_rangeproof_mutations_rejected_as_jax():
    pbytes, _ = _golden()
    verifiers = {root: _range_verifier(root) for root in PACKAGES}
    for verify in verifiers.values():
        verify(pbytes)                      # the golden proof verifies
    _same_rejections(verifiers, _mutations(pbytes, 1234))


@pytest.mark.parametrize("cut", [0, 1, 31, 32, 100, -1, "extend"])
def test_rangeproof_truncations_and_extensions_raise_as_jax(cut):
    pbytes, _ = _golden()
    blob = pbytes + bytes(32) if cut == "extend" else pbytes[:cut]
    got = []
    for root in PACKAGES:
        P = importlib.import_module(root)
        with pytest.raises(P.ProofError) as e:
            P.RangeProof.from_bytes(blob)
        got.append((type(e.value).__name__, str(e.value)))
    assert got[0] == got[1]


def _linear(root):
    """tests/test_fuzz_decode.py's n = 16 linear proof under Rng(24) ->
    (proof bytes, its verify(blob))."""
    P = importlib.import_module(root)
    R, U, LP = [importlib.import_module(f"{root}.{m}") for m in
                ("core.ristretto", "utils.util", "proofs.linear")]
    rng = Rng(24)
    n = 16
    pc = P.PedersenGens()
    G = P.BulletproofGens(64, 8).share(0).G(n)
    F, B = pc.B, pc.B_blinding
    a = [P.Scalar.random(rng) for _ in range(n)]
    b = [P.Scalar.random(rng) for _ in range(n)]
    r = P.Scalar.random(rng)
    C = R.multiscalar_mul(a + [r, U.inner_product(a, b)],
                          G + [B, F]).compress()
    proof = LP.LinearProof.create(P.Transcript(b"fuzz"), rng, C, r, list(a),
                                  list(b), list(G), F, B)

    def verify(blob):
        LP.LinearProof.from_bytes(blob).verify(
            P.Transcript(b"fuzz"), C, G, F, B, list(b), **_device(root))
    return proof.to_bytes(), verify


def test_linear_proof_mutations_rejected_as_jax():
    made = {root: _linear(root) for root in PACKAGES}
    (jbytes, _), (tbytes, tverify) = made.values()
    assert tbytes == jbytes
    tverify(tbytes)
    _same_rejections({root: v for root, (_, v) in made.items()},
                     _mutations(tbytes, 99))


def _r1cs(root):
    """tests/test_fuzz_decode.py's two-commitment R1CS proof under Rng(24)
    -> (proof bytes, its verify(blob), R1CSProof)."""
    P = importlib.import_module(root)
    R1 = importlib.import_module(root + ".proofs.r1cs")
    rng = Rng(24)
    pc, bp = P.PedersenGens(), P.BulletproofGens(8, 1)
    prover = R1.Prover(pc, P.Transcript(b"r1cs fuzz"))
    c1, v1 = prover.commit(P.Scalar(3), P.Scalar.random(rng))
    c2, v2 = prover.commit(P.Scalar(5), P.Scalar.random(rng))
    _, _, out = prover.multiply(v1 + v2, v1 - v2)
    prover.constrain(out + P.Scalar(16))
    proof = prover.prove(bp, rng=rng)

    def verify(blob):
        vf = R1.Verifier(P.Transcript(b"r1cs fuzz"))
        w1, w2 = vf.commit(c1), vf.commit(c2)
        _, _, vout = vf.multiply(w1 + w2, w1 - w2)
        vf.constrain(vout + P.Scalar(16))
        vf.verify(R1.R1CSProof.from_bytes(blob), pc, bp, rng=Rng(25),
                  **_device(root))
    return proof.to_bytes(), verify, R1.R1CSProof


def test_r1cs_proof_mutations_rejected_as_jax():
    made = {root: _r1cs(root) for root in PACKAGES}
    (jbytes, _, _), (tbytes, tverify, _) = made.values()
    assert tbytes == jbytes
    tverify(tbytes)
    _same_rejections({root: v for root, (_, v, _) in made.items()},
                     _mutations(tbytes, 99))


def test_r1cs_truncations_and_bad_version_raise_as_jax():
    made = {root: _r1cs(root) for root in PACKAGES}
    pbytes = made[PACKAGES[1]][0]
    for blob in [pbytes[:cut] for cut in (0, 1, 32, len(pbytes) - 1)] \
            + [bytes([0xFF]) + pbytes[1:]]:
        got = []
        for root, (_, _, proof_cls) in made.items():
            got.append(_verdict(root, lambda: proof_cls.from_bytes(blob)))
        assert got[0] == got[1] and got[0] != "accepted", (blob.hex(), got)
