"""The plain reference: its primitives against outside witnesses
(hashlib, RFC 9496's encodings, merlin's test vector), its proofs against
the port's CPU route byte for byte, and its imports: nothing of the
program, of JAX or of the JAX package."""

import ast
import hashlib
import os
import random
import subprocess
import sys

import pytest
from conftest import REPO

from portbench.reference import curve as C
from portbench.reference import merlin as M
from portbench.reference import rangeproof as R


def _sha3_256(msg: bytes) -> bytes:
    rate, st = 136, bytes(200)
    m = bytearray(msg) + b"\x06"
    while len(m) % rate:
        m += b"\x00"
    m[-1] |= 0x80
    for i in range(0, len(m), rate):
        blk = bytes(m[i: i + rate]) + bytes(200 - rate)
        st = M.keccak_f1600(bytes(a ^ b for a, b in zip(st, blk)))
    return st[:32]


@pytest.mark.parametrize("msg", [b"", b"abc", b"x" * 300])
def test_keccak_rebuilds_sha3(msg):
    assert _sha3_256(msg) == hashlib.sha3_256(msg).digest()


def test_merlin_test_vector():
    # merlin's tests.rs, equivalence_simple
    t = M.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")


def test_ristretto_encodings_of_small_multiples():
    # RFC 9496 A.1: B, 2B, 3B
    want = ["e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
            "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
            "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259"]
    got, p = [], C.BASEPOINT
    for _ in range(3):
        got.append(C.encode(p).hex())
        p = C.add(p, C.BASEPOINT)
    assert got == want
    assert C.encode(C.IDENTITY) == bytes(32)


def test_msm_against_repeated_addition():
    r = random.Random(3)
    pts = [C.from_uniform_bytes(r.randbytes(64)) for _ in range(5)]
    ks = [r.randrange(40) for _ in range(5)]
    want = C.IDENTITY
    for k, p in zip(ks, pts):
        for _ in range(k):
            want = C.add(want, p)
    assert C.encode(C.msm(ks, pts)) == C.encode(want)
    big = [r.randrange(C.L) for _ in range(5)]
    neg = [(-k) % C.L for k in big]
    assert C.encode(C.add(C.msm(big, pts), C.msm(neg, pts))) == bytes(32)


def test_decode_inverts_encode_and_refuses_bad_encodings():
    r = random.Random(4)
    p = C.IDENTITY
    for _ in range(8):
        enc = C.encode(p)
        assert C.encode(C.decode(enc)) == enc
        p = C.add(p, C.from_uniform_bytes(r.randbytes(64)))
    # RFC 9496 A.2: non-canonical, negative and non-square encodings
    for bad in ["00ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff",
                "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
                "0100000000000000000000000000000000000000000000000000000000000000",
                "26948d35ca62e643e26a83177332e6b6afeb9d08e4268b650f1f5bbd8d81d371"]:
        assert C.decode(bytes.fromhex(bad)) is None
    assert C.decode(bytes(31)) is None


def test_combination_is_the_weighted_sum_of_the_points():
    """The generators' coefficients that a replay's secrets give equal,
    under any weights, the weighted sum of the proof's own points; a
    point moved by B breaks the equality."""
    from portbench import check
    n, m = 8, 2
    rnd = random.Random(5)
    gens = R.Generators(n, m)
    vals = [rnd.randrange(1 << n) for _ in range(m)]
    blinds = [rnd.randrange(R.L) for _ in range(m)]
    key = rnd.randbytes(32)
    draws = R.draws(key, 1, n * m, [0])[0]
    whole = R.prove(gens, vals, blinds, draws, check.transcript(b"c", 0))
    rounds = (n * m).bit_length() - 1
    pts = check.parse(whole["proof"], whole["V"], rounds)
    rep = R.prove(gens, vals, blinds, draws, check.transcript(b"c", 0),
                  points=pts)
    w = check.weights(key, 0, m, rounds)
    acc = {"G": [0] * (n * m), "H": [0] * (n * m), "B": 0, "B_blinding": 0}
    R.combination(rep["secrets"], w, acc)
    want = C.msm(acc["G"] + acc["H"] + [acc["B"], acc["B_blinding"]],
                 gens.G + gens.H + [gens.B, gens.B_blinding])
    pairs = ([(w[k], pts[k]) for k in ("A", "S", "T_1", "T_2")]
             + list(zip(w["V"], pts["V"])) + list(zip(w["L"], pts["L"]))
             + list(zip(w["R"], pts["R"])))
    got = C.msm([x for x, _ in pairs], [C.decode(e) for _, e in pairs])
    assert C.encode(got) == C.encode(want)
    moved = C.msm([x for x, _ in pairs] + [w["L"][1]],
                  [C.decode(e) for _, e in pairs] + [gens.B])
    assert C.encode(moved) != C.encode(want)


def test_chacha_rfc8439_block():
    # RFC 8439 2.3.2: key 00..1f, nonce 000000090000004a00000000, counter 1;
    # nonce 0 here, so check the all-zero key's block 0 (2.4.2's "A.1 #1")
    out = R.chacha_blocks(bytes(32), __import__("numpy").array([0]))
    assert out[0].tobytes().hex().startswith(
        "76b8e0ada0f13d90405d6ae55386bd28bdd219b8a08ded1aa836efcc8b770dc7")


@pytest.mark.parametrize("n,m,count", [(8, 2, 3), (8, 1, 2)])
def test_reference_equals_the_ports_cpu_route(n, m, count):
    """Whole proofs, value commitments and transcript states, and the
    replay of the port's points, equal the port's bytes."""
    from bulletproofs_tpu_torch import (BatchProver, BulletproofGens,
                                        PedersenGens, Scalar, Transcript)
    rnd = random.Random(n * 100 + m)
    vals = [[rnd.randrange(1 << n) for _ in range(m)] for _ in range(count)]
    blinds = [[rnd.randrange(R.L) for _ in range(m)] for _ in range(count)]
    key = rnd.randbytes(32)

    class Key:
        def randbytes(self, k):
            assert k == 32
            return key
    bp = BatchProver(BulletproofGens(n, m), PedersenGens(), n, m, device="cpu")
    ts = []
    for i in range(count):
        t = Transcript(b"reference test")
        t.append_u64(b"statement", 40 + i)
        ts.append(t)
    if m == 1:
        proofs, vcs = bp.prove_batch([v[0] for v in vals],
                                     [Scalar(b[0]) for b in blinds], ts, rng=Key())
        vcs = [[v] for v in vcs]
    else:
        proofs, vcs = bp.prove_batch(vals, [[Scalar(b) for b in bs]
                                            for bs in blinds], ts, rng=Key())
    gens = R.Generators(n, m)
    draws = R.draws(key, count, n * m, range(count))
    from portbench import check
    for p in range(count):
        want = (proofs[p].to_bytes(), vcs[p], ts[p].strobe.buf.raw[:203])
        own = R.prove(gens, vals[p], blinds[p], draws[p],
                      check.transcript(b"reference test", 40 + p))
        assert (own["proof"], own["V"], own["state"]) == want
        pts = check.parse(want[0], vcs[p], (n * m).bit_length() - 1)
        replay = R.prove(gens, vals[p], blinds[p], draws[p],
                         check.transcript(b"reference test", 40 + p), points=pts)
        assert (replay["proof"], replay["state"]) == (want[0], want[2])


FORBIDDEN = ("jax", "jaxlib", "flax", "bulletproofs_tpu",
             "bulletproofs_tpu_torch")


def test_reference_imports_nothing_of_the_program():
    """In a fresh interpreter, the reference and the comparison load no
    module of the program, of JAX or of the JAX package (top-level names
    compared whole), and their sources import none."""
    code = ("import sys; import portbench.reference.rangeproof, "
            "portbench.check; print(sorted({m.split('.')[0] for m in "
            "sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN)
    assert "torch" not in loaded
    ref = os.path.join(REPO, "portbench", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, name)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                else:
                    continue
                assert not {x.split(".")[0] for x in mods} & set(FORBIDDEN)
