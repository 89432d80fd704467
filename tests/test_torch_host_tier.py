"""The port's host tier against the JAX package's, on the CPU: the
inner-product proof (tests/test_ipp.py), the generators (tests/
test_generators.py), Keccak / STROBE / Merlin (tests/test_transcript.py)
and the package's exported names.  Each case runs the same inputs through
both packages and requires the same bytes."""

import hashlib
import importlib
import random

import pytest

import bulletproofs_tpu as J
import bulletproofs_tpu_torch as T

PACKAGES = ("bulletproofs_tpu", "bulletproofs_tpu_torch")


def _mods(root, *names):
    return [importlib.import_module(f"{root}.{n}") for n in names]


def _compressed(points):
    return [p.compress() for p in points]


def _kind(x):
    """A module's last name, a class's name, else the value's class name."""
    if isinstance(x, type):
        return x.__name__
    if hasattr(x, "__path__") or hasattr(x, "__file__"):
        return x.__name__.rsplit(".", 1)[-1]
    return type(x).__name__


# -- exports --------------------------------------------------------------------

def test_every_jax_export_resolves_in_the_port():
    missing = [name for name in J.__all__ if not hasattr(T, name)]
    assert missing == []
    assert set(J.__all__) <= set(T.__all__)
    for name in J.__all__:
        assert _kind(getattr(T, name)) == _kind(getattr(J, name)), name
    assert T.BulletproofGensShare is type(T.BulletproofGens(8, 2).share(1))


# -- inner-product proof (tests/test_ipp.py) -------------------------------------

def _ipp(root, n):
    """tests/test_ipp.py's helper on `root` -> (proof bytes, P's bytes);
    the proof verifies before and after its byte round trip."""
    R, S, G_, U, I, TR = _mods(root, "core.ristretto", "core.scalar",
                               "generators", "utils.util", "proofs.ipp",
                               "transcript")
    rr = random.Random(n)
    bp_gens = G_.BulletproofGens(n, 1)
    G = bp_gens.share(0).G(n)
    H = bp_gens.share(0).H(n)
    Q = G_.GeneratorsChain(b"test point").take(1)[0]
    a = [S.Scalar(rr.randrange(S.L)) for _ in range(n)]
    b = [S.Scalar(rr.randrange(S.L)) for _ in range(n)]
    c = U.inner_product(a, b)
    y_inv = S.Scalar(rr.randrange(1, S.L))
    G_factors = [S.Scalar.one()] * n
    H_factors = U.exp_iter_take(y_inv, n)
    b_prime = [bi * yi for bi, yi in zip(b, H_factors)]
    P = R.multiscalar_mul(list(a) + b_prime + [c], G + H + [Q])

    proof = I.InnerProductProof.create(
        TR.Transcript(b"innerproducttest"), Q, G_factors, H_factors,
        list(G), list(H), list(a), list(b))
    for pr in (proof, I.InnerProductProof.from_bytes(proof.to_bytes())):
        pr.verify(n, TR.Transcript(b"innerproducttest"), [S.Scalar.one()] * n,
                  U.exp_iter_take(y_inv, n), P, Q, G, H)
    return proof.to_bytes(), P.compress()


@pytest.mark.parametrize("n", [1, 2, 4, 32, 64])
def test_ipp_proof_bytes_equal_jax(n):
    got = [_ipp(root, n) for root in PACKAGES]
    assert got[1] == got[0]
    assert len(got[1][0]) == 32 * (2 * (n.bit_length() - 1) + 2)


def _ipp_wrong_statement(root):
    """tests/test_ipp.py's wrong statement on `root` -> (proof bytes, the
    error's class name and message)."""
    S, G_, I, TR, E = _mods(root, "core.scalar", "generators", "proofs.ipp",
                            "transcript", "errors")
    n = 4
    rr = random.Random(7)
    bp_gens = G_.BulletproofGens(n, 1)
    G, H = bp_gens.share(0).G(n), bp_gens.share(0).H(n)
    Q = G_.GeneratorsChain(b"test point").take(1)[0]
    a = [S.Scalar(rr.randrange(S.L)) for _ in range(n)]
    b = [S.Scalar(rr.randrange(S.L)) for _ in range(n)]
    ones = [S.Scalar.one()] * n
    proof = I.InnerProductProof.create(TR.Transcript(b"innerproducttest"), Q,
                                       ones, ones, list(G), list(H), list(a),
                                       list(b))
    with pytest.raises(E.ProofError) as e:
        proof.verify(n, TR.Transcript(b"innerproducttest"), ones, ones, Q, Q,
                     G, H)
    return proof.to_bytes(), type(e.value).__name__, str(e.value)


def test_ipp_wrong_statement_fails_in_both():
    got = [_ipp_wrong_statement(root) for root in PACKAGES]
    assert got[1] == got[0]


# -- generators (tests/test_generators.py) ---------------------------------------

def test_pedersen_commit_equals_jax():
    pcs = [pkg.PedersenGens() for pkg in (J, T)]
    cs = [pc.commit(pkg.Scalar(5), pkg.Scalar(7))
          for pc, pkg in zip(pcs, (J, T))]
    pc = pcs[1]
    assert cs[1] == (pc.B.scalar_mul(T.Scalar(5))
                     + pc.B_blinding.scalar_mul(T.Scalar(7)))
    assert cs[1].compress() == cs[0].compress()
    assert _compressed([pc.B, pc.B_blinding]) \
        == _compressed([pcs[0].B, pcs[0].B_blinding])


def test_aggregated_gens_match_flat_map_and_jax():
    jbp, bp = J.BulletproofGens(64, 8), T.BulletproofGens(64, 8)
    for n, m in [(64, 8), (64, 4), (64, 2), (64, 1), (32, 2), (16, 4)]:
        assert bp.G(n, m) == [g for j in range(m) for g in bp.G_vec[j][:n]]
        assert bp.H(n, m) == [h for j in range(m) for h in bp.H_vec[j][:n]]
        assert _compressed(bp.G(n, m)) == _compressed(jbp.G(n, m))
        assert _compressed(bp.H(n, m)) == _compressed(jbp.H(n, m))


def test_resizing_matches_bigger_gens_and_jax():
    gens = T.BulletproofGens(64, 8)
    resized = [pkg.BulletproofGens(32, 8) for pkg in (J, T)]
    for r in resized:
        r.increase_capacity(64)
    for j in range(8):
        assert resized[1].G_vec[j] == gens.G_vec[j]
        assert resized[1].H_vec[j] == gens.H_vec[j]
        assert _compressed(resized[1].G_vec[j]) \
            == _compressed(resized[0].G_vec[j])
        assert _compressed(resized[1].H_vec[j]) \
            == _compressed(resized[0].H_vec[j])


def test_share_view_equals_jax():
    jbp, bp = J.BulletproofGens(16, 4), T.BulletproofGens(16, 4)
    for j in range(4):
        share = bp.share(j)
        assert isinstance(share, T.BulletproofGensShare)
        assert share.G(16) == bp.G_vec[j][:16]
        assert share.H(8) == bp.H_vec[j][:8]
        assert _compressed(share.G(16)) == _compressed(jbp.share(j).G(16))
        assert _compressed(share.H(8)) == _compressed(jbp.share(j).H(8))


@pytest.mark.parametrize("root", PACKAGES, ids=["jax", "torch"])
def test_commit_many_rejects_length_mismatch(root):
    P = importlib.import_module(root)
    rr = random.Random(3)
    pc = P.PedersenGens()
    vals = [P.Scalar(i + 1) for i in range(20)]
    blinds = [P.Scalar(rr.randrange(1, 1 << 250)) for _ in range(19)]
    with pytest.raises(ValueError):
        pc.commit_many(vals, blinds)
    with pytest.raises(ValueError):
        pc.commit_many(vals[:5], blinds[:9])   # short path too


# -- Keccak, STROBE, Merlin (tests/test_transcript.py) ---------------------------

SPONGES = [
    ("sha3_256", 136, 0x06, 32,
     [b"", b"x", b"hello world", b"a" * 135, b"b" * 136, b"c" * 1000]),
    ("sha3_512", 72, 0x06, 64, [b"", b"abc", b"z" * 71, b"z" * 72, b"q" * 500]),
    ("shake_256", 136, 0x1F, 300, [b"", b"abc" * 100]),
]


@pytest.mark.parametrize("name,rate,pad,out,msgs", SPONGES,
                         ids=[s[0] for s in SPONGES])
def test_sponge_equals_hashlib_and_jax(name, rate, pad, out, msgs):
    for msg in msgs:
        got = []
        for root in PACKAGES:
            (K,) = _mods(root, "utils.keccak")
            s = K.Sponge(rate, pad)
            s.absorb(msg)
            got.append(s.squeeze(out))
        h = hashlib.new(name, msg)
        want = h.digest(out) if name.startswith("shake") else h.digest()
        assert got[1] == got[0] == want


def test_f1600_equals_jax():
    from bulletproofs_tpu.utils.keccak import f1600_state as jf
    from bulletproofs_tpu_torch.utils.keccak import f1600_state as tf
    st = bytes(200)
    out = tf(st)
    assert out != st and len(out) == 200 and tf(st) == out
    st2 = bytes(random.Random(9).randbytes(200))
    assert out == jf(st) and tf(st2) == jf(st2)


def test_merlin_equivalence_simple():
    """The upstream merlin crate's test vector, in both packages."""
    got = []
    for pkg in (J, T):
        t = pkg.Transcript(b"test protocol")
        t.append_message(b"some label", b"some data")
        got.append(t.challenge_bytes(b"challenge", 32).hex())
    assert got[1] == got[0] == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")


def _clone_challenges(pkg):
    t = pkg.Transcript(b"proto")
    t.append_message(b"a", b"b")
    t2 = t.clone()
    c = [t.challenge_bytes(b"c", 32), t2.challenge_bytes(b"c", 32)]
    t.append_message(b"x", b"1")
    t2.append_message(b"x", b"2")
    return c + [t.challenge_bytes(b"c", 32), t2.challenge_bytes(b"c", 32)]


def test_merlin_clone_independent_as_jax():
    got = _clone_challenges(T)
    assert got[0] == got[1] and got[2] != got[3]
    assert got == _clone_challenges(J)


class _Fixed:
    @staticmethod
    def randbytes(n):
        return bytes(n)


def _transcript_rng_bytes(pkg):
    t = pkg.Transcript(b"proto")
    t.append_message(b"a", b"b")
    return [t.build_rng().rekey_with_witness_bytes(b"w", w).finalize(_Fixed())
            .randbytes(64) for w in (b"secret", b"secret", b"other")]


def test_transcript_rng_deterministic_as_jax():
    got = _transcript_rng_bytes(T)
    assert got[0] == got[1] and got[0] != got[2]
    assert got == _transcript_rng_bytes(J)
