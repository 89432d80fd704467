"""The port's MPC tier (proofs/dealer.py, party.py, messages.py and the
`range_proof_mpc` facade) against the JAX package's, on the CPU:

* the protocol of tests/test_mpc_wire.py at n = 16, m = 4 under the same
  seeded rng in both packages: every wire message (bit commitments, the
  bit challenge, poly commitments, the poly challenge, proof shares) and
  the aggregated proof byte for byte, each package verifying the other's
  proof;
* the codec's bad encodings raise the same error class in both;
* the wiping of tests/test_zeroize.py on the port's objects;
* the dishonest-party and malicious-dealer cases of tests/
  test_rangeproof.py: the same party blamed, the same error kind;
* the dealer with its parties in processes of their own, through the
  port's examples/mpc_multiprocess.py, no party importing JAX."""

import importlib
import random
import sys

import pytest

PACKAGES = ("bulletproofs_tpu", "bulletproofs_tpu_torch")


class Rng:
    def __init__(self, seed):
        self.r = random.Random(seed)

    def randbytes(self, n):
        return self.r.randbytes(n)


def _pkg(root):
    """-> (package, messages, range_proof_mpc) of `root`."""
    return (importlib.import_module(root),
            importlib.import_module(root + ".proofs.messages"),
            importlib.import_module(root + ".range_proof_mpc"))


def _wire_flow(root):
    """tests/test_mpc_wire.py's protocol under SeededRng(24) -> (every wire
    message in order, the proof's bytes, the value commitments)."""
    P, M, mpc = _pkg(root)
    rng = Rng(24)
    bp, pc = P.BulletproofGens(64, 4), P.PedersenGens()
    n, m = 16, 4
    values = [101, 202, 303, 404]
    blindings = [P.Scalar.random(rng) for _ in range(m)]
    wire = []

    dealer = mpc.Dealer.new(bp, pc, P.Transcript(b"wire mpc test"), n, m)
    parties = [mpc.Party.new(bp, pc, v, vb, n)
               for v, vb in zip(values, blindings)]
    states, bits = [], []
    for j, p in enumerate(parties):
        st, bc = p.assign_position(j, rng)
        states.append(st)
        wire.append(M.bit_commitment_to_bytes(bc))
        bits.append(M.bit_commitment_from_bytes(wire[-1]))
    dealer, bit_challenge = dealer.receive_bit_commitments(bits)
    wire.append(M.bit_challenge_to_bytes(bit_challenge))
    bit_challenge = M.bit_challenge_from_bytes(wire[-1])

    states2, polys = [], []
    for st in states:
        st2, pcm = st.apply_challenge(bit_challenge, rng)
        states2.append(st2)
        wire.append(M.poly_commitment_to_bytes(pcm))
        polys.append(M.poly_commitment_from_bytes(wire[-1]))
    dealer, poly_challenge = dealer.receive_poly_commitments(polys)
    wire.append(M.poly_challenge_to_bytes(poly_challenge))
    poly_challenge = M.poly_challenge_from_bytes(wire[-1])

    shares = []
    for st in states2:
        wire.append(M.proof_share_to_bytes(st.apply_challenge(poly_challenge)))
        shares.append(M.proof_share_from_bytes(wire[-1]))
    proof = dealer.receive_shares(shares, rng)
    return wire, proof.to_bytes(), [b.V_j for b in bits]


def test_mpc_wire_messages_and_proof_equal_jax():
    jwire, jproof, jvcs = _wire_flow("bulletproofs_tpu")
    twire, tproof, tvcs = _wire_flow("bulletproofs_tpu_torch")
    assert len(twire) == 4 + 1 + 4 + 1 + 4
    assert twire == jwire
    assert tvcs == jvcs
    assert tproof == jproof and len(tproof) == 672
    # each package verifies the other's proof
    for root, pbytes in (("bulletproofs_tpu", tproof),
                         ("bulletproofs_tpu_torch", jproof)):
        P = importlib.import_module(root)
        P.RangeProof.from_bytes(pbytes).verify_multiple(
            P.BulletproofGens(64, 4), P.PedersenGens(),
            P.Transcript(b"wire mpc test"), tvcs, 16, rng=Rng(5))


@pytest.mark.parametrize("codec,blob", [
    ("bit_commitment_from_bytes", bytes(32) + b"\x01" * 32 + bytes(32)),
    ("proof_share_from_bytes", b"\xff" * 32 * 3 + bytes(16)),
], ids=["bit_commitment", "proof_share"])
def test_message_codec_rejects_bad_encodings_as_jax(codec, blob):
    raised = []
    for root in PACKAGES:
        with pytest.raises(ValueError) as e:
            getattr(_pkg(root)[1], codec)(blob)
        raised.append((type(e.value).__name__, str(e.value)))
    assert raised[0] == raised[1]


def test_party_states_wiped_after_transitions():
    from bulletproofs_tpu_torch import (BulletproofGens, PedersenGens, Scalar,
                                        Transcript)
    from bulletproofs_tpu_torch.proofs.dealer import Dealer
    from bulletproofs_tpu_torch.proofs.party import Party
    rng = Rng(7)
    n = 8
    pc, bp = PedersenGens(), BulletproofGens(n, 1)
    dealer = Dealer.new(bp, pc, Transcript(b"zeroize"), n, 1)

    p0 = Party.new(bp, pc, 5, Scalar.random(rng), n)
    p1, bc = p0.assign_position(0, rng)
    assert p0.v is None and p0.v_blinding is None

    dealer, bit_challenge = dealer.receive_bit_commitments([bc])
    p2, pcm = p1.apply_challenge(bit_challenge, rng)
    assert p1.v is None and p1.v_blinding is None
    assert p1.a_blinding is None and p1.s_blinding is None
    assert p1.s_L == [] and p1.s_R == []

    dealer, poly_challenge = dealer.receive_poly_commitments([pcm])
    share = p2.apply_challenge(poly_challenge)
    assert p2.v_blinding is None and p2.a_blinding is None
    assert p2.s_blinding is None and p2.t_1_blinding is None
    assert p2.l_poly.c0 == [] and p2.l_poly.c1 == []
    assert p2.r_poly.c0 == [] and p2.r_poly.c1 == []
    assert (p2.t_poly.a is None and p2.t_poly.b is None
            and p2.t_poly.c is None)

    # the share still carries what the protocol needs
    proof = dealer.receive_trusted_shares([share])
    assert len(share.l_vec) == n and proof is not None


def test_poly_wipe_methods():
    from bulletproofs_tpu_torch import Scalar
    from bulletproofs_tpu_torch.utils.util import (Poly2, Poly6, VecPoly1,
                                                   VecPoly3)
    one = Scalar.one()
    vp1 = VecPoly1([one] * 4, [one] * 4)
    vp1.wipe()
    assert vp1.c0 == [] and vp1.c1 == []

    vp3 = VecPoly3.zero(4)
    vp3.wipe()
    assert all(c == [] for c in vp3.c)

    p2 = Poly2(one, one, one)
    p2.wipe()
    assert p2.a is None and p2.b is None and p2.c is None

    p6 = Poly6(one, one, one, one, one, one)
    p6.wipe()
    assert p6.t == [None] * 6


def _dishonest(root):
    """Parties 1 and 3 prove 64-bit values in a 32-bit proof -> the
    dealer's MPCError (kind, blamed indices)."""
    P, _, mpc = _pkg(root)
    rng = Rng(24)
    bp, pc = P.BulletproofGens(64, 4), P.PedersenGens()
    n, m = 32, 4
    values = [0, (1 << 40) + 937, 920212, (1 << 63) + 533]
    blindings = [P.Scalar.random(rng) for _ in range(m)]
    dealer = mpc.Dealer.new(bp, pc, P.Transcript(b"AggregatedRangeProofTest"),
                            n, m)
    # the dishonest parties claim bitsize 64 to Party.new, then work on n
    parties = [mpc.Party.new(bp, pc, v, b, 64 if j in (1, 3) else n)
               for j, (v, b) in enumerate(zip(values, blindings))]
    parties[1].n = parties[3].n = n
    states, bits = zip(*[p.assign_position(j, rng)
                         for j, p in enumerate(parties)])
    dealer, bit_challenge = dealer.receive_bit_commitments(list(bits))
    states, polys = zip(*[p.apply_challenge(bit_challenge, rng)
                          for p in states])
    dealer, poly_challenge = dealer.receive_poly_commitments(list(polys))
    shares = [p.apply_challenge(poly_challenge) for p in states]
    with pytest.raises(P.MPCError) as e:
        dealer.receive_shares(shares, rng)
    return e.value.kind, e.value.bad_shares


def _malicious_dealer(root):
    """A party given the challenge x = 0 -> its MPCError kind."""
    P, M, mpc = _pkg(root)
    rng = Rng(24)
    bp, pc = P.BulletproofGens(64, 1), P.PedersenGens()
    dealer = mpc.Dealer.new(bp, pc, P.Transcript(b"AggregatedRangeProofTest"),
                            32, 1)
    party = mpc.Party.new(bp, pc, 1, P.Scalar.random(rng), 32)
    state, bits = party.assign_position(0, rng)
    dealer, bit_challenge = dealer.receive_bit_commitments([bits])
    state, poly = state.apply_challenge(bit_challenge, rng)
    dealer.receive_poly_commitments([poly])
    with pytest.raises(P.MPCError) as e:
        state.apply_challenge(M.PolyChallenge(x=P.Scalar.zero()))
    return e.value.kind


def test_dishonest_parties_blamed_as_jax():
    got = [_dishonest(root) for root in PACKAGES]
    assert got[1] == got[0] == ("MalformedProofShares", [1, 3])


def test_malicious_dealer_detected_as_jax():
    got = [_malicious_dealer(root) for root in PACKAGES]
    assert got[1] == got[0] == "MaliciousDealer"


# a party process: the port's party_main, then a check of what it imported
# (stdout is the protocol channel: the verdict is the exit code)
PARTY = """
import runpy, sys
sys.argv = ["mpc_multiprocess", "--party"]
runpy.run_module("bulletproofs_tpu_torch.examples.mpc_multiprocess",
                 run_name="__main__", alter_sys=True)
sys.exit(3 if any(m.split(".")[0] in ("jax", "bulletproofs_tpu")
                  for m in sys.modules) else 0)
"""


def test_mpc_across_processes_through_the_example():
    from bulletproofs_tpu_torch import MPCError
    from bulletproofs_tpu_torch.examples import mpc_multiprocess as MP
    cmd = [sys.executable, "-c", PARTY]
    proof = MP.run_dealer([11, 22], n=16, party_cmd=cmd)
    assert len(proof.to_bytes()) == 32 * (9 + 2 * 5)
    with pytest.raises(MPCError) as e:
        MP.run_dealer([11, 1 << 40], n=16, party_cmd=cmd)
    assert e.value.bad_shares == [1]
