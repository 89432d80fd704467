"""Multi-party aggregation: mutually-distrusting parties produce one
aggregated range proof via the dealer protocol, every message crossing the
party/dealer boundary as wire bytes (reference docs/aggregation-api.md;
the session-typed flow of src/range_proof/{party,dealer}.rs).

Also demonstrates misbehavior detection: a party proving a too-large value
is identified by index when the dealer audits shares.

Run: python -m bulletproofs_tpu_torch.examples.mpc_aggregation
         [--device cuda]

The protocol runs on the host, as in the JAX package; `--device` is
checked as every entry point of the port checks it.
"""

import argparse
import secrets

from bulletproofs_tpu_torch import (BulletproofGens, MPCError, PedersenGens,
                                    Scalar, Transcript)
from bulletproofs_tpu_torch.device import resolve_device
from bulletproofs_tpu_torch.proofs import messages as M
from bulletproofs_tpu_torch.range_proof_mpc import Dealer, Party


class Rng:
    randbytes = staticmethod(secrets.token_bytes)


def run(values, n=32, label=b"mpc example"):
    rng = Rng()
    m = len(values)
    pc, bp = PedersenGens(), BulletproofGens(64, m)

    dealer = Dealer.new(bp, pc, Transcript(label), n, m)
    parties = [Party.new(bp, pc, v, Scalar.random(rng), n) for v in values]

    # round 1: bit commitments (serialized, as a networked run would)
    states, wire = zip(*[p.assign_position(j, rng)
                         for j, p in enumerate(parties)])
    bits = [M.bit_commitment_from_bytes(M.bit_commitment_to_bytes(b))
            for b in wire]
    dealer, bit_challenge = dealer.receive_bit_commitments(bits)
    bit_challenge = M.bit_challenge_from_bytes(
        M.bit_challenge_to_bytes(bit_challenge))

    # round 2: poly commitments
    states, polys = zip(*[s.apply_challenge(bit_challenge, rng)
                          for s in states])
    polys = [M.poly_commitment_from_bytes(M.poly_commitment_to_bytes(p))
             for p in polys]
    dealer, poly_challenge = dealer.receive_poly_commitments(polys)
    poly_challenge = M.poly_challenge_from_bytes(
        M.poly_challenge_to_bytes(poly_challenge))

    # round 3: shares -- the dealer verifies the assembled proof and, on
    # failure, audits each share to identify the misbehaving parties
    shares = [M.proof_share_from_bytes(M.proof_share_to_bytes(
        s.apply_challenge(poly_challenge))) for s in states]
    proof = dealer.receive_shares(shares, rng)

    vcs = [b.V_j for b in bits]
    proof.verify_multiple(bp, pc, Transcript(label), vcs, n, rng=rng)
    return proof


def main(device="cuda"):
    resolve_device(device)
    proof = run([101, 202, 303, 404])
    print(f"4-party aggregated proof: {len(proof.to_bytes())} bytes, verified")

    # a dishonest party: 64-bit value in a 32-bit proof
    try:
        run([1, 2, 1 << 40, 4])
        raise SystemExit("dishonest party was NOT detected")
    except MPCError as e:
        if e.kind != MPCError.MALFORMED_PROOF_SHARES or e.bad_shares != [2]:
            raise SystemExit(f"the wrong party was blamed: {e}")
        print(f"dishonest party detected: {e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
