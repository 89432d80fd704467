"""Single and aggregated range proofs (reference README.md:93-147 and
docs/aggregation-api.md).

Run: python -m bulletproofs_tpu_torch.examples.range_proof [--device cuda]

Proving and verifying one proof are host calls, as in the JAX package: no
kernel runs.  `--device` is checked all the same, so that "cuda" (the
default) raises without a card, as every entry point of the port does.
"""

import argparse
import secrets

from bulletproofs_tpu_torch import (BulletproofGens, PedersenGens, ProofError,
                                    RangeProof, Scalar, Transcript)
from bulletproofs_tpu_torch.device import resolve_device


class Rng:
    randbytes = staticmethod(secrets.token_bytes)


def main(device="cuda"):
    resolve_device(device)
    rng = Rng()
    pc_gens = PedersenGens()
    bp_gens = BulletproofGens(64, 16)

    # -- single 32-bit proof ------------------------------------------------
    secret_value = 1037578891
    blinding = Scalar.random(rng)
    proof, committed_value = RangeProof.prove_single(
        bp_gens, pc_gens, Transcript(b"doctest example"),
        secret_value, blinding, 32, rng=rng)
    proof.verify_single(bp_gens, pc_gens, Transcript(b"doctest example"),
                        committed_value, 32, rng=rng)
    print(f"single 32-bit proof: {len(proof.to_bytes())} bytes, verified")

    # -- aggregated proof: 16 values in one proof ---------------------------
    values = [secrets.randbelow(1 << 32) for _ in range(16)]
    blindings = [Scalar.random(rng) for _ in range(16)]
    proof, vcs = RangeProof.prove_multiple(
        bp_gens, pc_gens, Transcript(b"aggregated"), values, blindings, 32,
        rng=rng)
    proof.verify_multiple(bp_gens, pc_gens, Transcript(b"aggregated"),
                          vcs, 32, rng=rng)
    print(f"aggregated 16x32-bit proof: {len(proof.to_bytes())} bytes "
          f"(vs {16 * 608} for 16 single proofs), verified")

    # -- wire roundtrip ------------------------------------------------------
    wire = proof.to_bytes()
    RangeProof.from_bytes(wire).verify_multiple(
        bp_gens, pc_gens, Transcript(b"aggregated"), vcs, 32, rng=rng)
    print("wire roundtrip verified (byte format identical to the Rust crate)")

    # -- a tampered proof must fail ------------------------------------------
    bad = bytearray(wire)
    bad[4 * 32] ^= 1                                  # low byte of t_x
    try:
        RangeProof.from_bytes(bytes(bad)).verify_multiple(
            bp_gens, pc_gens, Transcript(b"aggregated"), vcs, 32, rng=rng)
    except ProofError as e:
        print(f"tampered proof rejected: {e}")
    else:
        raise SystemExit("tampered proof unexpectedly verified")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
