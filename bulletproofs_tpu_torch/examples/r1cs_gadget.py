"""Building a custom constraint-system proof with the R1CS API.

Worked example mirroring the reference's R1CS walkthrough
(docs/r1cs-docs-example.md): a ShuffleProof gadget proving that one list
of committed values is a permutation of another, without revealing the
permutation.  It exercises the full gadget-building surface:

- `commit` for high-level witness variables (Pedersen commitments),
- `multiply` / `constrain` over the `LinearCombination` algebra,
- the TWO-PHASE protocol: `specify_randomized_constraints` defers gadget
  construction until after the prover commits, so the gadget can consume a
  Fiat-Shamir `challenge_scalar` soundly,
- one gadget function shared verbatim between prover and verifier (the
  constraint system is the same; only assignments differ).

The permutation argument: lists x and y are equal as multisets iff the
polynomials prod_i (x_i - z) and prod_i (y_i - z) agree at a random z.
The gadget (`benches/shuffle.shuffle_gadget`, which chip_smoke.py's
R1CS phase proves at k = 2^15 too) chains k-1 multipliers per side and
constrains the two roots to be equal.

Run: python -m bulletproofs_tpu_torch.examples.r1cs_gadget [k]
         [--device cuda]

The prover runs on the host; `Verifier.verify` and `batch_verify` take
`device`, and their mega-MSM runs there from
settings.r1cs_device_msm_floor (2^14) padded multipliers up: k = 8192 is
the smallest power of two that reaches it.
"""

import argparse
import random
import secrets

from bulletproofs_tpu_torch import (BulletproofGens, PedersenGens,
                                    R1CSError, Scalar, Transcript)
from bulletproofs_tpu_torch.benches.shuffle import shuffle_gadget
from bulletproofs_tpu_torch.core.scalar import L
from bulletproofs_tpu_torch.device import resolve_device
from bulletproofs_tpu_torch.proofs.r1cs import Prover, Verifier, batch_verify


class Rng:
    randbytes = staticmethod(secrets.token_bytes)


def prove_shuffle(pc_gens, bp_gens, inputs, outputs, rng):
    """Returns (proof, input_commitments, output_commitments)."""
    prover = Prover(pc_gens, Transcript(b"ShuffleProofExample"))
    in_pairs = [prover.commit(v, Scalar.random(rng)) for v in inputs]
    out_pairs = [prover.commit(v, Scalar.random(rng)) for v in outputs]
    shuffle_gadget(prover,
                   [var for _, var in in_pairs],
                   [var for _, var in out_pairs])
    proof = prover.prove(bp_gens, rng=rng)
    return (proof,
            [com for com, _ in in_pairs],
            [com for com, _ in out_pairs])


def shuffle_verifier(in_coms, out_coms):
    """A verifier holding the gadget over the commitments (one-shot)."""
    verifier = Verifier(Transcript(b"ShuffleProofExample"))
    in_vars = [verifier.commit(c) for c in in_coms]
    out_vars = [verifier.commit(c) for c in out_coms]
    shuffle_gadget(verifier, in_vars, out_vars)
    return verifier


def verify_shuffle(pc_gens, bp_gens, proof, in_coms, out_coms, rng,
                   device="cuda"):
    shuffle_verifier(in_coms, out_coms).verify(proof, pc_gens, bp_gens,
                                               rng=rng, device=device)


def main(k=8, device="cuda"):
    dev = resolve_device(device)
    rng = Rng()
    pc_gens = PedersenGens()
    # 2*(k-1) multipliers, padded to the next power of two
    bp_gens = BulletproofGens(max(1 << (2 * k - 3).bit_length(), 2), 1)

    rr = random.Random()
    inputs = [Scalar(rr.randrange(L)) for _ in range(k)]
    outputs = list(inputs)
    rr.shuffle(outputs)

    proof, in_coms, out_coms = prove_shuffle(
        pc_gens, bp_gens, inputs, outputs, rng)
    print(f"k={k} shuffle proof: {len(proof.to_bytes())} bytes")

    verify_shuffle(pc_gens, bp_gens, proof, in_coms, out_coms, rng, dev)
    print("verified: committed outputs are a permutation of the inputs")

    # a non-permutation must fail
    bad = list(inputs)
    bad[0] = bad[0] + Scalar.one()
    proof2, in2, out2 = prove_shuffle(pc_gens, bp_gens, inputs, bad, rng)
    try:
        verify_shuffle(pc_gens, bp_gens, proof2, in2, out2, rng, dev)
    except R1CSError as e:
        print(f"tampered outputs rejected: {e}")
    else:
        raise SystemExit("tampered shuffle unexpectedly verified")

    # batch verification (one mega-MSM for all items): the good proof
    # alone passes, and the tampered one fails the batch it is in
    batch_verify([(shuffle_verifier(in_coms, out_coms), proof)],
                 pc_gens, bp_gens, rng=rng, device=dev)
    try:
        batch_verify([(shuffle_verifier(in_coms, out_coms), proof),
                      (shuffle_verifier(in2, out2), proof2)],
                     pc_gens, bp_gens, rng=rng, device=dev)
    except R1CSError as e:
        print(f"batch verified alone, rejected with the tampered proof: {e}")
    else:
        raise SystemExit("batch with a tampered shuffle unexpectedly verified")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("k", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.k, args.device)
