"""The k-shuffle R1CS circuit: the gadget (reference tests/r1cs.rs:22-144,
as the JAX package's tests/test_r1cs.py has it) and the steps of the JAX
package's bench.py:321-366 (batched commitments, the gadget, prove; a
fresh verifier per verify), which chip_smoke.py and the tests drive."""

from __future__ import annotations

import random

from ..core.scalar import L as ELL, Scalar
from ..generators import BulletproofGens, PedersenGens
from ..transcript import Transcript
from ..proofs.r1cs import Prover, Verifier


def shuffle_gadget(cs, x, y):
    """Constrain y to be a permutation of x: with a challenge z bound to
    the first phase, prod(x_i - z) == prod(y_i - z)."""
    assert len(x) == len(y)
    k = len(x)
    if k == 1:
        cs.constrain(y[0] - x[0])
        return

    def randomized(cs2):
        z = cs2.challenge_scalar(b"shuffle challenge")
        # last x multiplier
        _, _, last_mulx_out = cs2.multiply(x[k - 1] - z, x[k - 2] - z)
        first_mulx_out = last_mulx_out
        for i in range(k - 3, -1, -1):
            _, _, first_mulx_out = cs2.multiply(first_mulx_out, x[i] - z)
        _, _, last_muly_out = cs2.multiply(y[k - 1] - z, y[k - 2] - z)
        first_muly_out = last_muly_out
        for i in range(k - 3, -1, -1):
            _, _, first_muly_out = cs2.multiply(first_muly_out, y[i] - z)
        cs2.constrain(first_mulx_out - first_muly_out)

    cs.specify_randomized_constraints(randomized)


def shuffle_values(k: int, seed: int, tamper: bool = False):
    """k random inputs and a shuffle of them (the first output + 1 when
    `tamper`), from random.Random(seed)."""
    rr = random.Random(seed)
    inputs = [Scalar(rr.randrange(ELL)) for _ in range(k)]
    outputs = list(inputs)
    rr.shuffle(outputs)
    if tamper:
        outputs[0] = outputs[0] + Scalar.one()
    return inputs, outputs


def prove_shuffle(pc: PedersenGens, bp: BulletproofGens, label: bytes,
                  inputs, outputs, rng):
    """Commit to inputs and outputs (one batched commitment pass), build
    the gadget, prove -> (input commitments, output commitments, proof)."""
    k = len(inputs)
    prover = Prover(pc, Transcript(label))
    pairs = prover.commit_many(inputs + outputs,
                               [Scalar.random(rng) for _ in range(2 * k)])
    shuffle_gadget(prover, [v for _, v in pairs[:k]],
                   [v for _, v in pairs[k:]])
    proof = prover.prove(bp, rng=rng)
    return [c for c, _ in pairs[:k]], [c for c, _ in pairs[k:]], proof


def shuffle_verifier(label: bytes, ins, outs) -> Verifier:
    """A fresh verifier with the gadget built over the commitments (a
    verifier is one-shot)."""
    v = Verifier(Transcript(label))
    shuffle_gadget(v, v.commit_many(ins), v.commit_many(outs))
    return v
