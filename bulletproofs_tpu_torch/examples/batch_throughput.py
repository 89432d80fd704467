"""High-throughput batched proving and verification: the card's paths,
BatchProver (the device-transcript route) and BatchVerifier (one fused
MSM a sub-batch of 2048 proofs).

Run: python -m bulletproofs_tpu_torch.examples.batch_throughput [batch]
         [--device cuda]

`--device cpu` runs the kernels' plain PyTorch versions (slow: seconds a
proof).  Each time is taken on the host's clock and, on the card, ends in
torch.cuda.synchronize().
"""

import argparse
import secrets
import time

import torch

from bulletproofs_tpu_torch import (BatchProver, BatchVerifier,
                                    BulletproofGens, PedersenGens, Scalar,
                                    Transcript)
from bulletproofs_tpu_torch.device import resolve_device


class Rng:
    randbytes = staticmethod(secrets.token_bytes)


def _seconds_since(t0, dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def main(batch=256, device="cuda"):
    """Prove and verify `batch` n=64 proofs on `device` -> a dict of the
    proofs, their commitments and labels, the verifier and the two
    walls in seconds."""
    dev = resolve_device(device)
    rng = Rng()
    n = 64
    pc, bp = PedersenGens(), BulletproofGens(n, 1)

    prover = BatchProver(bp, pc, n, device=dev)
    values = [secrets.randbelow(1 << n) for _ in range(batch)]
    blindings = [Scalar.random(rng) for _ in range(batch)]
    labels = [b"batch %d" % i for i in range(batch)]

    t0 = time.perf_counter()
    proofs, vcs = prover.prove_batch(values, blindings,
                                     [Transcript(l) for l in labels], rng=rng)
    prove_s = _seconds_since(t0, dev)
    print(f"proved {batch} x {n}-bit proofs in {prove_s:.2f}s "
          f"({batch / prove_s:.1f} proofs/s) on {dev}")

    bv = BatchVerifier(bp, pc, n=n, m=1, device=dev)
    t0 = time.perf_counter()
    bv.verify_batch(proofs, [[vc] for vc in vcs],
                    [Transcript(l) for l in labels], rng=rng)
    verify_s = _seconds_since(t0, dev)
    print(f"verified all {batch} in ONE fused MSM in {verify_s * 1e3:.0f} ms "
          f"({batch / verify_s:.1f} proofs/s) on {dev}")
    return {"proofs": proofs, "commitments": vcs, "labels": labels,
            "verifier": bv, "prove_s": prove_s, "verify_s": verify_s}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.batch, args.device)
