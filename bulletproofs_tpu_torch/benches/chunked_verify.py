"""The aggregated (m = 16) verifier's chunked route timed alone on one CUDA
card, to compare two trees' walls in one call:

    python -m bulletproofs_tpu_torch.benches.chunked_verify [--proofs 256]
        [--runs 15] [--seed 1] [--label tree]

Proves `--proofs` range proofs of n = 64, m = 16 on the card from seeded
values, then times `BatchVerifier.verify_batch` of all of them (nm = 1024,
so the chunked route): `--runs` calls after a warm-up, each ending in a
synchronize, by the host clock; then one more call under torch.profiler
for its device time and largest kernels.  Prints one JSON line (the runs,
their median, the device milliseconds and the card's name and power
limit).  It uses only the port's public API and `benches.accumulate_z.smi`,
so dropped into an older tree of the port it times that tree.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import sys
import time

import torch

from . import accumulate_z as AZ


class Rng:
    """Seeded byte source with the interface the prover and verifier use."""

    def __init__(self, seed: int):
        self.r = random.Random(seed)

    def randbytes(self, n: int) -> bytes:
        return self.r.randbytes(n)


def device_kernels(fn):
    """(device ms, [(ms, calls, kernel)] of the five largest) of one fn()
    by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t / 1e3, e.count, e.key[:60]))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows[:5]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--proofs", type=int, default=256)
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chunked_verify: no CUDA device available", file=sys.stderr)
        return 2
    from .. import (BatchProver, BatchVerifier, BulletproofGens,
                    PedersenGens, Scalar, Transcript)
    n, m = 64, 16
    rng = Rng(args.seed)
    pc, bp = PedersenGens(), BulletproofGens(n, m)
    values = [[rng.r.randrange(1 << n) for _ in range(m)]
              for _ in range(args.proofs)]
    blinds = [[Scalar.random(rng) for _ in range(m)]
              for _ in range(args.proofs)]
    labels = [b"chunked verify bench %d" % i for i in range(args.proofs)]
    proofs, commitments = BatchProver(bp, pc, n, m, device="cuda") \
        .prove_batch(values, blinds, [Transcript(l) for l in labels],
                     rng=Rng(args.seed + 1))
    verifier = BatchVerifier(bp, pc, n=n, m=m, device="cuda")

    def verify(seed):
        verifier.verify_batch(proofs, commitments,
                              [Transcript(l) for l in labels],
                              rng=Rng(seed))
        torch.cuda.synchronize()

    verify(0)                                                     # warm-up
    runs = []
    for r in range(args.runs):
        t0 = time.perf_counter()
        verify(1 + r)
        runs.append((time.perf_counter() - t0) * 1e3)
    device_ms, top = device_kernels(lambda: verify(args.runs + 1))
    print(json.dumps({"label": args.label, "proofs": args.proofs,
                      "runs_ms": runs, "median_ms": statistics.median(runs),
                      "device_ms": device_ms, "top": top,
                      "card": AZ.smi("name,power.limit")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
