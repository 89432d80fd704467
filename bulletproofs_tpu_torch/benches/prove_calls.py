"""The batch prover's device-transcript route timed alone on one CUDA card,
at m = 1 and m = 16, to compare two trees' walls and launches in one call:

    python -m bulletproofs_tpu_torch.benches.prove_calls [--proofs 8192]
        [--agg-proofs 256] [--runs 5] [--seed 1] [--label tree]

For each shape (n = 64, m = 1 with `--proofs` proofs; n = 64, m = 16 with
`--agg-proofs`) it builds the prover's tables, proves once to warm up,
then times `--runs` calls of `BatchProver.prove_batch` (seeded values,
blinds and rng), each ending in a synchronize, by the host clock; then
one more call under torch.profiler: its device time, its kernel launches
(every kernel and copy the profiler saw, the count chip_smoke.py reports)
and the device's busy share of the best and of the median call.  Prints
one JSON line per shape with the card's name and power limit.  It uses
only the port's public API, `benches.accumulate_z.smi` and the helpers
of `benches/__init__.py` (`Rng`, `profiled`, the ones `chip_smoke.py`
counts its launches with), so dropped into an older tree of the port with
that file it measures that tree.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from . import Rng, profiled
from . import accumulate_z as AZ


def measure(m: int, proofs: int, runs: int, seed: int, label: str) -> dict:
    from .. import (BatchProver, BulletproofGens, PedersenGens, Scalar,
                    Transcript)
    n = 64
    rng = Rng(seed)
    t0 = time.perf_counter()
    prover = BatchProver(BulletproofGens(n, m), PedersenGens(), n, m,
                         device="cuda")
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0

    def draw():
        return rng.r.randrange(1 << n)
    values = [draw() if m == 1 else [draw() for _ in range(m)]
              for _ in range(proofs)]
    blinds = [Scalar.random(rng) if m == 1
              else [Scalar.random(rng) for _ in range(m)]
              for _ in range(proofs)]
    labels = [b"prove calls bench %d" % i for i in range(proofs)]

    def prove(s):
        prover.prove_batch(values, blinds, [Transcript(x) for x in labels],
                           rng=Rng(s))
        torch.cuda.synchronize()

    prove(seed + 100)                                             # warm-up
    walls = []
    for r in range(runs):
        t0 = time.perf_counter()
        prove(seed + 101 + r)
        walls.append((time.perf_counter() - t0) * 1e3)
    rows = profiled(lambda: prove(seed + 200))
    device_ms, launches = sum(r[0] for r in rows), sum(r[1] for r in rows)
    top = [(ms, c, k[:60]) for ms, c, k in rows[:6]]
    best, med = min(walls), statistics.median(walls)
    return {"label": label, "n": n, "m": m, "proofs": proofs,
            "tables_s": tables_s, "walls_ms": walls, "best_ms": best,
            "median_ms": med, "device_ms": device_ms, "launches": launches,
            "busy_of_best": device_ms / best, "busy_of_median": device_ms / med,
            "top": top, "card": AZ.smi("name,power.limit")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--proofs", type=int, default=8192)
    ap.add_argument("--agg-proofs", type=int, default=256)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prove_calls: no CUDA device available", file=sys.stderr)
        return 2
    for m, proofs in ((1, args.proofs), (16, args.agg_proofs)):
        print(json.dumps(measure(m, proofs, args.runs, args.seed,
                                 args.label)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
