"""The control of a verify cell's comparison: the plain reference
verifier, put in the program's place with one guarantee of the
configuration broken, must come out as not correct.

The proofs state no floating-point precision; the step below the one
they state is the challenge: 32 transcript bytes reduced mod l in place
of 64 (half the bits, and a biased draw).  The control builds the cell's
system (its pool proved on the card), then stands in for the program in
two calls, the pool's first batch that holds an invalid proof and its
first valid one: it verifies, with that challenge, the proofs that the
comparison reads, so the transcripts' states there are its own, and its
verdict on a call is its verdict on those proofs (a call rejects where
any of them fails).
`check_verify.compare` holds it to the reference:

    python3 -m portbench.control_verify --workload rp64x1.verify
        --seeds 11,12,13

prints one JSON line a seed.  The reference is plain Python; the card
makes the pool."""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

from . import check_verify
from .run import cell_parts, load_bench


def control_reading(system, seed: int, workers: int) -> dict:
    """The control in the program's place in two calls of `system` (a
    verify system whose set-up is done): its first batch that holds an
    invalid proof and its first valid one -> check_verify.compare's
    result."""
    calls = range(len(system.wires))
    records = [system.pool_record(i) for i in (
        next(i for i in calls if not system.label_of(i)),
        next(i for i in calls if system.label_of(i)))]
    check_verify.draw(records, random.Random(seed * 4 + 2),
                      system.traffic["check_proofs"])
    ts, results = check_verify.run(system.cfg, records, workers,
                                   challenge_len=32)
    accepts = check_verify.verdicts_of(system.cfg, ts, results)
    verdicts = []
    for c, rec in enumerate(records):
        rec["states"] = [None] * len(rec["wires"])
        verdicts.append((all(ok for (call, _), ok in accepts.items()
                             if call == c), system.label_of(rec["call"])))
    for t, res in zip(ts, results):
        for p, state in res["states"].items():
            records[t["call"]]["states"][p] = state
    return check_verify.compare(system.cfg, records, verdicts, workers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--workers", type=int, default=min(6, os.cpu_count() or 1))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the control's pool is proved on a CUDA card; found none",
              file=sys.stderr)
        return 2
    _, cfg, traffic, System = cell_parts(load_bench(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        system = System(cfg, traffic, seed, "cuda")
        system.free()
        got = control_reading(system, seed, args.workers)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got["numbers"],
                          "checked": got["checked"],
                          "limits": check_verify.LIMITS}), flush=True)
        del system
    return 0


if __name__ == "__main__":
    sys.exit(main())
