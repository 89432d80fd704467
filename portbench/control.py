"""The control of a prove cell's comparison: the plain reference, put in
the program's place with one guarantee of the configuration broken, must
come out as not correct.

The proofs state no floating-point precision; the step below the one they
state is the challenge: 32 transcript bytes reduced mod l in place of 64
(half the bits, and a biased draw).  The control makes, with that
challenge, the proofs that the exact comparison reads (one from each half
of two calls' batches, at the cell's own batch size and draw positions),
and `check.compare` holds them to the reference:

    python3 -m portbench.control --workload rp64x16.prove --seeds 11,12,13

prints one JSON line a seed.  It needs no card: the reference is plain
Python.  The replay comparison follows the points of a whole call, which
a pure-Python prover cannot make at 256 proofs a call in a run's time, so
the control is held to the exact comparison alone."""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

from . import check
from .systems import prove_batch as PB
from .run import KEEP_CALLS, load_json


def control_reading(cfg: dict, traffic: dict, seed: int, workers: int) -> dict:
    m = cfg["m"]
    pool = PB.statements(traffic, m, seed)
    count = traffic["outputs_per_call"] // m
    sampler = random.Random(seed * 4 + 2)
    label = cfg["transcript_label"].encode()
    records, tasks = [], []
    for i in range(KEEP_CALLS):
        vals, blinds = pool[i % len(pool)]
        rec = {"base": i * count, "key": PB.call_key(seed, i), "values": vals,
               "blindings": blinds, "proofs": [None] * count,
               "V": [[]] * count, "states": [None] * count,
               "exact": check.sample(sampler, count)}
        records.append(rec)
        for p in rec["exact"]:
            tasks.append({"n": cfg["n"], "m": m, "count": count,
                          "key": rec["key"], "base": rec["base"],
                          "label": label, "values": vals, "blindings": blinds,
                          "proofs": [p], "challenge_len": 32, "call": i})
    for key_id, res in check.run_tasks(check.keyed_reference_proofs, [
            dict(t, key_id=k) for k, t in enumerate(tasks)], workers):
        rec = records[tasks[key_id]["call"]]
        for p, out in res["proofs"].items():
            rec["proofs"][p], rec["V"][p], rec["states"][p] = \
                out["proof"], out["V"], out["state"]
    return check.compare(cfg, records, workers, replay=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--workers", type=int, default=min(6, os.cpu_count() or 1))
    args = ap.parse_args(argv)
    bench = load_json("BENCHMARK.json")
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(cfg_entry["file"])
    traffic = load_json("portbench", "traffic", cell["traffic"] + ".json")
    for seed in (int(s) for s in args.seeds.split(",")):
        got = control_reading(cfg, traffic, seed, args.workers)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got["numbers"],
                          "checked": got["checked"],
                          "limits": check.LIMITS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
