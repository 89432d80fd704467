"""The prover's fixed-base MSM kernels (K6, K7, K12) at the four
main-path shapes, on one CUDA card:

    python -m bulletproofs_tpu_torch.benches.fixed_msm_shapes [--reps 3]

Proves `--total` n=64 range proofs (m=1) and `--agg-total` aggregated ones
(n=64, m=16) once each on the device-transcript route, keeps the first
input of `fixed_msm.msm_digits_niels` at each shape below, then times K6
(`accumulate`: the one-hot form, and the direct form where the prover
sent the rows with consttime=False), K12 (`accumulate2`, the two-set
form `_ILP2` takes) and K7 (`reduce`, on K6's and on K12's slab) on those
inputs by CUDA events, each the mean of `--reps` after a warm-up, and
checks that K12's points equal K6's.  Prints the blocks per SM that the
runtime reports for each kernel, one JSON object per shape and the card's
name and power limit.

    m=1 IPP L stream    (n + 1) 64 rows x half the proofs   (public)
    m=1 S stream        (2n + 1) 64 rows x half the proofs  (witness)
    m=16 IPP L stream   (nm + 1) 64 rows x the proofs       (public)
    m=16 S stream       (2nm + 1) 64 rows x the proofs      (witness)
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys

import torch

from . import timed
from ..ops import curve as C
from ..ops import fixed_msm as FM


def shape_specs(n: int, m: int, lanes: int):
    """[(name, rows, lanes)] of one prove's IPP L and S streams."""
    N = n * m
    return [(f"m={m} IPP L stream", (N + 1) * FM.NUM_WINDOWS, lanes),
            (f"m={m} S stream", (2 * N + 1) * FM.NUM_WINDOWS, lanes)]


class ShapeCapture:
    """Wraps fixed_msm.msm_digits_niels (restored by close()) and keeps a
    clone of the first (niels, digits, keywords) seen at each (rows,
    lanes) of `specs`."""

    def __init__(self, specs):
        self.specs = {(r, q): name for name, r, q in specs}
        self.got = {}
        self.real = FM.msm_digits_niels
        FM.msm_digits_niels = self

    def __call__(self, niels, digits, **kw):
        name = self.specs.get((niels.shape[-1], digits.shape[1]))
        if name is not None and name not in self.got:
            self.got[name] = (niels.clone(), digits.clone(), dict(kw))
        return self.real(niels, digits, **kw)

    def close(self):
        FM.msm_digits_niels = self.real


def capture(prover, statements, blinds, lanes: int, seed: int):
    """One prove_batch with the capture in place -> {name: (niels, digits,
    keywords)} at the prover's two shapes."""
    from ..transcript import Transcript

    class Rng:
        def __init__(self, s):
            self.r = random.Random(s)

        def randbytes(self, k):
            return self.r.randbytes(k)

    cap = ShapeCapture(shape_specs(prover.n, prover.m, lanes))
    try:
        prover.prove_batch(statements, blinds,
                           [Transcript(b"shapes %d" % i)
                            for i in range(len(statements))], rng=Rng(seed))
        torch.cuda.synchronize()
    finally:
        cap.close()
    return cap.got


def measure(name, niels, digits, consttime: bool, reps: int):
    """K6 (the one-hot form; the direct form too for public rows) and K7
    on one captured input -> a dict of split and ms."""
    slab, ms6 = timed(lambda: FM.accumulate(niels, digits), reps, "cuda")
    _, ms7 = timed(lambda: FM.reduce(slab), reps, "cuda")
    rows, lanes = digits.shape
    row = {"shape": name, "rows": rows, "lanes": lanes,
           "split": slab.shape[0], "k6_ms": ms6, "k7_ms": ms7,
           "k7_groups": FM.red_groups(slab.shape[0])}
    if not consttime:
        _, row["k6_direct_ms"] = timed(
            lambda: FM.accumulate(niels, digits, consttime=False), reps,
            "cuda")
    # K12 (`_ILP2`, every row when set) beside K6 one-hot; K7 on its slab
    slab2, row["k12_ms"] = timed(lambda: FM.accumulate2(niels, digits), reps,
                                 "cuda")
    _, row["k7_on_k12_ms"] = timed(lambda: FM.reduce(slab2), reps, "cuda")
    row["k12_split"] = slab2.shape[0]
    row["k12_points_equal_k6"] = bool(torch.equal(
        C.compress(FM.reduce(slab2)), C.compress(FM.reduce(slab))))
    return row


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--total", type=int, default=8192)
    ap.add_argument("--agg-total", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fixed_msm_shapes: no CUDA device available", file=sys.stderr)
        return 2
    from .. import BatchProver, BulletproofGens, PedersenGens, Scalar
    from ..ops import _cuda

    for lib, out in _cuda.build_all().items():
        if lib == "fixed_msm":
            for line in out.splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    print(f"[{lib}] {line.strip()}", flush=True)
    r = random.Random(1)
    pc, n = PedersenGens(), 64
    got = {}
    for m, total in ((1, args.total), (16, args.agg_total)):
        prover = BatchProver(BulletproofGens(n, m), pc, n, m, device="cuda")
        vals = [[r.randrange(1 << n) for _ in range(m)] for _ in range(total)]
        bl = [[Scalar.random(r) for _ in range(m)] for _ in range(total)]
        if m == 1:
            vals, bl = [v[0] for v in vals], [b[0] for b in bl]
        lanes = total // 2 if total >= prover.FUSED_HALVES_FROM else total
        got.update(capture(prover, vals, bl, lanes, 7 + m))
    smi = card_line()
    print(json.dumps({"blocks_per_sm": FM.blocks_per_sm(), "card": smi}),
          flush=True)
    for name, (niels, digits, kw) in got.items():
        row = measure(name, niels, digits, kw.get("consttime", True),
                      args.reps)
        row["card"] = smi
        print(json.dumps(row), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
