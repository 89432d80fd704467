"""The mesh timed on the cards present: BatchVerifier(mesh=) and
sharded_msm_lanes over every card and over four virtual shards of card 0,
beside the one-card routes:

    python -m bulletproofs_tpu_torch.benches.mesh_verify [--proofs 8192]
        [--runs 3] [--points 65536] [--seed 1]

Proves `--proofs` n = 64 range proofs on card 0 (the device-transcript
route), then verifies them on the fused route (card 0), on the chunked
route over a mesh of card 0 alone, over every card present and over four
virtual shards of card 0: each must accept, leave the fused route's
transcripts and reject a flipped byte; every shard MSM must run with its
inputs on, and its device current as, its own mesh entry.  The routes'
`--runs` calls alternate, each ending in a synchronize of every card, by
the host clock.  Then the `--points` MSM (points from a table of 256
basepoint multiples, so the oracle is one scalar multiplication) unsharded
on card 0 and sharded over the same meshes.  Prints a JSON line per route
and per MSM (runs, best, median, launches of the port's kernels in the
first run) and the cards' names and power limits.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


class Rng:
    """Seeded byte source with the interface the prover and verifier use."""

    def __init__(self, seed: int):
        self.r = random.Random(seed)

    def randbytes(self, n: int) -> bytes:
        return self.r.randbytes(n)


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def clock(fn) -> float:
    """Milliseconds of one fn() ending in a synchronize of every card."""
    t0 = time.perf_counter()
    fn()
    sync_all()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--proofs", type=int, default=8192)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--points", type=int, default=1 << 16)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_verify: no CUDA device available", file=sys.stderr)
        return 2
    from .. import (BatchProver, BatchVerifier, BulletproofGens,
                    PedersenGens, ProofError, RangeProof, Scalar, Transcript)
    from ..core.ristretto import RISTRETTO_BASEPOINT
    from ..core.scalar import L as ELL
    from ..ops import _cuda
    from ..ops import curve as C
    from ..ops import msm as M
    from ..parallel import Mesh, make_mesh, sharded_msm_lanes
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card0 = torch.device("cuda", 0)
    everyone = make_mesh()
    meshes = [("card 0 alone", Mesh([card0])),
              (f"every card ({everyone.size})", everyone),
              ("4 virtual shards of card 0", Mesh([card0] * 4))]
    n = 64
    pc, bp = PedersenGens(), BulletproofGens(n, 1)
    rng = Rng(args.seed)
    values = [rng.r.randrange(1 << n) for _ in range(args.proofs)]
    blinds = [Scalar.random(rng) for _ in values]
    labels = [b"mesh verify bench %d" % i for i in range(args.proofs)]
    t0 = time.time()
    proofs, vcs = BatchProver(bp, pc, n, device=card0).prove_batch(
        values, blinds, [Transcript(l) for l in labels],
        rng=Rng(args.seed + 1))
    vcss = [[v] for v in vcs]
    print(f"mesh_verify: {args.proofs} proofs made in "
          f"{time.time() - t0:.1f} s; cards {cards}", flush=True)
    flipped = bytearray(proofs[-1].to_bytes())
    flipped[128] ^= 1
    bad = proofs[:-1] + [RangeProof.from_bytes(bytes(flipped))]

    def run(bv, ps, seed):
        ts = [Transcript(l) for l in labels]
        try:
            bv.verify_batch(ps, vcss, ts, rng=Rng(seed))
            ok = True
        except ProofError:
            ok = False
        sync_all()
        return ok, [t.strobe.buf.raw for t in ts]

    failures = []
    routes = [("fused route on card 0",
               BatchVerifier(bp, pc, n=n, m=1, device=card0), None)]
    routes += [(f"mesh verifier over {what}",
                BatchVerifier(bp, pc, n=n, m=1, mesh=mesh), mesh)
               for what, mesh in meshes]
    want_ts = None
    first = {}
    real = M.msm_lanes
    for what, bv, mesh in routes:
        seen = []

        def on_shard(pts, sc, seen=seen):
            seen.append((pts.device, sc.device,
                         torch.device("cuda", torch.cuda.current_device())))
            return real(pts, sc)

        M.msm_lanes = on_shard
        _cuda.reset_counts()
        try:
            ok, ts = run(bv, proofs, 10)
        finally:
            M.msm_lanes = real
        first[what] = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        want_ts = ts if want_ts is None else want_ts
        rejected = not run(bv, bad, 11)[0]
        right = mesh is None or mesh.size == 1 or (seen and all(
            e == (mesh.devices[i % mesh.size],) * 3
            for i, e in enumerate(seen)))
        if not (ok and ts == want_ts and rejected and right):
            failures.append(what)
        print(f"  {what}: {'accepted' if ok else 'REJECTED'}, transcripts "
              f"{'equal' if ts == want_ts else 'DIFFERENT'}, flipped byte "
              f"{'rejected' if rejected else 'ACCEPTED'}, shard devices "
              f"{'right' if right else 'WRONG'} ({len(seen)} shard MSMs)",
              flush=True)
    times = {what: [] for what, _, _ in routes}
    for r in range(args.runs):
        for what, bv, _ in routes:
            times[what].append(clock(lambda: run(bv, proofs, 20 + r)))
    for what, _, _ in routes:
        ms = times[what]
        print(json.dumps({"route": what, "proofs": args.proofs, "runs_ms": ms,
                          "best_ms": min(ms),
                          "median_ms": statistics.median(ms),
                          "launches": first[what]}), flush=True)

    big = args.points
    g = np.random.default_rng(args.seed + 2)
    table, acc = [], RISTRETTO_BASEPOINT
    for _ in range(256):
        table.append(acc)
        acc = acc + RISTRETTO_BASEPOINT
    idx = g.integers(0, 256, big)
    pts = torch.as_tensor(C.points_to_lanes(table)).to(card0)[
        ..., torch.as_tensor(idx, device=card0)].contiguous()
    ints = [int.from_bytes(g.bytes(32), "little") % ELL for _ in range(big)]
    rows = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in ints),
                         np.uint8).reshape(big, 32)
    k = sum((int(i) + 1) * v for i, v in zip(idx, ints)) % ELL
    oracle = RISTRETTO_BASEPOINT.scalar_mul(Scalar(k)).compress()
    msms = [("unsharded on card 0",
             lambda: M.msm_lanes(pts, torch.from_numpy(rows.copy()).to(
                 card0)))]
    msms += [(f"sharded over {what}",
              lambda mesh=mesh: sharded_msm_lanes(pts, rows, mesh))
             for what, mesh in meshes[1:]]
    for what, fn in msms:
        _cuda.reset_counts()
        good = C.compress(fn()).cpu().numpy().tobytes() == oracle
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        ms = [clock(fn) for _ in range(args.runs)]
        if not good:
            failures.append(f"{big}-point MSM {what}")
        print(json.dumps({"msm": what, "points": big, "equal_oracle": good,
                          "runs_ms": ms, "best_ms": min(ms),
                          "median_ms": statistics.median(ms),
                          "launches": launches}), flush=True)
    for line in cards:
        print(line)
    if failures:
        print("FAILED:", failures, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
