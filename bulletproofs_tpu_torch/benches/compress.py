"""Kernel K5 (`curve.compress`, batch ristretto compression of the prover's
commitments) alone on one CUDA card:

    python -m bulletproofs_tpu_torch.benches.compress [--reps 20]
        [--sizes 512,4608,8192,12288] [--lps 1,10]

At each size (m=16 `prove_batch` of 256: T commitments 512, V/A/S 4,608;
m=1 of 8192: T and each IPP round's L / R 8,192, V/A/S 12,288 a launch) it
makes seeded points of any Z on the card (benches.accumulate_z.make_points,
the identity and a point plus 4-torsion first) and times `curve.compress`
by CUDA events (the mean of `--reps` calls after a warm-up, host launch
work included) and K5's device time by torch.profiler over `--reps` more
calls; where the tree picks K5's lanes per point (`curve.compress_lanes`)
it also times K5 at each of `--lps`.  Every output is held to
`compress_plain` byte for byte.  Prints ptxas' report for K5, one JSON line
per size (with the operations bound: the plain version's field products
at 100 limb products and its squarings at 55, two 32-bit multiply-adds a
limb product) and one summary line with K5's SASS counts (cuobjdump) and
the card's name and power limit.  It uses only the compress /
compress_plain API where the tree has nothing more, so it runs unchanged
on older trees of the port (with this package's benches/__init__.py).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..core.field import SQRT_M1
from ..core.ristretto import RISTRETTO_BASEPOINT, RistrettoPoint
from ..ops import curve as C
from . import accumulate_z as AZ
from . import field_mads

SIZES = (512, 4608, 8192, 12288)
LPS = (1, 10)


def _k5(name: str) -> bool:
    """K5's kernels: compress_kernel and its template instances, mangled."""
    return "compress_kernel" in name and "decompress" not in name


def make_points(n: int, seed: int, device) -> torch.Tensor:
    """(4, 10, n) int32 points of any Z: the identity, the base point plus
    4-torsion, then benches.accumulate_z.make_points'."""
    t4 = RistrettoPoint(SQRT_M1, 0, 1, 0)
    head = torch.as_tensor(C.points_to_lanes(
        [RistrettoPoint.identity(), RISTRETTO_BASEPOINT + t4])).to(device)
    pts = torch.cat([head, AZ.make_points(n, seed, device)], dim=-1)
    return pts[:, :, :n].contiguous()


def device_ms(fn, reps: int) -> float:
    """K5's device milliseconds per call of fn() over `reps` calls, by
    torch.profiler (CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if _k5(e.key):
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0)
            total += t
    return total / 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--lps", default=",".join(map(str, LPS)))
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compress bench: no CUDA device available", file=sys.stderr)
        return 2
    from ..ops import _cuda
    from . import timed

    logs = _cuda.build_all()
    ptxas = AZ.ptxas_report(logs.get("compress", ""), _k5)
    for name, lines in ptxas.items():
        print(name, "|", " | ".join(lines), flush=True)
    card = AZ.smi("name,power.limit")
    mhz = float(AZ.smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    imads = sms * AZ.IMAD_PER_CLOCK_SM * mhz * 1e6
    mads = field_mads(lambda: C.encode(C.to_coords(C.identity(1, "cpu"))))
    swept = hasattr(C, "compress_lanes")
    rows, exact = [], True
    for n in [int(s) for s in args.sizes.split(",") if s]:
        pts = make_points(n, args.seed + n, "cuda")
        want = C.compress_plain(pts)
        got, ms = timed(lambda: C.compress(pts), args.reps, "cuda")
        row = {"n": n, "ms": ms,
               "device_ms": device_ms(lambda: C.compress(pts), args.reps),
               "exact": bool(torch.equal(got, want)),
               "bound_ms": max(n * mads / imads,
                               n * (160 + 32) / AZ.PEAK_BYTES) * 1e3}
        if swept:
            row["lp"] = C.compress_lanes(n)
            row["by_lp"] = {}
            for lp in [int(s) for s in args.lps.split(",") if s]:
                out, t = timed(lambda: C._compress_kernel(pts, lp),
                               args.reps, "cuda")
                row["by_lp"][lp] = {
                    "ms": t, "exact": bool(torch.equal(out, want)),
                    "device_ms": device_ms(
                        lambda: C._compress_kernel(pts, lp), args.reps)}
        exact &= row["exact"] and all(v["exact"] for v in
                                      row.get("by_lp", {}).values())
        rows.append(row)
        print(json.dumps(row), flush=True)
    result = {"bench": "compress", "reps": args.reps, "sizes": rows,
              "mads_per_point": mads, "ptxas": ptxas,
              "sass": AZ.sass_counts(_cuda._so_path("compress"), _k5),
              "exact": exact, "card": card, "max_sm_mhz": mhz}
    print(json.dumps(result), flush=True)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
