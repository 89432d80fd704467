"""Kernel K4b (`msm.horner`, the Horner window combine of every verifier
MSM) alone on one CUDA card, in seconds:

    python -m bulletproofs_tpu_torch.benches.horner [--reps 20]

Makes (64, 8, 4, 10) bucket sums on the card from seeded points, as the
verifier does (signed digits of random scalars, then K3 `accumulate` and
K4a `reduce` over the slab), times `msm.horner` on them by CUDA events
(the mean of `--reps` launches after a warm-up), and holds its point and
flag to `horner_plain` exactly on those sums and on the edge cases of
`edge_sums`.  Prints ptxas' report for the kernel, then one JSON line
with the time, the latency floor (`latency_floor_ms` at the card's
maximum SM clock) and the card's name and power limit.  It uses only the
horner / reduce / accumulate API, so it runs unchanged on older trees of
the port.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys

import torch

from ..core.field import P, SQRT_M1
from ..core.ristretto import RISTRETTO_BASEPOINT, RistrettoPoint
from ..core.scalar import L as ELL, Scalar
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..ops import scalar as S
from ..ops.limbs import fe_ints_to_limbs, sc_ints_to_limbs

CASES = ("identity", "top window identity", "window 0 only",
         "projective and 4-torsion")

# K4b's latency floor: the dependent instructions on its critical path,
# counted in the kernel's SASS (cuobjdump -sass of the built library),
# times the least latency of one.  The chain is 63 x (4 doublings of 2
# stages + 1 addition of 3); a stage (a doubling's second, the typical
# one) is 28 dependent integer instructions (operand sums and selects 4,
# the gather's multiply 1, five chained IMAD.WIDE, the x19 fold 2, the
# swap sum with carry round 1 7, rounds 2-3 9) and 6 others (the gather,
# swap and carry shuffles, a shared load, a shared store, the barrier).  A
# window sum is 8 additions deep, 3 products each, a product 29 dependent
# integer instructions and 5 shuffles.  4 cycles is the latency of a
# dependent arithmetic instruction (CUDA C++ Programming Guide, compute
# capability 7.x and later); taking it for the shuffles, shared accesses
# and barrier too keeps the floor low.
CHAIN_STAGES = 63 * (4 * 2 + 3)
STAGE_INSTRUCTIONS = 28 + 6
WINDOW_PRODUCTS = 8 * 3
PRODUCT_INSTRUCTIONS = 29 + 5
LEAST_LATENCY = 4


def latency_floor_ms(mhz: float) -> float:
    """Least milliseconds of K4b's dependent path at an SM clock of mhz."""
    cycles = LEAST_LATENCY * (CHAIN_STAGES * STAGE_INSTRUCTIONS
                              + WINDOW_PRODUCTS * PRODUCT_INSTRUCTIONS)
    return cycles / (mhz * 1e3)


def slab_sums(n: int, seed: int, device) -> torch.Tensor:
    """(64, 8, 4, 10) int32 bucket sums of n seeded points and scalars:
    K3 then K4a on a CUDA device, their plain versions on the CPU."""
    r = random.Random(seed)
    pts = [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
           for _ in range(n)]
    niels = C.to_niels(torch.as_tensor(C.points_to_lanes(C.normalized(pts)))
                       ).to(device)
    digits = S.signed_digits(torch.as_tensor(sc_ints_to_limbs(
        [r.randrange(ELL) for _ in range(n)]))).to(device)
    return M.reduce(M.accumulate(niels, digits))


def edge_sums(case: str, sums: torch.Tensor, seed: int) -> torch.Tensor:
    """A CASES variant of real bucket sums (CPU int32, carried limbs):
    every bucket the identity; window 63 the identity (the chain starts
    from it); every window but 0 the identity; or each bucket scaled
    projectively by a random Z, half of them plus the 4-torsion point
    (sqrt(-1) : 0 : 1 : 0), ristretto-equal representatives."""
    ident = C.identity(1, "cpu").reshape(1, 1, 4, 10)
    out = sums.clone()
    if case == "identity":
        return ident.expand(M.NUM_WINDOWS, M.NUM_BUCKETS, 4, 10).contiguous()
    if case == "top window identity":
        out[63] = ident[0]
        return out
    if case == "window 0 only":
        out[1:] = ident
        return out
    if case != "projective and 4-torsion":
        raise ValueError(f"unknown case {case!r}")
    r = random.Random(seed)
    n = M.NUM_WINDOWS * M.NUM_BUCKETS
    pts = out.reshape(n, 4, 10).permute(1, 2, 0).to(torch.int64)  # (4, 10, n)
    z = torch.as_tensor(fe_ints_to_limbs(
        [r.randrange(1, P) for _ in range(n)])).to(torch.int64)
    X, Y, Z, T = (F.mul(c, z) for c in pts)
    t4 = torch.as_tensor(C.points_to_lanes(
        [RistrettoPoint(SQRT_M1, 0, 1, 0)])).to(torch.int64)
    tX, tY, tZ, tT = C.add((X, Y, Z, T), tuple(t4[c] for c in range(4)))
    odd = torch.arange(n) % 2 == 1
    pts = torch.stack([torch.where(odd, a, b)
                       for a, b in zip((tX, tY, tZ, tT), (X, Y, Z, T))])
    return pts.permute(2, 0, 1).reshape(M.NUM_WINDOWS, M.NUM_BUCKETS, 4, 10
                                        ).to(torch.int32).contiguous()


def exact(sums: torch.Tensor) -> bool:
    """K4b's (point, flag) equals horner_plain's limb for limb."""
    out, flag = M.horner(sums)
    pout, pflag = M.horner_plain(sums)
    return bool(torch.equal(out, pout)) and bool(torch.equal(flag, pflag))


def ptxas_report(logs) -> str:
    """ptxas' lines for the K4b kernels out of _cuda.build_all()'s logs."""
    keep, lines = False, []
    for line in logs.get("msm", "").splitlines():
        if "Compiling entry function" in line:
            keep = "horner" in line
        if keep:
            lines.append(line.strip())
    return "\n".join(lines)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("horner bench: no CUDA device available", file=sys.stderr)
        return 2
    from . import timed
    from ..ops import _cuda

    print(ptxas_report(_cuda.build_all()), flush=True)
    card = smi("name,power.limit")
    mhz = float(smi("clocks.max.sm").split()[0])
    slabs = [slab_sums(4096, 1 + i, "cuda") for i in range(3)]
    _, ms = timed(lambda: M.horner(slabs[0]), args.reps, "cuda")
    checks = {f"slab {i}": exact(s) for i, s in enumerate(slabs)}
    host = slabs[0].cpu()
    for case in CASES:
        checks[case] = exact(edge_sums(case, host, 1).cuda())
    print(json.dumps({"kernel": "msm_horner", "ms": ms, "reps": args.reps,
                      "latency_floor_ms": latency_floor_ms(mhz),
                      "max_sm_mhz": mhz, "exact": all(checks.values()),
                      "checks": checks, "card": card}), flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
