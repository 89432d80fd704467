"""Kernels K11 (`msm.accumulate_z`, the bucket accumulation of the
verifier MSMs whose points have any Z) and K3 (`msm.accumulate`, the fused
m=1 verifier's accumulation of Niels points) alone on one CUDA card:

    python -m bulletproofs_tpu_torch.benches.accumulate_z [--reps 10]
        [--sizes 2052,8160,8260,46082,196653] [--niels-sizes 34946]

K11 at each of `--sizes` (the m=16 verifier's final MSM, its 8160-point
chunk, the R1CS batch of two k = 2^10 proofs, the linear batch of 2048
items at n = 1024 and the R1CS k = 2^15 mega-MSM) on seeded points of any
Z made on the card (sums of three of 64 random multiples of the base
point, doubled); K3 at each of `--niels-sizes` (34,946: one 2048-proof
sub-batch of the m=1 `verify_batch`, 130 static generators and 2048 x 17
decoded points) on the same points scaled to Z = 1 in Niels form.  Digits
are K10's of random 256-bit scalars.  Times the whole call by CUDA events
(the mean of `--reps` calls after a warm-up, host launch work included),
the device time of each kernel by torch.profiler over `--reps` more calls
and, where the tree has it, the binning launch `msm.bin_points` alone;
holds the slab to `accumulate_z_plain` / `accumulate_plain` and the bins
to `bin_points_plain` exactly (tolerance 0).  Prints ptxas' report for the
accumulation kernels, then one JSON line with the times, the operations
bound, the resident warps per SM, the kernels' SASS instruction counts
(cuobjdump) and the card's name and power limit.  It uses only the
accumulate / accumulate_z API and their plain versions where the tree has
nothing more, so it runs unchanged on older trees of the port.
"""

from __future__ import annotations

import argparse
import json
import random
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from ..core.ristretto import RISTRETTO_BASEPOINT
from ..core.scalar import L as ELL, Scalar
from ..ops import curve as C
from ..ops import field as F
from ..ops import fold as FO
from ..ops import msm as M
from ..ops import scalar as S
from . import MUL_PRODUCTS

SIZES = (2052, 8160, 8260, 46082, 196653)
NIELS_SIZES = (34946,)
# the complete and the mixed addition's field products, each 100 limb
# products of two 32-bit multiply-adds; 32-bit multiply-adds per clock per
# SM at compute capability 9.0 (CUDA C++ Programming Guide, throughput
# table)
ADD_FMULS = 9
MADD_FMULS = 7
FMUL_MADS = 2 * MUL_PRODUCTS
IMAD_PER_CLOCK_SM = 64
PEAK_BYTES = 3.35e12                    # HBM3 of one H100 SXM
# trees before the binned forms ran K11 (before K11's) and K3 (before
# K3's) in blocks of 32 threads
OLD_THREADS = 32


def make_points(n: int, seed: int, device) -> torch.Tensor:
    """(4, 10, n) int32 points of any Z: 2 (B_i + B_j + B_k) over 64 random
    multiples B of the base point, made on `device`."""
    r = random.Random(seed)
    base = torch.as_tensor(C.points_to_lanes(
        [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
         for _ in range(64)])).to(device)
    g = torch.Generator().manual_seed(seed)
    i, j, k = (torch.randint(0, 64, (n,), generator=g).to(device)
               for _ in range(3))
    p = C.add(C.add(C.to_coords(base[:, :, i]), C.to_coords(base[:, :, j])),
              C.to_coords(base[:, :, k]))
    return C.from_coords(C.double(p)).contiguous()


def make_niels(n: int, seed: int, device) -> torch.Tensor:
    """(3, 10, n) int32 Niels rows (Y+X, Y-X, 2dT) of make_points' points
    scaled to Z = 1."""
    X, Y, Z, _ = C.to_coords(make_points(n, seed, device))
    zi = F.invert(Z)
    x, y = F.mul(X, zi), F.mul(Y, zi)
    one = torch.zeros_like(x)
    one[..., 0, :] = 1
    return C.to_niels(C.from_coords((x, y, one, F.mul(x, y)))).contiguous()


def make_digits(n: int, seed: int, device) -> torch.Tensor:
    """(64, n) int8 signed digits of n random 256-bit scalars, by K10."""
    raw = np.random.default_rng(seed).integers(0, 256, (n, 32), np.uint8)
    return FO.digits_lanes(S.from_bytes32(torch.as_tensor(raw).to(device)))


# (case, point count): random digits; every digit 0; every digit +-8 (one
# bucket holds each list); fewer points than lanes; a last lane step only
# partly filled; every digit negative
CASES = (("random", 300), ("all zero", 300), ("all +-8", 100),
         ("fewer points than lanes", 5), ("ragged lanes", 70),
         ("all negative", 200))


def edge_inputs(case: str, seed: int, device, niels: bool = False):
    """(points (4, 10, n), or Niels points (3, 10, n) when `niels`, digits
    (64, n) int8) of a CASES entry."""
    n = dict(CASES)[case]
    pts = (make_niels if niels else make_points)(n, seed, device)
    dig = make_digits(n, seed + 1, device)
    if case == "all zero":
        dig = torch.zeros_like(dig)
    elif case == "all +-8":
        dig = torch.where(dig < 0, -8, 8).to(torch.int8)
    elif case == "all negative":
        dig = torch.where(dig == 0, -1, -dig.abs()).to(torch.int8)
    return pts, dig.contiguous()


def _ours(name: str) -> bool:
    """K3's and K11's kernels (accumulate_kernel, accumulate_z_kernel,
    bin_kernel, rank_kernel and their template instances, mangled)."""
    return "accumulate" in name or "bin_kernel" in name \
        or "rank_kernel" in name


def ptxas_report(log: str, keep=_ours) -> dict:
    """{kernel: ptxas' lines} for the kernels whose (mangled) names `keep`
    takes, K3's and K11's by default, out of an nvcc log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if keep(m.group(1)) else None
        elif name and ("registers" in line or "spill" in line
                       or "stack" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def sass_counts(so: str, keep=_ours) -> dict:
    """{kernel: [SASS instructions, of them IMAD.WIDE]} for the kernels of
    a built library whose names `keep` takes (K3's and K11's by default),
    by cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1) if keep(m.group(1)) else None
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
        if name and m:
            c = out.setdefault(name, [0, 0])
            c[0] += 1
            c[1] += "IMAD.WIDE" in m.group(1)
    return out


def occupancy_from_ptxas(lines, threads: int) -> int:
    """Resident warps per SM of an H100 for a kernel of `threads`-thread
    blocks from ptxas' registers and shared memory (65,536 registers in
    four sub-partitions of 16,384, allotted 256 per warp, 233,472 B of
    shared memory with 1 KB held per block, at most 32 blocks and 64
    warps)."""
    text = " ".join(lines)
    regs = int(re.search(r"Used (\d+) registers", text).group(1))
    m = re.search(r"(\d+) bytes smem", text)
    smem = int(m.group(1)) if m else 0
    wpb = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(4 * (16384 // per_warp) // wpb, 233472 // (smem + 1024), 32,
                 64 // wpb)
    return blocks * wpb


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, reps: int) -> dict:
    """{kernel: device milliseconds per call} of K3's and K11's kernels over
    `reps` calls of fn(), by torch.profiler (CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if _ours(e.key):
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0)
            out[e.key.split("(")[0]] = t / 1e3 / reps
    return out


def measure(inputs, reps: int, imads: float) -> list:
    """Per size: the accumulation's time (K11 for points of any Z, K3 for
    Niels points), its binning's, each kernel's device time, the bound and
    the exactness checks."""
    from . import timed
    rows = []
    for pts, dig in inputs:
        n = pts.shape[-1]
        niels = pts.shape[0] == 3
        acc, plain, fmuls = ((M.accumulate, M.accumulate_plain, MADD_FMULS)
                             if niels else
                             (M.accumulate_z, M.accumulate_z_plain, ADD_FMULS))
        slab, ms = timed(lambda: acc(pts, dig), reps, "cuda")
        nonzero = int((dig != 0).sum())
        nbytes = pts.numel() * 4 + dig.numel() + slab.numel() * 4
        row = {"kernel": "K3" if niels else "K11", "n": n,
               "lanes": slab.shape[-1], "nonzero": nonzero, "ms": ms,
               "bound_ms": max(nonzero * fmuls * FMUL_MADS / imads,
                               nbytes / PEAK_BYTES) * 1e3}
        row["device_ms"] = device_ms(lambda: acc(pts, dig), reps)
        # trees before K3's binned form bin extended points only
        if hasattr(M, "bin_points") and (not niels
                                         or hasattr(M, "ROW_WORDS")):
            bins, row["bin_ms"] = timed(lambda: M.bin_points(pts, dig), reps,
                                        "cuda")
            row["bin_exact"] = all(
                torch.equal(a, b) for a, b in
                zip(bins, M.bin_points_plain(pts, dig)))
        row["exact"] = bool(torch.equal(slab, plain(pts, dig)))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--niels-sizes", default=",".join(map(str, NIELS_SIZES)))
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("accumulate_z bench: no CUDA device available", file=sys.stderr)
        return 2
    from ..ops import _cuda

    logs = _cuda.build_all()
    ptxas = ptxas_report(logs.get("msm", ""))
    for name, lines in ptxas.items():
        print(name, "|", " | ".join(lines), flush=True)
    warps = M.warps_per_sm() if hasattr(M, "warps_per_sm") else {}
    if "msm_accumulate" not in warps:
        # trees before the binned forms: blocks of 32 threads
        warps.update({name: occupancy_from_ptxas(lines, OLD_THREADS)
                      for name, lines in ptxas.items() if name not in warps
                      and "bin_kernel" not in name})
    card = smi("name,power.limit")
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    imads = sms * IMAD_PER_CLOCK_SM * mhz * 1e6
    sizes = [int(s) for s in args.sizes.split(",") if s]
    niels_sizes = [int(s) for s in args.niels_sizes.split(",") if s]
    inputs = [(make(n, args.seed + n, "cuda"),
               make_digits(n, args.seed + 1 + n, "cuda"))
              for make, ns in ((make_points, sizes), (make_niels, niels_sizes))
              for n in ns]
    rows = measure(inputs, args.reps, imads)
    result = {"bench": "accumulate_z", "reps": args.reps, "sizes": rows,
              "ptxas": ptxas, "warps_per_sm": warps,
              "sass": sass_counts(_cuda._so_path("msm")),
              "exact": all(r["exact"] and r.get("bin_exact", True)
                           for r in rows),
              "card": card, "max_sm_mhz": mhz}
    print(json.dumps(result), flush=True)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
