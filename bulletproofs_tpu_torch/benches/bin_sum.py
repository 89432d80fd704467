"""The MSM binning kernel (`msm.bin_points`, K3's and K11's binning) and
kernel K19 (`scalar.tree_sum`) alone on one CUDA card, whole and in
parts, with the glue around them on their paths:

    python -m bulletproofs_tpu_torch.benches.bin_sum [--reps 20]
        [--proofs 8192] [--agg-proofs 256] [--msm-points 65536]
        [--label tree]

Every kernel time is device time from memory (`benches.cold`: each call
after a write of twice the L2 cache, queued behind a sleep of the card)
beside the warm queued time (`benches.queued`).

1. The binning at an m = 1 verify sub-batch (130 static Niels points and
   34,816 decoded Z = 1 points: 34,946), at the MSM entry's 65,536 (Niels
   and extended points) and at the R1CS k = 2^15 mega-MSM's 196,653
   (points of any Z).  A tree whose Niels bin takes only Niels points
   pays `curve.to_niels` and a `cat` first: timed beside it (by CUDA
   events around a loop: its constants' uploads block the host).  In a tree
   whose binning is one launch of 64 window blocks and row-copy blocks,
   the parts are timed apart by two patched copies of its `msm.cu`
   (built into `_build/bin_sum/`): the window blocks alone (no row
   blocks launched) and the row blocks alone (the window blocks' branch
   taken by every block).  In a tree whose binning is two launches, the
   first launch's list blocks alone and its row blocks alone (the other
   kind's blocks return at once), the same way.  Each
   kernel's warm device time is torch.profiler's.
2. K19 at 1024 x 512 (the m = 16 round's cross terms), 1024 x 256 (stage
   1's sums at m = 16) and 64 x 8192 (the m = 1 round's), and the ten
   cross sums of an m = 16 prove (N = 1024, P = 256, h = 512 .. 1): the
   masked composition `tree_sum(where(j < h, cat([x, y]), 0))`, and,
   where the tree has it, `tree_sum_prefix(x, y, h)`.
3. The MSM entry at `--msm-points` on both routes, device-resident: a
   warm-up, 5 calls by the host clock ending in a synchronize (median and
   best), a loop of 10 by CUDA events, and one call's kernels by
   torch.profiler (launches, device time).
4. One m = 1 `verify_batch` of `--proofs` card-proved proofs and one
   m = 16 prove of `--agg-proofs` under torch.profiler: kernel launches
   (every kernel and copy the profiler saw), device time, and the
   prove's K19 device time.

Prints one JSON line per part with the card's name and power limit.  It
uses `msm.bin_points`, `scalar.tree_sum`, the MSM entries and the public
prover and verifier, and takes the new calls only where the tree has
them, so dropped into an older tree of the port (with `benches/__init__.py`
and `benches/accumulate_z.py`) it measures that tree.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import Rng, cold, kernel_ms, profiled, queued, timed
from . import accumulate_z as AZ
from .._build import BUILD_DIR
from ..ops import _cuda
from ..ops import curve as C
from ..ops import msm as M
from ..ops import scalar as S

# the one-launch binning kernel's text, and each part's patch of it
_ROWS_PATCH = (("  if (blockIdx.x >= 64) {", "  if (true) {"),
               ("(int64_t)(blockIdx.x - 64) * 32", "(int64_t)blockIdx.x * 32"),
               ("(int64_t)(gridDim.x - 64) * 32", "(int64_t)gridDim.x * 32"),
               ("const unsigned blocks = 64 + (unsigned)",
                "const unsigned blocks = (unsigned)"))
_WINDOWS_PATCH = (("const unsigned blocks = 64 + (unsigned)",
                   "const unsigned blocks = 64 + 0 * (unsigned)"),)
# the two-launch binning's first kernel: its list blocks alone (the row
# blocks return at once) and its row blocks alone (the list blocks return
# at once)
_LISTS_PATCH = (("  if (row) {\n", "  if (row) {\n    return;\n"),)
_NEW_ROWS_PATCH = (("  // lanes is a power of two; 64 nm lanes < 2^31\n",
                    "  return;\n"),)


def _patched_lib(part: str, patches):
    """The tree's msm.cu with `patches` applied (each exactly once), built
    by nvcc; None when the tree's binning is not the one-launch form."""
    with open(os.path.join(_cuda.CSRC, "msm.cu")) as fh:
        text = fh.read()
    for old, new in patches:
        if text.count(old) != 1:
            return None
        text = text.replace(old, new)
    out = os.path.join(BUILD_DIR, "bin_sum")
    os.makedirs(out, exist_ok=True)
    src, so = os.path.join(out, f"{part}.cu"), os.path.join(out, f"{part}.so")
    with open(src, "w") as fh:
        fh.write(text)
    subprocess.run([_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", _cuda.CSRC, "-o", so, src], check=True,
                   capture_output=True, timeout=600)
    return ctypes.CDLL(so)


def _bin_call(lib, points, digits, pre=None):
    """fn() launching `lib`'s binning entry (the one-launch form's, or the
    two-launch form's first launch, its Niels form on `pre`, then
    `points`) on the bin_points outputs."""
    n = digits.shape[-1]
    lanes = M.pick_lanes(n)
    nm = -(-n // (32 * lanes))
    dev = points.device
    niels = points.shape[0] == 3 or pre is not None
    rows = torch.empty((n, M.ROW_WORDS[3 if niels else 4]), dtype=torch.int32,
                       device=dev)
    mask = torch.empty((64, 8, nm, lanes), dtype=torch.int32, device=dev)
    sign = torch.empty((64, nm, lanes), dtype=torch.int32, device=dev)
    cnt, perm = torch.empty((2, 64, 8, lanes), dtype=torch.int32, device=dev)
    f = getattr(lib, "bp_msm_bin_niels" if niels else "bp_msm_bin")
    f.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int64
    if not hasattr(lib, "bp_msm_rank"):
        f.argtypes = [P] * 7 + [I] * 2 + [P]
        args = [t.data_ptr() for t in (points, digits, rows, mask, sign, cnt,
                                       perm)]
    elif niels:
        f.argtypes = [P, I] + [P] * 5 + [I] * 2 + [P]
        args = [pre.data_ptr() or None, pre.shape[-1]] + [
            t.data_ptr() for t in (points, digits, rows, mask, sign)]
    else:
        f.argtypes = [P] * 5 + [I] * 2 + [P]
        args = [t.data_ptr() for t in (points, digits, rows, mask, sign)]

    def fn():
        err = f(*args, n, lanes, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"binning launch failed: cudaError {err}")
    return fn


def _ms(fn, reps):
    return {"cold_ms": cold(fn, reps)[1], "warm_ms": queued(fn, reps)[1]}


def _events_ms(fn, reps):
    """Mean ms of a loop of calls by CUDA events: for glue whose constant
    uploads block the host, so that it cannot be queued behind a sleep."""
    return timed(fn, reps, "cuda")[1]


def bin_part(reps: int, seed: int) -> dict:
    dev = torch.device("cuda")
    z1 = M.normalize_z
    cases = {
        "34946 niels (130 static + 34816 Z = 1)": (
            AZ.make_niels(130, seed, dev), z1(AZ.make_points(34816, seed + 1,
                                                             dev)), 34946),
        "65536 niels (Z = 1)": (torch.empty((3, 10, 0), dtype=torch.int32,
                                            device=dev),
                                z1(AZ.make_points(65536, seed + 2, dev)),
                                65536),
        "65536 extended": (None, AZ.make_points(65536, seed + 3, dev), 65536),
        "196653 extended": (None, AZ.make_points(196653, seed + 4, dev),
                            196653)}
    libs = {"windows": _patched_lib("windows", _WINDOWS_PATCH),
            "rows": _patched_lib("rows", _ROWS_PATCH),
            "lists": _patched_lib("lists", _LISTS_PATCH),
            "new_rows": _patched_lib("new_rows", _NEW_ROWS_PATCH)}
    out = {}
    for label, (niels, ext, n) in cases.items():
        dig = AZ.make_digits(n, seed + 5, dev)
        res = {}
        if niels is None:
            src = ext
            whole = lambda: M.bin_points(src, dig)           # noqa: E731
        else:
            glue = lambda: torch.cat([niels, C.to_niels(ext)],  # noqa: E731
                                     dim=-1).contiguous()
            src = glue()
            res["to_niels_and_cat_events_ms"] = _events_ms(glue, reps)
            res["launches_to_niels_and_cat"] = sum(
                r[1] for r in profiled(glue))
            if hasattr(M, "bin_niels"):             # the two-source form
                whole = lambda: M.bin_niels(niels, ext, dig)  # noqa: E731
                res["one_source_bin"] = _ms(lambda: M.bin_points(src, dig),
                                            reps)
            else:
                whole = lambda: M.bin_points(src, dig)       # noqa: E731
        res["whole"] = _ms(whole, reps)
        res["kernels_warm_ms"] = {k: v for k, v in kernel_ms(whole, reps)
                                  .items() if "bin" in k or "rank" in k}
        for part, lib in libs.items():
            if lib is not None and part in ("windows", "rows"):
                res[part] = _ms(_bin_call(lib, src, dig), reps)
            elif lib is not None:
                res[part] = _ms(_bin_call(lib, ext, dig, niels), reps)
        _cuda.reset_counts()
        whole()
        torch.cuda.synchronize()
        res["launches"] = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        out[label] = res
    return out


def _canonical(n: int, P: int, seed: int) -> torch.Tensor:
    """(n, 9, P) int64 canonical scalars (values below 2^252), seeded."""
    raw = np.random.default_rng(seed).integers(0, 256, (n * P, 32), np.uint8)
    raw[:, 31] &= 15
    v = S.from_bytes32(torch.as_tensor(raw).cuda())          # (9, n P)
    return v.reshape(9, n, P).transpose(0, 1).contiguous()


def sum_part(reps: int, seed: int) -> dict:
    out = {}
    for n, P in ((1024, 512), (1024, 256), (64, 8192)):
        v = _canonical(n, P, seed + n + P)
        res = _ms(lambda: S.tree_sum(v), reps)
        _cuda.reset_counts()
        S.tree_sum(v)
        res["launches"] = _cuda.LAUNCHES["sc_tree_sum"]
        out[f"{n} x {P}"] = res
    N, P = 1024, 256
    prod = _canonical(2 * N, P, seed + 7)
    x, y = prod[:N], prod[N:]
    j = torch.arange(N, device="cuda")
    rounds = {}
    for h in (512 >> k for k in range(10)):
        mh = (j < h)[:, None, None]
        old = _ms(lambda: S.tree_sum(torch.where(mh, torch.cat([x, y], -1),
                                                 0)), reps)
        rounds[h] = {"masked": old}
        if hasattr(S, "tree_sum_prefix"):
            hd = torch.tensor(h, device="cuda")
            rounds[h]["prefix"] = _ms(lambda: S.tree_sum_prefix(x, y, hd),
                                      reps)
    out["m16 cross sums"] = rounds
    out["m16 cross sums total cold_ms"] = {
        form: sum(r[form]["cold_ms"] for r in rounds.values())
        for form in rounds[512]}
    return out


def msm_part(points: int, seed: int) -> dict:
    gen = np.random.default_rng(seed + 60)
    raw = gen.integers(0, 256, (points, 64), dtype=np.uint8)
    sbytes = gen.integers(0, 256, (points, 32), dtype=np.uint8)
    sbytes[:, 31] &= 15
    pts = C.from_uniform_bytes(raw, "cuda")
    inputs = {"msm_lanes_flag": pts, "msm_lanes_niels_flag": M.normalize_z(pts)}
    sc = torch.from_numpy(sbytes).cuda()
    out = {}
    for route, p in inputs.items():
        fn = getattr(M, route)
        fn(p, sc)
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(p, sc)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        rows = profiled(lambda: fn(p, sc))
        out[route] = {"walls_ms": walls, "median_ms": statistics.median(walls),
                      "best_ms": min(walls),
                      "events_ms": _events_ms(lambda: fn(p, sc), 10),
                      "device_ms": sum(r[0] for r in rows),
                      "launches": sum(r[1] for r in rows)}
    return out


def path_part(proofs: int, agg_proofs: int, seed: int) -> dict:
    from .. import (BatchProver, BatchVerifier, BulletproofGens, PedersenGens,
                    Scalar, Transcript)
    n, out = 64, {}
    pc = PedersenGens()
    for m, count in ((1, proofs), (16, agg_proofs)):
        rng = Rng(seed + m)
        bp = BulletproofGens(n, m)
        prover = BatchProver(bp, pc, n, m, device="cuda")

        def draw():
            return rng.r.randrange(1 << n)
        values = [draw() if m == 1 else [draw() for _ in range(m)]
                  for _ in range(count)]
        blinds = [Scalar.random(rng) if m == 1
                  else [Scalar.random(rng) for _ in range(m)]
                  for _ in range(count)]
        labels = [b"bin sum bench %d" % i for i in range(count)]

        def prove(s):
            got = prover.prove_batch(values, blinds,
                                     [Transcript(x) for x in labels],
                                     rng=Rng(s))
            torch.cuda.synchronize()
            return got
        proofs_m, vcs = prove(seed + 100)
        rows = profiled(lambda: prove(seed + 101))
        res = {"prove_launches": sum(r[1] for r in rows),
               "prove_device_ms": sum(r[0] for r in rows),
               "prove_k19_ms": sum(r[0] for r in rows
                                   if "tree_sum" in r[2]),
               "prove_k19_launches": sum(r[1] for r in rows
                                         if "tree_sum" in r[2])}
        if m == 1:
            bv = BatchVerifier(bp, pc, n=n, m=m, device="cuda")
            vcss = [[v] for v in vcs]

            def verify(s):
                bv.verify_batch(proofs_m, vcss,
                                [Transcript(x) for x in labels], rng=Rng(s))
                torch.cuda.synchronize()
            verify(seed + 300)
            rows = profiled(lambda: verify(seed + 301))
            res.update(verify_launches=sum(r[1] for r in rows),
                       verify_device_ms=sum(r[0] for r in rows))
        out[f"m={m}"] = res
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--proofs", type=int, default=8192)
    ap.add_argument("--agg-proofs", type=int, default=256)
    ap.add_argument("--msm-points", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bin_sum: no CUDA device available", file=sys.stderr)
        return 2
    card = AZ.smi("name,power.limit")
    for part, fn in (("bin", lambda: bin_part(args.reps, args.seed)),
                     ("tree_sum", lambda: sum_part(args.reps, args.seed)),
                     ("msm_entry", lambda: msm_part(args.msm_points,
                                                    args.seed)),
                     ("paths", lambda: path_part(args.proofs,
                                                 args.agg_proofs,
                                                 args.seed))):
        print(json.dumps({"label": args.label, "part": part, "card": card,
                          "result": fn()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
