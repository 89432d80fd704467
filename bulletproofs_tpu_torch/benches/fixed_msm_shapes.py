"""The prover's fixed-base MSM kernels (K6's two forms, K7, K12) at the
benchmark cells' shapes, on one CUDA card:

    python -m bulletproofs_tpu_torch.benches.fixed_msm_shapes [--reps 5]
        [--parent DIR]

Proves once with each (m, proofs) of `--shapes` (default the two cells:
n = 64, m = 16 over 512 proofs and m = 8 over 1,024) on the
device-transcript route, keeps the first input of
`fixed_msm.msm_digits_niels` at the IPP L stream ((N + 1) 64 rows x the
proofs; public rows) and the S stream ((2N + 1) 64 rows; witness rows),
and times on those inputs, by CUDA events (the mean of `--reps` after a
warm-up):

* the direct form (`accumulate_direct`, over the multiples table and the
  round's row map) and K7's chunk merge on its slab, its points against
  the one-hot form's, compressed; with `--parent DIR`, a checkout of a
  commit whose direct form was still K6's bucket kernel over a
  `DirectSet` (shared-memory buckets, before `fixed_direct_kernel`; e.g.
  `git archive <commit> | tar -x -C DIR`), that checkout's own
  `fixed_msm.cu`, built as it is, on the gathered Niels rows at its own
  split;
* the one-hot form (`accumulate`) and K7 on its slab, and K12
  (`accumulate2`, the two-set form `_ILP2` takes);
* `make_multiples` over the prover's full tables (set-up).

Prints ptxas' registers, spills and shared memory of every fixed_msm
kernel (and the parent's), the resident blocks per SM the runtime reports
for each (`blocks_per_sm`), one JSON object per shape and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
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
    """Wraps fixed_msm.msm_digits_niels (restored by close()) and keeps,
    for the first call at each (digit rows, lanes) of `specs`, a clone of
    (the MSM's Niels rows, its digits, its keywords): for a call on
    TableRows, the rows gathered, and the keywords keep the multiples
    table (`mult`) and the row map (`sel`)."""

    def __init__(self, specs):
        self.specs = {(r, q): name for name, r, q in specs}
        self.got = {}
        self.real = FM.msm_digits_niels
        FM.msm_digits_niels = self

    def __call__(self, niels, digits, consttime=True):
        name = self.specs.get(tuple(digits.shape))
        if name is not None and name not in self.got:
            kw = {"consttime": consttime}
            if isinstance(niels, FM.TableRows):
                kw.update(mult=niels.mult, sel=None if niels.sel is None
                          else niels.sel.clone())
                rows = niels.gathered().clone()
            else:
                rows = niels.clone()
            self.got[name] = (rows, digits.clone(), kw)
        return self.real(niels, digits, consttime)

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


def build(src: str):
    """The parent checkout's fixed_msm.cu `src`, built as it is by nvcc into
    _build/cuda/fixed_msm_shapes/ -> (ctypes library, ptxas' report
    lines)."""
    from ..ops import _cuda
    d = os.path.join(_cuda.CUDA_DIR, "fixed_msm_shapes")
    os.makedirs(d, exist_ok=True)
    so = os.path.join(d, "parent.so")
    out = subprocess.run(
        [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
         "-v", "-I", os.path.dirname(src), "-o", so, src],
        capture_output=True, text=True, timeout=900, check=True)
    return ctypes.CDLL(so), ptxas_lines(out.stdout + out.stderr)


def ptxas_lines(log: str):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def _fn(lib, name, nargs):
    f = getattr(lib, name)
    f.argtypes = [ctypes.c_void_p] * nargs[0] + [ctypes.c_int64] * nargs[1] \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _check(err, what):
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def parent_direct(lib, niels, digits):
    """fn() launching the parent's direct form as the parent's wrapper did
    (its `bp_fixed_accumulate_vt(niels, digits, slab, S, Q, splits,
    stream)`; pick_splits at K6's target, the stream padded) -> slab
    (splits, 8, 4, 10, Q)."""
    niels, digits, splits = FM._split(niels, digits)
    S, Q = digits.shape
    slab = torch.empty((splits, FM.NUM_BUCKETS, 4, 10, Q), dtype=torch.int32,
                       device=digits.device)
    f = _fn(lib, "bp_fixed_accumulate_vt", (3, 3))

    def fn():
        _check(f(niels.data_ptr(), digits.data_ptr(), slab.data_ptr(), S, Q,
                 splits, torch.cuda.current_stream().cuda_stream),
               "parent direct")
        return slab
    return fn


def parent_blocks(lib) -> int:
    """The parent's direct form's resident blocks of 32 lanes an SM (out[1]
    of its bp_fixed_blocks_per_sm)."""
    out = (ctypes.c_int * 4)()
    f = lib.bp_fixed_blocks_per_sm
    f.argtypes, f.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    _check(f(out), "bp_fixed_blocks_per_sm")
    return out[1]


def measure(name, niels, digits, kw, reps: int, parent) -> dict:
    """Every kernel that serves one captured input -> a dict of splits,
    ms and checks."""
    points = lambda slab: C.compress(FM.reduce(slab))   # noqa: E731
    rows, lanes = digits.shape
    slab, ms6 = timed(lambda: FM.accumulate(niels, digits), reps, "cuda")
    _, ms7 = timed(lambda: FM.reduce(slab), reps, "cuda")
    want = points(slab)
    row = {"shape": name, "rows": rows, "lanes": lanes,
           "nonzero_share": float((digits != 0).float().mean()),
           "k6_one_hot_ms": ms6, "one_hot_split": slab.shape[0],
           "k7_ms": ms7, "k7_groups": FM.red_groups(slab.shape[0])}
    if not kw["consttime"]:
        mult, sel = kw["mult"], kw["sel"]
        vt, row["k6_direct_ms"] = timed(
            lambda: FM.accumulate_direct(mult, digits, sel), reps, "cuda")
        _, row["k7_merge_ms"] = timed(lambda: FM.reduce(vt), reps, "cuda")
        row["direct_split"] = vt.shape[0]
        row["direct_points_equal_one_hot"] = bool(torch.equal(points(vt),
                                                              want))
        if parent is not None:
            par, row["parent_direct_ms"] = timed(
                parent_direct(parent, niels, digits), reps, "cuda")
            row["parent_direct_split"] = par.shape[0]
            row["parent_points_equal_one_hot"] = bool(torch.equal(
                points(par), want))
    slab2, row["k12_ms"] = timed(lambda: FM.accumulate2(niels, digits), reps,
                                 "cuda")
    row["k12_split"] = slab2.shape[0]
    row["k12_points_equal_k6"] = bool(torch.equal(points(slab2), want))
    return row


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="16x512,8x1024",
                    help="comma-separated m x proofs to prove and capture")
    ap.add_argument("--parent", default=None,
                    help="a parent checkout whose direct form to time")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fixed_msm_shapes: no CUDA device available", file=sys.stderr)
        return 2
    from .. import BatchProver, BulletproofGens, PedersenGens, Scalar
    from ..ops import _cuda

    for lib, out in _cuda.build_all().items():
        if lib == "fixed_msm":
            for line in ptxas_lines(out):
                print(f"[tree] {line}", flush=True)
    res, parent = {"tree": FM.blocks_per_sm()}, None
    if args.parent:
        parent, plog = build(os.path.join(
            args.parent, "bulletproofs_tpu_torch", "csrc", "fixed_msm.cu"))
        for line in plog:
            print(f"[parent] {line}", flush=True)
        res["parent_direct"] = parent_blocks(parent)
    smi = card_line()
    print(json.dumps({"blocks_per_sm": res, "card": smi}), flush=True)

    r = random.Random(1)
    pc, n = PedersenGens(), 64
    for spec in args.shapes.split(","):
        m, total = (int(x) for x in spec.split("x"))
        prover = BatchProver(BulletproofGens(n, m), pc, n, m, device="cuda")
        _, mult_ms = timed(lambda: FM.make_multiples(prover.tables.niels), 1,
                           "cuda")
        print(json.dumps({"make_multiples_ms": mult_ms, "m": m,
                          "rows": prover.tables.niels.shape[-1],
                          "bytes": prover.tables.mult.numel() * 4,
                          "card": smi}), flush=True)
        vals = [[r.randrange(1 << n) for _ in range(m)] for _ in range(total)]
        bl = [[Scalar.random(r) for _ in range(m)] for _ in range(total)]
        if m == 1:
            vals, bl = [v[0] for v in vals], [b[0] for b in bl]
        lanes = total // 2 if total >= prover.FUSED_HALVES_FROM else total
        got = capture(prover, vals, bl, lanes, 7 + m)
        for name, (niels, digits, kw) in got.items():
            row = measure(name, niels, digits, kw, args.reps, parent)
            row["card"] = smi
            print(json.dumps(row), flush=True)
        del prover, got
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
