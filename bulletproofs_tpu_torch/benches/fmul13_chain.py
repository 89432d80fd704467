"""Kernels K15 and K16 (csrc/fmul13.cu, the MXU probe's two chains) alone
on one CUDA card:

    python -m bulletproofs_tpu_torch.benches.fmul13_chain
        [--lanes 512,16384] [--steps 1024] [--reps 5] [--sweep]
        [--phases] [--label tree] [--sass PATH]

For each lane count Q, seeded limbs below 2^13 and 3 T operands go
through `fmul13.chain_vpu` (K15) and `chain_mxu` (K16), each timed three
ways: `ms` by CUDA events around `--reps` calls after a warm-up, `queued_ms`
with the calls queued behind a sleep of the card (`benches.queued`) and
`kernel_ms` by torch.profiler; the two outputs must be equal limb for limb
and equal the plain versions on the first 64 lanes.  One JSON line a
(kernel, Q), then one with the card's name and power limit, nvcc's
register report and SASS counts of the two kernels, and their residency
where the tree has `fmul13.residency`.  `--sweep` also builds copies of
fmul13.cu with other shapes (`VARIANTS`: K15's and K16's lanes a block,
K16's ring stages) into `_build/cuda/fmul13_sweep/` and times
each the same way, held to the tree's output; `--phases` builds one with
FMUL13_PHASES and prints the median cycles of each phase of K16's step
(clock64 marks of block 0).  `--sass` writes the library's SASS there
(cuobjdump).  Dropped into an older tree of the port
(with benches/__init__.py) it times that tree's K15 and K16 through the
same wrappers, so run parent, tree, tree, parent in one call.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from ..ops import fmul13 as F

# the shapes of --sweep, as fmul13.cu's macros: VPU_WARPS (K15's lanes a
# block), MMA_BLOCK_LANES (K16's), MMA_XWARPS (its warps that run products
# only), MMA_STAGES (its ring); the tree's own are 4, 8, 15, 4
VARIANTS = ({"VPU_WARPS": 2, "MMA_XWARPS": 5},
            {"VPU_WARPS": 8, "MMA_XWARPS": 7},
            {"MMA_XWARPS": 0},
            {"MMA_STAGES": 8},
            {"MMA_BLOCK_LANES": 16})


def chain_inputs(q: int, t: int, seed: int):
    """(a (20, q) int32, b3 (3, 20, t) int32, m3 (3, t, 156, 40) int8) on
    the card: limbs below 2^13 drawn by numpy."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 1 << F.LIMB_BITS, (F.L, q)).astype(np.int32)
    bl = rng.randint(0, 1 << F.LIMB_BITS, (3 * t, F.L))
    b3 = np.ascontiguousarray(bl.reshape(3, t, F.L).transpose(0, 2, 1)
                              .astype(np.int32))
    m3 = F.band_matrices(bl).reshape(3, t, F.MROWS, F.MCOLS)
    return (torch.as_tensor(a).cuda(), torch.as_tensor(b3).cuda(),
            torch.as_tensor(np.ascontiguousarray(m3)).cuda())


def label(defines: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(defines.items()))


def build_variants(variants):
    """{label: .so path} of fmul13.cu built with each dict of macros (all at
    once) into _build/cuda/fmul13_sweep/, and {label: nvcc log}."""
    from ..ops import _cuda
    d = os.path.join(_cuda.CUDA_DIR, "fmul13_sweep")
    os.makedirs(d, exist_ok=True)
    procs, out, logs = {}, {}, {}
    for defines in variants:
        v = label(defines)
        so = os.path.join(d, "libfmul13-%s.so" % v.replace(",", "-")
                          .replace("=", ""))
        cmd = [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", *[f"-D{k}={x}" for k, x in defines.items()],
               "-I", _cuda.CSRC, "-o", so,
               os.path.join(_cuda.CSRC, "fmul13.cu")]
        procs[v] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT))
    for v, (so, p) in procs.items():
        logs[v] = p.communicate(timeout=600)[0].decode(errors="replace")
        if p.returncode != 0:
            raise RuntimeError(f"variant {v} failed to build:\n{logs[v]}")
        out[v] = so
    return out, logs


def variant_fn(so: str, fn: str, a, x):
    """A call of export `fn` of library `so` on (a, x): the same launch as
    the tree's wrappers make."""
    lib = ctypes.CDLL(so)
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
    f.restype = ctypes.c_int

    def call():
        out = torch.empty_like(a)
        err = f(a.data_ptr(), x.data_ptr(), out.data_ptr(), a.shape[1],
                x.shape[-1] if x.dim() == 3 else x.shape[1],
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn} of {so}: cudaError {err}")
        return out
    return call


def phases(so: str, a, m3) -> dict:
    """K16 of a library built with FMUL13_PHASES on (a, m3): the median
    cycles between its phase marks over steps 8-63 of block 0."""
    lib = ctypes.CDLL(so)
    variant_fn(so, "bp_fmul13_chain_mma", a, m3)()
    torch.cuda.synchronize()
    marks = np.zeros((7, 64), np.int64)
    lib.bp_fmul13_phases.argtypes = [ctypes.c_void_p]
    if lib.bp_fmul13_phases(marks.ctypes.data_as(ctypes.c_void_p)):
        raise RuntimeError("reading the phase marks failed")
    m = marks[:, 8:]
    step = m[0, 1:] - m[0, :-1]
    med = lambda x: float(np.median(x))
    return {"step": med(step),
            "products": med(m[1] - m[0]), "first_barrier": med(m[2] - m[1]),
            "next_fragments": med(m[3] - m[2]), "tail": med(m[4] - m[3]),
            "second_barrier": med(m[0, 1:] - m[4, :-1]),
            "copier_after_first_barrier": med(m[5] - m[2]),
            "copier_refill": med(m[6] - m[5])}


def three_ways(fn, reps: int) -> dict:
    from . import kernel_ms, queued, timed
    out, ms = timed(fn, reps, "cuda")
    return {"ms": ms, "queued_ms": queued(fn, reps)[1],
            "kernel_ms": sum(kernel_ms(fn, reps).values())}, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", default="512,16384")
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--sass", default="")
    ap.add_argument("--phases", action="store_true",
                    help="also K16 built with FMUL13_PHASES: the cycles of "
                         "each phase of a step at the first lane count")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fmul13_chain: no CUDA device available", file=sys.stderr)
        return 2
    from ..ops import _cuda
    from . import accumulate_z as AZ
    logs = _cuda.build_all()
    so = _cuda._so_path("fmul13")
    ours = lambda n: "fmul13" in n
    summary = {"label": args.label, "card": AZ.smi("name,power.limit"),
               "max_sm_mhz": float(AZ.smi("clocks.max.sm").split()[0]),
               "ptxas": AZ.ptxas_report(logs.get("fmul13", ""), ours),
               "sass": AZ.sass_counts(so, ours)}
    if hasattr(F, "residency"):
        summary["residency"] = F.residency()
    if args.sass:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        with open(args.sass, "w") as fh:
            fh.write(subprocess.run([tool, "-sass", so], capture_output=True,
                                    text=True, timeout=300, check=True).stdout)
    try:
        from .field_kernels import fmul13_latency_floor_ms
        summary["latency_floor_ms"] = {
            k: fmul13_latency_floor_ms(summary["max_sm_mhz"], k, args.steps)
            for k in ("K15", "K16")}
    except ImportError:
        pass
    variants, extra = {}, []
    if args.sweep:
        extra += VARIANTS
    if args.phases:
        extra.append({"FMUL13_PHASES": 1})
    if extra:
        variants, vlogs = build_variants(extra)
        summary["variant_ptxas"] = {
            v: AZ.ptxas_report(vlogs[v], ours) for v in variants}
    phase_so = variants.pop(label({"FMUL13_PHASES": 1}), None)
    ok = True
    lanes = [int(x) for x in args.lanes.split(",")]
    first_q = lanes[0]
    for q in lanes:
        a, b3, m3 = chain_inputs(q, args.steps, q)
        cases = [("K15", "bp_fmul13_chain", b3, lambda: F.chain_vpu(a, b3)),
                 ("K16", "bp_fmul13_chain_mma", m3, lambda: F.chain_mxu(a, m3))]
        outs = {}
        for name, _, _, fn in cases:
            row, outs[name] = three_ways(fn, args.reps)
            print(json.dumps({"label": args.label, "kernel": name, "Q": q,
                              "T": args.steps, **row}), flush=True)
        n = min(q, 64)
        exact = bool(torch.equal(outs["K15"], outs["K16"])) and bool(
            torch.equal(outs["K15"][:, :n],
                        F.chain_vpu_plain(a[:, :n].contiguous(), b3))) and bool(
            torch.equal(outs["K16"][:, :n],
                        F.chain_mxu_plain(a[:, :n].contiguous(), m3)))
        print(json.dumps({"label": args.label, "Q": q, "exact": exact}),
              flush=True)
        ok &= exact
        if phase_so:
            print(json.dumps({"label": "phases", "kernel": "K16", "Q": q,
                              **phases(phase_so, a, m3)}), flush=True)
            phase_so = None
        for v, vso in variants.items():
            if "FMUL13_PHASES" in v and q == first_q:
                print(json.dumps({"label": v, "kernel": "K16", "Q": q,
                                  **phases(vso, a, m3)}), flush=True)
            for name, fn_name, x, _ in cases:
                fn = variant_fn(vso, fn_name, a, x)
                row, out = three_ways(fn, args.reps)
                same = bool(torch.equal(out, outs[name]))
                ok &= same
                print(json.dumps({"label": v, "kernel": name,
                                  "Q": q, "T": args.steps, **row,
                                  "exact": same}), flush=True)
        del a, b3, m3
        torch.cuda.empty_cache()
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
