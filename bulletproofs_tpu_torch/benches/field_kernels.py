"""What the compiler made of every kernel that includes csrc/fe25519.cuh
(K1, K3, K4a, K4b, K5, K6 in both forms, K7, K11, K12), on one CUDA card:

    python -m bulletproofs_tpu_torch.benches.field_kernels [--time]
        [--reps 20]

Builds the libraries (decompress, msm, compress, fixed_msm) and prints one
JSON line per kernel: ptxas' registers, spill stores and loads and static
shared memory (`-Xptxas -v`), the resident warps per SM those allow at the
kernel's block size (65,536 registers allotted 256 a warp, 233,472 B of
shared memory with 1 KB held a block, at most 32 blocks and 64 warps;
dynamic shared memory not counted), and its SASS instructions, IMAD.WIDE
among them (cuobjdump); then a line with the card's name and power limit.
With `--time` it also times, by CUDA events (the mean of `--reps` calls
after a warm-up), the kernels of the m=1 verifier's sub-batch that no
other bench times alone, on seeded inputs of its shapes, each held to its
plain version exactly: K1 (`curve.decompress` of 2048 x 17 = 34,816
encodings), K4a (`msm.reduce` of a 512-lane slab) and K4b (`msm.horner`,
whose arithmetic is its own).
Dropped into an older tree of the port (with this package's
benches/__init__.py and benches/accumulate_z.py) it reports that tree's
kernels, with their block sizes then.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import torch

from . import accumulate_z as AZ

LIBS = ("decompress", "msm", "compress", "fixed_msm")
# (kernel name, template instance?) -> threads a block; K3 ran blocks of
# 32 and K5 of 128 before their template forms; K4a runs lanes / 2 (256 at
# the verifier's 512 lanes), msm_bin `lanes`
THREADS = {("decompress_kernel", False): 128,
           ("compress_kernel", True): 32, ("compress_kernel", False): 128,
           ("accumulate_kernel", True): 128, ("accumulate_kernel", False): 32,
           ("accumulate_z_kernel", False): 128,
           ("bin_kernel", True): 512, ("bin_kernel", False): 512,
           ("reduce_kernel", False): 256, ("horner_kernel", False): 128,
           ("fixed_accumulate_kernel", True): 32,
           ("fixed_accumulate2_kernel", False): 32,
           ("fixed_reduce_kernel", False): 128}


def base_name(mangled: str):
    """(identifier, template instance?) of an Itanium-mangled kernel."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled, False
    k = int(m.group(1))
    rest = mangled[m.end():]
    return rest[:k], rest[k:k + 1] == "I"


def report(lines) -> dict:
    text = " ".join(lines)
    regs = re.search(r"Used (\d+) registers", text)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      text)
    smem = re.search(r"(\d+) bytes smem", text)
    return {"registers": int(regs.group(1)) if regs else None,
            "spill_stores": int(spill.group(1)) if spill else None,
            "spill_loads": int(spill.group(2)) if spill else None,
            "smem": int(smem.group(1)) if smem else 0}


def timings(reps: int) -> dict:
    """{kernel: {ms, exact}} of K1, K4a and K4b at the sub-batch's
    shapes."""
    from ..ops import curve as C
    from ..ops import msm as M
    from . import timed
    raw = C.compress(AZ.make_points(34816, 5, "cuda"))
    slab = M.accumulate_z(AZ.make_points(34946, 6, "cuda"),
                          AZ.make_digits(34946, 7, "cuda"))
    sums = M.reduce(slab)
    out = {}
    for name, fn, plain in (
            ("decompress", lambda: C.decompress(raw),
             lambda: C.decompress_plain(raw)),
            ("msm_reduce", lambda: M.reduce(slab),
             lambda: M.reduce_plain(slab)),
            ("msm_horner", lambda: M.horner(sums),
             lambda: M.horner_plain(sums))):
        got, ms = timed(fn, reps, "cuda")
        want = plain()
        exact = all(torch.equal(a, b) for a, b in zip(got, want)) \
            if isinstance(got, tuple) else bool(torch.equal(got, want))
        out[name] = {"ms": ms, "exact": exact}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("field_kernels: no CUDA device available", file=sys.stderr)
        return 2
    from ..ops import _cuda
    logs = _cuda.build_all()
    for lib in LIBS:
        ptxas = AZ.ptxas_report(logs.get(lib, ""), lambda n: True)
        sass = AZ.sass_counts(_cuda._so_path(lib), lambda n: True)
        for name in sorted(set(ptxas) | set(sass)):
            row = {"lib": lib, "kernel": name}
            row.update(report(ptxas.get(name, [])))
            threads = THREADS.get(base_name(name))
            if threads and row["registers"] is not None:
                row["threads"] = threads
                row["warps_per_sm"] = AZ.occupancy_from_ptxas(
                    ptxas[name], threads)
            row["sass"], row["imad_wide"] = sass.get(name, [None, None])
            print(json.dumps(row), flush=True)
    result = {"card": AZ.smi("name,power.limit")}
    if args.time:
        result["times"] = timings(args.reps)
    print(json.dumps(result), flush=True)
    return 0 if all(t["exact"] for t in result.get("times", {}).values()) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
