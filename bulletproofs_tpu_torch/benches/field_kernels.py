"""What the compiler made of every kernel that includes csrc/fe25519.cuh
(K1, K3, K4a, K4b, K5, K6 in both forms, K7, K11, K12) or
csrc/sc25519.cuh (K8, K9, K10, K14), on one CUDA card:

    python -m bulletproofs_tpu_torch.benches.field_kernels [--time]
        [--reps 20]

Builds the libraries (decompress, msm, compress, fixed_msm, fold) and
prints one JSON line per kernel: ptxas' registers, spill stores and loads
and static shared memory (`-Xptxas -v`), the resident warps per SM those
allow at the kernel's block size (`accumulate_z.occupancy_from_ptxas`),
its SASS instructions, IMAD.WIDE among them, and the instructions in
each compiled loop's body (cuobjdump); then a line with the card's name
and power limit and, where the tree has the query, K1's resident points
that the CUDA runtime reports.  With `--time` it also times, by
CUDA events (the mean of `--reps` calls after a warm-up), kernels that
no other bench times alone, on seeded inputs, each held to its plain
version exactly: K1 (`curve.decompress`) at 8,192, 33,792, 34,816 (an m=1
verifier sub-batch, 2048 x 17), 45,056 (the linear batch's 2048 x 22)
and 65,579 (the R1CS k = 2^15 shuffle's) encodings, with the waves of
resident blocks each takes, K4a (`msm.reduce` of a 512-lane slab), K4b
(`msm.horner`, whose arithmetic is its own) and K14 (`scalar.sinv`) at
256 and 4096 challenges, with 0, 1 and l - 1 among them.
Dropped into an older tree of the port (with this package's
benches/__init__.py and benches/accumulate_z.py) it reports that tree's
kernels, with their block sizes then.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys

import torch

from . import accumulate_z as AZ

LIBS = ("decompress", "msm", "compress", "fixed_msm", "fold")
# (kernel name, template instance?) -> threads a block; K1 ran blocks of
# 128 before its blocks of one warp, K3 of 32 and K5 of 128 before their
# template forms; K4a runs lanes / 2 (256 at the verifier's 512 lanes),
# msm_bin `lanes`
THREADS = {("decompress_kernel", False): 32,
           ("compress_kernel", True): 32, ("compress_kernel", False): 128,
           ("accumulate_kernel", True): 128, ("accumulate_kernel", False): 32,
           ("accumulate_z_kernel", False): 128,
           ("bin_kernel", True): 512, ("bin_kernel", False): 512,
           ("reduce_kernel", False): 256, ("horner_kernel", False): 128,
           ("fixed_accumulate_kernel", True): 32,
           ("fixed_accumulate2_kernel", False): 32,
           ("fixed_reduce_kernel", False): 128,
           ("fold_kernel", False): 128, ("smul_kernel", False): 128,
           ("digits_kernel", False): 128, ("sinv_kernel", False): 128}

# K14's work (csrc/sc25519.cuh sc_invert), counted from what the compiler
# made of it for sm_90a (cuobjdump -sass; `loop_bodies` reports the loop):
# 20 batches of one loop body, 30 divsteps and the batch's matrix updates
# of f, g, d and e, 1,082 instructions, 4 of them the loop's counter and
# branch.  So a batch needs 1,078 32-bit integer operations (LOP3, IADD,
# IMAD, SHF, IMAD.WIDE), each counted once at the multiply-add rate (64 a
# clock an SM at compute capability 9.0); the ~290 instructions outside
# the loop (loads, limb conversions, normalisation, stores) are not
# counted, so the bound stays below what the function needs.
SINV_DIVSTEPS = 20 * 30
SINV_BATCH_OPS = 1082 - 4
SINV_OPS = 20 * SINV_BATCH_OPS
# K14's latency floor: the dependent instructions on its critical path,
# read off the kernel's SASS (cuobjdump -sass), times the least latency of
# one (4 cycles, as benches/horner.py).  A divstep is 6 deep: the new f
# (LOP3 g & c1 & c2, IMAD.IADD), the next x = (f ^ c1) - c1 (LOP3,
# IMAD.IADD), x & c2 (LOP3) and g + (x & c2) (IADD3); the next batch
# waits 8 more on the first limbs of f and g (two IMAD.WIDE, the 64-bit
# shift's two SHF, two IMAD.WIDE, an add and the mask); the limb
# conversions, loads, normalisation and stores add ~60.
SINV_CHAIN = SINV_DIVSTEPS * 6 + 20 * 8 + 60
SINV_LEAST_LATENCY = 4


def sinv_latency_floor_ms(mhz: float) -> float:
    """Least milliseconds of one thread's K14 chain at an SM clock of mhz
    (every launch of the prover is one wave, so a launch's floor)."""
    return SINV_LEAST_LATENCY * SINV_CHAIN / (mhz * 1e3)


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


# K1's point counts: 8,192 (256 warps, fewer than the card's 528
# sub-partitions), 33,792 (one wave at 8 warps an SM on 132 SMs, K1's
# residency at blocks of 128 and 222 registers), an m=1 verifier sub-batch
# (2048 x 17), the linear batch (2048 x 22) and the R1CS k = 2^15
# shuffle's encodings; K14's challenge counts (m=16 and m=1 provers)
K1_SIZES = (8192, 33792, 34816, 45056, 65579)
K14_SIZES = (256, 4096)


def encodings(n: int, seed: int) -> torch.Tensor:
    """(n, 32) uint8 on the card: seeded point encodings with the invalid
    ones chip_smoke.py crafts first (non-canonical p + 1, a negative one,
    64 random byte strings)."""
    from ..ops import curve as C
    raw = C.compress(AZ.make_points(n, seed, "cuda"))
    raw[0] = torch.tensor(list(((1 << 255) - 18).to_bytes(32, "little")),
                          dtype=torch.uint8)
    raw[1, 0] |= 1
    g = torch.Generator().manual_seed(seed)
    raw[2:66] = torch.randint(0, 256, (64, 32), generator=g,
                              dtype=torch.uint8).cuda()
    raw[2:66, 31] &= 127
    return raw


def challenges(n: int, seed: int) -> torch.Tensor:
    """(9, n) int64 canonical scalars on the card: 0, 1, l - 1, then
    seeded values below l."""
    import random
    from ..core.scalar import L as ELL
    from ..ops.limbs import sc_ints_to_limbs
    r = random.Random(seed)
    vals = [0, 1, ELL - 1] + [r.randrange(ELL) for _ in range(n - 3)]
    return torch.as_tensor(sc_ints_to_limbs(vals)).cuda()


def loop_bodies(so: str) -> dict:
    """{kernel: [SASS instructions from each backward branch's target to
    the branch, both included]} of a built library (cuobjdump -sass): the
    bodies of its compiled loops, 16 bytes an instruction."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/[^;]*\bBRA\s+(0x[0-9a-f]+)",
                     line)
        if name and m:
            at, to = int(m.group(1), 16), int(m.group(2), 16)
            if to < at:
                out.setdefault(name, []).append((at - to) // 16 + 1)
    return out


def timings(reps: int) -> dict:
    """{kernel at size: {ms, exact}} of K1 at K1_SIZES (with its waves,
    where the tree has the query), K4a and K4b at the verifier sub-batch's
    shapes and K14 at K14_SIZES."""
    from ..ops import curve as C
    from ..ops import msm as M
    from ..ops import scalar as S
    from . import timed
    cases = []
    for n in K1_SIZES:
        raw = encodings(n, 5)
        cases.append((f"decompress {n}", lambda raw=raw: C.decompress(raw),
                      lambda raw=raw: C.decompress_plain(raw)))
    slab = M.accumulate_z(AZ.make_points(34946, 6, "cuda"),
                          AZ.make_digits(34946, 7, "cuda"))
    sums = M.reduce(slab)
    cases += [("msm_reduce", lambda: M.reduce(slab),
               lambda: M.reduce_plain(slab)),
              ("msm_horner", lambda: M.horner(sums),
               lambda: M.horner_plain(sums))]
    for n in K14_SIZES:
        x = challenges(n, 8)
        cases.append((f"sinv {n}", lambda x=x: S.sinv(x),
                      lambda x=x: S.sinv_plain(x)))
    out = {}
    for name, fn, plain in cases:
        got, ms = timed(fn, reps, "cuda")
        want = plain()
        exact = all(torch.equal(a, b) for a, b in zip(got, want)) \
            if isinstance(got, tuple) else bool(torch.equal(got, want))
        out[name] = {"ms": ms, "exact": exact}
    if hasattr(C, "decompress_waves"):
        for n in K1_SIZES:
            out[f"decompress {n}"]["waves"] = C.decompress_waves(n)
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
        loops = loop_bodies(_cuda._so_path(lib))
        for name in sorted(set(ptxas) | set(sass)):
            row = {"lib": lib, "kernel": name}
            row.update(report(ptxas.get(name, [])))
            threads = THREADS.get(base_name(name))
            if threads and row["registers"] is not None:
                row["threads"] = threads
                row["warps_per_sm"] = AZ.occupancy_from_ptxas(
                    ptxas[name], threads)
            row["sass"], row["imad_wide"] = sass.get(name, [None, None])
            row["loop_bodies"] = loops.get(name, [])
            print(json.dumps(row), flush=True)
    result = {"card": AZ.smi("name,power.limit")}
    from ..ops import curve as C
    if hasattr(C, "decompress_resident"):
        result["decompress_resident"] = C.decompress_resident()
    if args.time:
        result["times"] = timings(args.reps)
    print(json.dumps(result), flush=True)
    return 0 if all(t["exact"] for t in result.get("times", {}).values()) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
