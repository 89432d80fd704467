"""What the compiler made of every kernel that includes csrc/fe25519.cuh
(K1, K3, K4a, K4b, K5, K6 in both forms, K7, K11, K12) or
csrc/sc25519.cuh (K2, K8, K9, K10, K14), and of K13, K15 and K16, on one
CUDA card:

    python -m bulletproofs_tpu_torch.benches.field_kernels [--time]
        [--reps 20] [--only smul,digits]

Builds the libraries (decompress, emit, msm, compress, fixed_msm, fold,
keccak, fmul13) and prints one JSON line per kernel: ptxas' registers, spill
stores and loads and static shared memory (`-Xptxas -v`), the resident
warps per SM those allow at the kernel's block size
(`accumulate_z.occupancy_from_ptxas`; not for K2 and K4a, whose residency
the runtime reports, nor K13), its SASS instructions, IMAD.WIDE among
them, and the instructions in each compiled loop's body (cuobjdump); then
a line with the card's name and power limit and, where the tree has the
queries, K1's resident points and K2's and K4a's resident warps per SM
that the CUDA runtime reports (K2's with its dynamic shared memory, which
ptxas does not see).  With `--time` it also times kernels that no other
bench times alone, on seeded inputs, each held to its plain version
exactly, three ways: `ms` by CUDA events around a loop of `--reps` calls
after a warm-up (the host's launch pace where a kernel is shorter than
its launch), `queued_ms` by the same events with the calls queued behind
a sleep of the card (device time, back to back: `benches.queued`) and
`kernel_ms` by torch.profiler (the kernels' own durations, summed per
call).  The cases: K1 (`curve.decompress`) at 8,192, 33,792, 34,816 (an
m=1 verifier sub-batch, 2048 x 17), 45,056 (the linear batch's 2048 x 22)
and 65,579 (the R1CS k = 2^15 shuffle's) encodings, with the waves of
resident blocks each takes, K2 (`verify.emit`) on a 2048-proof
sub-batch's challenge blocks at n = 64, m = 1, K4a (`msm.reduce`) at 512,
256, 128 and 64 lanes (an m=1 verifier sub-batch's 34,946 points, the
R1CS batch's 8,260, an m=16 chunk's 8,160 and the chunked verifier's
final 2,052), K4b (`msm.horner`, whose arithmetic is its own), K14
(`scalar.sinv`) at 256 and 4096 challenges, with 0, 1 and l - 1 among
them; K8 on the IPP round 1 of the m=1 (64 x 4096) and m=16 (1024 x 256)
provers: `fold.fold_pair` (one launch for a and b) where the tree has it,
and the six-launch form of an older `fold_dyn` (two `index_select`, two
`fold_lanes`, two `where`), with the kernels one `prover_stages.fold_dyn`
call launches; K9 on the same round's gw and hw: `fold.smul_pair` (one
launch for both) where the tree has it, and two `smul_lanes` launches,
beside a PyTorch copy of the same bytes (`clone pair`: what the memory
gives that traffic); K10 (`fold.digits_lanes`) on the m=1 and m=16
provers' S coefficients (129 x 4096, 2049 x 256); K13 at 4096 and 256
transcript states with a transcript's pad: one launch where the tree's `f1600_state_bytes` takes the pad, and
the two-launch form (an XOR, then the permutation), K13 alone on the
states with no pad, and the tree's K13
built with its 24 rounds cut to none (loads and stores alone, into
`_build/cuda/loads_only/`: a measurement, never loaded by the port).
K15 and K16 (`fmul13.chain_vpu`, `chain_mxu`) at 512 and 16,384 lanes,
T = 1024 (benches/fmul13_chain.py times them alone, with a sweep of
their shapes), with their bound and latency floor.
K2's, K4a's and K13's lines carry their bound and latency floor at the
card's maximum SM clock, K8's, K9's and K10's their bound.  `--only`
times only the cases whose names hold one of its words.  Dropped into an
older tree of the port (with this package's benches/__init__.py and
benches/accumulate_z.py) it reports that tree's kernels; K2's and K4a's
resident warps only where the tree has their queries.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import shutil
import subprocess
import sys

import torch

from . import accumulate_z as AZ

LIBS = ("decompress", "emit", "msm", "compress", "fixed_msm", "fold",
        "keccak", "fmul13")
# (kernel name, template instance?) -> threads a block; K1 ran blocks of
# 128 before its blocks of one warp, K3 of 32 and K5 of 128 before their
# template forms; msm_bin `lanes`.  K2's and K4a's resident warps come from
# the runtime's occupancy queries (verify.warps_per_sm, msm.warps_per_sm),
# where the tree has them
THREADS = {("decompress_kernel", False): 32,
           ("compress_kernel", True): 32, ("compress_kernel", False): 128,
           ("accumulate_kernel", True): 128, ("accumulate_kernel", False): 32,
           ("accumulate_z_kernel", False): 128,
           ("bin_kernel", True): 512, ("bin_kernel", False): 512,
           ("horner_kernel", False): 128,
           ("fixed_accumulate_kernel", True): 32,
           ("fixed_accumulate2_kernel", False): 32,
           ("fixed_reduce_kernel", False): 128,
           ("fold_kernel", False): 128, ("smul_kernel", False): 128,
           ("digits_kernel", False): 128, ("sinv_kernel", False): 128,
           ("fmul13_chain_kernel", False): 128}

# the least latency of a dependent arithmetic instruction, in cycles (as
# benches/horner.py): every latency floor below counts its chain's
# instructions at this
LEAST_LATENCY = 4

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


def sinv_latency_floor_ms(mhz: float) -> float:
    """Least milliseconds of one thread's K14 chain at an SM clock of mhz
    (every launch of the prover is one wave, so a launch's floor)."""
    return LEAST_LATENCY * SINV_CHAIN / (mhz * 1e3)


# K2's work: the Montgomery products of the emit function under its
# cheapest schedule (`emit_mont_muls`), 171 64-bit multiply-adds each,
# two 32-bit ones apiece at the card's integer rate
SC_MUL_MADS = 171 * 2
# dependent instructions of one Montgomery product (sc25519.cuh
# sc_mont_mul), read from the source: 9 CIOS rounds of 8 (t0 + a_i b_0
# IMAD.WIDE, the low-bit mask LOP3, the quotient IMAD, its mask LOP3,
# + q l_0 IMAD.WIDE, the shift SHF, the 64-bit add of the next limb IADD3
# and IADD3.X), the final carry chain (8 x 3) and the conditional
# subtraction of l (8 x 3 and a select)
SC_MUL_CHAIN = 9 * 8 + 8 * 3 + 8 * 3 + 1
# dependent instructions of one complete addition (fe25519.cuh ge_add):
# its longest path is C = (T 2d) T', F = D - C, X = E F, three field
# products of 26 (a column of up to ten chained IMAD.WIDE, the x19 fold 2,
# carry round 1 5, rounds 2-3 9) and two operand sums
GE_ADD_CHAIN = 3 * 26 + 2


def emit_mont_muls(n: int, m: int, P: int) -> int:
    """Montgomery products of the emit function for P proofs under its
    cheapest schedule: the challenge block into the Montgomery domain but
    rc, -a and -b (lg + 5), the prefix chain and the suffix chain to
    prod(u) (a chain's first term from one is its factor), u_k^2, u_k^-2
    (3 lg - 2: the ends take one factor fewer), y^-2^j, z^j, the dynamic
    coefficients, made plain from r and rc as read (r itself by one
    product by one), the three seeds (-a t0, -b t0r, rzz) with t0, t0r and
    rz, two factors a bit for the second and third tables, and the three
    tables of plain g and h terms by doubling, one product a row, after
    which g_i and h_i are additions and nothing leaves the Montgomery
    domain by a product.  K2 (ops/verify.emit_schedule) makes these and a
    few more: a tree of prod(u) beside the suffix chain (lg - 2, for a
    shorter chain), and above nm = 64 the split tables' hi rows and 3
    products for each i >= 64.  K2's first form made 3 popcount(i) + 4
    products for each (proof, i) and more per proof; the same count bounds
    both."""
    nm = n * m
    lg = nm.bit_length() - 1
    per_proof = ((lg + 5)                     # into the Montgomery domain
                 + max(lg - 2, 0) + max(lg - 1, 0)   # prefix, suffix chains
                 + lg + max(3 * lg - 2, 0)    # u_k^2, u_k^-2
                 + max(lg - 1, 0) + max(m - 2, 0)    # y^-2^j, z^j
                 + 2 * lg + m + 5             # the dynamic coefficients
                 + 6                          # rz, t0, t0r and the seeds
                 + 2 * lg                     # the tables' factors
                 + 3 * (nm - 1))              # the tables
    return P * per_proof


def emit_latency_floor_ms(n: int, m: int, mhz: float) -> float:
    """Least milliseconds of K2's longest dependent chain at an SM clock of
    mhz: into the Montgomery domain (1), the schedule's dependency depth
    (lg + min(lg, 6) + 1 products: the suffix chain, u_0^-2, the second
    table's factor and its doubling levels) and above nm = 64 a hi row's
    product (1), each SC_MUL_CHAIN dependent instructions of
    LEAST_LATENCY cycles."""
    lg = (n * m).bit_length() - 1
    depth = 1 + lg + min(lg, 6) + 1 + (lg > 6)
    return LEAST_LATENCY * depth * SC_MUL_CHAIN / (mhz * 1e3)


def reduce_latency_floor_ms(lanes: int, mhz: float) -> float:
    """Least milliseconds of K4a's chain at an SM clock of mhz: log2(lanes)
    dependent complete additions of GE_ADD_CHAIN instructions (the loads
    and shuffles not counted)."""
    return LEAST_LATENCY * (lanes.bit_length() - 1) * GE_ADD_CHAIN \
        / (mhz * 1e3)


# K8's multiply-adds: a folded element is one sc_mont_mul_sum (9 x 9 limb
# products twice, the reduction's 9 x 9 and 9 quotients), u R and v R one
# sc_mont_mul (171 limb products) each per proof; two 32-bit multiply-adds
# a limb product
FOLD_ELEMENT_MADS = 2 * (3 * 81 + 9)
FOLD_FACTOR_MADS = 2 * 171
# IPP round 1 of the m=1 prover (one half of 8192 proofs) and of the m=16
# prover (256 proofs): (N rows, P proofs)
FOLD_SHAPES = ((64, 4096), (1024, 256))
# K10's inputs: the S coefficients of the m=1 (2n + 1 = 129 rows, one
# half's 4096 proofs) and the m=16 prover (2nm + 1 = 2049, 256 proofs);
# its work: 72 bytes in and 64 out a scalar against the guard's 9 small
# limb products (18 multiply-adds)
DIGITS_SHAPES = ((129, 4096), (2049, 256))
DIGITS_MADS = 18
# K13's states: one half of the m=1 prover's 8192 transcripts, the m=16
# prover's 256
K13_SIZES = (4096, 256)
# K13's latency floor: per round two shared-memory round trips (a store,
# the block's barrier, a load; each counted as one shared load's latency,
# ~30 cycles on recent NVIDIA parts, the barrier free) and 7 dependent
# instructions (the rotation by one, theta's two LOP3, rho's select and
# funnel shift; chi's LOP3, the parity's LOP3), x 24 rounds; the global
# loads and stores not counted
SMEM_TRIP = 30
KECCAK_ROUND_CYCLES = 2 * SMEM_TRIP + 7 * 4


def fold_work(N: int, P: int, nk: int):
    """(bytes, 32-bit multiply-adds) of K8's round: a and b read and
    written once (and the maps, u and u^-1), against 2 nk P folded
    elements and the 2 P Montgomery factors."""
    return (4 * N * 9 * 8 * P + 2 * 9 * 8 * P + 9 * N,
            2 * nk * P * FOLD_ELEMENT_MADS + 2 * P * FOLD_FACTOR_MADS)


def smul_work(N: int, P: int):
    """(bytes, 32-bit multiply-adds) of K9's round: gw and hw read and
    written once (and the mask and the two multipliers), against 2 N P
    products of one Montgomery multiplication and the 2 P factors m1 R,
    m0 R."""
    return (4 * N * 9 * 8 * P + 2 * 9 * 8 * P + N,
            (2 * N * P + 2 * P) * FOLD_FACTOR_MADS)


def work_bound(nbytes: float, mads: float, imads: float) -> dict:
    """The least time of a kernel's work at the card's rates."""
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, mads / imads * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops}


def fold_bound(N: int, P: int, nk: int, imads: float) -> dict:
    """K8's bound on one round (fold_work at the card's rates)."""
    return work_bound(*fold_work(N, P, nk), imads)


def keccak_latency_floor_ms(mhz: float) -> float:
    """Least milliseconds of K13's 24 rounds at an SM clock of mhz."""
    return 24 * KECCAK_ROUND_CYCLES / (mhz * 1e3)


# K15's and K16's latency floor: one step's dependent path, (dependent
# instructions, shuffle or shared-memory round trips of SMEM_TRIP cycles),
# x T, read off the compiled step loops (cuobjdump -sass;
# benches/fmul13_chain.py --sass).  K15: the gather of the limbs (a trip),
# a column sum's chain of 20 IMAD, the difference and its select (2), the
# fold (a SHFL.UP trip, then SHF, IMAD, SEL, IADD: 4), three carry rounds
# and the step's carry (a SHFL.IDX trip and SHF, IMAD each), the sum of
# the three products (an IADD3).  K16: the lanes' split (an LDS trip), the
# mma (a trip), the combination (IADD, IMAD, IMAD), the column sums
# through shared memory across a barrier (2 trips), the tail (the fold,
# four carry rounds: 5 trips, 12 instructions, the sum), the new split (2)
# to shared memory across a barrier (a trip).
FMUL13_CHAIN = {"K15": (20 + 2 + 4 + 4 * 2 + 1, 1 + 1 + 4),
                "K16": (3 + 3 + 4 * 2 + 1 + 2, 1 + 1 + 2 + 5 + 1)}
# the probe's lane counts (512) and 124 lanes an SM (16,384), T = 1024
FMUL13_LANES = (512, 16384)
FMUL13_STEPS = 1024


def fmul13_latency_floor_ms(mhz: float, kernel: str = "K15",
                            steps: int = FMUL13_STEPS) -> float:
    """Least milliseconds of a chain of `steps` steps of K15 or K16 at an SM
    clock of mhz (every lane's chain runs at once: one wave)."""
    instr, trips = FMUL13_CHAIN[kernel]
    return steps * (LEAST_LATENCY * instr + SMEM_TRIP * trips) / (mhz * 1e3)


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


# K4a's lane counts: 512 for an m=1 verifier sub-batch's 34,946 MSM points
# (and the R1CS k = 2^15 and linear MSMs), 256 for the R1CS batch of two
# k = 2^10 (8,260), 128 for an m=16 chunk's 8,160, 64 for the chunked
# verifier's final MSM of 2,052
K4A_POINTS = (34946, 8260, 8160, 2052)


def emit_blocks(P: int, n: int, m: int, seed: int) -> torch.Tensor:
    """(P, lg + 8, 32) uint8 challenge blocks on the card: seeded canonical
    scalars."""
    import random
    import numpy as np
    from ..core.scalar import L as ELL
    from ..ops import verify as V
    _, nblk, _ = V.shape(n, m)
    r = random.Random(seed)
    return torch.as_tensor(np.frombuffer(
        b"".join(r.randrange(ELL).to_bytes(32, "little")
                 for _ in range(P * nblk)), np.uint8
    ).reshape(P, nblk, 32).copy()).cuda()


def fold_inputs(N: int, P: int, seed: int):
    """IPP round 1's fold inputs on the card: a, b (N, 9, P) seeded
    canonical scalars (below 2^252), u and its inverse (9, P), the maps of
    the fold into nk = N / 2 (idx, mask)."""
    import numpy as np
    from ..ops import scalar as S
    g = torch.Generator().manual_seed(seed)
    top = torch.tensor([1 << 29] * 8 + [1 << 20])[None, :, None]

    def vec(rows):
        return (torch.randint(0, 1 << 29, (rows, 9, P), generator=g)
                % top).cuda()
    a, b, u = vec(N), vec(N), vec(1)[0]
    j = np.arange(N)
    idx = torch.as_tensor(np.where(j < N // 2, j + N // 2, 0)).cuda()
    mask = torch.as_tensor(j < N // 2).cuda()
    return a, b, u, S.sinv(u), idx, mask


def fold_six(a, b, u, uinv, idx, mask, fold=None):
    """The older fold_dyn's a and b: two index_select, two fold_lanes (or
    `fold`, its plain version), two where."""
    from ..ops import fold as FO
    fold = fold or FO.fold_lanes
    m = mask[:, None, None]
    na = fold(a, a.index_select(0, idx), u, uinv)
    nb = fold(b, b.index_select(0, idx), uinv, u)
    return torch.where(m, na, a), torch.where(m, nb, b)


def transcript_pad(seed: int) -> torch.Tensor:
    """(200, 1) uint8 on the card: a pending pad as the device transcript
    makes one (constant bytes, 0x04 after them, 0x80 at byte 167)."""
    g = torch.Generator().manual_seed(seed)
    pad = torch.zeros((200, 1), dtype=torch.uint8)
    pad[:20, 0] = torch.randint(0, 256, (20,), generator=g).to(torch.uint8)
    pad[21, 0] ^= 0x04
    pad[167, 0] ^= 0x80
    return pad.cuda()


def keccak_loads_only():
    """The tree's csrc/keccak.cu with its round loop cut to no round, built
    into _build/cuda/loads_only/ -> a function (200, P) uint8 -> (200, P)
    that only loads and stores the states, through that kernel."""
    import ctypes
    from ..ops import _cuda
    from .._build import BUILD_DIR
    d = os.path.join(BUILD_DIR, "cuda", "loads_only")
    os.makedirs(d, exist_ok=True)
    for name in os.listdir(_cuda.CSRC):
        if name.endswith((".cuh", ".cu")):
            shutil.copy(os.path.join(_cuda.CSRC, name), d)
    src = os.path.join(d, "keccak.cu")
    with open(src) as fh:
        text = fh.read()
    if text.count("rnd < 24") != 1:
        raise RuntimeError("keccak.cu: no single round loop to cut")
    with open(src, "w") as fh:
        fh.write(text.replace("rnd < 24", "rnd < 0"))
    so = os.path.join(d, "libkeccak_loads_only.so")
    subprocess.run([_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", d, "-o", so, src], check=True, capture_output=True,
                   timeout=600)
    fn = ctypes.CDLL(so).bp_keccak_f1600
    from ..ops import keccak_device as K
    takes_pad = "pad" in inspect.signature(K.f1600_state_bytes).parameters
    fn.restype = ctypes.c_int

    def run(st):
        out = torch.empty_like(st)
        ptrs = [st.data_ptr()] + ([None] if takes_pad else []) \
            + [out.data_ptr()]
        args = [ctypes.c_void_p(p) for p in ptrs] + [
            ctypes.c_int64(st.shape[1]),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]
        if fn(*args) != 0:
            raise RuntimeError("the loads-only K13 did not launch")
        return out
    return run


def kernel_counts(fn, reps: int = 10) -> dict:
    """{kernel: launches a call} of fn() on the card, by torch.profiler
    over `reps` calls (the mean, rounded: a trace may miss an event)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0][:80]: round(e.count / reps)
            for e in prof.key_averages()
            if (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0)) > 0}


def timings(reps: int, mhz: float, only=()) -> dict:
    """{kernel at size: {ms, queued_ms, kernel_ms, exact}} of K1 at
    K1_SIZES (with its waves, where the tree has the query), K2 on a
    2048-proof sub-batch, K4a at K4A_POINTS' lane counts (both with their
    bound and latency floor), K4b at the verifier sub-batch's shape, K14
    at K14_SIZES, K8 and K9 at FOLD_SHAPES (with their bounds and the
    launches of one fold_dyn), K10 at DIGITS_SHAPES (with its bound) and
    K13 at K13_SIZES (with its bound and latency floor)."""
    from ..ops import curve as C
    from ..ops import fold as FO
    from ..ops import keccak_device as K
    from ..ops import msm as M
    from ..ops import prover_stages as PS
    from ..ops import scalar as S
    from ..ops import verify as V
    from . import field_mads, kernel_ms, queued, timed
    imads = torch.cuda.get_device_properties(0).multi_processor_count \
        * 64 * mhz * 1e6
    cases, extra = [], {}
    for n in K1_SIZES:
        raw = encodings(n, 5)
        cases.append((f"decompress {n}", lambda raw=raw: C.decompress(raw),
                      lambda raw=raw: C.decompress_plain(raw)))
    blk = emit_blocks(2048, 64, 1, 9)
    cases.append(("emit 2048", lambda: V.emit(64, 1, blk),
                  lambda: V.emit_plain(64, 1, blk)))
    extra["emit 2048"] = {
        "bound_ms": emit_mont_muls(64, 1, 2048) * SC_MUL_MADS / imads * 1e3,
        "latency_floor_ms": emit_latency_floor_ms(64, 1, mhz)}
    add = field_mads(lambda: C.add(*(C.to_coords(C.identity(1, "cpu")),)
                                   * 2))
    sums = None
    for k, npts in enumerate(K4A_POINTS):
        slab = M.accumulate_z(AZ.make_points(npts, 6 + k, "cuda"),
                              AZ.make_digits(npts, 7 + k, "cuda"))
        lanes = slab.shape[-1]
        if sums is None:
            sums = M.reduce(slab)
        name = f"msm_reduce {lanes}"
        cases.append((name, lambda slab=slab: M.reduce(slab),
                      lambda slab=slab: M.reduce_plain(slab)))
        extra[name] = {
            "bound_ms": 64 * 8 * (lanes - 1) * add / imads * 1e3,
            "latency_floor_ms": reduce_latency_floor_ms(lanes, mhz)}
    cases.append(("msm_horner", lambda: M.horner(sums),
                  lambda: M.horner_plain(sums)))
    for n in K14_SIZES:
        x = challenges(n, 8)
        cases.append((f"sinv {n}", lambda x=x: S.sinv(x),
                      lambda x=x: S.sinv_plain(x)))
    for N, P in FOLD_SHAPES:
        f = fold_inputs(N, P, N + P)
        plain = lambda f=f: fold_six(*f, fold=FO.fold_plain)
        if hasattr(FO, "fold_pair"):
            cases.append((f"fold_pair {N}x{P}", lambda f=f: FO.fold_pair(*f),
                          plain))
        cases.append((f"fold six-launch {N}x{P}", lambda f=f: fold_six(*f),
                      plain))
        for name in (f"fold_pair {N}x{P}", f"fold six-launch {N}x{P}"):
            extra[name] = fold_bound(N, P, N // 2, imads)
        a, b, u, ui, idx, mask = f
        extra[f"fold six-launch {N}x{P}"]["fold_dyn_kernels"] = \
            kernel_counts(lambda: PS.fold_dyn(a, b, a, b, u, ui, mask, idx,
                                              mask))
        # K9 on the same round: gw, hw updated by the glo pattern of round
        # 1 (j < N / 2 takes u^-1 for gw, u for hw)
        plain = lambda a=a, b=b, u=u, ui=ui, m=mask: (
            FO.smul_plain(a, m, ui, u), FO.smul_plain(b, m, u, ui))
        if hasattr(FO, "smul_pair"):
            cases.append((f"smul_pair {N}x{P}", lambda a=a, b=b, u=u, ui=ui,
                          m=mask: FO.smul_pair(a, b, m, ui, u), plain))
        cases.append((f"smul two-launch {N}x{P}", lambda a=a, b=b, u=u, ui=ui,
                      m=mask: (FO.smul_lanes(a, m, ui, u),
                               FO.smul_lanes(b, m, u, ui)), plain))
        # the same bytes through a PyTorch copy: what the memory gives
        # this traffic (a reference, not K9's function)
        cases.append((f"clone pair {N}x{P}", lambda a=a, b=b: (a.clone(),
                                                               b.clone()),
                      lambda a=a, b=b: (a, b)))
        for name in (f"smul_pair {N}x{P}", f"smul two-launch {N}x{P}",
                     f"clone pair {N}x{P}"):
            extra[name] = work_bound(*smul_work(N, P), imads)
    for nb, Q in DIGITS_SHAPES:
        x = fold_inputs(nb, Q, nb + Q)[0]
        name = f"digits {nb}x{Q}"
        cases.append((name, lambda x=x: FO.digits_lanes(x),
                      lambda x=x: FO.digits_plain(x)))
        extra[name] = work_bound(nb * Q * (9 * 8 + 64),
                                 DIGITS_MADS * nb * Q, imads)
    takes_pad = "pad" in inspect.signature(K.f1600_state_bytes).parameters
    loads_only = keccak_loads_only()
    for n in K13_SIZES:
        g = torch.Generator().manual_seed(n)
        st = torch.randint(0, 256, (200, n), generator=g,
                           dtype=torch.uint8).cuda()
        pad = transcript_pad(n)
        plain = lambda st=st, pad=pad: K.f1600_state_bytes_plain(st ^ pad)
        if takes_pad:
            cases.append((f"keccak {n}", lambda st=st, pad=pad:
                          K.f1600_state_bytes(st, pad), plain))
        cases.append((f"keccak xor+permute {n}", lambda st=st, pad=pad:
                      K.f1600_state_bytes(st ^ pad), plain))
        cases.append((f"keccak no pad {n}",
                      lambda st=st: K.f1600_state_bytes(st),
                      lambda st=st: K.f1600_state_bytes_plain(st)))
        cases.append((f"keccak loads-only {n}",
                      lambda st=st: loads_only(st), lambda st=st: st))
        for name in (f"keccak {n}", f"keccak xor+permute {n}",
                     f"keccak no pad {n}"):
            extra[name] = {"bound_ms": 400 * n / 3.35e12 * 1e3,
                           "latency_floor_ms": keccak_latency_floor_ms(mhz)}
    from ..ops import fmul13 as F13
    from .fmul13_chain import chain_inputs
    for q in FMUL13_LANES:
        a, b3, m3 = chain_inputs(q, FMUL13_STEPS, q)
        steps = q * FMUL13_STEPS
        cases.append((f"fmul13_chain {q}", lambda a=a, b3=b3:
                      F13.chain_vpu(a, b3),
                      lambda a=a, b3=b3: F13.chain_vpu_plain(a, b3)))
        cases.append((f"fmul13_chain_mma {q}", lambda a=a, m3=m3:
                      F13.chain_mxu(a, m3),
                      lambda a=a, m3=m3: F13.chain_mxu_plain(a, m3)))
        extra[f"fmul13_chain {q}"] = {
            **work_bound(a.numel() * 8 + b3.numel() * 4,
                         steps * (3 * 441 + 1), imads),
            "latency_floor_ms": fmul13_latency_floor_ms(mhz, "K15")}
        int8_ms = 3 * steps * F13.MROWS * F13.MCOLS / 9.895e14 * 1e3
        b = work_bound(a.numel() * 8 + m3.numel(), steps * (3 * 41 + 1),
                       imads)
        if int8_ms > b["bound_ms"]:
            b.update(bound_ms=int8_ms, bound_by="operations")
        extra[f"fmul13_chain_mma {q}"] = {
            **b, "int8_ms": int8_ms,
            "latency_floor_ms": fmul13_latency_floor_ms(mhz, "K16")}
    out = {}
    for name, fn, plain in cases:
        if only and not any(w in name for w in only):
            continue
        got, ms = timed(fn, reps, "cuda")
        want = plain()
        exact = all(torch.equal(a, b) for a, b in zip(got, want)) \
            if isinstance(got, tuple) else bool(torch.equal(got, want))
        out[name] = {"ms": ms, "queued_ms": queued(fn, reps)[1],
                     "kernel_ms": sum(kernel_ms(fn, reps).values()),
                     "exact": exact, **extra.get(name, {})}
    if hasattr(C, "decompress_waves"):
        for n in K1_SIZES:
            if f"decompress {n}" in out:
                out[f"decompress {n}"]["waves"] = C.decompress_waves(n)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="time only the cases whose names hold one of these "
                         "comma-separated words")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("field_kernels: no CUDA device available", file=sys.stderr)
        return 2
    from ..ops import _cuda
    from ..ops import msm as M
    from ..ops import verify as V
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
    if hasattr(V, "warps_per_sm"):
        result["resident_warps"] = {
            "emit": V.warps_per_sm(),
            "msm_reduce": M.warps_per_sm()["msm_reduce"]}
    if args.time:
        mhz = float(AZ.smi("clocks.max.sm").split()[0])
        result["max_sm_mhz"] = mhz
        result["times"] = timings(args.reps, mhz,
                                  [w for w in args.only.split(",") if w])
    print(json.dumps(result), flush=True)
    return 0 if all(t["exact"] for t in result.get("times", {}).values()) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
