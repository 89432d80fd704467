"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--total 8192] [--prove-runs 3] [--runs 12]
                          [--agg-total 256] [--agg-runs 3]
                          [--probe-steps 1024] [--r1cs-k 32768]
                          [--linear-items 2048] [--host-prove 256]
                          [--sharded-points 65536]
                          [--example-batch 256] [--example-k 8192]
                          [--msm-points 65536]

Builds the port's CUDA kernels from bulletproofs_tpu_torch/csrc, then
  1. drives the prover's main path: BatchProver.prove_batch of `--total`
     n=64 range proofs on the card on its default route, the device
     transcript (one warm-up, then the best of `--prove-runs`), with the
     launch counts of one run and a breakdown (device time per kernel,
     host C++ transcript time; K8 and K9 must run once a round per half,
     a and b in one launch, gw and hw in one; K20 once a half and once a
     challenge; K17-K19 must run; fewer than 5,000 launches by
     torch.profiler, the mod-l vector code one launch a call); runs one
     half's device
     rest again under torch.cuda.set_sync_debug_mode("error") (no op may
     wait for the card); proves once more on the per-stage route with the same rng and
     requires the same proofs, commitments and transcripts;
  2. checks the proofs: the card's BatchVerifier accepts all of them (the
     verifier's main path, with its launch counts), 64 sampled ones pass
     the host RangeProof.verify_single, a flipped byte and two swapped
     commitments are rejected, the Rust crate's golden proof is accepted,
     and 4 proofs at n=8 from the card equal the device="cpu" route's
     byte for byte;
  3. holds every kernel against its plain PyTorch version on the card, on
     main-path inputs (one 2048-proof verifier sub-batch: its Niels
     static points and decoded points, whose Niels rows K3's binning
     makes; K3 with its binning's two launches on each of the verify
     run's four; one IPP round's L
     stream and the S stream, the prover's compressions at each size it
     makes (12,288 and 8,192 points), one half's transcript states with
     their pad (K13, beside the two-launch XOR-then-permute form) and IPP
     challenges, IPP round 1's fold of a and b (K8, 64 x 4096, beside the
     six-launch form of an older fold_dyn) and its gw / hw update (K9,
     beside two one-vector launches); K12 beside K6 on the L
     stream; K17-K20 on the prover's own calls (K19's prefix form at
     every IPP round's row count, and each tree sum's shape), kept with
     their strides:
     the round emission's product, power_sequence's expanded operand
     against a column slice, stage 1's sums, a (9, 1) constant, the
     round's tree sum and an odd one, the blinding draws and a
     challenge's transposed transcript bytes, and empty operands), and
     the verifier MSM
     against the host curve library on a small input.  At each of the
     prover's fixed-base shapes (m=1 and m=16, IPP L and S streams) each
     K6 form that serves it (one-hot for the witness rows, also direct for
     the public IPP rows) and K7 are timed and held against their plain
     versions, the two forms against each other; launches per form are
     checked;
  4. times the verifier's main path (`--runs` calls after a warm-up, best
     and median), each call's record on a line of its own: wall and CPU
     time, the cyclic GC's collections and time, context switches, page
     faults, the CUDA caching allocator's and pinned allocator's deltas
     and the host clock of each stage of verify_batch;
  5. drives the aggregated path at full width: BatchProver(m=16) of
     `--agg-total` n=64 proofs on the device-transcript route (one
     warm-up, then the best of `--agg-runs`, launch counts, breakdown, the
     no-sync check of one rest), once on the per-stage route (its launch
     counts checked) and `--agg-runs` times with fixed_msm._ILP2 set (the
     two-set kernel K12 in place of K6; its device time by torch.profiler
     beside the default route's), all three byte-identical; then
     BatchVerifier(m=16) on its chunked route (best of `--agg-runs`); the
     same proofs accepted by the fused route too, a flipped byte and
     swapped commitments rejected, 2 proofs through the host
     verify_multiple, and n=8, m=2 proofs from the card equal to the CPU
     route's byte for byte;
  6. holds kernels K5, K8-K14 and K17-K20 against their plain versions
     on the aggregated path's inputs (its compressions at each size, 4,608 and
     512 points; IPP round 1's fold, 1024 x 256, one gw / hw update, the S
     coefficients' digits, the 256 transcript states with their pad, the
     IPP challenges,
     one verifier chunk's and the final MSM's accumulation, K11's binning
     there too, K4a on their 128- and 64-lane slabs, the S
     commitment's stream for K12, timed beside K6), and K6 / K7 at the
     m=16 IPP L and S streams as in 3;
  9. drives the MXU probe (benches/mxu_fmul_probe.run, Q = 512 lanes,
     `--probe-steps` chained steps): its oracle check, then K15 and K16
     timed; both against their plain versions and each other limb for
     limb, 14 lanes against the Python-int oracle of the whole chain, and
     for reference the same int8 products by torch._int_mm;
 10. R1CS: a k = `--r1cs-k` shuffle proved on the host and verified on the
     card by the default rule (the device mega-MSM: cold, then 3 runs
     alternating with the host C++ route, medians; the MSM alone), K1,
     K10, K11 (its binning and itself), K4a and K4b against their
     plain versions on that MSM's inputs, a flipped byte and swapped output commitments rejected; the
     same for batch_verify of two k = 2^10 proofs on the device (one
     tampered batch rejected);
 11. linear proofs: batch_verify of `--linear-items` items at n = 1024 on
     the forced device route (cold, then 3 runs alternating with the host
     route, medians; the MSM alone), the six MSM kernels against their
     plain versions on its inputs, and a tampered batch rejected;
 12. the host and Python routes and the mesh, on 2's proofs: the C++
     route (BatchVerifier(prefer_host=True), timed beside the fused
     route), the mesh verifier (chunked, every MSM sharded) over every
     card present and over a virtual 4-shard mesh on card 0 (launches a
     shard a chunk, each shard under its own device, timed), the
     `--sharded-points` (2^16) MSM sharded over both beside the unsharded one (a
     one-scalar oracle; one shard's K10, K11, K4a, K4b against their plain
     versions), use_native=False on 256 proofs with and without the
     4-shard mesh, an R1CS k = 8 shuffle verified with msm= over each
     mesh, BatchProver(prefer_host=True) on `--host-prove` proofs (its
     proofs accepted on the card, its stage-0 and IPP round-1 rows redone
     by msm_rows_compressed on the card byte for byte) and 2 m=16 proofs
     of prove_multiple on the chunked route; every route accepts, rejects
     tampering and leaves the fused route's transcripts;
 13. the examples (bulletproofs_tpu_torch/examples/), each main called
     in-process on the card: batch_throughput of `--example-batch` (256)
     n=64 proofs (the prove and verify routes' kernels launched, the
     proofs accepted again and a tampered one rejected), r1cs_gadget at
     k = `--example-k` (8192, the smallest power of two whose padded
     multipliers reach the device floor: the mega-MSM's kernels
     launched), range_proof, mpc_aggregation and mpc_multiprocess 4 (host
     paths), each with its wall;
 14. the north-star MSM entry at `--msm-points` (2^16, the JAX package's
     shape): seeded rows hashed to the group on the card
     (curve.from_uniform_bytes, 4,096 of them against the host C++),
     msm.normalize_z, then both MSM routes (msm_lanes_flag: K10, K11, K4a,
     K4b; msm_lanes_niels_flag: K10, K3, K4a, K4b), equal to each other,
     to the host C++ rist_msm and to the subtract trick; each route's
     launches; its kernels against their plain versions on these inputs;
     both timed device-resident and with the scalars' upload;
 15. prints the kernels' launches, times, plain times and bounds as one
     JSON line (K8's, K9's, K10's, K13's, the binnings' and K17-K20's
     times by device time: launches queued behind a sleep of the card,
     `benches.queued`; the binnings' and K17-K20's each after a read of
     twice the L2 cache, `benches.cold`, so that every byte comes from
     device memory as their bound assumes; the others by CUDA events
     around a loop of launches; no recorded time may sit under its
     bound), the card's name and power limit,
     and last the device line.
Every plain version timed here must launch no kernel of the port (the
launch counts are read around each).  Exits non-zero on any failure, and
at once when there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import time

import torch

from bulletproofs_tpu_torch.benches import Rng, profiled

DEVICE = "cuda"
# HBM3 rate of one H100 SXM (NVIDIA data sheet)
PEAK_BYTES = 3.35e12
# 32-bit integer multiply-adds per clock per SM at compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput table);
# times the card's SMs and maximum SM clock, read in main(), that is the
# peak integer rate.  A 32 x 32 -> 64-bit limb product takes two of them
# (low and high word).
IMAD_PER_CLOCK_SM = 64
# dense int8 tensor-core peak of one H100 SXM: 1,979 TOPS (NVIDIA data
# sheet), two operations to a multiply-add
PEAK_INT8_MACS = 1979e12 / 2
# shared-memory bytes per clock per SM (32 banks of 4 bytes)
SMEM_BYTES_PER_CLOCK_SM = 128
# shared-memory bytes per (row, lane) of K6's one-hot form: it reads all 8
# buckets (40 words each) to select, then reads and writes all 8 to update
# (the direct form keeps no shared memory)
ONE_HOT_SMEM_BYTES = 3 * 8 * 40 * 4


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` launches, after one warm-up,
    by CUDA events."""
    from bulletproofs_tpu_torch.benches import timed
    return timed(fn, reps, DEVICE)[1]


def queued_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` launches queued behind a sleep
    of the card (device time, back to back: where a kernel is shorter
    than its launch, time_cuda measures the host's pace)."""
    from bulletproofs_tpu_torch.benches import queued
    return queued(fn, reps)[1]


def cold_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` launches queued behind a sleep
    of the card, each after a read of twice the L2 cache (device time
    with every input read from device memory, as a bound by the memory
    rate assumes; benches.cold)."""
    from bulletproofs_tpu_torch.benches import cold
    return cold(fn, reps)[1]


def max_abs_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def peak_imads() -> float:
    """32-bit integer multiply-adds per second of card 0 at its maximum SM
    clock."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * IMAD_PER_CLOCK_SM * float(mhz.split()[0]) * 1e6


def bound(nbytes: float, mads: float, imads_per_s: float,
          int8_macs: float = 0, alu_ops: float = 0):
    """Least milliseconds for moving `nbytes`, making `mads` 32-bit
    multiply-adds on the CUDA cores, `alu_ops` 32-bit integer additions,
    logic operations and shifts (the integer pipe, beside the
    multiply-adds' at the same rate) and `int8_macs` int8 multiply-adds
    on the tensor cores (each unit runs beside the others), and which
    bounds it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(mads / imads_per_s, alu_ops / imads_per_s,
                int8_macs / PEAK_INT8_MACS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def field_mads(fn) -> int:
    """32-bit multiply-adds of the field products (100 limb products) and
    squarings (55) the plain version makes in fn()."""
    from bulletproofs_tpu_torch.benches import field_mads as fm
    return fm(fn)


def decode_mads() -> int:
    """Multiply-adds of one ristretto decode (K1)."""
    from bulletproofs_tpu_torch.ops import curve as C
    return field_mads(lambda: C.decode(torch.zeros((10, 1),
                                                   dtype=torch.int64)))


def horner_mads() -> int:
    """Multiply-adds of K4b: 64 window sums of 14 complete additions, then
    63 x (4 doublings + 1 addition)."""
    from bulletproofs_tpu_torch.ops import curve as C
    ident = C.to_coords(C.identity(1, "cpu"))
    add = field_mads(lambda: C.add(ident, ident))
    dbl = field_mads(lambda: C.double(ident))
    return 64 * 14 * add + 63 * (4 * dbl + add)


def encode_mads() -> int:
    """Multiply-adds of one ristretto encode (K5)."""
    from bulletproofs_tpu_torch.ops import curve as C
    return field_mads(lambda: C.encode(C.to_coords(C.identity(1, "cpu"))))


def compress_checks(calls, what, imads, smi, failures):
    """K5 against compress_plain on each size a prover's run compressed
    (`calls` of a CaptureEach keyed by N): exact, timed, with its lanes
    per point."""
    from bulletproofs_tpu_torch.ops import curve as C
    for n_pts, ((pts,), out) in sorted(calls.items()):
        want, plain_ms = time_once(lambda: C.compress_plain(pts))
        err = max_abs_err(out, want)
        ms = time_cuda(lambda: C.compress(pts), 20)
        b_ms, b_by = bound(pts.numel() * 4 + out.numel(),
                           n_pts * encode_mads(), imads)
        log(f"  compress on the {what}'s {n_pts} points "
            f"({C.compress_lanes(n_pts)} lanes a point): max_abs_err {err} "
            f"({'ok' if err == 0 else 'MISMATCH'}); {ms:.4f} ms kernel, "
            f"{plain_ms:.2f} ms plain, bound {b_ms:.4f} ms ({b_by}) on {smi}")
        if err != 0:
            failures.append(f"compress on the {what}'s {n_pts} points")


class Capture:
    """Keeps the first main-path input (tensors cloned, or with `views` the
    tensors as passed, so that a view keeps its strides: for inputs that
    no later step writes) and result of a function that matches `want`,
    while the function goes on working.  Captures of one function chain;
    restore them in reverse order."""

    def __init__(self, module, name, want=lambda *a: True, views=False):
        self.module, self.name, self.want = module, name, want
        self.views = views
        self.real = getattr(module, name)
        self.args = self.out = None
        setattr(module, name, self)

    def __call__(self, *args):
        keep = self.args is None and self.want(*args)
        if keep:
            self.args = tuple(
                a.clone() if isinstance(a, torch.Tensor) and not self.views
                else a for a in args)
        out = self.real(*args)
        if keep:
            self.out = out
        return out

    def restore(self):
        setattr(self.module, self.name, self.real)


class CaptureEach(Capture):
    """Keeps the input (tensors cloned) and result of the first call of
    each key(*args), by default of every call, in `calls` ({key: (args,
    out)}, in call order), while the function goes on working."""

    def __init__(self, module, name, key=None):
        super().__init__(module, name)
        self.key, self.calls = key, {}

    def __call__(self, *args):
        k = len(self.calls) if self.key is None else self.key(*args)
        if k in self.calls:
            return self.real(*args)
        kept = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args)
        out = self.real(*args)
        self.calls[k] = (kept, out)
        return out


# most kernel launches (torch.profiler's count) of one m=1 prove of 8192
# proofs or one m=16 prove of 256 (56,268 and 44,558 before K17-K20)
PROVE_LAUNCH_LIMIT = 5000

# the launches of the port's kernels that a plain version made while
# time_once timed it (main() fails if there are any)
PLAIN_LAUNCHES = []


def time_once(fn):
    """(fn(), milliseconds of that one call by CUDA events): for the plain
    versions at main-path shapes, too slow to repeat.  A plain version is
    an oracle and launches no kernel of the port: if the launch counts
    move during the call, what moved goes into PLAIN_LAUNCHES."""
    from bulletproofs_tpu_torch.benches import timed
    from bulletproofs_tpu_torch.ops import _cuda
    before = dict(_cuda.LAUNCHES)
    out = timed(fn, 1, DEVICE, warm=False)
    if _cuda.LAUNCHES != before:
        PLAIN_LAUNCHES.append({k: v - before[k] for k, v in
                               _cuda.LAUNCHES.items() if v != before[k]})
    return out


def operand_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's distinct elements: a broadcast dimension
    (stride 0) is read once."""
    k = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            k *= size
    return k * t.element_size()


# K20's work a draw from a key: 20 ChaCha rounds of 4 quarter rounds (4
# additions, 4 XORs, 4 rotations each) and the 16 final additions, 32-bit
# integer ALU operations (64 a clock an SM, beside the multiply-adds);
# and the wide reduction's two products under one Montgomery reduction,
# 252 limb products of two multiply-adds each
CHACHA_OPS = 20 * 4 * 12 + 16
WIDE_MADS = 2 * 252


def scalar_captures(PS, TD, N: int, P: int) -> dict:
    """K17-K20's main-path calls in one prove of P proofs a half with
    vectors of N: the round emission's product of 4N rows, power_sequence's
    first product (an expanded one against a column slice of the y / z
    block), a sum of two (N, 9, P) vectors, a sum with a (9, 1) constant,
    a negation of a column slice, the first round's prefix tree sum of two
    (N, 9, P) row blocks, each tree sum's shape (stage 1's, stage 2's),
    the blinding draws and a challenge's wide reduction of transposed
    transcript bytes.  Tensors are kept as passed (no step writes them),
    so views keep their strides; the tree sums' are cloned."""
    S = PS.S

    def vec(rows):
        return lambda a, *r: a.dim() == 3 and a.shape[0] == rows \
            and a.shape[-1] == P
    return {
        "smul": Capture(S, "smul", vec(4 * N), views=True),
        "smul_bcast": Capture(S, "smul", lambda a, b: a.stride(-1) == 0
                              and a.shape[-1] == P, views=True),
        "sadd": Capture(S, "sadd", vec(N), views=True),
        "sadd_const": Capture(S, "sadd", lambda a, b: b.shape[-1] == 1
                              and a.shape[-1] == P, views=True),
        "sneg": Capture(S, "sneg", lambda a: a.shape[-1] == P, views=True),
        "tree_sum": CaptureEach(S, "tree_sum", key=lambda v: tuple(v.shape)),
        "tree_sum_prefix": Capture(S, "tree_sum_prefix", views=True),
        "random_scalars": Capture(PS.chacha, "random_scalars",
                                  lambda key, k, dev: k == P * (4 + 2 * N)),
        "from_wide_bytes": Capture(TD.S, "from_wide_bytes",
                                   lambda raw: raw.shape[0] == P, views=True)}


def same_outputs(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_outputs(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def instrumented(fn):
    """Run fn() once with a CUDA-event pair around every kernel launch and
    a host clock around every native call of the prover -> (wall ms,
    {kernel: device ms}, host C++ transcript ms)."""
    from bulletproofs_tpu_torch.ops import _cuda
    from bulletproofs_tpu_torch.proofs import batch_prover as BPm
    real_launch, real_native = _cuda.launch, BPm._NATIVE
    events, host = [], [0.0]

    def launch(kernel, *args):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        real_launch(kernel, *args)
        e.record()
        events.append((kernel, s, e))

    class Native:
        def __getattr__(self, name):
            f = getattr(real_native, name)

            def call(*args):
                t0 = time.perf_counter()
                try:
                    return f(*args)
                finally:
                    host[0] += (time.perf_counter() - t0) * 1e3
            return call

    _cuda.launch, BPm._NATIVE = launch, Native()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        _cuda.launch, BPm._NATIVE = real_launch, real_native
    per = {}
    for k, s, e in events:
        per[k] = per.get(k, 0.0) + s.elapsed_time(e)
    return wall, per, host[0]


class NativeTimer:
    """Replaces core.ristretto's native library handle by one that adds
    the host milliseconds of every call of `names` into `ms` (restored by
    close())."""

    def __init__(self, names):
        from bulletproofs_tpu_torch.core import ristretto
        self.mod, self.real = ristretto, ristretto._NATIVE
        self.names, self.ms = names, {n: 0.0 for n in names}
        ristretto._NATIVE = self

    def __getattr__(self, name):
        f = getattr(self.real, name)
        if name not in self.names:
            return f

        def call(*args):
            t0 = time.perf_counter()
            try:
                return f(*args)
            finally:
                self.ms[name] += (time.perf_counter() - t0) * 1e3
        return call

    def close(self):
        self.mod._NATIVE = self.real


def host_clock(fn) -> float:
    """Milliseconds of one fn() ending in a synchronize, by the host
    clock."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def paired(device_fn, host_fn, runs: int = 3, what: str = None):
    """Device and host route timed alike: `runs` calls of each, alternating
    and starting with the device -> (device ms, host ms), lists in run
    order, by the host clock.  With `what`, each call's CallRecorder
    record is logged."""
    from bulletproofs_tpu_torch.benches.verify_calls import CallRecorder
    dev, host = [], []
    rec = CallRecorder()
    try:
        for r in range(runs):
            for name, fn, out in (("card", device_fn, dev),
                                  ("host", host_fn, host)):
                got = rec.run(fn)
                out.append(got["wall_ms"])
                if what:
                    log(f"    {what} {name} run {r}: {rec.text(got)}")
    finally:
        rec.close()
    return dev, host


def runs_text(ms) -> str:
    return (f"median {statistics.median(ms):.1f} ms of "
            f"{[round(x, 1) for x in ms]}")


def probe_phase(args, dev, smi, record, failures, mhz):
    """9. The MXU probe's main path (benches/mxu_fmul_probe.run: K15 and
    K16 at Q = 512, T = --probe-steps), then both kernels against their
    plain versions and each other, limb for limb over the whole chain, and
    14 lanes against the Python-int oracle."""
    from bulletproofs_tpu_torch.benches import field_kernels as FK
    from bulletproofs_tpu_torch.benches import mxu_fmul_probe as PROBE
    from bulletproofs_tpu_torch.ops import _cuda
    from bulletproofs_tpu_torch.ops import fmul13 as F13
    q, t = 512, args.probe_steps
    inp = PROBE.make_inputs(q, t)
    log(f"MXU probe (Q = {q} lanes, T = {t} steps) on {smi}:")
    _cuda.reset_counts()
    res = PROBE.run(DEVICE, inputs=inp, reps=8, log=lambda *a: log(" ", *a))
    launches = dict(_cuda.LAUNCHES)
    if not res["oracle_ok"]:
        failures.append("MXU-form product vs oracle")
        return
    for k in ("fmul13_chain", "fmul13_chain_mma"):
        if launches[k] == 0:
            failures.append(f"{k} not launched by the probe")
    a, b3, m3 = (inp[k].to(dev) for k in ("a", "b3", "m3"))
    v, m = res["vpu_out"], res["mxu_out"]
    pv, pv_ms = time_once(lambda: F13.chain_vpu_plain(a, b3))
    pm, pm_ms = time_once(lambda: F13.chain_mxu_plain(a, m3))
    same = torch.equal(v, m)
    lanes = list(range(0, q, 37))
    want = PROBE.chain_oracle([inp["a_int"][i] for i in lanes],
                              inp["b_steps"], t)
    got = F13.limbs_to_ints(v[:, lanes].cpu().numpy())
    oracle = [g % F13.P25519 for g in got] == want
    log(f"  K15 and K16 limb for limb {'equal' if same else 'DIFFERENT'}; "
        f"{len(lanes)} lanes {'equal to' if oracle else 'DIFFERENT from'} "
        f"the Python-int oracle of the whole chain; largest limb "
        f"{int(v.max())} (the int8 split needs < 16384)")
    if not same or not oracle:
        failures.append("K15 / K16 chain results")
    per_lane_step = q * t
    # 400 multiply-adds per product and 41 multiplications by 608 in its
    # tail, three products and one carry (one more) per step
    record("fmul13_chain", "bulletproofs_tpu_torch/csrc/fmul13.cu",
           "benches/_mxu_fmul_probe.py:135", max_abs_err(v, pv),
           res["vpu_ms"], pv_ms, a.numel() * 8 + b3.numel() * 4,
           per_lane_step * (3 * 441 + 1), launches,
           floor_ms=FK.fmul13_latency_floor_ms(mhz, "K15", t))
    # the 156 x 40 int8 product on the tensor cores; on the CUDA cores the
    # tail's 41 multiplications by 608 per product and one per step (the
    # fold's 128 and 16384 are shifts)
    record("fmul13_chain_mma", "bulletproofs_tpu_torch/csrc/fmul13.cu",
           "benches/_mxu_fmul_probe.py:147", max_abs_err(m, pm),
           res["mxu_ms"], pm_ms, a.numel() * 8 + m3.numel(),
           per_lane_step * (3 * 41 + 1), launches,
           floor_ms=FK.fmul13_latency_floor_ms(mhz, "K16", t),
           int8_macs=3 * per_lane_step * F13.MROWS * F13.MCOLS)
    # the zero-skipping tiles: 30 m16n8k32 a step for 8 lanes
    issued = per_lane_step * 30 * 16 * 8 * 32 // 8
    log(f"  K16 issues {issued:,} int8 multiply-adds (30 mma a step for 8 "
        f"lanes) against the dense product's "
        f"{3 * per_lane_step * F13.MROWS * F13.MCOLS:,}")
    # for reference only (the port never calls it): the same 3 T int8
    # products alone, one library call each, the JAX probe's "int8 matmul
    # alone" row
    prods = [m3[j, s] for s in range(t) for j in range(3)]
    for A in (F13.split(a), F13.split(a).t().contiguous().t()):
        try:
            torch._int_mm(prods[0], A)
        except RuntimeError as e:
            log(f"  torch._int_mm refused a (40, {q}) operand of strides "
                f"{A.stride()}: {str(e)[:120]}")
            continue
        ms = time_cuda(lambda: [torch._int_mm(p, A) for p in prods], 3)
        log(f"  for reference, {len(prods)} (156 x 40) @ (40 x {q}) int8 "
            f"products alone by torch._int_mm: {ms:.4f} ms "
            f"({ms * 1e3 / t:.3f} us per step) on {smi}")
        break
    else:
        log("  torch._int_mm products: not measured")


def msm_path_checks(what, dec, msm, imads, smi, failures):
    """K1, K10, K11 (msm_bin, then the whole accumulate_z), K4a and K4b
    against their plain versions on the card,
    on the inputs of one path's device MSM (`dec` and `msm` are Captures of
    curve.decompress and msm.msm_lanes_flag from that path's run).  Exact,
    tolerance 0; the path's own decoded points and MSM result are among the
    outputs compared."""
    from bulletproofs_tpu_torch.ops import curve as C
    from bulletproofs_tpu_torch.ops import msm as M
    (raw,), (pts, sc) = dec.args, msm.args
    waves = C.decompress_waves(raw.shape[0])
    log(f"  {what}: kernels against their plain versions ({raw.shape[0]} "
        f"encodings, K1 in {waves} wave(s); {pts.shape[-1]} MSM points in "
        f"{M.pick_lanes(pts.shape[-1])} lanes):")
    check_stages(what, (("decompress", dec.out, lambda: C.decompress(raw),
                         lambda: C.decompress_plain(raw),
                         raw.shape[0] * (32 + 1 + 160),
                         raw.shape[0] * decode_mads()),)
                 + msm_stages(pts, sc, msm.out, False), imads, smi, failures)


def msm_stages(pts, sc, out, niels: bool):
    """The stages of one MSM route on its inputs, for check_stages: K10,
    then the binning launch and the whole accumulation of K3 (`niels`:
    Z = 1 points in Niels form, the mixed addition) or K11 (points of any
    Z), K4a and K4b; the last output compared is the route's own result
    `out` (point (4, 10, 1), flag)."""
    from bulletproofs_tpu_torch.ops import curve as C
    from bulletproofs_tpu_torch.ops import field as F
    from bulletproofs_tpu_torch.ops import fold as FO
    from bulletproofs_tpu_torch.ops import msm as M
    from bulletproofs_tpu_torch.ops import scalar as S
    N = pts.shape[-1]
    coef = S.from_bytes32(sc)
    dig = FO.digits_lanes(coef)
    ident = C.to_coords(C.identity(1, "cpu"))
    add = field_mads(lambda: C.add(ident, ident))
    if niels:
        # K3's binning makes the Z = 1 points' Niels rows (no prefix here)
        pre = torch.empty((3, 10, 0), dtype=torch.int32, device=pts.device)
        names = ("msm_bin_niels", "msm_accumulate")
        per_add = field_mads(lambda: C.madd(ident, ident[:3]))
        fmul = field_mads(lambda: F.mul(ident[0], ident[0]))
        binned = M.bin_niels(pre, pts, dig)
        slab = M.accumulate(pre, dig, pts)
        bin_fn = lambda: M.bin_niels(pre, pts, dig)              # noqa: E731
        bin_plain = lambda: M.bin_niels_plain(pre, pts, dig)     # noqa: E731
        acc = lambda: M.accumulate(pre, dig, pts)                # noqa: E731
        acc_plain = lambda: M.accumulate_plain(                  # noqa: E731
            torch.cat([pre, C.to_niels(pts)], dim=-1), dig)
        bin_cost = (bin_niels_bytes(pre, pts, dig, binned), N * fmul)
        acc_cost = (N * 120 + dig.numel() + slab.numel() * 4,
                    int((dig != 0).sum()) * per_add + N * fmul)
    else:
        binned = M.bin_points(pts, dig)
        slab = M.accumulate_z(pts, dig)
        names = ("msm_bin", "msm_accumulate_z")
        bin_fn = lambda: M.bin_points(pts, dig)                  # noqa: E731
        bin_plain = lambda: M.bin_points_plain(pts, dig)         # noqa: E731
        acc = lambda: M.accumulate_z(pts, dig)                   # noqa: E731
        acc_plain = lambda: M.accumulate_z_plain(pts, dig)       # noqa: E731
        bin_cost = (bin_bytes(pts, dig, binned), 0)
        acc_cost = (pts.numel() * 4 + dig.numel() + slab.numel() * 4,
                    int((dig != 0).sum()) * add)
    sums = M.reduce(slab)
    lanes = slab.shape[-1]
    # (name, output, kernel, plain version, bytes, multiply-adds)
    return (
        ("digits", dig, lambda: FO.digits_lanes(coef),
         lambda: FO.digits_plain(coef[None]), coef.numel() * 8 + dig.numel(),
         18 * N),
        (names[0], binned, bin_fn, bin_plain) + bin_cost,
        (names[1], slab, acc, acc_plain) + acc_cost,
        ("msm_reduce", sums, lambda: M.reduce(slab),
         lambda: M.reduce_plain(slab), slab.numel() * 4 + sums.numel() * 4,
         64 * 8 * (lanes - 1) * add),
        ("msm_horner", (out[0][..., 0], out[1]),
         lambda: M.horner(sums), lambda: M.horner_plain(sums),
         sums.numel() * 4 + 160 + 4, horner_mads()))


def check_stages(what, stages, imads, smi, failures):
    """Each stage's kernel against its plain version on the card (exact,
    tolerance 0), timed by the events loop, by device time (queued) and
    by device time from memory (`cold_ms`, held to its bound), with its
    bound; a stage is (name, the path's output, kernel, plain version,
    bytes, multiply-adds)."""
    for name, got, kernel, plain, nbytes, mads in stages:
        want, plain_ms = time_once(plain)
        err = max_abs_err(got, want)
        ms = time_cuda(kernel, 3)
        dev_ms = queued_ms(kernel, 20)
        mem_ms = cold_ms(kernel, 10)
        b_ms, b_by = bound(nbytes, mads, imads)
        log(f"    {name}: max_abs_err {err} "
            f"({'ok' if err == 0 else 'MISMATCH'}); {ms:.4f} ms kernel "
            f"(events loop), {dev_ms:.4f} ms device (queued), {mem_ms:.4f} "
            f"from memory, {plain_ms:.2f} ms plain, bound {b_ms:.4f} ms "
            f"({b_by}) on {smi}")
        if err != 0:
            failures.append(f"{name} on the {what}")
        if mem_ms < b_ms:
            failures.append(f"{name} on the {what}: {mem_ms:.4f} ms under "
                            f"its bound {b_ms:.4f} ms")


def device_captures(module, name):
    """Captures of a device check and of the two calls it makes."""
    from bulletproofs_tpu_torch.ops import curve as C
    from bulletproofs_tpu_torch.ops import msm as M
    return (Capture(module, name), Capture(C, "decompress"),
            Capture(M, "msm_lanes_flag"))


MSM_KERNELS = ("decompress", "digits", "msm_bin", "msm_accumulate_z",
               "msm_reduce", "msm_horner")


def bin_bytes(pts, dig, binned) -> int:
    """Bytes K3's or K11's binning must move: the points and digits read
    once, the point-major rows, the lists and the offsets written once."""
    return pts.numel() * 4 + dig.numel() + sum(t.numel() * 4 for t in binned)


def bin_niels_bytes(pre, pts, dig, binned) -> int:
    """Bytes K3's two-source binning must move: 30 words a point read (a
    Niels prefix point's, or X, Y and T of a Z = 1 point: its Z is 1 and
    not read), the digits, and its outputs written once."""
    return (pre.shape[-1] + pts.shape[-1]) * 120 + dig.numel() \
        + sum(t.numel() * 4 for t in binned)


def r1cs_phase(args, smi, imads, failures):
    """10. R1CS: the k-shuffle (bench.py:321-366) proved on the host,
    verified on the card by the default rule (cold, then 3 runs alternating
    with the host C++ route), the mega-MSM alone, K1, K10, K11, K4a and K4b
    against their plain versions on its inputs, two tampered proofs
    rejected, and the same for batch_verify of two k = 2^10 proofs."""
    from bulletproofs_tpu_torch import (BulletproofGens, PedersenGens,
                                        R1CSError)
    from bulletproofs_tpu_torch.benches import shuffle as SH
    from bulletproofs_tpu_torch.config import settings
    from bulletproofs_tpu_torch.ops import _cuda
    from bulletproofs_tpu_torch.proofs import r1cs as R1
    from bulletproofs_tpu_torch.proofs.r1cs import verifier as RV
    k = args.r1cs_k
    padded = 1 << (2 * k - 3).bit_length()          # 2 (k - 1) multipliers
    pc, bp = PedersenGens(), BulletproofGens(padded, 1)
    label = b"ShuffleScaleBench"
    t0 = time.time()
    ins, outs, proof = SH.prove_shuffle(pc, bp, label, *SH.shuffle_values(k, k),
                                        Rng(args.seed + 40))
    log(f"R1CS k={k} shuffle ({padded} padded multipliers): host prove "
        f"(gadget included) {time.time() - t0:.2f} s; device floor "
        f"{settings.r1cs_device_msm_floor}")
    if padded < settings.r1cs_device_msm_floor:
        failures.append("R1CS: the default rule does not take the device")
    old = settings.r1cs_device_msm_floor

    def verify(p, ins=ins, outs=outs, seed=41):
        SH.shuffle_verifier(label, ins, outs).verify(p, pc, bp, rng=Rng(seed),
                                                    device=DEVICE)

    def on_host(fn, floor):
        """fn() on the host C++ route (the floor raised) -> its rist_msm
        milliseconds; no kernel may launch."""
        settings.r1cs_device_msm_floor = 1 << 40
        timer = NativeTimer(["rist_msm"])
        _cuda.reset_counts()
        try:
            fn()
        finally:
            timer.close()
            settings.r1cs_device_msm_floor = floor
        if any(_cuda.LAUNCHES.values()):
            failures.append("R1CS host route launched a kernel")
        return timer.ms["rist_msm"]

    def device_run(what, fn, floor):
        """The path fn() on the card (cold; counts from 0 just before it,
        read just after), then 3 runs alternating with the host route, the
        MSM alone, and the kernels against their plain versions on its
        inputs."""
        caps = device_captures(RV, "_device_msm_is_identity")
        _cuda.reset_counts()
        try:
            cold = host_clock(fn)
        finally:
            for c in caps:
                c.restore()
        launches = dict(_cuda.LAUNCHES)
        for name in MSM_KERNELS:
            if launches[name] == 0:
                failures.append(f"{name} not launched by the {what}")
        if any(c.args is None for c in caps):
            failures.append(f"{what}: the device MSM did not run")
            return
        rist = []
        dev_ms, host_ms = paired(fn, lambda: rist.append(on_host(fn, floor)),
                                 what=what)
        cap = caps[0]
        msm_ms = [host_clock(lambda: cap.real(*cap.args)) for _ in range(3)]
        log(f"  {what} on the card: cold {cold:.1f} ms; then alternating "
            f"with the host C++ route (floor raised), 3 runs each: card "
            f"{runs_text(dev_ms)}, host {runs_text(host_ms)} (its rist_msm "
            f"{runs_text(rist)}); launches "
            f"{ {k: v for k, v in launches.items() if v} }; the device "
            f"mega-MSM alone ({caps[2].args[0].shape[-1]} points, K1 + K10 + "
            f"K11 + K4a + K4b, uploads included) {runs_text(msm_ms)}; on "
            f"{smi}")
        msm_path_checks(what, caps[1], caps[2], imads, smi, failures)

    device_run(f"R1CS k={k} verify (default rule)", lambda: verify(proof), old)
    b = bytearray(proof.to_bytes())
    b[1 + 14 * 32] ^= 1                               # low byte of t_x
    swapped = [outs[1], outs[0]] + outs[2:]
    for name, p, o in (("flipped byte", R1.R1CSProof.from_bytes(bytes(b)), outs),
                       ("swapped output commitments", proof, swapped)):
        try:
            verify(p, outs=o, seed=42)
        except R1CSError:
            log(f"  R1CS {name}: rejected on the card")
        else:
            failures.append(f"R1CS {name} accepted")

    # batch_verify of two k = 2^10 shuffles, the floor lowered to their size
    ks = min(1 << 10, k)
    made = [SH.prove_shuffle(pc, bp, b"chip batch %d" % i,
                             *SH.shuffle_values(ks, ks + i, tamper=i == 2),
                             Rng(args.seed + 43 + i)) for i in range(3)]

    def items(idx):
        return [(SH.shuffle_verifier(b"chip batch %d" % i, made[i][0],
                                     made[i][1]), made[i][2]) for i in idx]

    low = 1 << (2 * ks - 3).bit_length()
    settings.r1cs_device_msm_floor = low
    try:
        device_run(f"R1CS batch_verify of two k={ks} shuffles",
                   lambda: R1.batch_verify(items([0, 1]), pc, bp, rng=Rng(44),
                                           device=DEVICE), low)
        try:
            R1.batch_verify(items([0, 2]), pc, bp, rng=Rng(45), device=DEVICE)
        except R1CSError:
            log("  the batch with one tampered shuffle: rejected on the card")
        else:
            failures.append("R1CS tampered batch accepted")
    finally:
        settings.r1cs_device_msm_floor = old


def linear_phase(args, smi, imads, failures):
    """11. Linear proofs: batch_verify of --linear-items items at n = 1024
    (128 created proofs, each repeated with fresh transcripts) on the
    forced device route (cold, then 3 runs alternating with the host
    route), the fused MSM alone, K1, K10, K11, K4a and K4b against their
    plain versions on its inputs, and a tampered batch rejected on the
    card."""
    from bulletproofs_tpu_torch import (BulletproofGens, LinearProof,
                                        PedersenGens, ProofError, Scalar,
                                        Transcript)
    from bulletproofs_tpu_torch.config import settings
    from bulletproofs_tpu_torch.core.ristretto import multiscalar_mul
    from bulletproofs_tpu_torch.ops import _cuda
    from bulletproofs_tpu_torch.proofs import linear as LIN
    from bulletproofs_tpu_torch.utils.util import inner_product
    n = 1024
    G = BulletproofGens(n, 1).share(0).G(n)
    pc = PedersenGens()
    F, B = pc.B, pc.B_blinding
    rng = Rng(args.seed + 50)
    made = []
    t0 = time.time()
    for i in range(min(128, args.linear_items)):
        a = [Scalar.random(rng) for _ in range(n)]
        b = [Scalar.random(rng) for _ in range(n)]
        r = Scalar.random(rng)
        C = multiscalar_mul(a + [r, inner_product(a, b)], G + [B, F]).compress()
        label = b"chip linear %d" % i
        made.append((LinearProof.create(Transcript(label), rng, C, r, a, b,
                                        list(G), F, B), C, b, label))
    reps = args.linear_items // len(made)
    total = reps * len(made) * (2 + 2 * (n.bit_length() - 1)) + 2 + n
    log(f"linear proofs, n={n}: {len(made)} created in "
        f"{time.time() - t0:.1f} s (host), each verified {reps} times "
        f"(fresh transcripts): {reps * len(made)} items, {total} MSM points "
        f"(device floor {settings.linear_device_msm_floor})")

    def verify(proofs=None, use_device=True, seed=51):
        LinearProof.batch_verify(
            [(p, Transcript(l), C, b) for _ in range(reps)
             for p, C, b, l in (proofs or made)],
            G, F, B, rng=Rng(seed), use_device=use_device, device=DEVICE)

    caps = device_captures(LIN, "_device_linear_check")
    _cuda.reset_counts()
    try:
        cold = host_clock(verify)
    finally:
        for c in caps:
            c.restore()
    launches = dict(_cuda.LAUNCHES)
    for name in MSM_KERNELS:
        if launches[name] == 0:
            failures.append(f"{name} not launched by the linear verifier")
    if any(c.args is None for c in caps):
        failures.append("linear: the device check did not run")
        return
    parts = {"linear_verify_replay_batch_c": [], "rist_batch_decompress": [],
             "rist_msm": []}

    def on_host():
        timer = NativeTimer(list(parts))
        _cuda.reset_counts()
        try:
            verify(use_device=False)
        finally:
            timer.close()
        if any(_cuda.LAUNCHES.values()):
            failures.append("linear host route launched a kernel")
        for name, ms in timer.ms.items():
            parts[name].append(ms)

    dev_ms, host_ms = paired(verify, on_host, what="linear batch")
    cap = caps[0]
    msm_ms = [host_clock(lambda: cap.real(*cap.args)) for _ in range(3)]
    log(f"  device route (forced): cold {cold:.1f} ms; then alternating with "
        f"the host route, 3 runs each: card {runs_text(dev_ms)}, host "
        f"{runs_text(host_ms)} (its C++ replay "
        f"{runs_text(parts['linear_verify_replay_batch_c'])}, decompression "
        f"{runs_text(parts['rist_batch_decompress'])}, rist_msm "
        f"{runs_text(parts['rist_msm'])}); launches "
        f"{ {k: v for k, v in launches.items() if v} }; the fused MSM alone "
        f"(uploads included) {runs_text(msm_ms)}; on {smi}")
    msm_path_checks("linear batch verify", caps[1], caps[2], imads, smi,
                    failures)
    p0, C0, b0, l0 = made[0]
    bad = LinearProof.from_bytes(p0.to_bytes())
    bad.a = bad.a + Scalar.one()
    try:
        verify([(bad, C0, b0, l0)] + made[1:], seed=52)
    except ProofError:
        log("  linear batch with one tampered proof: rejected on the card")
    else:
        failures.append("linear tampered batch accepted")


class RowCapture:
    """Keeps (coefficient rows (copied), consttime, output) of every
    fixed_msm.msm_rows_compressed call while it goes on working (the host
    prover reuses its round buffer)."""

    def __init__(self, module):
        self.module, self.real, self.calls = module, \
            module.msm_rows_compressed, []
        module.msm_rows_compressed = self

    def __call__(self, tables, coef, consttime=False):
        out = self.real(tables, coef, consttime)
        self.calls.append((tables, coef.copy(), consttime, out.copy()))
        return out

    def restore(self):
        self.module.msm_rows_compressed = self.real


def routes_phase(args, smi, failures, main):
    """12. The host and Python routes and the mesh, on the main path's
    proofs (`main`: its generators, prover, fused verifier, proofs,
    commitments and labels, and the m=16 verifier and statements):
    BatchVerifier(prefer_host=True) (all C++), BatchVerifier(mesh=) over
    every card present and over a virtual 4-shard mesh on card 0 (the
    chunked route, every MSM sharded: launches per shard, the shards'
    devices), the 2^16-point sharded MSM over both meshes beside the
    unsharded one and one shard's kernels against their plain versions,
    use_native=False with and without the 4-shard mesh, an R1CS k = 8
    shuffle verified with msm= over each mesh, BatchProver(prefer_host=
    True) (the C++ stage engine) with its row MSMs redone on the card,
    and m = 16 through prove_multiple.  Every route: accepted, tampering
    rejected, transcripts equal to the fused route's."""
    from bulletproofs_tpu_torch import (BatchProver, BatchVerifier,
                                        BulletproofGens, R1CSError,
                                        RangeProof, ProofError, Transcript)
    from bulletproofs_tpu_torch.benches import shuffle as SH
    from bulletproofs_tpu_torch.config import settings
    from bulletproofs_tpu_torch.core.ristretto import RISTRETTO_BASEPOINT
    from bulletproofs_tpu_torch.core.scalar import L as ELL, Scalar
    from bulletproofs_tpu_torch.ops import _cuda
    from bulletproofs_tpu_torch.ops import curve as C
    from bulletproofs_tpu_torch.ops import fixed_msm as FM
    from bulletproofs_tpu_torch.ops import fold as FO
    from bulletproofs_tpu_torch.ops import msm as M
    from bulletproofs_tpu_torch.ops import scalar as S
    from bulletproofs_tpu_torch.parallel import (Mesh, make_mesh,
                                                 sharded_msm_lanes)
    from bulletproofs_tpu_torch.parallel import sharded_msm as SMm
    from bulletproofs_tpu_torch.proofs import batch_prover as BPm
    import numpy as np
    bp, pc, n = main["bp"], main["pc"], main["n"]
    proofs, vcss, labels = main["proofs"], main["vcss"], main["labels"]
    count = len(proofs)
    card0 = torch.device(DEVICE, 0) if DEVICE == "cuda" \
        else torch.device(DEVICE)
    meshes = [("every card present", make_mesh(device=DEVICE)),
              ("a virtual 4-shard mesh on card 0", Mesh([card0] * 4))]
    log(f"routes and the mesh ({count} proofs of n={n}; meshes: "
        + "; ".join(f"{w} {mesh}" for w, mesh in meshes) + f") on {smi}:")

    def run(verifier, ps, vs, seed, labs=None):
        """-> (accepted, transcript bytes after)."""
        ts = [Transcript(l) for l in (labs or labels)]
        try:
            verifier.verify_batch(ps, vs, ts, rng=Rng(seed))
            ok = True
        except ProofError:
            ok = False
        torch.cuda.synchronize()
        return ok, [t.strobe.buf.raw for t in ts]

    last = count - 1
    b = bytearray(proofs[last].to_bytes())
    b[128] ^= 1                                       # low byte of t_x
    tampered = (("flipped byte", proofs[:last]
                 + [RangeProof.from_bytes(bytes(b))], vcss),
                ("swapped commitments", proofs,
                 vcss[:last - 1] + [vcss[last], vcss[last - 1]]))
    fused = main["bv"]
    ok, fused_ts = run(fused, proofs, vcss, 60)
    if not ok:
        failures.append("fused route rejected the proofs")

    def route_checks(what, verifier, ps=proofs, vs=vcss, want_ts=fused_ts,
                     labs=None, no_kernels=False):
        """Accept (launches counted from 0 just before, read just after),
        transcripts equal to the fused route's, both tamperings
        rejected -> the accepting run's launches."""
        _cuda.reset_counts()
        ok, ts = run(verifier, ps, vs, 61, labs)
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        same = ts == want_ts
        log(f"  {what}: {'accepted' if ok else 'REJECTED'}, transcripts "
            f"{'equal to' if same else 'DIFFERENT from'} the fused "
            f"route's; launches {launches}")
        if not ok or not same:
            failures.append(f"{what}: verdict or transcripts")
        if no_kernels and launches:
            failures.append(f"{what} launched kernels")
        if ps is proofs:
            for name, tps, tvs in tampered:
                if run(verifier, tps, tvs, 62, labs)[0]:
                    failures.append(f"{what}: {name} accepted")
                    log(f"    {name}: ACCEPTED")
                else:
                    log(f"    {name}: rejected")
        return launches

    # -- prefer_host=True: the C++ route, beside the fused route -----------------
    hbv = BatchVerifier(bp, pc, n=n, m=1, prefer_host=True, device=DEVICE)
    route_checks("prefer_host=True (C++ replay, decompression, rist_msm)",
                 hbv, no_kernels=True)
    fused_ms, host_ms = paired(lambda: run(fused, proofs, vcss, 63),
                               lambda: run(hbv, proofs, vcss, 63))
    log(f"    {count} proofs, 3 runs each alternating (host clock): fused "
        f"route best {min(fused_ms):.1f} ms ({runs_text(fused_ms)}), C++ "
        f"route best {min(host_ms):.1f} ms ({runs_text(host_ms)})")

    # -- the mesh verifier: the chunked route, every MSM sharded -----------------------
    n_dyn = 4 + 2 * (n.bit_length() - 1) + 1
    chunks = -(-count // max(1, settings.verify_chunk_pts // n_dyn))
    for what, mesh in meshes:
        seen = []
        real = SMm.M.msm_lanes

        def on_shard(pts, sc, real=real, seen=seen):
            cur = torch.device(DEVICE, torch.cuda.current_device()) \
                if DEVICE == "cuda" else pts.device
            seen.append((pts.device, sc.device, cur))
            return real(pts, sc)

        mbv = BatchVerifier(bp, pc, n=n, m=1, mesh=mesh)
        SMm.M.msm_lanes = on_shard
        try:
            launches = route_checks(f"mesh verifier over {what} "
                                    f"(chunked)", mbv)
        finally:
            SMm.M.msm_lanes = real
        want = mesh.size * (chunks + 1)
        msm_k = {k: launches.get(k, 0) for k in
                 ("digits", "msm_bin", "msm_accumulate_z", "msm_reduce",
                  "msm_horner")}
        log(f"    {chunks} chunks: K10 / K11 / K4a / K4b launches {msm_k} "
            f"(expected {want} each: one a shard a chunk and the final "
            f"MSM's, two of the binning's), K1 "
            f"{launches.get('decompress', 0)} (expected {chunks})")
        if any(v != want * (2 if k == "msm_bin" else 1)
               for k, v in msm_k.items()) \
                or launches.get("decompress", 0) != chunks \
                or launches.get("emit", 0) or launches.get("msm_accumulate"):
            failures.append(f"mesh verifier over {what}: launches")
        if mesh.size > 1:
            # the accepting run first, then the two tampered ones
            right = len(seen) == 3 * mesh.size * (chunks + 1) and all(
                e == (mesh.devices[i % mesh.size],) * 3
                for i, e in enumerate(seen))
            log(f"    every shard's inputs and current device its own "
                f"({len(seen)} shard MSMs): {'yes' if right else 'NO'}")
            if not right:
                failures.append(f"mesh verifier over {what}: shard devices")
        ms = [host_clock(lambda: run(mbv, proofs, vcss, 64))
              for _ in range(3)]
        log(f"    best {min(ms):.1f} ms of 3 ({runs_text(ms)}) -> "
            f"{count / min(ms) * 1e3:.0f} proofs/s")

    # -- the 2^16-point sharded MSM (__graft_entry__.dryrun_multichip) -----
    big = args.sharded_points
    g = np.random.default_rng(args.seed + 70)
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

    def unsharded():
        return M.msm_lanes(pts, torch.from_numpy(rows.copy()).to(card0))

    results = [("unsharded msm_lanes", unsharded)] + [
        (f"sharded over {what}", lambda mesh=mesh: sharded_msm_lanes(
            pts, rows, mesh)) for what, mesh in meshes]
    for what, fn in results:
        out = fn()
        good = C.compress(out).cpu().numpy().tobytes() == oracle
        ms = [host_clock(fn) for _ in range(3)]
        log(f"  {big}-point MSM, {what}: "
            f"{'equal to' if good else 'DIFFERENT from'} the one-scalar "
            f"oracle; best {min(ms):.2f} ms of 3 ({runs_text(ms)}; scalars "
            f"uploaded from the host inside)")
        if not good:
            failures.append(f"{big}-point MSM {what}")
    shard = -(-big // 4)
    sp = pts[..., :shard].contiguous()
    coef = S.from_bytes32(torch.from_numpy(rows[:shard].copy()).to(card0))
    dig = FO.digits_lanes(coef)
    slab = M.accumulate_z(sp, dig)
    sums = M.reduce(slab)
    checks = (("digits", dig, lambda: FO.digits_plain(coef[None])),
              ("msm_bin", M.bin_points(sp, dig),
               lambda: M.bin_points_plain(sp, dig)),
              ("msm_accumulate_z", slab,
               lambda: M.accumulate_z_plain(sp, dig)),
              ("msm_reduce", sums, lambda: M.reduce_plain(slab)),
              ("msm_horner", M.horner(sums), lambda: M.horner_plain(sums)))
    errs = {}
    for name, got, plain in checks:
        errs[name] = max_abs_err(got, plain())
        if errs[name] != 0:
            failures.append(f"{name} on a {big}-point MSM shard")
    log(f"  one shard ({shard} points) of the 4-shard mesh: kernels against "
        f"their plain versions, max_abs_err {errs}")

    # -- use_native=False: the Python replay, one device MSM ----------------------------
    few = min(256, count)
    sub = (proofs[:few], vcss[:few], labels[:few])
    want_ts = run(fused, *sub[:2], 65, sub[2])[1]
    for what, mesh in (("on the card", None),
                       ("over " + meshes[1][0], meshes[1][1])):
        pbv = BatchVerifier(bp, pc, n=n, m=1, use_native=False, mesh=mesh,
                            device=DEVICE)
        t0 = time.perf_counter()
        launches = route_checks(f"use_native=False {what}, {few} proofs",
                                pbv, *sub[:2], want_ts=want_ts, labs=sub[2])
        ms = (time.perf_counter() - t0) * 1e3
        want = 1 if mesh is None else mesh.size
        if launches.get("msm_accumulate_z", 0) != want \
                or launches.get("decompress", 0) != 1:
            failures.append(f"use_native=False {what}: launches")
        fb = bytearray(sub[0][-1].to_bytes())
        fb[128] ^= 1
        bad = sub[0][:-1] + [RangeProof.from_bytes(bytes(fb))]
        rejected = not run(pbv, bad, sub[1], 66, sub[2])[0]
        log(f"    one run {ms:.1f} ms (host clock, with the check); a "
            f"flipped byte {'rejected' if rejected else 'ACCEPTED'}")
        if not rejected:
            failures.append(f"use_native=False {what}: flipped byte accepted")

    # -- an R1CS shuffle verified with msm= over the mesh -------------------------------
    kk = 8
    rbp = BulletproofGens(32, 1)
    ins, outs, rproof = SH.prove_shuffle(pc, rbp, b"chip mesh r1cs",
                                         *SH.shuffle_values(kk, kk),
                                         Rng(args.seed + 71))
    for what, mesh in meshes:
        used = []

        def mesh_msm(scalars, points, mesh=mesh, used=used):
            lanes = torch.as_tensor(C.points_to_lanes(points)).to(card0)
            used.append(len(points))
            out = sharded_msm_lanes(lanes, list(scalars), mesh)
            return C.lanes_to_points(out.cpu().numpy())[0]

        verdicts = []
        for o in (outs, [outs[1], outs[0]] + outs[2:]):
            try:
                SH.shuffle_verifier(b"chip mesh r1cs", ins, o).verify(
                    rproof, pc, rbp, rng=Rng(72), msm=mesh_msm, device=DEVICE)
                verdicts.append(True)
            except R1CSError:
                verdicts.append(False)
        log(f"  R1CS k={kk} shuffle, msm= sharded over {what}: "
            f"{'accepted' if verdicts[0] else 'REJECTED'}, swapped outputs "
            f"{'ACCEPTED' if verdicts[1] else 'rejected'} ({used} MSM "
            f"points)")
        if verdicts != [True, False] or not used:
            failures.append(f"R1CS over {what}")

    # -- BatchProver(prefer_host=True): the C++ stage engine ---------------------------
    hp = min(args.host_prove, count)
    hprover = BatchProver(bp, pc, n, 1, device=DEVICE, prefer_host=True)
    vals, blinds = main["values"][:hp], main["blinds"][:hp]
    cap = RowCapture(BPm.fixed_msm)
    _cuda.reset_counts()
    t0 = time.perf_counter()
    try:
        ts = [Transcript(l) for l in labels[:hp]]
        hps, hvs = hprover.prove_batch(vals, blinds, ts, rng=Rng(73))
    finally:
        cap.restore()
    ms = (time.perf_counter() - t0) * 1e3
    if any(_cuda.LAUNCHES.values()):
        failures.append("the host prover launched kernels")
    log(f"  BatchProver(prefer_host=True), {hp} proofs of n={n}: {ms:.1f} "
        f"ms (host clock, one run), {len(cap.calls)} row MSM calls")
    route_checks(f"the host prover's {hp} proofs on the card's fused "
                 f"verifier", fused, hps, [[v] for v in hvs],
                 want_ts=[t.strobe.buf.raw for t in ts], labs=labels[:hp])
    card_tables = {id(hprover.tables): main["prover"].tables,
                   id(hprover.tables_bb): main["prover"].tables_bb}
    for i, what in ((0, "stage 0's V / A / S rows (one-hot K6)"),
                    (2, "IPP round 1's L / R rows (direct K6)")):
        tables, coef, ct, out = cap.calls[i]
        _cuda.reset_counts()
        got = FM.msm_rows_compressed(card_tables[id(tables)], coef,
                                     consttime=ct)
        torch.cuda.synchronize()
        lk = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        same = np.array_equal(got, out)
        log(f"    {what}, {coef.shape[0]} rows x {coef.shape[1]} bases on "
            f"the card: {'byte-identical to' if same else 'DIFFERENT from'} "
            f"the C++ rows; launches {lk}")
        if not same or not lk.get("digits") or not lk.get("compress") \
                or not lk.get("fixed_reduce" if ct else "fixed_merge") \
                or not lk.get("fixed_accumulate" if ct
                              else "fixed_accumulate_vt"):
            failures.append(f"card rows of {what}")

    # -- m = 16 through prove_multiple, verified on the chunked route -----------------
    bp16, bv16, m16 = main["bp16"], main["bv16"], main["m16"]
    p16 = BatchProver(bp16, pc, n, m16, device=DEVICE, prefer_host=True)
    ts = [Transcript(l) for l in main["labels16"][:2]]
    t0 = time.perf_counter()
    ps16, vs16 = p16.prove_batch(main["vals16"][:2], main["blinds16"][:2], ts,
                                 rng=Rng(74))
    ms = (time.perf_counter() - t0) * 1e3
    launches = route_checks(f"2 m={m16} proofs of prove_multiple ({ms:.1f} "
                            f"ms to prove) on the chunked route", bv16, ps16,
                            vs16, want_ts=[t.strobe.buf.raw for t in ts],
                            labs=main["labels16"][:2])
    if launches.get("emit") or not launches.get("msm_accumulate_z"):
        failures.append(f"m={m16} host proofs did not take the chunked "
                        f"route")


# the kernels each example's path must launch (counts from 0 just before
# the example's main, read just after)
# K17-K20, the prover's mod-l vector kernels
SCALAR_KERNELS = ("sc_mul", "sc_add", "sc_tree_sum", "chacha_scalars")
PROVE_KERNELS = ("compress", "fixed_accumulate", "fixed_accumulate_vt",
                 "fixed_reduce", "fixed_merge", "fold", "smul", "digits",
                 "keccak_f1600", "sinv") + SCALAR_KERNELS
VERIFY_KERNELS = ("decompress", "emit", "msm_bin_niels", "msm_accumulate",
                  "msm_reduce", "msm_horner")


def examples_phase(args, smi, failures):
    """13. The examples (bulletproofs_tpu_torch/examples/), each main
    called in-process with device="cuda": batch_throughput at
    `--example-batch` (256) n=64 proofs (the prove and verify routes'
    kernels must launch; the proofs verify again on the card and 4 on the
    host, a tampered one is rejected), r1cs_gadget at k = `--example-k`
    (8192: its 2 x 8191 multipliers pad to the device floor, so the
    verifier's mega-MSM kernels must launch), then the host paths
    range_proof, mpc_aggregation and mpc_multiprocess 4.  Each example's
    wall on the host clock, ending in a synchronize."""
    import traceback
    from bulletproofs_tpu_torch import (BulletproofGens, PedersenGens,
                                        ProofError, RangeProof, Transcript)
    from bulletproofs_tpu_torch.config import settings
    from bulletproofs_tpu_torch.examples import (batch_throughput,
                                                 mpc_aggregation,
                                                 mpc_multiprocess,
                                                 r1cs_gadget, range_proof)
    from bulletproofs_tpu_torch.ops import _cuda
    log(f"the examples on the card ({smi}):")

    def run(what, fn, want=()):
        """fn() with the counts from 0 just before it, read just after;
        an exception or a kernel of `want` not launched is a failure."""
        _cuda.reset_counts()
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
        except (Exception, SystemExit) as e:
            traceback.print_exc()
            failures.append(f"example {what}: {type(e).__name__}: {e}")
            return None
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        log(f"  {what}: {wall:.3f} s wall (host clock, ending in a "
            f"synchronize; on {smi}); launches {launches}")
        for name in want:
            if not launches.get(name):
                failures.append(f"{name} not launched by the example {what}")
        return out

    batch = args.example_batch
    out = run(f"batch_throughput {batch}",
              lambda: batch_throughput.main(batch, DEVICE),
              PROVE_KERNELS + VERIFY_KERNELS)
    if out is not None:
        proofs, vcs, labels = out["proofs"], out["commitments"], out["labels"]
        log(f"    prove {out['prove_s'] * 1e3:.1f} ms ({batch / out['prove_s']:.1f}"
            f" proofs/s), verify {out['verify_s'] * 1e3:.1f} ms "
            f"({batch / out['verify_s']:.1f} proofs/s)")
        bp, pc = BulletproofGens(64, 1), PedersenGens()
        for i in range(min(4, batch)):
            proofs[i].verify_single(bp, pc, Transcript(labels[i]), vcs[i], 64,
                                    rng=Rng(81 + i))
        b = bytearray(proofs[-1].to_bytes())
        b[128] ^= 1                                   # low byte of t_x
        for what, ps in (("as proved", proofs),
                         ("one tampered", proofs[:-1]
                          + [RangeProof.from_bytes(bytes(b))])):
            try:
                out["verifier"].verify_batch(
                    ps, [[c] for c in vcs], [Transcript(l) for l in labels],
                    rng=Rng(80))
                ok = True
            except ProofError:
                ok = False
            torch.cuda.synchronize()
            log(f"    the batch {what}: {'accepted' if ok else 'rejected'} "
                f"on the card")
            if ok != (what == "as proved"):
                failures.append(f"batch_throughput: the batch {what} was "
                                f"{'accepted' if ok else 'rejected'}")

    k = args.example_k
    padded = 1 << (2 * k - 3).bit_length()
    if padded < settings.r1cs_device_msm_floor:
        failures.append(f"r1cs_gadget k={k}: {padded} padded multipliers "
                        f"stay below the device floor")
    run(f"r1cs_gadget {k}", lambda: r1cs_gadget.main(k, DEVICE), MSM_KERNELS)

    run("range_proof", lambda: range_proof.main(DEVICE))
    run("mpc_aggregation", lambda: mpc_aggregation.main(DEVICE))
    run("mpc_multiprocess 4", lambda: mpc_multiprocess.main(4, DEVICE))


# the kernels each MSM route launches once a call (the binning twice)
MSM_ROUTES = {
    "msm_lanes_flag": ("digits", "msm_bin", "msm_accumulate_z", "msm_reduce",
                       "msm_horner"),
    "msm_lanes_niels_flag": ("digits", "msm_bin_niels", "msm_accumulate",
                             "msm_reduce", "msm_horner")}


def msm_phase(args, smi, imads, failures):
    """14. The north-star MSM entry (the JAX package's bench.py MSM row and
    benches/bench_msm_northstar.py) at `--msm-points` (2^16): seeded rows
    of 64 bytes hashed to the group on the card (curve.from_uniform_bytes;
    4,096 of them against the host C++ rist_from_uniform_bytes by their
    encodings), msm.normalize_z, then both MSM routes with scalars below
    2^252: equal to each other, to the host C++ rist_msm over the points'
    encodings and to the subtract trick (one scalar + 1: the difference
    is that point); each route's launches; K10, K3 and K11 with their
    binning launches, K4a and K4b against their plain versions on these
    inputs; each route timed device-resident and with the scalars'
    upload (a warm-up, then 5 runs)."""
    import ctypes

    import numpy as np

    from bulletproofs_tpu_torch.core._native import LIB
    from bulletproofs_tpu_torch.ops import _cuda
    from bulletproofs_tpu_torch.ops import curve as C
    from bulletproofs_tpu_torch.ops import msm as M
    N = args.msm_points
    dev = torch.device(DEVICE)
    gen = np.random.default_rng(args.seed + 60)
    raw = gen.integers(0, 256, (N, 64), dtype=np.uint8)
    sbytes = gen.integers(0, 256, (N, 32), dtype=np.uint8)
    sbytes[:, 31] &= 15          # < 2^252, as bench_msm_northstar.py
    log(f"the MSM entry, {N} points, on {smi}:")
    got = []
    map_ms = host_clock(lambda: got.append(C.from_uniform_bytes(raw, DEVICE)))
    pts = got.pop()
    norm_ms = host_clock(lambda: got.append(M.normalize_z(pts)))
    pts1 = got.pop()
    log(f"  set-up, once each: from_uniform_bytes {map_ms:.1f} ms, "
        f"normalize_z {norm_ms:.1f} ms (plain PyTorch, host clock ending "
        f"in a synchronize)")

    # the hash against the host C++, by the card's encodings (K5)
    sample = np.sort(gen.choice(N, min(4096, N), replace=False))
    idx = torch.as_tensor(sample, device=dev)
    enc = C.compress(pts.index_select(-1, idx).contiguous()).cpu().numpy()
    enc1 = C.compress(pts1.index_select(-1, idx).contiguous()).cpu().numpy()
    ext, out32 = ctypes.create_string_buffer(128), ctypes.create_string_buffer(32)
    bad = 0
    for j, i in enumerate(sample):
        LIB.rist_from_uniform_bytes(raw[i].tobytes(), ext)
        LIB.rist_compress(ext.raw, out32)
        bad += out32.raw != enc[j].tobytes()
    z_one = bool((pts1[2, 0] == 1).all()) and not bool(pts1[2, 1:].any())
    same = np.array_equal(enc, enc1)
    log(f"  {len(sample)} sampled rows: {len(sample) - bad} encodings equal "
        f"to the host C++ rist_from_uniform_bytes; normalize_z: Z = 1 "
        f"{'everywhere' if z_one else 'NOT everywhere'}, the same points "
        f"{'by' if same else 'NOT by'} their encodings")
    if bad or not z_one or not same:
        failures.append("from_uniform_bytes / normalize_z on the card")

    sc = torch.from_numpy(sbytes).to(dev)
    inputs = {"msm_lanes_flag": pts, "msm_lanes_niels_flag": pts1}
    outs = {}
    for route, kernels in MSM_ROUTES.items():
        fn = getattr(M, route)
        torch.cuda.synchronize()
        _cuda.reset_counts()
        outs[route] = fn(inputs[route], sc)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        want = {k: 2 if k.startswith("msm_bin") else 1 for k in kernels}
        log(f"  {route}: launches {launches} (expected {want})")
        if launches != want:
            failures.append(f"{route}: launches {launches}, expected {want}")

    def encoding(out) -> bytes:
        return C.lanes_to_points(out[0].cpu().numpy())[0].compress()

    # the host C++ Pippenger over the points' encodings
    all_enc = C.compress(pts).cpu().numpy().tobytes()
    hext, ok = ctypes.create_string_buffer(128 * N), ctypes.create_string_buffer(N)
    decoded = LIB.rist_batch_decompress(N, all_enc, hext, ok)
    hout = ctypes.create_string_buffer(128)
    t0 = time.perf_counter()
    LIB.rist_msm(N, sbytes.tobytes(), hext.raw, hout)
    host_ms = (time.perf_counter() - t0) * 1e3
    LIB.rist_compress(hout.raw, out32)
    host_enc = out32.raw
    results = {r: encoding(o) for r, o in outs.items()}
    flags = {r: bool(o[1][0]) for r, o in outs.items()}
    agree = (len(set(results.values())) == 1 and decoded == N
             and results["msm_lanes_flag"] == host_enc
             and not any(flags.values()))
    log(f"  both routes {'equal' if agree else 'DIFFERENT'}: each other, the "
        f"host C++ rist_msm over the {decoded} decoded encodings "
        f"({host_ms:.1f} ms on the host), flags {flags}")
    if not agree:
        failures.append("MSM routes against each other and the host rist_msm")

    # the subtract trick (tests/test_tpu_smoke.py): s_k + 1 at one k
    k = 12345 % N
    s2 = sbytes.copy()
    v = int.from_bytes(s2[k].tobytes(), "little") + 1
    s2[k] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    sc2 = torch.from_numpy(s2).to(dev)
    pk = C.lanes_to_points(pts[:, :, k: k + 1].cpu().numpy())[0]
    for route in MSM_ROUTES:
        out2 = getattr(M, route)(inputs[route], sc2)
        p1 = C.lanes_to_points(outs[route][0].cpu().numpy())[0]
        p2 = C.lanes_to_points(out2[0].cpu().numpy())[0]
        ok_k = (p2 - p1).compress() == pk.compress()
        log(f"  {route}: msm(s + e_{k}) - msm(s) "
            f"{'equals' if ok_k else 'DIFFERS from'} point {k}")
        if not ok_k:
            failures.append(f"{route}: subtract trick")

    for route in MSM_ROUTES:
        log(f"  {route}: kernels against their plain versions ({N} points "
            f"in {M.pick_lanes(N)} lanes):")
        check_stages(f"MSM entry's {route}",
                     msm_stages(inputs[route], sc, outs[route],
                                route == "msm_lanes_niels_flag"),
                     imads, smi, failures)

    for route in MSM_ROUTES:
        fn, p = getattr(M, route), inputs[route]
        for how, scalars in (("device-resident", lambda: sc),
                             ("with the scalars' upload",
                              lambda: torch.from_numpy(sbytes).to(dev))):
            host_clock(lambda: fn(p, scalars()))                  # warm-up
            ms = [host_clock(lambda: fn(p, scalars())) for _ in range(5)]
            best, med = min(ms), statistics.median(ms)
            log(f"  MSM {N} {route} {how}: runs "
                f"{[round(x, 4) for x in ms]} ms, median {med:.4f}, best "
                f"{best:.4f} -> {N / med * 1e3:,.0f} points/s at the median, "
                f"{N / best * 1e3:,.0f} at the best on {smi}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--total", type=int, default=8192)
    ap.add_argument("--prove-runs", type=int, default=3)
    ap.add_argument("--runs", type=int, default=12)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--agg-total", type=int, default=256)
    ap.add_argument("--agg-runs", type=int, default=3)
    ap.add_argument("--probe-steps", type=int, default=1024)
    ap.add_argument("--r1cs-k", type=int, default=1 << 15)
    ap.add_argument("--linear-items", type=int, default=2048)
    ap.add_argument("--host-prove", type=int, default=256)
    ap.add_argument("--sharded-points", type=int, default=1 << 16)
    ap.add_argument("--example-batch", type=int, default=256)
    ap.add_argument("--example-k", type=int, default=8192)
    ap.add_argument("--msm-points", type=int, default=1 << 16)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from bulletproofs_tpu_torch import (BatchProver, BatchVerifier,
                                        BulletproofGens, PedersenGens,
                                        ProofError, RangeProof, Scalar,
                                        Transcript)
    from bulletproofs_tpu_torch.core.ristretto import multiscalar_mul
    from bulletproofs_tpu_torch.ops import _cuda
    from bulletproofs_tpu_torch.ops import curve as C
    from bulletproofs_tpu_torch.config import settings
    from bulletproofs_tpu_torch.ops import fixed_msm as FM
    from bulletproofs_tpu_torch.benches import field_kernels as FK
    from bulletproofs_tpu_torch.benches import fixed_msm_shapes as FS
    from bulletproofs_tpu_torch.benches import verify_calls as VC
    from bulletproofs_tpu_torch.ops import fold as FO
    from bulletproofs_tpu_torch.ops import msm as M
    from bulletproofs_tpu_torch.ops import prover_stages as PS
    from bulletproofs_tpu_torch.ops import keccak_device as K
    from bulletproofs_tpu_torch.ops import scalar as S
    from bulletproofs_tpu_torch.ops import transcript_device as TD
    from bulletproofs_tpu_torch.ops import verify as V
    from bulletproofs_tpu_torch.ops.limbs import sc_ints_to_limbs
    from bulletproofs_tpu_torch.core.scalar import L as ELL
    from bulletproofs_tpu_torch.utils.keccak import f1600_state

    dev = torch.device(DEVICE)
    smi = card_line()
    imads = peak_imads()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = imads / (sms * IMAD_PER_CLOCK_SM) / 1e6     # maximum SM clock
    smem_rate = imads / IMAD_PER_CLOCK_SM * SMEM_BYTES_PER_CLOCK_SM
    log("torch", torch.__version__, "cuda", torch.version.cuda, "|", smi,
        f"| peak {imads:.4g} int32 multiply-adds/s")

    # -- 1. build --------------------------------------------------------------
    t0 = time.time()
    logs = _cuda.build_all()
    log(f"build: {time.time() - t0:.1f} s")
    for lib, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line \
                    or (lib in ("fixed_msm", "msm")
                        and "Compiling entry" in line):
                log(f"  [{lib}] {line.strip()}")
    failures = []
    per_sm = FM.blocks_per_sm()
    direct_warps = per_sm["fixed_accumulate_vt"] * FM.DIRECT_THREADS // 32
    log(f"fixed_msm blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor): "
        f"{per_sm}; K6 one-hot's split assumes {FM.TARGET_THREADS // (sms * 32)} "
        f"blocks of 32 lanes per SM, the direct form's "
        f"{FM.TARGET_THREADS_DIRECT // (sms * 32)} warps ({direct_warps} "
        f"resident)")
    if per_sm["fixed_accumulate"] * sms * 32 != FM.TARGET_THREADS:
        log("  NOTE: K6's occupancy differs from fixed_msm.TARGET_THREADS")
    if direct_warps * sms * 32 < FM.TARGET_THREADS_DIRECT:
        failures.append(f"K6's direct form holds {direct_warps} warps per "
                        f"SM, under its split target's "
                        f"{FM.TARGET_THREADS_DIRECT // (sms * 32)}")
    if per_sm["fixed_accumulate2"] != per_sm["fixed_accumulate"]:
        failures.append("K12 holds fewer blocks per SM than K6")
    log(f"msm resident warps per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor"
        f"): {M.warps_per_sm()}")
    log(f"decompress resident points (cudaOccupancyMaxActiveBlocksPerMultiprocessor"
        f"): {C.decompress_resident()}")

    n, m = 64, 1
    lg, nblk, n_dyn = V.shape(n, m)
    bp, pc = BulletproofGens(n, m), PedersenGens()
    kernels = []

    def check_k6_forms(launches, N, halves, what):
        """K6 launches per form, per half: 4 one-hot (V, A, S, T) and
        2 log2 N direct (each IPP round's L and R), one K7 per K6 (its
        8-bucket form after the one-hot form, its chunk merge after the
        direct form)."""
        rounds = N.bit_length() - 1
        want = {"fixed_accumulate": 4 * halves,
                "fixed_accumulate_vt": 2 * rounds * halves,
                "fixed_reduce": 4 * halves,
                "fixed_merge": 2 * rounds * halves}
        got = {k: launches[k] for k in want}
        log(f"  {what}: K6 / K7 launches {got} (expected {want})")
        if got != want:
            failures.append(f"{what}: K6 / K7 launches {got}, expected {want}")

    def check_k8_k9_k13(launches, N, halves, what, last_smul):
        """K8 once a round per half (a and b in one launch: log2 N), K9
        once a round too (gw and hw in one launch; the device-transcript
        route's last fold updates neither, the per-stage route's
        `last_smul` does), K20 once a half for the blinds and, on the
        device-transcript route (not `last_smul`), once a challenge (x, w
        and each round's u), and K13's and K17-K19's launches and the
        port's kernel launches of the call."""
        want = (N.bit_length() - 1) * halves
        want9 = want if last_smul else want - halves
        want20 = halves if last_smul else want + 3 * halves
        log(f"  {what}: K8 fold {launches['fold']} launches (one a round: "
            f"expected {want}), K9 smul {launches['smul']} (expected "
            f"{want9}), K20 chacha_scalars {launches['chacha_scalars']} "
            f"(expected {want20}), K13 keccak_f1600 "
            f"{launches['keccak_f1600']}, K17 sc_mul {launches['sc_mul']}, "
            f"K18 sc_add {launches['sc_add']}, K19 sc_tree_sum "
            f"{launches['sc_tree_sum']}, {sum(launches.values())} launches "
            f"of the port's kernels")
        if launches["chacha_scalars"] != want20:
            failures.append(f"{what}: {launches['chacha_scalars']} K20 "
                            f"launches, expected {want20}")
        if launches["fold"] != want:
            failures.append(f"{what}: {launches['fold']} K8 launches, "
                            f"expected {want}")
        if launches["smul"] != want9:
            failures.append(f"{what}: {launches['smul']} K9 launches, "
                            f"expected {want9}")

    def fold_check(cap, what):
        """K8 on a prove's captured round-1 inputs: exact against its plain
        version and the path's own output; timed by device time and by the
        events loop, beside the six-launch form of an older fold_dyn (two
        index_select, two fold_lanes, two where; fold_lanes on this K8 with
        the identity map) -> (max_abs_err, ms, plain ms, bytes,
        multiply-adds) for `record`."""
        a, b, u, ui, idx, mask = cap.args
        N, P, nk = a.shape[0], a.shape[-1], int(mask.sum())
        got = FO.fold_pair(*cap.args)
        want, plain_ms = time_once(lambda: FO.fold_pair_plain(*cap.args))
        err = max(max_abs_err(got, want), max_abs_err(got, cap.out))

        def six():
            return FK.fold_six(*cap.args)
        six_err = max_abs_err(six(), want)
        ms = queued_ms(lambda: FO.fold_pair(*cap.args), 50)
        loop_ms = time_cuda(lambda: FO.fold_pair(*cap.args), 50)
        six_ms, six_loop = queued_ms(six, 50), time_cuda(six, 50)
        nbytes, mads = FK.fold_work(N, P, nk)
        b_ms, b_by = bound(nbytes, mads, imads)
        log(f"  fold_pair on the {what}'s IPP round 1 ({N} x {P}, nk {nk}): "
            f"max_abs_err {err} ({'ok' if err == 0 else 'MISMATCH'}); "
            f"{ms:.4f} ms device (events loop {loop_ms:.4f}), {plain_ms:.2f} "
            f"ms plain, bound {b_ms:.4f} ms ({b_by}; bytes "
            f"{nbytes / PEAK_BYTES * 1e3:.4f}, operations "
            f"{mads / imads * 1e3:.4f}); the six-launch form {six_ms:.4f} ms "
            f"device (events loop {six_loop:.4f}), max_abs_err {six_err} on "
            f"{smi}")
        if err != 0 or six_err != 0:
            failures.append(f"fold_pair on the {what}'s round 1")
        return err, ms, plain_ms, nbytes, mads

    def smul_check(cap, what):
        """K9 on a prove's captured first gw / hw update: exact against its
        plain version and the path's own output; timed by device time and
        by the events loop, beside two one-vector launches (the update
        before K9 took gw and hw in one launch) -> (max_abs_err, ms, plain
        ms, bytes, multiply-adds) for `record`."""
        x, y, mask, m1, m0 = cap.args
        N, P = x.shape[0], x.shape[-1]
        got = FO.smul_pair(*cap.args)
        want, plain_ms = time_once(lambda: FO.smul_pair_plain(*cap.args))
        err = max(max_abs_err(got, want), max_abs_err(got, cap.out))

        def two():
            return FO.smul_lanes(x, mask, m1, m0), FO.smul_lanes(y, mask, m0,
                                                                m1)
        two_err = max_abs_err(two(), want)
        ms = queued_ms(lambda: FO.smul_pair(*cap.args), 50)
        loop_ms = time_cuda(lambda: FO.smul_pair(*cap.args), 50)
        two_ms = queued_ms(two, 50)
        nbytes, mads = FK.smul_work(N, P)
        b_ms, b_by = bound(nbytes, mads, imads)
        log(f"  smul_pair on the {what}'s first gw / hw update ({N} x {P}): "
            f"max_abs_err {err} ({'ok' if err == 0 else 'MISMATCH'}); "
            f"{ms:.4f} ms device (events loop {loop_ms:.4f}), {plain_ms:.2f} "
            f"ms plain, bound {b_ms:.4f} ms ({b_by}; bytes "
            f"{nbytes / PEAK_BYTES * 1e3:.4f}, operations "
            f"{mads / imads * 1e3:.4f}); two one-vector launches {two_ms:.4f} "
            f"ms device, max_abs_err {two_err} on {smi}")
        if err != 0 or two_err != 0:
            failures.append(f"smul_pair on the {what}'s first update")
        return err, ms, plain_ms, nbytes, mads

    def keccak_check(cap, what):
        """K13 on a prove's captured states and pad: exact against its
        plain version and, for the first and the last state, the host
        permutation; timed by device time and by the events loop, beside
        the two-launch form (an XOR, then the permutation) -> (max_abs_err,
        ms, plain ms) for `record`."""
        st, pad = cap.args
        got = K.f1600_state_bytes(st, pad)
        plain, plain_ms = time_once(
            lambda: K.f1600_state_bytes_plain(st, pad))
        err = max_abs_err(got, plain)
        for p in (0, st.shape[1] - 1):
            padded = (st[:, p] ^ pad[:, 0]).cpu().numpy().tobytes()
            if got[:, p].cpu().numpy().tobytes() != f1600_state(padded):
                err = max(err, 1.0)
        ms = queued_ms(lambda: K.f1600_state_bytes(st, pad), 50)
        loop_ms = time_cuda(lambda: K.f1600_state_bytes(st, pad), 50)
        two_ms = queued_ms(lambda: K.f1600_state_bytes(st ^ pad), 50)
        b_ms, _ = bound(2 * st.numel() + pad.numel(), 0, imads)
        log(f"  keccak_f1600 on the {what}'s {st.shape[1]} states, pad "
            f"included: max_abs_err {err} ({'ok' if err == 0 else 'MISMATCH'}"
            f"); {ms:.4f} ms device (events loop {loop_ms:.4f}), "
            f"{plain_ms:.2f} ms plain, bound {b_ms:.5f} ms (bytes), latency "
            f"floor {FK.keccak_latency_floor_ms(mhz):.4f} ms; the two-launch "
            f"form (XOR, then K13) {two_ms:.4f} ms device on {smi}")
        if err != 0:
            failures.append(f"keccak_f1600 on the {what}'s states")
        return err, ms, plain_ms

    def check_prove_launches(rows, what):
        """A prove's kernel launches as torch.profiler counts them (every
        kernel and copy it saw on the card): with K17-K20 the mod-l vector
        code is one launch a call, so fewer than PROVE_LAUNCH_LIMIT."""
        got = sum(r[1] for r in rows)
        log(f"  {what}: {got} kernel launches (limit {PROVE_LAUNCH_LIMIT})")
        if got >= PROVE_LAUNCH_LIMIT:
            failures.append(f"{what}: {got} kernel launches")

    sc_src = "bulletproofs_tpu_torch/csrc/scalar.cu"
    sc_replaces = {"sc_mul": "bulletproofs_tpu/ops/vec_scalar.py:107",
                   "sc_add": "bulletproofs_tpu/ops/vec_scalar.py:85",
                   "sc_tree_sum": "bulletproofs_tpu/ops/vec_scalar.py:281",
                   "chacha_scalars": "bulletproofs_tpu/ops/chacha.py:52"}

    def scalar_checks(caps, what, launches=None):
        """K17-K20 on a prove's captured calls (views with their strides:
        an expanded operand, column slices, a (9, 1) constant, transposed
        transcript bytes): each exact against its plain version and the
        path's own output, timed by device time (queued behind a sleep of
        the card; held to its bound with the L2 filled by other data
        before each call, and warm in L2 as on the path); then an odd tree
        sum over a column slice, K17 in Montgomery form and empty
        operands, which launch nothing.  With `launches` (the m=1 main path's counts) the first
        check of each kernel goes into the kernels line."""
        from bulletproofs_tpu_torch.ops import chacha as CH
        if any(c.args is None for c in caps.values()
               if not isinstance(c, CaptureEach)) \
                or not caps["tree_sum"].calls:
            failures.append(f"{what}: K17-K20 inputs not captured")
            return
        mul = FK.SC_MUL_MADS
        a, b = caps["smul"].args
        ea, eb = caps["smul_bcast"].args
        sa, sb = caps["sadd"].args
        ca, cb = caps["sadd_const"].args
        (na,) = caps["sneg"].args
        px, py, ph = caps["tree_sum_prefix"].args
        key, k, _ = caps["random_scalars"].args
        (raw,) = caps["from_wide_bytes"].args
        # the round's cross terms with every row live, as the masked form
        # summed them, and an odd slice of them
        tv = torch.cat([px, py], dim=-1)
        odd = tv[1:, :, 1:]
        N, P = px.shape[0], px.shape[-1]

        def elems(*ts):
            return torch.broadcast_shapes(*(t.shape for t in ts)).numel() // 9

        def mul_case(x, y, mode, label, out):
            fn, plain = ((S.mont_mul, S.mont_mul_plain) if mode == 0
                         else (S.smul, S.smul_plain))
            e = elems(x, y)
            return ("sc_mul", f"{'smul' if mode else 'mont_mul'} {label}",
                    lambda: fn(x, y), lambda: plain(x, y), out,
                    operand_bytes(x) + operand_bytes(y) + 72 * e,
                    (2 if mode else 1) * mul * e, 0)

        def add_case(x, y, label, out):
            e = elems(x) if y is None else elems(x, y)
            fn = (lambda: S.sneg(x)) if y is None else (lambda: S.sadd(x, y))
            plain = ((lambda: S.sneg_plain(x)) if y is None
                     else (lambda: S.sadd_plain(x, y)))
            nb = operand_bytes(x) + (0 if y is None else operand_bytes(y))
            return ("sc_add", f"{'sneg' if y is None else 'sadd'} {label}",
                    fn, plain, out, nb + 72 * e, 0, 0)

        def sum_case(v, label, out):
            return ("sc_tree_sum", f"tree_sum {label}",
                    lambda: S.tree_sum(v), lambda: S.tree_sum_plain(v), out,
                    operand_bytes(v) + 72 * v.shape[-1], 0, 0)

        def prefix_case(h, label, out):
            # the bytes of the live rows: this run's h
            hd = torch.tensor(h, device=dev)
            return ("sc_tree_sum", f"tree_sum_prefix h = {h} {label}",
                    lambda: S.tree_sum_prefix(px, py, hd),
                    lambda: S.tree_sum_prefix_plain(px, py, hd), out,
                    2 * h * 72 * P + 72 * 2 * P, 0, 0)

        cases = [
            mul_case(a, b, 1, f"{tuple(a.shape)} (the round emission's)",
                     caps["smul"].out),
            mul_case(ea, eb, 1, f"{tuple(ea.shape)} expanded one x "
                     f"{tuple(eb.shape)} column slice (power_sequence)",
                     caps["smul_bcast"].out),
            mul_case(a, b, 0, f"{tuple(a.shape)} (the same operands)", None),
            add_case(sa, sb, f"{tuple(sa.shape)} (stage 1's)",
                     caps["sadd"].out),
            add_case(ca, cb, f"{tuple(ca.shape)} + (9, 1) constant",
                     caps["sadd_const"].out),
            add_case(na, None, f"{tuple(na.shape)} column slice",
                     caps["sneg"].out),
            prefix_case(N // 2, f"of two {tuple(px.shape)} row blocks (the "
                        f"first round's cross terms)",
                        caps["tree_sum_prefix"].out)]
        cases += [prefix_case(N // 2 >> r, "(a later round's)", None)
                  for r in range(1, N.bit_length() - 1)]
        cases += [prefix_case(0, "(no row)", None)]
        cases += [sum_case(v, f"{shape} (a prover's)", out)
                  for shape, ((v,), out) in caps["tree_sum"].calls.items()]
        cases += [
            sum_case(tv, f"{tuple(tv.shape)} (the round's cross terms, "
                     f"every row live)", None),
            sum_case(odd, f"{tuple(odd.shape)} (odd rows, column slice)",
                     None),
            ("chacha_scalars", f"random_scalars of {k} draws",
             lambda: CH.random_scalars(key, k, dev),
             lambda: CH.random_scalars_plain(key, k, dev),
             caps["random_scalars"].out, 72 * k, k * WIDE_MADS,
             k * CHACHA_OPS),
            ("chacha_scalars", f"from_wide_bytes {tuple(raw.shape)} "
             f"transposed transcript bytes",
             lambda: S.from_wide_bytes(raw),
             lambda: S.from_wide_bytes_plain(raw),
             caps["from_wide_bytes"].out, raw.numel() + 72 * raw.shape[0],
             raw.shape[0] * WIDE_MADS, 0)]
        log(f"  K17-K20 on the {what}'s inputs:")
        recorded = set()
        for kernel, label, fn, plain, out, nbytes, mads, alu in cases:
            got = fn()
            want, plain_ms = time_once(plain)
            err = max_abs_err(got, want)
            if out is not None:
                err = max(err, max_abs_err(got, out))
            # the bound reads every byte at the memory rate, so the time
            # held to it is taken with the L2 holding other data;
            # the warm time (inputs left in L2, as on the path) is logged
            ms = cold_ms(fn, 20)
            warm_ms = queued_ms(fn, 20)
            b_ms, b_by = bound(nbytes, mads, imads, alu_ops=alu)
            log(f"    {kernel} {label}: max_abs_err {err} "
                f"({'ok' if err == 0 else 'MISMATCH'}); {ms:.4f} ms device "
                f"from memory, {warm_ms:.4f} warm in L2, {plain_ms:.2f} ms "
                f"plain, bound {b_ms:.4f} ms ({b_by}) on {smi}")
            if launches is not None and kernel not in recorded:
                recorded.add(kernel)
                record(kernel, sc_src, sc_replaces[kernel], err, ms, plain_ms,
                       nbytes, mads, launches, alu_ops=alu)
            elif err != 0:
                failures.append(f"{kernel} on the {what}'s {label}")
        before = dict(_cuda.LAUNCHES)
        empties = [(S.smul(a[:0], b[0]), S.smul_plain(a[:0], b[0])),
                   (S.mont_mul(eb[:, :0], cb), S.mont_mul_plain(eb[:, :0], cb)),
                   (S.sadd(sa[:, :, :0], cb), S.sadd_plain(sa[:, :, :0], cb)),
                   (S.sneg(na[:, :0]), S.sneg_plain(na[:, :0])),
                   (S.tree_sum(tv[:, :, :0]), S.tree_sum_plain(tv[:, :, :0])),
                   (S.tree_sum_prefix(px[:, :, :0], py[:, :, :0], ph),
                    S.tree_sum_prefix_plain(px[:, :, :0], py[:, :, :0], ph)),
                   (CH.random_scalars(key, 0, dev),
                    CH.random_scalars_plain(key, 0, dev)),
                   (S.from_wide_bytes(raw[:0]),
                    S.from_wide_bytes_plain(raw[:0]))]
        moved = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                 if v != before[k]}
        shapes = all(x.shape == y.shape for x, y in empties)
        log(f"    empty operands: shapes {'as' if shapes else 'NOT as'} the "
            f"plain versions', launches {moved or 'none'}")
        if not shapes or moved:
            failures.append(f"K17-K20 on empty operands ({what})")

    # -- 2. the prover's main path: the device-transcript route ---------------------
    t0 = time.time()
    prover = BatchProver(bp, pc, n, m, device=DEVICE)
    torch.cuda.synchronize()
    log(f"BatchProver(n={n}) tables: {time.time() - t0:.2f} s")
    rng = Rng(args.seed)
    values = [rng.r.randrange(1 << n) for _ in range(args.total)]
    values[:2] = [0, (1 << n) - 1]
    blinds = [Scalar.random(rng) for _ in values]
    labels = [b"chip smoke %d" % i for i in range(args.total)]
    half = args.total // 2 if args.total >= prover.FUSED_HALVES_FROM \
        else args.total

    def prove(seed, fused=True):
        """-> (proofs, commitments, transcript bytes after)."""
        prover.fused = fused
        ts = [Transcript(l) for l in labels]
        out = prover.prove_batch(values, blinds, ts, rng=Rng(seed))
        torch.cuda.synchronize()
        return out + ([t.strobe.buf.raw for t in ts],)

    def wire(out):
        return [p.to_bytes() for p in out[0]], out[1], out[2]

    # the warm-up keeps the main-path inputs of the kernel checks: one IPP
    # round's L stream and the S stream, one 8192-point compression, one
    # half's transcript states and challenges, and the inputs and outputs
    # of one half's device rest
    shapes1 = FS.ShapeCapture(FS.shape_specs(n, m, half))
    caps1 = {
        "compress": CaptureEach(PS.C, "compress", lambda pts: pts.shape[-1]),
        "keccak": Capture(TD, "f1600_state_bytes",
                          lambda st, *pad: st.shape[1] == half),
        "fold": Capture(PS.FO, "fold_pair",
                        lambda a, *r: a.shape == (n * m, 9, half)),
        "smul": Capture(PS.FO, "smul_pair",
                        lambda x, *r: x.shape == (n * m, 9, half)),
        "sinv": Capture(PS.S, "sinv", lambda x: x.shape[1] == half),
        "rest": Capture(PS, "prove_rest")}
    sc_caps1 = scalar_captures(PS, TD, n * m, half)
    t0 = time.time()
    try:
        prove(100)
    finally:
        for c in reversed(list(sc_caps1.values())):
            c.restore()
        for c in caps1.values():
            c.restore()
        shapes1.close()
    log(f"prove_batch warm-up ({args.total} proofs, device-transcript "
        f"route): {time.time() - t0:.2f} s")

    _cuda.reset_counts()
    t0 = time.time()
    fused_out = prove(101)
    times = [time.time() - t0]
    prove_launches = dict(_cuda.LAUNCHES)
    proofs, vcs = fused_out[0], fused_out[1]
    log(f"prove_batch launches (device-transcript route): {prove_launches}")
    for k in ("keccak_f1600", "sinv", "fold", "smul", "digits",
              "fixed_accumulate", "fixed_accumulate_vt", "fixed_reduce",
              "fixed_merge", "compress") + SCALAR_KERNELS:
        if prove_launches[k] == 0:
            failures.append(f"{k} not launched by the m=1 prover")
    halves = 2 if args.total >= prover.FUSED_HALVES_FROM \
        and args.total % 2 == 0 else 1
    check_k6_forms(prove_launches, n * m, halves, "m=1 prove")
    check_k8_k9_k13(prove_launches, n * m, halves, "m=1 prove", False)
    for r in range(args.prove_runs - 1):
        t0 = time.time()
        prove(102 + r)
        times.append(time.time() - t0)
    best = min(times)
    log(f"prove_batch {args.total} proofs of n={n} (device-transcript "
        f"route): best {best * 1e3:.1f} ms, median "
        f"{statistics.median(times) * 1e3:.1f} ms of {len(times)} -> "
        f"{args.total / best:.0f} proofs/s (runs "
        f"{[round(t * 1e3, 1) for t in times]} ms) on {smi}")
    wall, per, host_ms = instrumented(lambda: prove(110))
    dev_ms = sum(per.values())
    log(f"prove breakdown (one instrumented run): wall {wall:.1f} ms; "
        f"kernels {dev_ms:.2f} ms device ("
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(per.items()))
        + f"); host C++ transcripts {host_ms:.1f} ms; the rest "
        f"{wall - host_ms - dev_ms:.1f} ms (PyTorch mod-l vector code, "
        f"copies, Python) if nothing overlapped")

    rows = profiled(lambda: prove(111))
    if rows:
        busy = sum(r[0] for r in rows)
        log(f"prove device time (torch.profiler, one run): {busy:.1f} ms in "
            f"{sum(r[1] for r in rows)} kernel launches, busy "
            f"{busy / (best * 1e3):.1%} of the best call; largest: "
            + "; ".join(f"{ms:.1f} ms x{c} {k[:60]}" for ms, c, k in rows[:6]))
        check_prove_launches(rows, "m=1 prove")
    else:
        log("torch.profiler saw no device time: the prove's device busy "
            "share is not measured")

    def no_host_sync(cap, what):
        """Run a captured device rest again under set_sync_debug_mode
        ("error"): any op that waits for the card raises."""
        if cap.args is None:
            failures.append(f"{what}: inputs not captured")
            return
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = cap.real(*cap.args)
        except RuntimeError as e:
            failures.append(f"{what}: host sync")
            log(f"{what} under set_sync_debug_mode('error'): SYNC: {e}")
            return
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        same = same_outputs(out, cap.out)
        log(f"{what} (one half, {cap.args[5].shape[-1]} proofs) under "
            f"set_sync_debug_mode('error'): no host sync; "
            f"output {'equal to' if same else 'DIFFERENT from'} the warm-up's")
        if not same:
            failures.append(f"{what}: output differs under the sync check")

    no_host_sync(caps1["rest"], "prove_rest (m=1)")

    _cuda.reset_counts()
    t0 = time.time()
    stage_out = prove(101, fused=False)
    stage_ms = (time.time() - t0) * 1e3
    stage_launches = dict(_cuda.LAUNCHES)
    same = wire(stage_out) == wire(fused_out)
    log(f"prove_batch {args.total} proofs, per-stage route: {stage_ms:.1f} "
        f"ms (one run) on {smi}; launches {stage_launches}; proofs, "
        f"commitments and transcripts "
        f"{'byte-identical to' if same else 'DIFFERENT from'} the "
        f"device-transcript route's")
    if not same:
        failures.append("m=1 per-stage and device-transcript proofs differ")
    for k in ("fold", "smul", "digits") + SCALAR_KERNELS:
        if stage_launches[k] == 0:
            failures.append(f"{k} not launched by the m=1 per-stage prover")
    stage_halves = 2 if args.total >= prover.HALVES_FROM \
        and args.total % 2 == 0 else 1
    check_k6_forms(stage_launches, n * m, stage_halves, "m=1 per-stage prove")
    check_k8_k9_k13(stage_launches, n * m, stage_halves,
                    "m=1 per-stage prove", True)

    # -- 3. the proofs are right -------------------------------------------------------
    bv = BatchVerifier(bp, pc, n=n, m=m, device=DEVICE)
    vcss = [[v] for v in vcs]

    def verify(ps, vs, seed):
        bv.verify_batch(ps, vs, [Transcript(l) for l in labels], rng=Rng(seed))
        torch.cuda.synchronize()

    k3_caps = CaptureEach(M, "accumulate")          # K3, every sub-batch
    _cuda.reset_counts()
    t0 = time.time()
    try:
        verify(proofs, vcss, 11)
    finally:
        k3_caps.restore()
    verify_launches = dict(_cuda.LAUNCHES)
    log(f"verify_batch({len(proofs)} card-proved proofs, n={n}): accepted "
        f"(first run {time.time() - t0:.3f} s); launches {verify_launches}")

    sample = random.Random(args.seed).sample(range(args.total),
                                             min(64, args.total))
    for i in sample:
        proofs[i].verify_single(bp, pc, Transcript(labels[i]), vcs[i], n)
    log(f"host verify_single: {len(sample)} sampled proofs accepted")

    last = len(proofs) - 1
    b = bytearray(proofs[last].to_bytes())
    b[128] ^= 1                                       # low byte of t_x
    flipped = RangeProof.from_bytes(bytes(b))
    for name, ps, vs in (
            ("flipped byte", proofs[:last] + [flipped], vcss),
            ("swapped commitments", proofs,
             vcss[:last - 1] + [vcss[last], vcss[last - 1]])):
        try:
            verify(ps, vs, 12)
        except ProofError:
            log(f"{name}: rejected")
        else:
            failures.append(f"{name} accepted")
            log(f"{name}: ACCEPTED")

    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "golden_vectors.json")
    with open(gold) as fh:
        data = json.load(fh)
    gproof = RangeProof.from_bytes(bytes.fromhex(data["proofs"][3][0]))
    gbv = BatchVerifier(BulletproofGens(64, 8), pc, n=64, m=1, device=DEVICE)
    gbv.verify_batch([gproof], [[bytes.fromhex(data["value_commitments"][0])]],
                     [Transcript(data["transcript_label"].encode())],
                     rng=Rng(13))
    log("golden vector n=64, m=1: accepted")

    small = []
    for device in (DEVICE, "cpu"):
        ts = [Transcript(b"small %d" % i) for i in range(4)]
        ps, vs = BatchProver(bp, pc, 8, device=device).prove_batch(
            [0, 1, 200, 255], blinds[:4], ts, rng=Rng(14))
        small.append(([p.to_bytes() for p in ps], vs,
                      [t.strobe.buf.raw for t in ts]))
    same = small[0] == small[1]
    log(f"4 proofs at n=8, card vs device='cpu': "
        f"{'byte-identical' if same else 'DIFFERENT'}")
    if not same:
        failures.append("card and cpu proofs differ")

    def record(name, source, replaces, err, ms, plain_ms, nbytes, mads,
               launches, floor_ms=None, **ops):
        """One kernel's entry of the JSON line; `floor_ms`, where given, is
        its latency floor (its dependent chain at the least latency,
        counted from the source), logged beside the bound and kept out of
        the line."""
        b_ms, b_by = bound(nbytes, mads, imads, **ops)
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        floor = "" if floor_ms is None \
            else f", latency floor {floor_ms:.4f} ms"
        kernels.append(entry)
        status = "ok" if err == 0 else "MISMATCH"
        log(f"  {name}: max_abs_err {err} ({status}); {ms:.4f} ms kernel, "
            f"{plain_ms:.2f} ms plain, bound {b_ms:.4f} ms ({b_by}){floor}; "
            f"{launches[name]} launches on the main path")
        if err != 0:
            failures.append(name)
        if launches[name] == 0:
            failures.append(f"{name} not launched on the main path")
        if ms < b_ms:
            failures.append(f"{name}: {ms:.4f} ms under its bound "
                            f"{b_ms:.4f} ms")

    madd = field_mads(lambda: C.madd(
        C.to_coords(C.identity(1, "cpu")),
        tuple(torch.zeros((10, 1), dtype=torch.int64) for _ in range(3))))
    add = field_mads(lambda: C.add(*(C.to_coords(C.identity(1, "cpu")),) * 2))

    def k12_against_k6(niels, dig, what):
        """K12 against its plain version and beside K6 on one stream ->
        (max_abs_err, ms, plain ms, bytes, multiply-adds)."""
        slab2 = FM.accumulate2(niels, dig)
        plain2, plain_ms = time_once(lambda: FM.accumulate2_plain(niels, dig))
        err = max_abs_err(slab2, plain2)
        ms2 = time_cuda(lambda: FM.accumulate2(niels, dig), 3)
        ms6 = time_cuda(lambda: FM.accumulate(niels, dig), 3)
        same = torch.equal(C.compress(FM.reduce(slab2)),
                           C.compress(FM.reduce(FM.accumulate(niels, dig))))
        rows, q = dig.shape
        k2, k6 = slab2.shape[0], FM.pick_splits(rows, q)
        log(f"  fixed_accumulate2 on {what} ({rows} rows x {q} lanes): "
            f"max_abs_err {err}; {ms2:.4f} ms (split {k2}) beside K6 "
            f"{ms6:.4f} ms (split {k6}) on {smi}; plain {plain_ms:.2f} ms; "
            f"points {'equal to' if same else 'DIFFERENT from'} K6's")
        if err != 0 or not same:
            failures.append(f"fixed_accumulate2 on {what}")
        if what in shape_ms:
            log(f"    K6's direct form there: {shape_ms[what]:.4f} ms")
        return (err, ms2, plain_ms,
                niels.numel() * 4 + dig.numel() + slab2.numel() * 4,
                rows * q * madd + k2 * q * FM.NUM_BUCKETS * add)

    shape_ms = {}           # shape -> the direct K6's ms, for k12_against_k6

    def fixed_shape_checks(what, niels, dig, kw):
        """At one main-path shape (`niels`: the MSM's Niels rows; `kw`: the
        call's keywords): each K6 form that serves it (the one-hot form
        everywhere; on public rows the direct form, over the multiples
        table and the round's row map) against its plain version (exact)
        and timed, the two forms' points against each other, and K7 on the
        slab that serves the rows -> {kernel: (max_abs_err, ms, plain ms,
        bytes, multiply-adds)}."""
        public = not kw.get("consttime", True)
        rows, q = dig.shape
        nonzero = int((dig != 0).sum())
        mads = nonzero * madd
        forms = [("fixed_accumulate", lambda: FM.accumulate(niels, dig),
                  lambda: FM.accumulate_plain(niels, dig))]
        if public:
            mult, sel = kw["mult"], kw["sel"]
            forms.append((
                "fixed_accumulate_vt",
                lambda: FM.accumulate_direct(mult, dig, sel),
                lambda: FM.accumulate_direct_plain(mult, dig, sel)))
        out, slabs = {}, {}
        for name, kernel, plain_fn in forms:
            plain, plain_ms = time_once(plain_fn)
            K = plain.shape[0]
            slabs[name] = kernel()
            err = max_abs_err(slabs[name], plain)
            ms = time_cuda(kernel, 3)
            nbytes = niels.numel() * 4 + dig.numel() + plain.numel() * 4
            b_ms, b_by = bound(nbytes, mads, imads)
            floor = "" if name != "fixed_accumulate" else (
                f", shared-memory floor "
                f"{rows * q * ONE_HOT_SMEM_BYTES / smem_rate * 1e3:.4f} ms")
            log(f"  {what}: {rows} rows x {q} lanes, "
                f"{nonzero / (rows * q):.2%} non-zero digits; {name} split "
                f"{K} ({K * q} threads): max_abs_err {err}; {ms:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}){floor}, plain "
                f"{plain_ms:.2f} ms on {smi}")
            if err != 0:
                failures.append(f"{name} on {what}")
            out[name] = (err, ms, plain_ms, nbytes, mads)
        if public:
            shape_ms[what] = out["fixed_accumulate_vt"][1]
            same = torch.equal(
                C.compress(FM.reduce(slabs["fixed_accumulate"])),
                C.compress(FM.reduce(slabs["fixed_accumulate_vt"])))
            log(f"    the two K6 forms' points {'equal' if same else 'DIFFER'}")
            if not same:
                failures.append(f"K6's two forms differ on {what}")
        slab = slabs["fixed_accumulate_vt" if public else "fixed_accumulate"]
        K, nb = slab.shape[:2]
        pts = FM.reduce(slab)
        rplain, rplain_ms = time_once(lambda: FM.reduce_plain(slab))
        err = max_abs_err(pts, rplain)
        ms = time_cuda(lambda: FM.reduce(slab), 20)
        nbytes = slab.numel() * 4 + pts.numel() * 4
        mads = q * ((K - 1) * nb + 2 * (nb - 1)) * add
        b_ms, b_by = bound(nbytes, mads, imads)
        name = "fixed_merge" if nb == 1 else "fixed_reduce"
        log(f"    {name} ({FM.red_groups(K)} chunk groups): max_abs_err "
            f"{err}; {ms:.4f} ms, plain {rplain_ms:.2f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        if err != 0:
            failures.append(f"{name} on {what}")
        out[name] = (err, ms, rplain_ms, nbytes, mads)
        return out

    # -- 4. verifier kernels against their plain versions (exact: integer
    #       arithmetic repeated step for step, so the tolerance is 0) ----------------
    sub = min(bv.sub_batch, len(proofs))
    log(f"verifier kernel phases (sub-batch of {sub} proofs):")
    blob, vblob, dyn_raw = bv._serialize(proofs[:sub], vcss[:sub], lg, n_dyn,
                                         32 * (9 + 2 * lg))
    blk_np, pair_np = bv.replay(blob, vblob, [Transcript(l) for l in labels[:sub]],
                                Rng(args.seed + 1))
    raw = torch.from_numpy(dyn_raw.copy())
    # invalid encodings among them: non-canonical (p + 1), negative (odd),
    # random bytes (about half of them off the curve)
    bad = raw.clone()
    p_plus_1 = ((1 << 255) - 18).to_bytes(32, "little")
    bad[0] = torch.tensor(list(p_plus_1), dtype=torch.uint8)
    bad[1, 0] |= 1
    g = torch.Generator().manual_seed(args.seed)
    bad[2:66] = torch.randint(0, 256, (64, 32), generator=g, dtype=torch.uint8)
    bad[2:66, 31] &= 127
    raw_dev = bad.to(dev)
    N = raw_dev.shape[0]
    got = C.decompress(raw_dev)
    want = C.decompress_plain(raw_dev)
    torch.cuda.synchronize()
    if bool(got[0][0]) or bool(got[0][1]) or not bool(got[0][66:].all()):
        failures.append("decompress validity")
    record("decompress", "bulletproofs_tpu_torch/csrc/decompress.cu",
           "bulletproofs_tpu/ops/msm_pallas.py:242",
           max_abs_err((got[0], got[1]), (want[0], want[1])),
           time_cuda(lambda: C.decompress(raw_dev), 20),
           time_cuda(lambda: C.decompress_plain(raw_dev), 1),
           N * (32 + 1 + 160), N * decode_mads(), verify_launches)
    log(f"    ({N} encodings: {C.decompress_waves(N)} wave(s) of "
        f"resident blocks)")

    blk = torch.from_numpy(blk_np.copy()).to(dev)
    got = V.emit(n, m, blk)
    want = time_once(lambda: V.emit_plain(n, m, blk))[0]    # no launch
    record("emit", "bulletproofs_tpu_torch/csrc/emit.cu",
           "bulletproofs_tpu/ops/verify_pallas.py:190",
           max_abs_err(got, want), time_cuda(lambda: V.emit(n, m, blk), 20),
           time_cuda(lambda: V.emit_plain(n, m, blk), 1),
           blk.numel() + n * 36 + got[0].numel() + got[1].numel() * 4,
           FK.emit_mont_muls(n, m, sub) * FK.SC_MUL_MADS,
           verify_launches, floor_ms=FK.emit_latency_floor_ms(n, m, mhz))
    log(f"    ({FK.emit_mont_muls(n, m, sub)} Montgomery "
        f"products for {sub} proofs under the cheapest schedule; "
        f"{V.warps_per_sm()} warps of K2 resident an SM)")

    valid, pts = C.decompress(raw.to(dev))
    gh = V.tree_sum(got[1])
    pair_sc = S.sreduce(S.from_bytes32(torch.from_numpy(pair_np.copy()).to(dev)))
    static_sc = torch.cat([pair_sc, gh[0].T, gh[1].T], dim=-1)
    digits = torch.cat([S.signed_digits(static_sc), got[0]], dim=-1).contiguous()
    # the fused tail passes the static Niels points and the decoded points;
    # K3's binning makes the decoded points' Niels rows (one field product
    # a point); the plain versions take the whole in Niels form
    pre = bv.static_niels
    niels = torch.cat([pre, C.to_niels(pts)], dim=-1).contiguous()
    NP = niels.shape[-1]
    lanes = M.pick_lanes(NP)
    nonzero = int((digits != 0).sum())
    to_niels = field_mads(lambda: C.to_niels(C.identity(1, "cpu")))
    # K3 on each sub-batch of the verify run: its binning (two launches)
    # and the whole accumulate call against their plain versions
    log(f"  K3 on the {len(k3_caps.calls)} sub-batches of the verify run:")
    for i, ((kn, kd, kp), kslab) in enumerate(k3_caps.calls.values()):
        berr = max_abs_err(M.bin_niels(kn, kp, kd),
                           M.bin_niels_plain(kn, kp, kd))
        err = max_abs_err(kslab, M.accumulate_plain(
            torch.cat([kn, C.to_niels(kp)], dim=-1), kd))
        log(f"    sub-batch {i} ({kn.shape[-1]} Niels points and "
            f"{kp.shape[-1]} decoded points): msm_bin_niels max_abs_err "
            f"{berr}, msm_accumulate max_abs_err {err}")
        if berr != 0 or err != 0:
            failures.append(f"K3 on verify sub-batch {i}")
    if len(k3_caps.calls) != verify_launches["msm_accumulate"]:
        failures.append("K3's sub-batches not captured")
    binned = M.bin_niels(pre, pts, digits)
    record("msm_bin_niels", "bulletproofs_tpu_torch/csrc/msm.cu",
           "bulletproofs_tpu/ops/msm_pallas.py:58",
           max_abs_err(binned, M.bin_niels_plain(pre, pts, digits)),
           cold_ms(lambda: M.bin_niels(pre, pts, digits), 20),
           time_cuda(lambda: M.bin_niels_plain(pre, pts, digits), 1),
           bin_niels_bytes(pre, pts, digits, binned),
           pts.shape[-1] * to_niels, verify_launches)
    log(f"    (msm_bin_niels: device time from memory, two launches a call; "
        f"warm in L2 {queued_ms(lambda: M.bin_niels(pre, pts, digits), 20):.4f}"
        f" ms)")
    # msm_accumulate's time is the whole accumulate call, its binning
    # launches included
    slab = M.accumulate(pre, digits, pts)
    record("msm_accumulate", "bulletproofs_tpu_torch/csrc/msm.cu",
           "bulletproofs_tpu/ops/msm_pallas.py:58",
           max_abs_err(slab, M.accumulate_plain(niels, digits)),
           time_cuda(lambda: M.accumulate(pre, digits, pts), 20),
           time_cuda(lambda: M.accumulate_plain(niels, digits), 1),
           NP * 120 + digits.numel() + slab.numel() * 4,
           nonzero * madd + pts.shape[-1] * to_niels, verify_launches)
    sums = M.reduce(slab)
    record("msm_reduce", "bulletproofs_tpu_torch/csrc/msm.cu",
           "bulletproofs_tpu/ops/msm_pallas.py:178",
           max_abs_err(sums, M.reduce_plain(slab)),
           time_cuda(lambda: M.reduce(slab), 20),
           time_cuda(lambda: M.reduce_plain(slab), 1),
           slab.numel() * 4 + sums.numel() * 4,
           64 * 8 * (lanes - 1) * add, verify_launches,
           floor_ms=FK.reduce_latency_floor_ms(lanes, mhz))
    log(f"    ({lanes} lanes; {M.warps_per_sm()['msm_reduce']} warps of K4a "
        f"resident an SM)")
    out = M.horner(sums)
    record("msm_horner", "bulletproofs_tpu_torch/csrc/msm.cu",
           "bulletproofs_tpu/ops/msm_pallas.py:214",
           max_abs_err(out, M.horner_plain(sums)),
           time_cuda(lambda: M.horner(sums), 20),
           time_cuda(lambda: M.horner_plain(sums), 1),
           sums.numel() * 4 + 160 + 4, horner_mads(), verify_launches)
    if not bool(out[1].all()) or not bool(valid.all()):
        failures.append("sub-batch MSM is not the identity")

    # the MSM against the host curve library on a small input
    k = 300
    rsc = [rng.r.randrange(ELL) for _ in range(k)]
    sc_dig = S.signed_digits(torch.as_tensor(sc_ints_to_limbs(rsc)).to(dev))
    pt_dev, _ = M.msm_niels(niels[:, :, :k].contiguous(), sc_dig.contiguous())
    host_pts = ([pc.B_blinding, pc.B] + bp.G(n, m) + bp.H(n, m)
                + C.lanes_to_points(pts[:, :, : k - 130].cpu().numpy()))
    ref = multiscalar_mul([Scalar(v) for v in rsc], host_pts)
    got_pt = C.lanes_to_points(pt_dev.cpu().numpy()[:, :, None])[0]
    ref_ok = got_pt.compress() == ref.compress()
    log(f"MSM of {k} points vs host multiscalar_mul: "
        f"{'equal' if ref_ok else 'DIFFERENT'}")
    if not ref_ok:
        failures.append("msm vs host")

    # -- 5. prover kernels against their plain versions, on main-path inputs ---------
    k5_1 = caps1.pop("compress").calls
    if any(c.args is None for c in caps1.values()) \
            or min(2 * half, 8192) not in k5_1 or len(shapes1.got) != 2:
        failures.append("prover kernel inputs not captured")
    else:
        (cpts,), _ = k5_1[min(2 * half, 8192)]
        l_name, s_name = (name for name, _, _ in FS.shape_specs(n, m, half))
        rniels, rdig, rkw = shapes1.got[l_name]
        if rkw.get("consttime", True):
            failures.append("the m=1 IPP L stream was sent to the one-hot K6")
        log(f"prover kernel phases (compress of {cpts.shape[-1]} points; IPP "
            f"L stream of {rdig.shape[0]} rows x {rdig.shape[1]} lanes):")
        compress_checks(k5_1, "m=1 prove", imads, smi, failures)
        got = C.compress(cpts)
        record("compress", "bulletproofs_tpu_torch/csrc/compress.cu",
               "bulletproofs_tpu/ops/msm_pallas.py:251",
               max_abs_err(got, C.compress_plain(cpts)),
               time_cuda(lambda: C.compress(cpts), 20),
               time_cuda(lambda: C.compress_plain(cpts), 1),
               cpts.numel() * 4 + got.numel(),
               cpts.shape[-1] * encode_mads(), prove_launches)
        log(f"  fixed-base MSM at the m=1 shapes ({madd} multiplications per "
            f"mixed addition, {add} per addition):")
        at_l = fixed_shape_checks(l_name, rniels, rdig, rkw)
        sniels1, sdig1, skw1 = shapes1.got[s_name]
        if not skw1.get("consttime", True):
            failures.append("the m=1 S stream was sent to the direct K6")
        at_s = fixed_shape_checks(s_name, sniels1, sdig1, skw1)
        src, tpu = ("bulletproofs_tpu_torch/csrc/fixed_msm.cu",
                    "bulletproofs_tpu/ops/fixed_msm.py:")
        record("fixed_accumulate", src, tpu + "274",
               *at_s["fixed_accumulate"], prove_launches)
        record("fixed_accumulate_vt", src, tpu + "274",
               *at_l["fixed_accumulate_vt"], prove_launches)
        record("fixed_reduce", src, tpu + "346", *at_s["fixed_reduce"],
               prove_launches)
        record("fixed_merge", src, tpu + "346", *at_l["fixed_merge"],
               prove_launches)
        k12_against_k6(rniels, rdig, l_name)

        kst = caps1["keccak"].args[0]
        record("keccak_f1600", "bulletproofs_tpu_torch/csrc/keccak.cu",
               "bulletproofs_tpu/ops/keccak_device.py:68",
               *keccak_check(caps1["keccak"], "m=1 prove"),
               2 * kst.numel() + 200, 0, prove_launches)
        fold_check(caps1["fold"], "m=1 prove")
        smul_check(caps1["smul"], "m=1 prove")
        (sx,) = caps1["sinv"].args
        got = S.sinv(sx)
        plain, plain_ms = time_once(lambda: S.sinv_plain(sx))
        record("sinv", "bulletproofs_tpu_torch/csrc/fold.cu",
               "bulletproofs_tpu/ops/vec_scalar.py:207",
               max_abs_err(got, plain), time_cuda(lambda: S.sinv(sx), 20),
               plain_ms, 2 * 8 * sx.numel(), FK.SINV_OPS * sx.shape[1],
               prove_launches)
        log(f"  (keccak_f1600 on {kst.shape[1]} states and sinv on "
            f"{sx.shape[1]} challenges ({FK.SINV_DIVSTEPS} divsteps and "
            f"{FK.SINV_OPS} integer operations each; latency floor "
            f"{FK.sinv_latency_floor_ms(mhz):.4f} ms, {FK.SINV_CHAIN} "
            f"dependent instructions): no Pallas counterpart, the JAX "
            f"package runs both in XLA)")
        scalar_checks(sc_caps1, "m=1 prove", prove_launches)

    # -- 6. the verifier's timing ------------------------------------------------------
    # each call recorded (CallRecorder), the stages of verify_batch by the
    # host clock: _serialize, each sub-batch's C++ replay, each _upload, the
    # launches of K1 and of the fused tail, and the final flag sync (from
    # the last sub-batch's end to verify_batch's return); "outside" is the
    # caller's share of the wall (its transcripts, the synchronize)
    log(f"heap before the timed verify calls: {VC.heap_census()}")
    verify(proofs, vcss, 14)                                      # warm-up
    times = [got["wall_ms"] / 1e3 for got in VC.record_verify_calls(
        bv, lambda r: verify(proofs, vcss, 15 + r), args.runs, log)]
    log(f"heap after them: {VC.heap_census()}")
    best = min(times)
    med = statistics.median(times)
    log(f"verify_batch {len(proofs)} proofs: best {best * 1e3:.1f} ms, median "
        f"{med * 1e3:.1f} ms of {args.runs} -> {len(proofs) / best:.0f} "
        f"proofs/s (runs {[round(t * 1e3, 1) for t in times]} ms; slowest "
        f"{max(times) / med:.2f}x the median) on {smi}")

    # where the verifier's time goes: the host stages alone, beside the kernels
    plen = 32 * (9 + 2 * lg)
    t0 = time.time()
    blob, vblob, _ = bv._serialize(proofs, vcss, lg, n_dyn, plen)
    ser_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    for lo in range(0, len(proofs), bv.sub_batch):
        hi = min(lo + bv.sub_batch, len(proofs))
        bv.replay(blob[lo * plen: hi * plen], vblob[lo * 32: hi * 32],
                  [Transcript(l) for l in labels[lo:hi]], Rng(16))
    replay_ms = (time.time() - t0) * 1e3
    kern_ms = sum(k["ms"] * k["launches"] for k in kernels
                  if k["name"] in ("decompress", "emit", "msm_accumulate",
                                   "msm_reduce", "msm_horner"))
    log(f"breakdown per verify_batch: serialize {ser_ms:.1f} ms, C++ replay "
        f"{replay_ms:.1f} ms (host); kernels {kern_ms:.2f} ms (device, sum "
        f"of kernel time x launches); the rest is PyTorch glue and copies")

    # -- 7. the aggregated path: m = 16, n = 64 ---------------------------------------
    m16 = 16
    bp16 = BulletproofGens(n, m16)
    t0 = time.time()
    prover16 = BatchProver(bp16, pc, n, m16, device=DEVICE)
    torch.cuda.synchronize()
    log(f"BatchProver(n={n}, m={m16}) tables: {time.time() - t0:.2f} s")
    agg = args.agg_total
    vals16 = [[rng.r.randrange(1 << n) for _ in range(m16)] for _ in range(agg)]
    vals16[0][:2] = [0, (1 << n) - 1]
    blinds16 = [[Scalar.random(rng) for _ in range(m16)] for _ in range(agg)]
    labels16 = [b"chip smoke agg %d" % i for i in range(agg)]

    def prove16(seed, fused=True):
        """-> (proofs, commitments, transcript bytes after)."""
        prover16.fused = fused
        ts = [Transcript(l) for l in labels16]
        out = prover16.prove_batch(vals16, blinds16, ts, rng=Rng(seed))
        torch.cuda.synchronize()
        return out + ([t.strobe.buf.raw for t in ts],)

    # the warm-up (device-transcript route) keeps the
    # aggregated path's kernel inputs: the first fold and the first gw
    # update (all N = 1024 rows: the rest's folds are full width), the S
    # coefficients' digits (2N + 1 = 2049 rows), the S commitment's stream
    # (131,136 rows) and one IPP round's L stream (65,600 rows), and the
    # inputs and outputs of one device rest
    N16 = n * m16
    lanes16 = agg // 2 if agg >= prover16.FUSED_HALVES_FROM and agg % 2 == 0 \
        else agg
    shapes16 = FS.ShapeCapture(FS.shape_specs(n, m16, lanes16))
    pcaps = [Capture(PS.FO, "fold_pair", lambda a, *r: a.shape[0] == N16),
             Capture(PS.FO, "smul_pair", lambda x, *a: x.shape[0] == N16),
             Capture(PS.FO, "digits_lanes",
                     lambda x: x.dim() == 3 and x.shape[0] == 2 * N16 + 1),
             Capture(PS, "prove_rest"),
             Capture(PS.S, "sinv"),
             Capture(TD, "f1600_state_bytes",
                     lambda st, *pad: st.shape[1] == lanes16)]
    k5_16 = CaptureEach(PS.C, "compress", lambda pts: pts.shape[-1])
    sc_caps16 = scalar_captures(PS, TD, N16, lanes16)
    t0 = time.time()
    try:
        prove16(200)
    finally:
        for c in reversed(list(sc_caps16.values())):
            c.restore()
        k5_16.restore()
        for c in reversed(pcaps):
            c.restore()
        shapes16.close()
    log(f"prove_batch m={m16} warm-up ({agg} proofs, device-transcript "
        f"route): {time.time() - t0:.2f} s")
    _cuda.reset_counts()
    t0 = time.time()
    fused16 = prove16(201)
    times = [time.time() - t0]
    prove16_launches = dict(_cuda.LAUNCHES)
    proofs16, vcs16 = fused16[0], fused16[1]
    log(f"prove_batch m={m16} launches (device-transcript route): "
        f"{prove16_launches}")
    for r in range(args.agg_runs - 1):
        t0 = time.time()
        prove16(202 + r)
        times.append(time.time() - t0)
    best = min(times)
    log(f"prove_batch {agg} proofs of n={n}, m={m16} (device-transcript "
        f"route): best {best * 1e3:.1f} ms, median "
        f"{statistics.median(times) * 1e3:.1f} ms of {len(times)} -> "
        f"{agg / best:.1f} proofs/s, {best * 1e3 / agg:.3f} ms/proof (runs "
        f"{[round(t * 1e3, 1) for t in times]} ms) on {smi}")
    wall, per, host_ms = instrumented(lambda: prove16(210))
    dev_ms = sum(per.values())
    log(f"prove m={m16} breakdown (one instrumented run): wall {wall:.1f} ms; "
        f"kernels {dev_ms:.2f} ms device ("
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(per.items()))
        + f"); host C++ transcripts {host_ms:.1f} ms; the rest "
        f"{wall - host_ms - dev_ms:.1f} ms if nothing overlapped")
    rows = profiled(lambda: prove16(211))
    busy16 = sum(r[0] for r in rows)
    if rows:
        busy = busy16
        log(f"prove m={m16} device time (torch.profiler, one run): {busy:.1f} "
            f"ms in {sum(r[1] for r in rows)} kernel launches, busy "
            f"{busy / (best * 1e3):.1%} of the best call; largest: "
            + "; ".join(f"{ms:.1f} ms x{c} {k[:60]}" for ms, c, k in rows[:6]))
        check_prove_launches(rows, f"m={m16} prove")
    for k in ("keccak_f1600", "sinv", "fold", "smul", "digits",
              "fixed_accumulate", "fixed_accumulate_vt",
              "compress") + SCALAR_KERNELS:
        if prove16_launches[k] == 0:
            failures.append(f"{k} not launched by the m={m16} prover")
    halves16 = 2 if lanes16 != agg else 1
    check_k6_forms(prove16_launches, N16, halves16, f"m={m16} prove")
    check_k8_k9_k13(prove16_launches, N16, halves16, f"m={m16} prove",
                    False)
    no_host_sync(pcaps[3], f"prove_rest (m={m16})")

    _cuda.reset_counts()
    t0 = time.time()
    stage16 = prove16(201, fused=False)
    stage16_launches = dict(_cuda.LAUNCHES)
    log(f"prove_batch m={m16}, per-stage route: "
        f"{(time.time() - t0) * 1e3:.1f} ms (one run) on {smi}; launches "
        f"{stage16_launches}")
    for k in ("fold", "smul", "digits", "fixed_accumulate",
              "compress") + SCALAR_KERNELS:
        if stage16_launches[k] == 0:
            failures.append(f"{k} not launched by the m={m16} per-stage "
                            f"prover")
    check_k6_forms(stage16_launches, N16,
                   2 if agg >= prover16.HALVES_FROM and agg % 2 == 0 else 1,
                   f"m={m16} per-stage prove")
    FM._ILP2 = True
    try:
        _cuda.reset_counts()
        t0 = time.time()
        ilp16 = prove16(201)
        times = [time.time() - t0]
        ilp2_launches = dict(_cuda.LAUNCHES)
        for r in range(args.agg_runs - 1):
            t0 = time.time()
            prove16(202 + r)
            times.append(time.time() - t0)
        ilp_rows = profiled(lambda: prove16(212))
    finally:
        FM._ILP2 = False
    log(f"prove_batch m={m16} with _ILP2 (K12 in place of K6): best "
        f"{min(times) * 1e3:.1f} ms of {len(times)} (runs "
        f"{[round(t * 1e3, 1) for t in times]} ms) on {smi}; launches "
        f"{ilp2_launches}")
    if ilp_rows and busy16:
        ilp_busy = sum(r[0] for r in ilp_rows)
        log(f"  _ILP2 prove device time (torch.profiler, one run): "
            f"{ilp_busy:.1f} ms, {ilp_busy / busy16 - 1:+.1%} against the "
            f"default route's {busy16:.1f} ms; largest: "
            + "; ".join(f"{ms:.1f} ms x{c} {k[:60]}"
                        for ms, c, k in ilp_rows[:3]))
    rounds16 = N16.bit_length() - 1
    if ilp2_launches["fixed_accumulate2"] != (4 + 2 * rounds16) * halves16 \
            or ilp2_launches["fixed_accumulate"] \
            or ilp2_launches["fixed_accumulate_vt"]:
        failures.append(f"_ILP2 did not route every m={m16} K6 row through "
                        f"K12")
    same = wire(stage16) == wire(fused16) == wire(ilp16)
    log(f"m={m16} proofs, commitments and transcripts: per-stage, "
        f"device-transcript and device-transcript with K12 "
        f"{'byte-identical' if same else 'DIFFER'}")
    if not same:
        failures.append(f"m={m16} routes give different proofs")

    bv16 = BatchVerifier(bp16, pc, n=n, m=m16, device=DEVICE)
    lg16, _, n_dyn16 = V.shape(n, m16)
    chunk_pts = min(settings.verify_chunk_pts // n_dyn16, agg) * n_dyn16
    final_pts = 2 + 2 * N16 + -(-agg * n_dyn16 // chunk_pts)

    def verify16(ps, vs, seed):
        bv16.verify_batch(ps, vs, [Transcript(l) for l in labels16],
                          rng=Rng(seed))
        torch.cuda.synchronize()

    vcaps = [Capture(M, "accumulate_z",
                    lambda pts, d: pts.shape[-1] == chunk_pts),
            Capture(M, "accumulate_z",
                    lambda pts, d: pts.shape[-1] == final_pts)]
    _cuda.reset_counts()
    t0 = time.time()
    try:
        verify16(proofs16, vcs16, 21)
    finally:
        for c in reversed(vcaps):
            c.restore()
    verify16_launches = dict(_cuda.LAUNCHES)
    log(f"verify_batch({agg} card-proved m={m16} proofs, chunked route): "
        f"accepted (first run {time.time() - t0:.3f} s); launches "
        f"{verify16_launches}")
    for k in ("decompress", "msm_bin", "msm_accumulate_z", "msm_reduce",
              "msm_horner", "digits"):
        if verify16_launches[k] == 0:
            failures.append(f"{k} not launched by the m={m16} verifier")
    if verify16_launches["emit"] or verify16_launches["msm_accumulate"]:
        failures.append(f"the m={m16} verifier took the fused route")
    times = []
    for r in range(args.agg_runs):
        t0 = time.time()
        verify16(proofs16, vcs16, 22 + r)
        times.append(time.time() - t0)
    best = min(times)
    log(f"verify_batch {agg} proofs of n={n}, m={m16} (chunked): best "
        f"{best * 1e3:.1f} ms of {len(times)} -> {agg / best:.0f} proofs/s "
        f"(runs {[round(t * 1e3, 1) for t in times]} ms) on {smi}")

    old_max = settings.fused_verify_max_nm
    settings.fused_verify_max_nm = N16
    try:
        _cuda.reset_counts()
        verify16(proofs16, vcs16, 30)
        if _cuda.LAUNCHES["emit"] == 0:
            failures.append("the fused cross-check did not take the fused route")
    finally:
        settings.fused_verify_max_nm = old_max
    log(f"the same {agg} m={m16} proofs on the fused route: accepted")
    last = agg - 1
    b = bytearray(proofs16[last].to_bytes())
    b[128] ^= 1                                       # low byte of t_x
    swapped = list(vcs16[last])
    swapped[0], swapped[1] = swapped[1], swapped[0]
    for name, ps, vs in (
            (f"m={m16} flipped byte", proofs16[:last]
             + [RangeProof.from_bytes(bytes(b))], vcs16),
            (f"m={m16} swapped commitments", proofs16,
             vcs16[:last] + [swapped])):
        try:
            verify16(ps, vs, 31)
        except ProofError:
            log(f"{name}: rejected")
        else:
            failures.append(f"{name} accepted")
            log(f"{name}: ACCEPTED")
    for i in (0, last):
        proofs16[i].verify_multiple(bp16, pc, Transcript(labels16[i]),
                                    vcs16[i], n)
    log(f"host verify_multiple: proofs 0 and {last} accepted")

    small = []
    bp2 = BulletproofGens(8, 2)
    for device in (DEVICE, "cpu"):
        ts = [Transcript(b"small agg %d" % i) for i in range(4)]
        ps, vs = BatchProver(bp2, pc, 8, 2, device=device).prove_batch(
            [[0, 255], [1, 2], [200, 3], [255, 0]],
            [blinds[i: i + 2] for i in range(4)], ts, rng=Rng(32))
        small.append(([p.to_bytes() for p in ps], vs,
                      [t.strobe.buf.raw for t in ts]))
    same = small[0] == small[1]
    log(f"4 proofs at n=8, m=2, card vs device='cpu': "
        f"{'byte-identical' if same else 'DIFFERENT'}")
    if not same:
        failures.append("card and cpu m=2 proofs differ")

    # -- 8. K8-K11 against their plain versions, on the aggregated path's inputs --------
    if any(c.args is None for c in pcaps + vcaps) or len(shapes16.got) != 2:
        failures.append("aggregated-path kernel inputs not captured")
    else:
        P = pcaps[0].args[0].shape[-1]
        log(f"aggregated-path kernel phases (fold {N16} x {P}; gw / hw "
            f"update {pcaps[1].args[0].shape[0]} x {P}; S digits "
            f"{pcaps[2].args[0].shape[0]} x {P}; K11 on {chunk_pts} and "
            f"{final_pts} points):")
        record("fold", "bulletproofs_tpu_torch/csrc/fold.cu",
               "bulletproofs_tpu/ops/fold_pallas.py:42",
               *fold_check(pcaps[0], f"m={m16} prove"), prove16_launches)
        keccak_check(pcaps[5], f"m={m16} prove")
        record("smul", "bulletproofs_tpu_torch/csrc/fold.cu",
               "bulletproofs_tpu/ops/fold_pallas.py:50",
               *smul_check(pcaps[1], f"m={m16} prove"), prove16_launches)
        (coef,) = pcaps[2].args
        nb = coef.shape[0]
        got = FO.digits_lanes(coef)
        log(f"  digits on the m={m16} prove's S coefficients: events loop "
            f"{time_cuda(lambda: FO.digits_lanes(coef), 20):.4f} ms (the "
            f"host's launch pace; the line below: device time)")
        # the guard's reduction: 9 small limb products (18 multiply-adds)
        # per scalar
        record("digits", "bulletproofs_tpu_torch/csrc/fold.cu",
               "bulletproofs_tpu/ops/fold_pallas.py:115",
               max_abs_err(got, FO.digits_plain(coef)),
               queued_ms(lambda: FO.digits_lanes(coef), 50),
               time_cuda(lambda: FO.digits_plain(coef), 1),
               nb * P * (9 * 8 + 64), 18 * nb * P, prove16_launches)
        (sx16,) = pcaps[4].args
        err = max_abs_err(S.sinv(sx16), time_once(
            lambda: S.sinv_plain(sx16))[0])
        ms = time_cuda(lambda: S.sinv(sx16), 20)
        b_ms, b_by = bound(2 * 8 * sx16.numel(), FK.SINV_OPS * sx16.shape[1],
                           imads)
        log(f"  sinv on the m={m16} prover's {sx16.shape[1]} challenges: "
            f"max_abs_err {err} ({'ok' if err == 0 else 'MISMATCH'}); "
            f"{ms:.4f} ms kernel, bound {b_ms:.4f} ms ({b_by}), latency "
            f"floor {FK.sinv_latency_floor_ms(mhz):.4f} ms on {smi}")
        if err != 0:
            failures.append(f"sinv on the m={m16} prover's challenges")
        scalar_checks(sc_caps16, f"m={m16} prove")
        add9 = field_mads(lambda: C.add(*(C.to_coords(C.identity(1, "cpu")),)
                                         * 2))
        for cap, what in ((vcaps[0], "chunk"), (vcaps[1], "final MSM")):
            zp, zd = cap.args
            zb = M.bin_points(zp, zd)
            berr = max_abs_err(zb, M.bin_points_plain(zp, zd))
            # device time from memory (two launches)
            bms = cold_ms(lambda: M.bin_points(zp, zd), 20)
            bplain_ms = time_cuda(lambda: M.bin_points_plain(zp, zd), 1)
            bbytes = bin_bytes(zp, zd, zb)
            zs = M.accumulate_z(zp, zd)
            err = max_abs_err(zs, M.accumulate_z_plain(zp, zd))
            ms = time_cuda(lambda: M.accumulate_z(zp, zd), 10)
            plain_ms = time_cuda(lambda: M.accumulate_z_plain(zp, zd), 1)
            nbytes = zp.numel() * 4 + zd.numel() + zs.numel() * 4
            mads = int((zd != 0).sum()) * add9
            # K4a on this MSM's slab (128 lanes a chunk, 64 the final MSM)
            lanes_z = zs.shape[-1]
            rerr = max_abs_err(M.reduce(zs), M.reduce_plain(zs))
            rms = time_cuda(lambda: M.reduce(zs), 10)
            rb_ms, rb_by = bound(zs.numel() * 4 + 64 * 8 * 40 * 4,
                                 64 * 8 * (lanes_z - 1) * add9, imads)
            log(f"  msm_reduce on the {what}'s slab ({lanes_z} lanes): "
                f"max_abs_err {rerr} ({'ok' if rerr == 0 else 'MISMATCH'}); "
                f"{rms:.4f} ms kernel, bound {rb_ms:.4f} ms ({rb_by}), "
                f"latency floor "
                f"{FK.reduce_latency_floor_ms(lanes_z, mhz):.4f} ms on {smi}")
            if rerr != 0:
                failures.append(f"msm_reduce on the m={m16} {what}")
            if what == "chunk":
                # msm_bin alone; msm_accumulate_z's time is the whole
                # accumulate_z call, its binning launch included
                record("msm_bin", "bulletproofs_tpu_torch/csrc/msm.cu",
                       "bulletproofs_tpu/ops/msm_pallas.py:121", berr, bms,
                       bplain_ms, bbytes, 0, verify16_launches)
                record("msm_accumulate_z", "bulletproofs_tpu_torch/csrc/msm.cu",
                       "bulletproofs_tpu/ops/msm_pallas.py:121", err, ms,
                       plain_ms, nbytes, mads, verify16_launches)
            else:
                for name, e, t, pt, nb, md in (
                        ("msm_bin", berr, bms, bplain_ms, bbytes, 0),
                        ("msm_accumulate_z", err, ms, plain_ms, nbytes, mads)):
                    b_ms, b_by = bound(nb, md, imads)
                    log(f"  {name} on the {what} ({zp.shape[-1]} points): "
                        f"max_abs_err {e}; {t:.4f} ms kernel, {pt:.2f} ms "
                        f"plain, bound {b_ms:.4f} ms ({b_by})")
                    if e != 0:
                        failures.append(f"{name} on the final MSM")
        compress_checks(k5_16.calls, f"m={m16} prove", imads, smi, failures)
        if not k5_16.calls:
            failures.append(f"compress inputs of the m={m16} prove not "
                            f"captured")
        l16, s16 = (name for name, _, _ in FS.shape_specs(n, m16, lanes16))
        log(f"  fixed-base MSM at the m={m16} shapes:")
        lniels, ldig, lkw = shapes16.got[l16]
        sniels, sdig, skw = shapes16.got[s16]
        if lkw.get("consttime", True) or not skw.get("consttime", True):
            failures.append(f"m={m16}: K6 forms not routed by row kind")
        fixed_shape_checks(l16, lniels, ldig, lkw)
        fixed_shape_checks(s16, sniels, sdig, skw)
        err, ms, plain_ms, nbytes, mads = k12_against_k6(sniels, sdig, s16)
        record("fixed_accumulate2", "bulletproofs_tpu_torch/csrc/fixed_msm.cu",
               "bulletproofs_tpu/ops/fixed_msm.py:206", err, ms, plain_ms,
               nbytes, mads, ilp2_launches)
    probe_phase(args, dev, smi, record, failures, mhz)
    r1cs_phase(args, smi, imads, failures)
    linear_phase(args, smi, imads, failures)
    routes_phase(args, smi, failures, {
        "bp": bp, "pc": pc, "n": n, "prover": prover, "bv": bv,
        "proofs": proofs, "vcss": vcss, "labels": labels, "values": values,
        "blinds": blinds, "bp16": bp16, "bv16": bv16, "m16": m16,
        "vals16": vals16, "blinds16": blinds16, "labels16": labels16})
    examples_phase(args, smi, failures)
    msm_phase(args, smi, imads, failures)
    if PLAIN_LAUNCHES:
        failures.append(f"plain versions launched kernels: {PLAIN_LAUNCHES}")
    if failures:
        log("FAILED:", failures)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
