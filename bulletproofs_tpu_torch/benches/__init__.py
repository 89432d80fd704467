"""Benchmarks of the port: the MXU field-multiplication probe
(`python -m bulletproofs_tpu_torch.benches.mxu_fmul_probe`) and the
k-shuffle R1CS circuit."""

from __future__ import annotations

import random
import time

import torch

# limb products of a field product and of a squaring (csrc/fe25519.cuh
# fe_mul, fe_sq), each two 32-bit multiply-adds on the card
MUL_PRODUCTS = 100
SQ_PRODUCTS = 55


def field_mads(fn) -> int:
    """32-bit multiply-adds of the field products and squarings that the
    plain version makes in fn() (the kernels make the same ones)."""
    from ..ops import field as F
    real_mul, real_sq, n = F.mul, F.square, {"mul": 0, "sq": 0}

    def mul(a, b):
        n["mul"] += 1
        return real_mul(a, b)

    def square(a):
        n["sq"] += 1
        return real_sq(a)

    F.mul, F.square = mul, square
    try:
        fn()
    finally:
        F.mul, F.square = real_mul, real_sq
    # square() is mul(a, a): each squaring was counted as a product too
    return 2 * (MUL_PRODUCTS * (n["mul"] - n["sq"]) + SQ_PRODUCTS * n["sq"])


def timed(fn, reps: int, device, warm: bool = True):
    """(last output, mean milliseconds of fn() over `reps` calls), after one
    warm-up call when `warm`: by CUDA events on a CUDA device, by the host
    clock on the CPU."""
    dev = torch.device(device)
    out = fn() if warm else None
    if dev.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def _behind_sleep(queue_calls, reps: int, host_s: float):
    """queue_calls() (which queues `reps` calls, each taking the host about
    `host_s` seconds to issue) behind a sleep of the card long enough that
    it runs them back to back -> what queue_calls returned, once the card
    has run them.  Raises if the host could not queue every call before
    the sleep ended."""
    cycles = int(4 * reps * host_s * 2e9) + 2_000_000   # ~4x at 2 GHz
    for _ in range(4):
        torch.cuda._sleep(cycles)
        first = torch.cuda.Event()
        first.record()
        got = queue_calls()
        ahead = not first.query()       # the card still asleep: all queued
        torch.cuda.synchronize()
        if ahead:
            return got
        cycles *= 4
    raise RuntimeError("the host could not queue the calls ahead of the card")


def _host_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s


def queued(fn, reps: int):
    """(last output, mean milliseconds of fn() over `reps` calls by CUDA
    events, with the calls queued behind a sleep of the card long enough
    that it runs them back to back): device time, where `timed`'s loop of
    a short kernel measures the host's launch pace.  Each call finds in L2
    what the one before left there."""
    fn()

    def calls():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        return out, start, end
    out, start, end = _behind_sleep(calls, reps, _host_s(fn))
    return out, start.elapsed_time(end) / reps


def cold(fn, reps: int):
    """(last output, mean milliseconds of fn() over `reps` calls queued
    behind a sleep of the card, each timed alone by CUDA events after a
    read of a buffer twice the card's L2 cache): device time with the
    inputs read from device memory, which a bound by the memory rate
    assumes.  The buffer is written once, before the calls, and only read
    between them, so the L2 holds clean lines when a call starts: a write
    before each call (the form before) left up to an L2 of dirty lines,
    whose write-back each call then paid on top of its own bytes."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    l2 = getattr(props, "L2_cache_size", 0) or 50 << 20
    scrub = torch.ones(2 * l2 // 8, dtype=torch.int64, device="cuda")
    total = torch.empty((), dtype=torch.int64, device="cuda")
    fn()

    def flush():
        torch.sum(scrub, dim=0, out=total)

    def calls():
        marks = []
        for _ in range(reps):
            flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            marks.append((start, end))
        return out, marks
    host_s = _host_s(lambda: (flush(), fn()))
    out, marks = _behind_sleep(calls, reps, host_s)
    return out, sum(s.elapsed_time(e) for s, e in marks) / reps


def kernel_ms(fn, reps: int) -> dict:
    """{kernel: device milliseconds per call} of every kernel (and copy)
    that fn() runs on the card, over `reps` calls, by torch.profiler (CUDA
    activity only): the kernels' own durations, without the gaps between
    launches."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {key.split("(")[0][:80]: ms / reps
            for ms, _, key in profiled(calls)}


def profiled(fn):
    """Device kernels of one fn() by torch.profiler (CUDA activity only) ->
    [(device ms, calls, kernel name)], largest first; empty when the
    profiler saw no device time.  Summed, the calls are a path's kernel
    launches (every kernel and copy the profiler saw)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    return sorted(rows, reverse=True)


class Rng:
    """Seeded byte source with the interface the prover and verifier use."""

    def __init__(self, seed: int):
        self.r = random.Random(seed)

    def randbytes(self, n: int) -> bytes:
        return self.r.randbytes(n)
