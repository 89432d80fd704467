"""Benchmarks of the port: the MXU field-multiplication probe
(`python -m bulletproofs_tpu_torch.benches.mxu_fmul_probe`) and the
k-shuffle R1CS circuit."""

from __future__ import annotations

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


def queued(fn, reps: int):
    """(last output, mean milliseconds of fn() over `reps` calls by CUDA
    events, with the calls queued behind a sleep of the card long enough
    that it runs them back to back): device time, where `timed`'s loop of
    a short kernel measures the host's launch pace.  Raises if the host
    could not queue every call before the sleep ended."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4 * reps * host_s * 2e9) + 2_000_000   # ~4x at 2 GHz
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        ahead = not start.query()       # the card still asleep: all queued
        torch.cuda.synchronize()
        if ahead:
            return out, start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("the host could not queue the calls ahead of the card")


def kernel_ms(fn, reps: int) -> dict:
    """{kernel: device milliseconds per call} of every kernel (and copy)
    that fn() runs on the card, over `reps` calls, by torch.profiler (CUDA
    activity only): the kernels' own durations, without the gaps between
    launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            out[e.key.split("(")[0][:80]] = t / 1e3 / reps
    return out
