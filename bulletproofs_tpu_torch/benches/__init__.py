"""Benchmarks of the port: the MXU field-multiplication probe
(`python -m bulletproofs_tpu_torch.benches.mxu_fmul_probe`) and the
k-shuffle R1CS circuit."""

from __future__ import annotations

import time

import torch


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
