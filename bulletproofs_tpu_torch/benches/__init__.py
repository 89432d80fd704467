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
