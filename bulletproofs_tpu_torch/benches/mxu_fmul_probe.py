"""The chained shared-operand field-multiplication probe on the card: the
port's counterpart of the JAX package's benches/_mxu_fmul_probe.py.

    python -m bulletproofs_tpu_torch.benches.mxu_fmul_probe [--lanes 512]
        [--steps 1024] [--reps 8] [--device cuda]

Same shapes and seed as the JAX probe: Q = 512 lanes, T = 1024 chained
steps of three shared-operand multiplications each, numpy
RandomState(5) drawing the lanes' a, one operand b, then the 3 T step
operands.  `run` checks one MXU-form product against the Python-int
oracle on every 37th lane, builds b3 (3, 20, T) int32 and m3 (3, T, 156,
40) int8, then times both chains (one warm-up, then `reps` calls; CUDA
events on the card): K15 (ops/fmul13.chain_vpu, the schoolbook form) and
K16 (chain_mxu, the banded int8 matrix on the tensor cores).  Rates are
3 T Q / time, as the JAX probe counts them.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..ops import fmul13 as F
from . import timed


def make_inputs(lanes: int = 512, steps: int = 1024, seed: int = 5) -> dict:
    """The probe's operands as ints and tensors (on the CPU)."""
    rng = np.random.RandomState(seed)
    p = F.P25519
    a_int = [int.from_bytes(rng.bytes(31), "little") % p for _ in range(lanes)]
    b_int = int.from_bytes(rng.bytes(31), "little") % p
    b_steps = [int.from_bytes(rng.bytes(31), "little") % p
               for _ in range(3 * steps)]
    bl = np.stack([F.to_limbs(v) for v in b_steps])            # (3 T, 20)
    return {
        "a_int": a_int, "b_int": b_int, "b_steps": b_steps,
        "a": torch.as_tensor(F.ints_to_limbs(a_int)),
        "M": torch.as_tensor(F.band_matrix(b_int)),
        "b3": torch.as_tensor(np.ascontiguousarray(
            bl.reshape(3, steps, F.L).transpose(0, 2, 1)).astype(np.int32)),
        "m3": torch.as_tensor(F.band_matrices(bl).reshape(
            3, steps, F.MROWS, F.MCOLS)),
    }


def chain_oracle(a_int, b_steps, steps: int):
    """Python ints: each a after the chain, mod p (step t's operands are
    b_steps[t], b_steps[T + t], b_steps[2 T + t])."""
    p = F.P25519
    out = []
    for a in a_int:
        for t in range(steps):
            a = a * (b_steps[t] + b_steps[steps + t]
                     + b_steps[2 * steps + t]) % p
        out.append(a)
    return out


def run(device="cuda", lanes: int = 512, steps: int = 1024, reps: int = 8,
        seed: int = 5, inputs: dict = None, log=print) -> dict:
    """The probe on `device` ("cuda" must have a card; "cpu" runs the plain
    versions) -> {"device", "lanes", "steps", "oracle_ok", "vpu_ms",
    "mxu_ms", "vpu_gmuls", "mxu_gmuls", "vpu_out", "mxu_out", "inputs"}
    (the outputs are the chains' last results, on `device`)."""
    dev = resolve_device(device)
    inp = inputs or make_inputs(lanes, steps, seed)
    q = len(inp["a_int"])
    t = len(inp["b_steps"]) // 3
    a = inp["a"].to(dev)
    got = F.limbs_to_ints(F.mxu_mul(a, inp["M"].to(dev)).cpu().numpy())
    p = F.P25519
    ok = all(got[i] % p == inp["a_int"][i] * inp["b_int"] % p
             for i in range(0, q, 37))
    log(f"MXU-form product bit-exact vs oracle (every 37th lane): {ok}")
    res = {"device": str(dev), "lanes": q, "steps": t, "oracle_ok": ok,
           "inputs": inp}
    if not ok:
        return res
    b3, m3 = inp["b3"].to(dev), inp["m3"].to(dev)
    for key, name, fn in (
            ("vpu", "VPU schoolbook", lambda: F.chain_vpu(a, b3)),
            ("mxu", "MXU int8 product", lambda: F.chain_mxu(a, m3))):
        out, ms = timed(fn, reps, dev)
        rate = 3 * t * q / (ms / 1e3)
        res[f"{key}_out"], res[f"{key}_ms"] = out, ms
        res[f"{key}_gmuls"] = rate / 1e9
        log(f"{name} on {dev}: {ms:.4f} ms for {3 * t} chained shared-muls "
            f"x {q} lanes ({ms * 1e3 / t:.3f} us per step) -> "
            f"{rate / 1e9:.3f} G muls/s")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=512)
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run(args.device, args.lanes, args.steps, args.reps)
    if not res["oracle_ok"]:
        raise SystemExit("the MXU form disagrees with the oracle")


if __name__ == "__main__":
    main()
