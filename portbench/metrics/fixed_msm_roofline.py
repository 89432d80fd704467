"""Least time of the calls' fixed-base MSM work (work.prove_bound_s,
counted from the calls' shapes at the card's integer and memory peaks),
over the device time of the operations launched inside the spans around
fixed_msm.msm_digits_niels (K6 and K7)."""

from .. import work

UNIT = "%"
LAYER = "kernels (ops/fixed_msm.py, csrc/fixed_msm.cu: K6, K7)"
MOVES = "prove_outputs_per_s"


def read(run):
    tl, shape = run.timeline, run.shape
    if tl is None or not run.latencies_s or "max_sm_mhz" not in run.card:
        return None
    device_s = tl.span_device_s("fixed_msm")
    if device_s <= 0:
        return None
    peak = work.peak_imads_per_s(float(run.card["max_sm_mhz"]))
    bound = work.prove_bound_s(shape["n"], shape["m"], shape["proofs"], peak)
    return 100.0 * bound * len(run.latencies_s) / device_s
