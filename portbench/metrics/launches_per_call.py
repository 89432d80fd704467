"""Device operations a call, by torch.profiler: every kernel, copy and
set the card ran in the traced window, over the calls in it."""

UNIT = "launches"
LAYER = "device stages (ops/prover_stages.py, transcript_device, scalar, chacha)"
MOVES = "prove_outputs_per_s"


def read(run):
    if run.timeline is None or not run.latencies_s or not run.timeline.ops():
        return None
    return run.timeline.ops() / len(run.latencies_s)
