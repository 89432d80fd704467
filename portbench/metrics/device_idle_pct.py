"""Share of the traced window in which no kernel, copy or set ran on the
card: 100 less the union of the profiler's device intervals."""

UNIT = "%"
LAYER = "device (one H100)"
MOVES = "prove_outputs_per_s"


def read(run):
    tl = run.timeline
    if tl is None or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
