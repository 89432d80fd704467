"""Milliseconds a call that Python's cyclic garbage collector held the
process, all generations (gc.callbacks), over the window."""

UNIT = "ms"
LAYER = "host runtime (Python)"
MOVES = "prove_call_p90_ms"


def read(run):
    if run.spans is None or not run.latencies_s:
        return None
    return run.spans.gc_seconds / len(run.latencies_s) * 1e3
