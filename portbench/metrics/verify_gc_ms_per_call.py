"""Milliseconds a verify call that Python's cyclic garbage collector held
the process: the arithmetic of `gc_ms_per_call`, moving the verify
p90: a name of its own because a metric moves one end-to-end metric."""

from .gc_ms_per_call import LAYER, read  # noqa: F401

UNIT = "ms"
MOVES = "verify_call_p90_ms"
