"""90th percentile of the host-clock latency of every verify call in the
window, each from its start to a synchronize after it: the arithmetic of
`prove_call_p90_ms`, under a name of its own so that the verify cell's
latency has a bound set from its own spread and the prove cells' metric
keeps its own cells."""

from .prove_call_p90_ms import read  # noqa: F401

UNIT = "ms"
