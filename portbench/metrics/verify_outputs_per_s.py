"""Range values verified (proofs x m) by the verify calls completed in the
window, over the window's seconds: all the work over all the time, the
arithmetic of `prove_outputs_per_s`, under a name of its own so that the
verify cell's rate has a bound set from its own spread and the prove
cells' metric keeps its own cells."""

from .prove_outputs_per_s import read  # noqa: F401

UNIT = "outputs/s"
