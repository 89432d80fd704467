"""Share of the traced window of a verify cell in which no kernel, copy
or set ran on the card: the arithmetic of `device_idle_pct`, moving the
verify rate: a name of its own because a metric moves one end-to-end
metric."""

from .device_idle_pct import LAYER, read  # noqa: F401

UNIT = "%"
MOVES = "verify_outputs_per_s"
