"""One reader a metric, found by the metric's name in BENCHMARK.json:
`<name>.py` holds its UNIT, and for a per-layer metric its LAYER and the
end-to-end metric it MOVES, and `read(run)`, which returns the metric
from what the run recorded (`portbench.run.Run`), or None where the run
holds nothing to read.  A share of a roofline or a peak is never made
up as 0 or capped."""
