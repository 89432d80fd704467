"""90th percentile of the host-clock latency of every prove call in the
window, each from its start to a synchronize after it."""

from .. import stats

UNIT = "ms"


def read(run):
    if len(run.latencies_s) < 2:
        return None
    return stats.percentile([s * 1e3 for s in run.latencies_s], 90)
