"""Range values proved (proofs x m) by the prove calls completed in the
window, over the window's seconds: all the work over all the time."""

from .. import stats

UNIT = "outputs/s"


def read(run):
    if not run.latencies_s:
        return None
    return stats.rate(run.outputs, run.window_s)
