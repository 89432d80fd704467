"""One profiler timeline over the traced window, reduced to what the
per-layer metrics read: the device's busy time (the union of every
kernel, copy and set on the card), its operations, the device time of the
work that each benchmark span launched, and the idle gaps with the span
the host was in.

The profiler mirrors each host range onto the device's timeline, from the
start of the first device operation launched inside the range to the end
of the last.  The port runs on one stream, in order, so the device time
of a span's work is the device operations' time inside its mirrored
ranges."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

from . import stats
from .spans import PREFIX

OUTSIDE = "between calls"


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


class Timeline:
    """The reduced trace.  Times in seconds on the profiler's clock."""

    def __init__(self, prof):
        device, host, mirrored = [], defaultdict(list), defaultdict(list)
        for e in prof.profiler.kineto_results.events():
            s, d, name = e.start_ns() * 1e-9, e.duration_ns() * 1e-9, e.name()
            on_device = "CUDA" in str(e.device_type())
            if name.startswith(PREFIX):
                (mirrored if on_device else host)[name[len(PREFIX):]].append(
                    (s, s + d))
            elif on_device and d > 0:
                device.append((s, s + d, name))
        if len(host.get("window", ())) != 1:
            raise RuntimeError("the trace holds no window range")
        (self.lo, self.hi), = host.pop("window")
        self.device = [x for x in device if x[1] > self.lo and x[0] < self.hi]
        self.ranges = {k: sorted(v) for k, v in host.items()}
        self._starts = {k: [s for s, _ in v] for k, v in self.ranges.items()}
        self.mirrored = {k: stats.union(v) for k, v in mirrored.items()}
        self.window_s = self.hi - self.lo
        self.busy_s = stats.covered(((s, e) for s, e, _ in self.device),
                                    self.lo, self.hi)

    def ops(self) -> int:
        return len(self.device)

    def span_device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside span `name`
        (0 where the trace mirrors no such range onto the device)."""
        return stats.overlap(((s, e) for s, e, _ in self.device),
                             self.mirrored.get(name, []))

    def _host_span_at(self, t: float) -> str:
        best, width = OUTSIDE, float("inf")
        for name, spans in self.ranges.items():
            i = bisect.bisect_right(self._starts[name], t) - 1
            if i >= 0 and t <= spans[i][1] and spans[i][1] - spans[i][0] < width:
                best, width = name, spans[i][1] - spans[i][0]
        return best

    def breakdown(self, top: int = 10) -> Dict[str, List[Tuple[str, float]]]:
        """The device operations that took the most time, and the idle time
        by the innermost span the host was in at each gap's middle."""
        by_op = defaultdict(float)
        for s, e, name in self.device:
            by_op[name.split("(")[0][:96]] += min(e, self.hi) - max(s, self.lo)
        idle = defaultdict(float)
        for s, e in stats.gaps(((s, e) for s, e, _ in self.device),
                               self.lo, self.hi):
            idle[self._host_span_at((s + e) / 2)] += e - s
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order(by_op)],
                "idle_gaps": [[k, v] for k, v in order(idle)]}
