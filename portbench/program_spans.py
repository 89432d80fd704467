"""Readings of the program's own spans (the port's `tracing` recorder) laid
over a traced run's device timeline.  No metric registers them yet: the
harness does not turn the recorder on (PERF.md, Open questions).  They
live here, beside the benchmark's other arithmetic, so that a later
benchmark entry reads them from frozen code and never from the program.

A record is what the recorder keeps of one span: `name`, `parent` (the
index of the enclosing span's record, None for a root), `t0_ns`, `t1_ns`
on the profiler's clock, and `counts` ({counter: n}).  Each reading is a
call, over the calls completed in the window; every interval is clipped to
the timeline's window [lo, hi]; a span's self time is its extent less its
child spans'; card-idle time is the gaps between the timeline's device
operations (`stats.gaps`).

* `entry_idle_ms`: card-idle ms under the self time of `prove`,
  `prove.check`, `prove.statements`, `prove.writeback`, `prove.assemble`;
* `issue_idle_ms`: card-idle ms under the self time of `prove.stage0`,
  `prove.mid`, `prove.round`, `prove.fin` (the card waiting while the
  host launches the stages' work);
* `fetch_wait_ms`: host ms in `prove.fetch`;
* `torch_ops_per_call`: the timeline's device operations less the
  `launches` the program counted in spans that start in the window:
  PyTorch's own kernels, copies and sets."""

from __future__ import annotations

from typing import Dict, Optional

from . import stats

ENTRY = ("prove", "prove.check", "prove.statements", "prove.writeback",
         "prove.assemble")
STAGES = ("prove.stage0", "prove.mid", "prove.round", "prove.fin")


def _self_intervals(recs, keep, lo: float, hi: float):
    """Seconds intervals of the self time of the records i with keep(i),
    clipped to [lo, hi]."""
    kids: Dict[int, list] = {}
    for r in recs:
        if r.parent is not None:
            kids.setdefault(r.parent, []).append((r.t0_ns * 1e-9,
                                                  r.t1_ns * 1e-9))
    out = []
    for i, r in enumerate(recs):
        if keep(i):
            s, e = max(r.t0_ns * 1e-9, lo), min(r.t1_ns * 1e-9, hi)
            if e > s:
                out.extend(stats.gaps(kids.get(i, ()), s, e))
    return out


def _idle_s(gaps, recs, keep, lo, hi) -> float:
    return stats.overlap(gaps, _self_intervals(recs, keep, lo, hi))


def _gaps(tl):
    return stats.gaps(((s, e) for s, e, _ in tl.device), tl.lo, tl.hi)


def readings(tl, recs, calls: int) -> Optional[dict]:
    """The four readings of a traced run's timeline `tl` (trace.Timeline:
    .device, .lo, .hi, .ops()) and the recorder's records over `calls`
    calls -> {name: value}, or None where the run was not traced or
    recorded nothing."""
    if tl is None or not recs or calls <= 0:
        return None
    lo, hi = tl.lo, tl.hi
    gaps = _gaps(tl)
    entry = _idle_s(gaps, recs, lambda i: recs[i].name in ENTRY, lo, hi)
    stages = _idle_s(gaps, recs, lambda i: recs[i].name in STAGES, lo, hi)
    fetch = sum(max(0.0, min(r.t1_ns * 1e-9, hi) - max(r.t0_ns * 1e-9, lo))
                for r in recs if r.name == "prove.fetch")
    ours = sum(r.counts.get("launches", 0) for r in recs
               if lo <= r.t0_ns * 1e-9 < hi)
    return {"entry_idle_ms": entry / calls * 1e3,
            "issue_idle_ms": stages / calls * 1e3,
            "fetch_wait_ms": fetch / calls * 1e3,
            "torch_ops_per_call": (tl.ops() - ours) / calls}


def span_table(tl, recs, calls: int) -> Optional[dict]:
    """Per span name, each a call: calls, host self ms, card-idle ms under
    its self time, counters; records that start in the window."""
    if tl is None or not recs or calls <= 0:
        return None
    lo, hi = tl.lo, tl.hi
    gaps = _gaps(tl)
    inside = [lo <= r.t0_ns * 1e-9 < hi for r in recs]
    names = sorted({r.name for r, ok in zip(recs, inside) if ok})
    child_ns = [0] * len(recs)
    for r in recs:
        if r.parent is not None:
            child_ns[r.parent] += r.t1_ns - r.t0_ns
    table = {}
    for name in names:
        mine = [i for i, r in enumerate(recs) if r.name == name and inside[i]]
        counts: Dict[str, float] = {}
        for i in mine:
            for k, v in recs[i].counts.items():
                counts[k] = counts.get(k, 0) + v / calls
        table[name] = {
            "calls": len(mine) / calls,
            "self_ms": sum(recs[i].t1_ns - recs[i].t0_ns - child_ns[i]
                           for i in mine) * 1e-6 / calls,
            "idle_ms": _idle_s(gaps, recs, frozenset(mine).__contains__,
                               lo, hi) / calls * 1e3,
            "counts": counts}
    return table


def clock_skew_us(tl, recs) -> Optional[float]:
    """Largest distance between a `prove` span's start and the start of
    the benchmark's own range around the same call (`pb.prove_batch`), or
    None where the two do not pair up."""
    if tl is None:
        return None
    starts = [s for s, _ in tl.ranges.get("prove_batch", ())]
    roots = [r.t0_ns * 1e-9 for r in recs if r.name == "prove"]
    if not starts or len(starts) != len(roots):
        return None
    return max(abs(a - b) for a, b in zip(sorted(starts), sorted(roots))) * 1e6
