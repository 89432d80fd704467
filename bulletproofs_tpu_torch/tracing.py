"""Spans and counters inside the port, kept in memory.

    from bulletproofs_tpu_torch import tracing
    tracing.reset(); tracing.enable()
    prover.prove_batch(...)
    tracing.disable()
    for name, row in tracing.summary().items(): ...

`span(name)` is a context manager around one piece of the program's work;
`count(name, n)` adds n to a counter of the innermost open span.  A span
opened while no other is open is a root: it starts a new call, and every
span opened under it carries that call's id.  The prover opens the root
`prove` in `BatchProver.prove_batch`.

Off (the default), `span` returns one shared object that does nothing and
`count` returns at once: no clock is read, nothing is allocated.  On, each
span records (call, name, parent, t0_ns, t1_ns, counters).  Its times are
on the Unix-epoch clock that torch.profiler stamps its events with (a
`perf_counter_ns` reading plus an offset taken at `enable()`), so that a
span can be laid over a profiler trace.  No span is a `record_function`
range: the profiler mirrors those onto the device's timeline, where they
would read as device work.

The recorder serves one thread: the port's prover launches all its work
from the caller's thread.  A span must close before a generator that
opened it yields."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

ON = False          # the recorder's flag: enable() / disable()
OUTSIDE = "(no span)"   # summary()'s row of counts made with no span open


class Record:
    """One span: `parent` is the index of the enclosing span's record in
    records(), None for a root; times in ns on the profiler's clock."""

    __slots__ = ("call", "name", "parent", "t0_ns", "t1_ns", "counts")

    def __init__(self, call: int, name: str, parent: Optional[int],
                 t0_ns: int):
        self.call, self.name, self.parent = call, name, parent
        self.t0_ns, self.t1_ns = t0_ns, t0_ns
        self.counts: Dict[str, int] = defaultdict(int)


_records: List[Record] = []
_open: List[int] = []                       # indices of the open spans
_loose: Dict[str, int] = defaultdict(int)   # counts with no span open
_calls = 0
_offset_ns = 0


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("_name", "_at")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        global _calls
        if not _open:
            _calls += 1
        self._at = len(_records)
        _records.append(Record(_calls, self._name,
                               _open[-1] if _open else None,
                               time.perf_counter_ns() + _offset_ns))
        _open.append(self._at)
        return self

    def __exit__(self, *exc):
        _records[self._at].t1_ns = time.perf_counter_ns() + _offset_ns
        _open.pop()
        return False


def span(name: str):
    """A context manager that records its extent as span `name`."""
    return _Span(name) if ON else _OFF


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` of the innermost open span."""
    if ON:
        (_records[_open[-1]].counts if _open else _loose)[name] += n


def enable() -> None:
    """Start recording; anchors the span clock to the Unix epoch."""
    global ON, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    ON = True


def disable() -> None:
    """Stop recording; the records are kept."""
    global ON
    ON = False


def reset() -> None:
    """Drop every record and count."""
    global _calls
    if _open:
        raise RuntimeError("reset() inside an open span")
    _records.clear()
    _loose.clear()
    _calls = 0


def records() -> List[Record]:
    """Every span recorded since the last reset(), in the order opened."""
    return _records


def summary() -> Dict[str, dict]:
    """Per span name: calls, total and self host ms (self: less the time
    of the spans directly under it), and its counters summed; the counts
    made with no span open under OUTSIDE."""
    child_ns = [0] * len(_records)
    for r in _records:
        if r.parent is not None:
            child_ns[r.parent] += r.t1_ns - r.t0_ns
    out: Dict[str, dict] = {}
    for r, kids in zip(_records, child_ns):
        row = out.setdefault(r.name, {"calls": 0, "total_ms": 0.0,
                                      "self_ms": 0.0, "counts": {}})
        row["calls"] += 1
        row["total_ms"] += (r.t1_ns - r.t0_ns) * 1e-6
        row["self_ms"] += (r.t1_ns - r.t0_ns - kids) * 1e-6
        for k, v in r.counts.items():
            row["counts"][k] = row["counts"].get(k, 0) + v
    if _loose:
        out[OUTSIDE] = {"calls": 0, "total_ms": 0.0, "self_ms": 0.0,
                        "counts": dict(_loose)}
    return out
