"""The benchmark's own spans around calls into the program: each wrapped
function's host time is summed under a name, and each call is a profiler
range of the same name (`pb.<name>`), so that the trace can tell which
device work a span launched and what the host did in each idle gap.  The
cyclic garbage collector's pauses are summed from `gc.callbacks`.
Installed only in traced runs; `close()` puts every function back."""

from __future__ import annotations

import functools
import gc
import time
from collections import defaultdict
from typing import Any, Callable, List, Tuple

PREFIX = "pb."


class _Proxy:
    """Stands for an object (a ctypes library) whose named attributes are
    wrapped and whose others pass through."""

    def __init__(self, target, wrapped: dict):
        self._target = target
        self._wrapped = wrapped

    def __getattr__(self, name):
        if name in self._wrapped:
            return self._wrapped[name]
        return getattr(self._target, name)


class Spans:
    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.gc_seconds = 0.0
        self.gc_collections = 0
        self._gc_start = None
        self._undo: List[Tuple[Any, str, Any]] = []
        gc.callbacks.append(self._gc)

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_start = time.perf_counter()
        elif self._gc_start is not None:
            self.gc_seconds += time.perf_counter() - self._gc_start
            self.gc_collections += 1
            self._gc_start = None

    def timed(self, name: str, fn: Callable) -> Callable:
        from torch.profiler import record_function
        label = PREFIX + name

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with record_function(label):
                    return fn(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
        return inner

    def wrap(self, owner, attr: str, name: str) -> None:
        """Replace owner.attr by a timed copy until close()."""
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, orig))
        setattr(owner, attr, self.timed(name, orig))

    def wrap_library(self, module, attr: str, names, name: str) -> None:
        """Replace module.attr (a ctypes library) by a proxy whose
        functions `names` are timed under `name`."""
        lib = getattr(module, attr)
        wrapped = {f: self.timed(name, getattr(lib, f)) for f in names}
        self._undo.append((module, attr, lib))
        setattr(module, attr, _Proxy(lib, wrapped))

    def close(self) -> None:
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)
