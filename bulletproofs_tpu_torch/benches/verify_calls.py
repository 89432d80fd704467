"""Per-call records of timed calls, and the m = 1 verifier's calls recorded
alone on one CUDA card:

    python -m bulletproofs_tpu_torch.benches.verify_calls [--proofs 8192]
        [--runs 12] [--ballast 0,3000000]

`CallRecorder` records each call of a timed function on its own: wall
time (time.perf_counter) ending in a synchronize, the process's and the
calling thread's CPU time, Python's cyclic GC (collections, milliseconds
and objects collected by generation, from a gc.callbacks hook),
involuntary context switches and major page faults (getrusage deltas),
the CUDA caching allocator's retries, device allocations and segments and
the pinned host allocator's allocations (torch.cuda.memory_stats /
host_memory_stats deltas), and the host clock of every stage it wraps.
A call that stalls shows where its extra time went: in the process's own
work (CPU time grows with the wall), in waiting (it does not), in a full
GC collection, or in the allocators.

`record_verify_calls` wraps the stages of BatchVerifier.verify_batch's
fused route (`_serialize`, each sub-batch's C++ replay, each `_upload`,
the launches of K1 and of the fused tail, the final flag sync) and records
`runs` calls; chip_smoke.py's phase 6 and this module's main use it.

main proves `--proofs` n = 64 range proofs on the card, then records
`--runs` verify_batch calls after a warm-up for each ballast size of
`--ballast` in turn: that many small GC-tracked lists held by the caller,
the heap a long-running caller of the port may hold.  One line per call,
then one JSON line per series (walls, GC milliseconds, the card's name and
power limit).
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import random
import resource
import statistics
import sys
import time

import torch


class CallRecorder:
    """Per-call records of timed calls (module docstring).  Stages are
    wrapped by `patch` until close(); the gc hook is removed by close()."""

    ALLOC = ("num_alloc_retries", "num_device_alloc", "num_device_free",
             "num_sync_all_streams")

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.spans = collections.defaultdict(list)
        self._reset()
        self.patched = []
        gc.callbacks.append(self._gc)

    def _reset(self):
        self.spans.clear()
        self.gc_n, self.gc_ms, self.gc_freed = [0] * 3, [0.0] * 3, [0] * 3

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.gc_n[g] += 1
            self.gc_ms[g] += (time.perf_counter() - self._t) * 1e3
            self.gc_freed[g] += info["collected"]

    def stage(self, name, fn):
        """fn, its calls' (start, end) host clocks kept under `name`."""
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.spans[name].append((t0, time.perf_counter()))
        return call

    def patch(self, owner, name, label=None):
        """Wrap owner.name by `stage` until close()."""
        self.patched.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, self.stage(label or name, getattr(owner, name)))

    def close(self):
        gc.callbacks.remove(self._gc)
        for owner, name, old in reversed(self.patched):
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        self.patched = []

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _alloc(self) -> dict:
        if not self.cuda:
            return {}
        st = torch.cuda.memory_stats()
        out = {k: st.get(k, 0) for k in self.ALLOC}
        out["segments"] = st.get("segment.all.current", 0)
        host = getattr(torch.cuda, "host_memory_stats", None)
        if host is not None:
            out["pinned_allocs"] = host().get("num_host_alloc", 0)
        out["reserved_gib"] = st.get("reserved_bytes.all.current", 0) / 2**30
        return out

    def run(self, fn) -> dict:
        """One call of fn(), ending in a synchronize -> its record."""
        self._reset()
        self._sync()
        a0, r0 = self._alloc(), resource.getrusage(resource.RUSAGE_SELF)
        c0, h0, t0 = time.process_time(), time.thread_time(), \
            time.perf_counter()
        fn()
        self._sync()
        t1, h1, c1 = time.perf_counter(), time.thread_time(), \
            time.process_time()
        r1, a1 = resource.getrusage(resource.RUSAGE_SELF), self._alloc()
        return {
            "wall_ms": (t1 - t0) * 1e3, "cpu_ms": (c1 - c0) * 1e3,
            "thread_ms": (h1 - h0) * 1e3, "gc_n": list(self.gc_n),
            "gc_ms": list(self.gc_ms), "gc_freed": list(self.gc_freed),
            "nivcsw": r1.ru_nivcsw - r0.ru_nivcsw,
            "majflt": r1.ru_majflt - r0.ru_majflt,
            "alloc": {k: a1[k] - a0[k] for k in a1 if k != "reserved_gib"},
            "reserved_gib": a1.get("reserved_gib", 0.0),
            "stages": {k: [(e - b) * 1e3 for b, e in v]
                       for k, v in self.spans.items()},
            "ends": {k: v[-1][1] for k, v in self.spans.items()}}

    @staticmethod
    def text(rec) -> str:
        gcs = ", ".join(f"gen{g} {n} x {ms:.1f} ms ({f} freed)"
                        for g, (n, ms, f) in enumerate(zip(
                            rec["gc_n"], rec["gc_ms"], rec["gc_freed"])) if n)

        def one(v):
            if len(v) > 4:
                return f"{sum(v):.1f} ms ({len(v)} calls)"
            if len(v) > 1:
                return f"{sum(v):.1f} ms ({', '.join(f'{x:.1f}' for x in v)})"
            return f"{sum(v):.1f} ms"
        st = "; ".join(f"{k} {one(v)}" for k, v in rec["stages"].items())
        return (f"wall {rec['wall_ms']:.1f} ms, process cpu "
                f"{rec['cpu_ms']:.1f}, thread cpu {rec['thread_ms']:.1f} "
                f"(wall - thread {rec['wall_ms'] - rec['thread_ms']:.1f}); "
                f"gc {sum(rec['gc_ms']):.1f} ms [{gcs or 'none'}]; nivcsw "
                f"{rec['nivcsw']}, majflt {rec['majflt']}; allocator "
                f"{rec['alloc']}, reserved {rec['reserved_gib']:.2f} GiB"
                + (f"; stages: {st}" if st else ""))


def heap_census() -> str:
    """The objects Python's cyclic GC tracks, in all and by the eight
    commonest types (a full collection's work grows with their count)."""
    objs = gc.get_objects()
    by = collections.Counter(f"{type(o).__module__}.{type(o).__qualname__}"
                             for o in objs)
    del objs
    return (f"{sum(by.values())} tracked objects; thresholds "
            f"{gc.get_threshold()}, counts {gc.get_count()}; commonest: "
            + ", ".join(f"{k} {v}" for k, v in by.most_common(8)))


def record_verify_calls(bv, call, runs: int, log, cuda: bool = True):
    """`runs` calls of call(r) (each one verify_batch of `bv` on its fused
    route, with whatever the caller does around it), each recorded with
    the verifier's stages: _serialize, replay (one a sub-batch), _upload,
    the K1 launch and the fused tail's launches, "flag sync" (the last
    sub-batch's end to verify_batch's return) and "outside verify_batch"
    (the caller's share of the wall) -> the records; each logged."""
    from ..ops import curve as C
    from ..ops import verify as V
    rec = CallRecorder(cuda)
    for owner, name, label in ((bv, "verify_batch", None),
                               (bv, "_serialize", None), (bv, "replay", None),
                               (bv, "_upload", None), (bv, "_subbatch", None),
                               (C, "decompress", "K1 launch"),
                               (V, "fused_tail", "fused_tail launches")):
        rec.patch(owner, name, label)
    out = []
    try:
        for r in range(runs):
            got = rec.run(lambda: call(r))
            st, ends = got["stages"], got["ends"]
            st["flag sync"] = [(ends["verify_batch"] - ends["_subbatch"])
                               * 1e3]
            st["outside verify_batch"] = [got["wall_ms"]
                                          - st.pop("verify_batch")[0]]
            del st["_subbatch"]
            out.append(got)
            log(f"  verify call {r}: {CallRecorder.text(got)}")
    finally:
        rec.close()
    return out


class Rng:
    """Seeded byte source with the interface the prover and verifier use."""

    def __init__(self, seed: int):
        self.r = random.Random(seed)

    def randbytes(self, n: int) -> bytes:
        return self.r.randbytes(n)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--proofs", type=int, default=8192)
    ap.add_argument("--runs", type=int, default=12)
    ap.add_argument("--ballast", default="0,3000000",
                    help="comma-separated counts of caller-held tracked "
                         "objects, one series each")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("verify_calls: no CUDA device available", file=sys.stderr)
        return 2
    from .. import (BatchProver, BatchVerifier, BulletproofGens,
                    PedersenGens, Scalar, Transcript)
    from .accumulate_z import smi

    def log(*a):
        print(*a, flush=True)

    card = smi("name,power.limit")
    n = 64
    bp, pc = BulletproofGens(n, 1), PedersenGens()
    rng = Rng(1)
    values = [rng.r.randrange(1 << n) for _ in range(args.proofs)]
    blinds = [Scalar.random(rng) for _ in values]
    labels = [b"verify calls %d" % i for i in range(args.proofs)]
    proofs, vcs = BatchProver(bp, pc, n, device="cuda").prove_batch(
        values, blinds, [Transcript(l) for l in labels], rng=Rng(2))
    vcss = [[v] for v in vcs]
    bv = BatchVerifier(bp, pc, n=n, m=1, device="cuda")

    def verify(seed):
        bv.verify_batch(proofs, vcss, [Transcript(l) for l in labels],
                        rng=Rng(seed))

    verify(3)                                           # warm-up
    ballast = []
    for size in (int(x) for x in args.ballast.split(",")):
        ballast.extend([i] for i in range(size - len(ballast)))
        log(f"ballast {len(ballast)}: {heap_census()}")
        recs = record_verify_calls(bv, lambda r: verify(10 + r), args.runs,
                                   log)
        log(f"after the calls: {heap_census()}")
        walls = [r["wall_ms"] for r in recs]
        log(json.dumps({
            "ballast": len(ballast), "proofs": args.proofs,
            "walls_ms": [round(w, 3) for w in walls],
            "median_ms": statistics.median(walls),
            "max_over_median": max(walls) / statistics.median(walls),
            "gc_ms": [round(sum(r["gc_ms"]), 3) for r in recs],
            "full_gcs": [r["gc_n"][2] for r in recs], "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
