"""The port's recorder (bulletproofs_tpu_torch/tracing.py) around the batch
prover: off it reads no clock and allocates nothing; on, one call of
prove_batch is one `prove` root with the declared spans under it, whose
counters match the call's uploads and fetches; the proofs are the same
bytes either way; and the spans' times lie on torch.profiler's clock.
The last test runs on the card (marked `gpu`)."""

import random
import tracemalloc

import pytest
import torch

import bulletproofs_tpu_torch as T
from bulletproofs_tpu_torch import tracing
from bulletproofs_tpu_torch.ops import _cuda
from bulletproofs_tpu_torch.proofs import batch_prover as BPM

N_BITS, M_AGG, COUNT = 8, 2, 3
ROUNDS = (N_BITS * M_AGG).bit_length() - 2      # IPP rounds after round 0

# span -> its declared parent (every one sits directly under the root)
PARENTS = {"prove": None, "prove.check": "prove",
           "prove.statements": "prove", "prove.stage0": "prove",
           "prove.fetch": "prove", "prove.fs": "prove", "prove.mid": "prove",
           "prove.round": "prove", "prove.fin": "prove",
           "prove.writeback": "prove", "prove.assemble": "prove"}
CALLS = {"prove": 1, "prove.check": 1, "prove.statements": 1,
         "prove.stage0": 1, "prove.fetch": 2, "prove.fs": 1, "prove.mid": 1,
         "prove.round": ROUNDS, "prove.fin": 1, "prove.writeback": 1,
         "prove.assemble": 1}


class Rng:
    def __init__(self, seed):
        self.r = random.Random(seed)

    def randbytes(self, n):
        return self.r.randbytes(n)


class _NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"the recorder read time.{name} while off")


@pytest.fixture(autouse=True)
def recorder():
    """Every test starts and ends with the recorder off and empty."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def prover():
    return T.BatchProver(T.BulletproofGens(N_BITS, M_AGG), T.PedersenGens(),
                         N_BITS, m=M_AGG, device="cpu")


def _prove(prover, seed=5):
    rng = Rng(seed)
    values = [[rng.r.randrange(1 << N_BITS) for _ in range(M_AGG)]
              for _ in range(COUNT)]
    blinds = [[T.Scalar(rng.r.randrange(1 << 250)) for _ in range(M_AGG)]
              for _ in range(COUNT)]
    ts = [T.Transcript(b"tracing %d" % i) for i in range(COUNT)]
    proofs, vcs = prover.prove_batch(values, blinds, ts, rng=rng)
    return [p.to_bytes() for p in proofs], vcs, [t.strobe.buf.raw for t in ts]


def test_off_reads_no_clock_and_records_nothing(prover, monkeypatch):
    monkeypatch.setattr(tracing, "time", _NoClock())
    _prove(prover)
    assert tracing.records() == [] and tracing.summary() == {}


def test_off_allocates_nothing():
    assert tracing.span("a") is tracing.span("b")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with tracing.span("prove.round"):
                tracing.count("launches")
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == tracing.__file__ and d.size_diff]
    assert grown == []


def test_on_one_root_and_the_declared_parents(prover):
    tracing.enable()
    _prove(prover)
    tracing.disable()
    recs = tracing.records()
    assert [r.name for r in recs if r.parent is None] == ["prove"]
    assert {r.call for r in recs} == {1}
    for r in recs:
        parent = None if r.parent is None else recs[r.parent].name
        assert parent == PARENTS[r.name], r.name
        assert r.t0_ns <= r.t1_ns
        if r.parent is not None:
            up = recs[r.parent]
            assert up.t0_ns <= r.t0_ns and r.t1_ns <= up.t1_ns
    summary = tracing.summary()
    assert {k: v["calls"] for k, v in summary.items()} == CALLS
    root = summary["prove"]["total_ms"]
    assert sum(v["self_ms"] for v in summary.values()) == pytest.approx(root)
    # a second call opens a second call id; disable() kept the first
    tracing.enable()
    _prove(prover)
    assert {r.call for r in tracing.records()} == {1, 2}


def test_proofs_and_transcripts_identical_on_and_off(prover):
    off = _prove(prover, seed=9)
    tracing.enable()
    on = _prove(prover, seed=9)
    assert on == off


def test_counters_match_the_uploads_and_fetches(prover, monkeypatch):
    uploaded, fetched = [], []
    real_upload, real_fetch = T.BatchProver._upload, BPM._fetch

    def upload(self, arr):
        uploaded.append(arr.nbytes)
        return real_upload(self, arr)

    def fetch(x):
        out = real_fetch(x)
        fetched.extend(out if isinstance(x, tuple) else (out,))
        return out

    monkeypatch.setattr(T.BatchProver, "_upload", upload)
    monkeypatch.setattr(BPM, "_fetch", fetch)
    tracing.enable()
    _prove(prover)
    counts = {}
    for row in tracing.summary().values():
        for k, v in row["counts"].items():
            counts[k] = counts.get(k, 0) + v
    assert counts["h2d_bytes"] == sum(uploaded) > 0
    assert counts["syncs"] == len(fetched) == 5    # vas; tb, lr, fin, st
    assert counts["d2h_bytes"] == sum(a.nbytes for a in fetched)
    assert "launches" not in counts                  # no kernel on the CPU
    by_span = tracing.summary()
    assert set(by_span["prove.fetch"]["counts"]) == {"syncs", "d2h_bytes"}
    assert set(by_span["prove.statements"]["counts"]) == {"h2d_bytes"}


def test_counts_outside_every_span_have_their_own_row():
    tracing.enable()
    tracing.count("launches", 3)
    with tracing.span("prove"):
        tracing.count("launches")
    summary = tracing.summary()
    assert summary[tracing.OUTSIDE]["counts"] == {"launches": 3}
    assert summary["prove"]["counts"] == {"launches": 1}


def test_spans_lie_on_the_profiler_clock():
    """A record_function range opened just outside a span starts and ends
    within 1 ms of it (the best of five pairs, after a first range that
    pays the profiler's lazy set-up; the clocks agree to microseconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        for i in range(5):
            with record_function(f"outer {i}"):
                with tracing.span(f"inner {i}"):
                    sum(range(10000))
    outer = {e.name(): e for e in prof.profiler.kineto_results.events()}
    starts, ends = [], []
    for r in tracing.records():
        o = outer["outer " + r.name.split()[1]]
        starts.append(abs(o.start_ns() - r.t0_ns))
        ends.append(abs(o.start_ns() + o.duration_ns() - r.t1_ns))
    assert len(starts) == 5
    assert min(starts) < 1_000_000 and min(ends) < 1_000_000


def test_counts_go_to_the_innermost_open_span():
    tracing.enable()
    with tracing.span("prove"):
        tracing.count("syncs")
        with tracing.span("prove.fetch"):
            tracing.count("syncs", 2)
            tracing.count("d2h_bytes", 64)
        tracing.count("syncs")
    summary = tracing.summary()
    assert summary["prove"]["counts"] == {"syncs": 2}
    assert summary["prove.fetch"]["counts"] == {"syncs": 2, "d2h_bytes": 64}
    recs = tracing.records()
    assert [r.parent for r in recs] == [None, 0]
    assert summary["prove"]["self_ms"] == pytest.approx(
        summary["prove"]["total_ms"] - summary["prove.fetch"]["total_ms"])


def test_a_span_left_by_an_exception_is_closed():
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span("prove"):
            with tracing.span("prove.check"):
                raise ValueError("out of range")
    with tracing.span("prove"):
        pass
    recs = tracing.records()
    assert [(r.call, r.name, r.parent) for r in recs] == [
        (1, "prove", None), (1, "prove.check", 0), (2, "prove", None)]
    assert all(r.t0_ns <= r.t1_ns for r in recs)


def test_disable_keeps_the_records_and_reset_drops_them():
    tracing.enable()
    with tracing.span("prove"):
        with pytest.raises(RuntimeError):
            tracing.reset()
    tracing.disable()
    with tracing.span("prove"):
        tracing.count("launches")
    assert [r.name for r in tracing.records()] == ["prove"]
    assert tracing.OUTSIDE not in tracing.summary()
    tracing.reset()
    assert tracing.records() == [] and tracing.summary() == {}
    tracing.enable()
    with tracing.span("prove"):
        pass
    assert [r.call for r in tracing.records()] == [1]


def test_the_per_stage_route_puts_its_transcript_calls_under_fs(prover):
    off = _prove(prover, seed=11)
    prover.fused = False
    try:
        tracing.enable()
        on = _prove(prover, seed=11)
        tracing.disable()
    finally:
        prover.fused = True
    recs = tracing.records()
    assert [r.name for r in recs if r.parent is None] == ["prove"]
    assert all(recs[r.parent].name == "prove" for r in recs
               if r.parent is not None)
    calls = {k: v["calls"] for k, v in tracing.summary().items()}
    # rp_ts_yz, rp_ts_x, rp_ts_w, and one rp_ts_round a round, round 0
    # included
    assert calls["prove.fs"] == 3 + ROUNDS + 1
    assert calls["prove.assemble"] == calls["prove.statements"] == 1
    assert on[0] == off[0] and on[2] == off[2]


@pytest.mark.gpu
def test_span_launches_sum_to_the_launch_counts():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gpu_prover = T.BatchProver(T.BulletproofGens(N_BITS, M_AGG),
                               T.PedersenGens(), N_BITS, m=M_AGG,
                               device="cuda")
    first = _prove(gpu_prover)                # builds and warms the kernels
    before = sum(_cuda.LAUNCHES.values())
    tracing.enable()
    got = _prove(gpu_prover)
    tracing.disable()
    rise = sum(_cuda.LAUNCHES.values()) - before
    summary = tracing.summary()
    spans = sum(r["counts"].get("launches", 0) for r in summary.values())
    assert got == first
    assert rise > 0 and spans == rise
    assert tracing.OUTSIDE not in summary
    assert summary["prove.round"]["counts"]["launches"] > 0
