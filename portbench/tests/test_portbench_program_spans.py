"""The readers of the program's spans (portbench/program_spans.py) on
hand-made timelines and records: known gaps, nested spans, a window that
cuts spans, and None where the run was not traced."""

from types import SimpleNamespace

import pytest

from portbench import program_spans as P


def _timeline(device, lo, hi):
    return SimpleNamespace(device=[(s, e, "k") for s, e in device], lo=lo,
                           hi=hi, ops=lambda: len(device),
                           ranges={"prove_batch": [(0.5001, 7.5)]})


def _records(*spans):
    """(name, parent index, t0 s, t1 s, launches) -> records as the
    program's recorder keeps them."""
    return [SimpleNamespace(call=1, name=name, parent=parent,
                            t0_ns=int(t0 * 1e9), t1_ns=int(t1 * 1e9),
                            counts={"launches": n} if n else {})
            for name, parent, t0, t1, n in spans]


# the card busy in [0, 1], [2, 3], [5, 6]: idle in (1, 2), (3, 5), (6, 8)
DEVICE = [(0.0, 1.0), (2.0, 3.0), (5.0, 6.0)]
RECS = _records(("prove", None, 0.5, 7.5, 0),
                ("prove.check", 0, 0.5, 1.5, 0),
                ("prove.stage0", 0, 1.5, 2.5, 1),
                ("prove.fetch", 0, 2.5, 4.0, 0),
                ("prove.round", 0, 4.0, 5.5, 1),
                ("prove.assemble", 0, 5.5, 7.0, 0))


def test_readers_on_known_gaps_and_nested_spans():
    got = P.readings(_timeline(DEVICE, 0.0, 8.0), RECS, calls=2)
    # entry: check 0.5 s (1 to 1.5), assemble 1.0 (6 to 7), and the
    # root's own self time 0.5 (7 to 7.5): 2.0 s over two calls
    assert got["entry_idle_ms"] == pytest.approx(1000.0)
    # stages: stage0 0.5 s (1.5 to 2), round 1.0 (4 to 5)
    assert got["issue_idle_ms"] == pytest.approx(750.0)
    assert got["fetch_wait_ms"] == pytest.approx(750.0)
    assert got["torch_ops_per_call"] == pytest.approx((3 - 2) / 2)
    table = P.span_table(_timeline(DEVICE, 0.0, 8.0), RECS, 2)
    assert table["prove"]["idle_ms"] == pytest.approx(250.0)
    assert table["prove"]["self_ms"] == pytest.approx(250.0)
    assert table["prove.round"]["counts"] == {"launches": 0.5}
    assert table["prove.fetch"]["idle_ms"] == pytest.approx(500.0)


def test_readers_clip_a_span_partly_outside_the_window():
    # the window [1.25, 3.5]: idle (1.25, 2) and (3, 3.5); check and
    # fetch cut at the window's edges; round and assemble outside it
    got = P.readings(_timeline(DEVICE, 1.25, 3.5), RECS, calls=1)
    assert got["entry_idle_ms"] == pytest.approx(250.0)
    assert got["issue_idle_ms"] == pytest.approx(500.0)
    assert got["fetch_wait_ms"] == pytest.approx(1000.0)
    assert got["torch_ops_per_call"] == pytest.approx(3 - 1)


def test_a_child_span_inside_a_child_is_not_the_parents_self_time():
    # stage0 holds a fetch: of the idle (1, 2), stage0's self time takes
    # 1 to 1.5, and the fetch's 1.5 to 2 is neither stage0's nor the
    # root's, whose self time (0.5 to 1, 2.5 to 3) sees the card busy
    recs = _records(("prove", None, 0.5, 3.0, 0),
                    ("prove.stage0", 0, 1.0, 2.5, 2),
                    ("prove.fetch", 1, 1.5, 2.0, 0))
    got = P.readings(_timeline(DEVICE, 0.0, 3.0), recs, calls=1)
    assert got["entry_idle_ms"] == pytest.approx(0.0)
    assert got["issue_idle_ms"] == pytest.approx(500.0)
    assert got["fetch_wait_ms"] == pytest.approx(500.0)
    table = P.span_table(_timeline(DEVICE, 0.0, 3.0), recs, 1)
    assert table["prove"]["self_ms"] == pytest.approx(1000.0)
    assert table["prove.stage0"]["self_ms"] == pytest.approx(1000.0)


def test_clock_skew_pairs_each_root_with_the_benchmarks_range():
    tl = _timeline(DEVICE, 0.0, 8.0)
    assert P.clock_skew_us(tl, RECS) == pytest.approx(100.0)
    assert P.clock_skew_us(tl, RECS + RECS[:1]) is None
    assert P.clock_skew_us(None, RECS) is None


def test_readers_return_none_on_an_untraced_run():
    tl = _timeline(DEVICE, 0.0, 8.0)
    for read in (P.readings, P.span_table):
        assert read(None, RECS, 2) is None
        assert read(tl, [], 2) is None
        assert read(tl, RECS, 0) is None
