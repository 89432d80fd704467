"""The frozen arithmetic: rate and p90 over synthetic call lists, spreads,
the union of intervals (overlapping ones included), the idle share, and
the last line a run prints."""

import json
import math
import subprocess
import sys

import pytest
from conftest import REPO

from portbench import stats


def test_rate_is_all_work_over_all_time():
    assert stats.rate(4096 * 150, 30.5) == pytest.approx(4096 * 150 / 30.5)
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_p90_over_every_call():
    lat = [100.0 + k for k in range(101)]           # 100 .. 200
    assert stats.percentile(lat, 90) == pytest.approx(190.0)
    assert stats.percentile(list(reversed(lat)), 90) == pytest.approx(190.0)
    # a stall far out moves the p90 only by its rank, not by its size
    lat[-1] = 10_000.0
    assert stats.percentile(lat, 90) == pytest.approx(190.0)
    two = [10.0, 20.0]
    assert stats.percentile(two, 90) == pytest.approx(19.0)
    with pytest.raises(ValueError):
        stats.percentile([1.0], 90)


@pytest.mark.parametrize("intervals,union,covered,gaps", [
    ([(0, 1), (2, 3)], [(0, 1), (2, 3)], 2.0, [(1, 2), (3, 4)]),
    ([(0, 2), (1, 3)], [(0, 3)], 3.0, [(3, 4)]),
    ([(1, 3), (0, 4), (2, 2.5)], [(0, 4)], 4.0, []),
    ([(0.5, 1), (1, 1.5), (3, 5)], [(0.5, 1.5), (3, 5)], 2.0,
     [(0, 0.5), (1.5, 3)]),
    ([(-1, 0.25), (3.75, 9)], [(-1, 0.25), (3.75, 9)], 0.5, [(0.25, 3.75)]),
    ([], [], 0.0, [(0, 4)]),
])
def test_union_covered_and_gaps(intervals, union, covered, gaps):
    assert stats.union(intervals) == union
    assert stats.covered(intervals, 0, 4) == pytest.approx(covered)
    assert stats.gaps(intervals, 0, 4) == gaps
    # busy and idle fill the window
    idle = sum(e - s for s, e in stats.gaps(intervals, 0, 4))
    assert covered + idle == pytest.approx(4.0)


def test_idle_share_reader_on_a_synthetic_timeline():
    from portbench.metrics import device_idle_pct

    class TL:
        busy_s, window_s = 7.5, 10.0

    class Run:
        timeline = TL()
    assert device_idle_pct.read(Run()) == pytest.approx(25.0)
    TL.busy_s = 0.0
    assert device_idle_pct.read(Run()) is None


def test_no_card_no_result():
    """Without a CUDA card the run fails and prints nothing on stdout."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "rp64x16.prove", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_last_line_parses(tiny):
    """The result a run prints is one JSON object with the contract's keys,
    its comparison last, each number beside its limit."""
    from conftest import run_tiny
    line = json.dumps(run_tiny(tiny))
    res = json.loads(line.splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-1] == "check"
    for v in res["check"].values():
        assert set(v) == {"value", "limit"}
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])


def test_import_guard_compares_whole_top_level_names(monkeypatch, capsys):
    """A loaded module of JAX or of the JAX package fails the run with no
    result; the port's name, which begins with the JAX package's, does
    not."""
    import types

    import torch

    from portbench import run as RUN
    monkeypatch.setitem(sys.modules, "bulletproofs_tpu_torch.fake",
                        types.ModuleType("x"))
    before = RUN.forbidden_modules()
    assert "bulletproofs_tpu_torch.fake" not in before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(RUN, "run_cell", lambda *a, **k: {"check": {}})
    assert RUN.main(["--workload", "rp64x16.prove", "--seed", "1",
                     "--seconds", "1"]) == (3 if before else 0)
    capsys.readouterr()
    for name in ("jax", "jaxlib.xla_client", "flax", "bulletproofs_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(RUN.forbidden_modules()) >= {"jax", "jaxlib.xla_client",
                                            "flax", "bulletproofs_tpu.ops"}
    assert "bulletproofs_tpu_torch.fake" not in RUN.forbidden_modules()
    assert RUN.main(["--workload", "rp64x16.prove", "--seed", "1",
                     "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "JAX" in out.err


def test_overlap_counts_each_interval_inside_the_cover():
    ops = [(0, 1), (1, 2), (2.5, 3.5), (5, 6)]
    within = [(0.5, 3), (2.9, 3.2), (5.5, 10)]
    assert stats.overlap(ops, within) == pytest.approx(0.5 + 1 + 0.7 + 0.5)
    assert stats.overlap(ops, []) == 0.0


class _Event:
    def __init__(self, name, start, end, device):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1e9)

    def duration_ns(self):
        return int((self._e - self._s) * 1e9)

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"


def test_timeline_on_synthetic_events():
    """Busy time is the union of device operations (the mirrored ranges
    are not work); a span's device time is its operations inside its
    mirrored ranges; idle gaps go to the innermost host span."""
    from types import SimpleNamespace

    from portbench.trace import OUTSIDE, Timeline
    ev = [_Event("pb.window", 0, 10, False),
          _Event("pb.prove_batch", 1, 8.5, False),
          _Event("pb.assemble", 7.1, 7.4, False),
          _Event("pb.fixed_msm", 2, 3, False),
          _Event("pb.fixed_msm", 2.5, 6.5, True),          # mirrored range
          _Event("pb.prove_batch", 2.5, 8, True),
          _Event("k6", 2.5, 5, True), _Event("k7", 5, 6.5, True),
          _Event("copy", 6, 7, True),                      # overlaps k7
          _Event("late", 7.5, 8, True),
          _Event("outside", 9.5, 11, True),                # clipped
          _Event("aten::cat", 2.1, 2.2, False)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    tl = Timeline(prof)
    assert (tl.lo, tl.hi, tl.window_s) == (0, 10, 10)
    assert tl.ops() == 5
    assert tl.busy_s == pytest.approx(4.5 + 0.5 + 0.5)
    assert tl.span_device_s("fixed_msm") == pytest.approx(2.5 + 1.5 + 0.5)
    assert tl.span_device_s("absent") == 0.0
    bd = tl.breakdown()
    assert bd["device_ops"][0] == ["k6", pytest.approx(2.5)]
    idle = dict(bd["idle_gaps"])
    # gaps [0, 2.5], [7, 7.5] and [8, 9.5], each by its middle
    assert idle == {"prove_batch": pytest.approx(2.5),
                    "assemble": pytest.approx(0.5),
                    OUTSIDE: pytest.approx(1.5)}
