"""Everything a cell needs is found by name: a configuration, a traffic
mix and a per-layer metric dropped in as new files are picked up with no
other file edited; which metrics a cell reports follows BENCHMARK.json
and the cells held back from it (`portbench/pending/`)."""

import json
import os

import pytest
from conftest import TINY_CFG, TINY_TRAFFIC, tiny_bench

import portbench.metrics
from portbench import run as RUN


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "traffic").mkdir(parents=True)
    with open(tmp_path / "portbench" / "configs" / "tiny.json", "w") as fh:
        json.dump(TINY_CFG, fh)
    with open(tmp_path / "portbench" / "traffic" / "fresh_mix.json", "w") as fh:
        json.dump(dict(TINY_TRAFFIC, pool_batches=3), fh)
    metrics_dir = tmp_path / "new_metrics"
    metrics_dir.mkdir()
    (metrics_dir / "calls_seen.py").write_text(
        'UNIT = "calls"\nLAYER = "test layer"\nMOVES = "prove_outputs_per_s"\n'
        "\n\ndef read(run):\n    return float(len(run.latencies_s))\n")
    monkeypatch.setattr(RUN, "ROOT", str(tmp_path))
    monkeypatch.setattr(portbench.metrics, "__path__",
                        [str(metrics_dir)] + list(portbench.metrics.__path__))
    bench = tiny_bench(cells=(("tiny.fresh_mix", "tiny", "fresh_mix"),))
    bench["end_to_end"].append({"name": "calls_seen", "unit": "calls",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["tiny.fresh_mix"]})
    res = RUN.run_cell("tiny.fresh_mix", 5, 0.01, False, device="cpu",
                       workers=1, bench=bench, log=lambda *a, **k: None)
    assert res["correct"]
    assert res["metrics"]["calls_seen"]["value"] == res["attempted"]


def test_cell_metrics_follow_benchmark_json():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "p", "moves": "a"},
                           {"name": "q", "moves": "b"},
                           {"name": "r", "moves": "a", "workloads": ["y"]}]}
    names = lambda c, k: [m["name"] for m in RUN.cell_metrics(bench, c, k)]
    assert names("x", "end_to_end") == ["a", "b"]
    assert names("y", "end_to_end") == ["a"]
    assert names("x", "per_layer") == ["p", "q"]
    assert names("y", "per_layer") == ["p", "r"]


def test_every_metric_has_a_reader_that_agrees():
    bench = RUN.load_bench()
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = RUN.reader(m["name"])
        assert mod.UNIT == m["unit"], m["name"]
        if "layer" in m:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


PROVE_E2E = {"prove_outputs_per_s", "prove_call_p90_ms", "setup_s"}
PROVE_LAYER = {"prove_entry_host_ms", "host_fs_ms", "gc_ms_per_call",
               "launches_per_call", "fixed_msm_roofline", "device_idle_pct"}


@pytest.mark.parametrize("cell,e2e,layer", [
    ("rp64x16.prove", PROVE_E2E, PROVE_LAYER),
    ("rp64x8.prove", PROVE_E2E, PROVE_LAYER),
    ("rp64x1.verify", {"verify_outputs_per_s", "verify_call_p90_ms",
                       "setup_s"},
     {"verify_replay_host_ms", "verify_serialize_host_ms",
      "verify_gc_ms_per_call", "verify_device_idle_pct"}),
])
def test_each_cell_reports_its_own_metrics(cell, e2e, layer):
    """The prove cells report exactly what they reported before the verify
    cell came, with or without the held-back cells; the verify cell (held
    back) its own two metrics, setup_s and its four per-layer metrics."""
    with open(os.path.join(RUN.ROOT, "BENCHMARK.json")) as fh:
        alone = json.load(fh)
    for bench in (alone, RUN.load_bench()):
        if cell not in {c["name"] for c in bench["workloads"]}:
            continue
        names = lambda k: {m["name"]
                           for m in RUN.cell_metrics(bench, cell, k)}
        assert names("end_to_end") == e2e
        assert names("per_layer") == layer


def test_held_back_cells_stay_apart():
    """A held-back cell is in no entry of BENCHMARK.json, its metrics have
    no bounds yet and name only held-back cells."""
    with open(os.path.join(RUN.ROOT, "BENCHMARK.json")) as fh:
        alone = json.load(fh)
    bench = RUN.load_bench()
    held = {c["name"] for c in bench["workloads"]} - {
        c["name"] for c in alone["workloads"]}
    assert held == {"rp64x1.verify"}
    for key in ("end_to_end", "per_layer"):
        for m in bench[key][len(alone[key]):]:
            assert "bound" not in m and set(m["workloads"]) <= held, m
