"""Everything a cell needs is found by name: a configuration, a traffic
mix and a per-layer metric dropped in as new files are picked up with no
other file edited; which metrics a cell reports follows BENCHMARK.json."""

import json
import os

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
    with open(os.path.join(RUN.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = RUN.reader(m["name"])
        assert mod.UNIT == m["unit"], m["name"]
        if "layer" in m:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
