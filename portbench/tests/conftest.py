"""A tiny cell for the CPU: n = 8, m = 2, two proofs a call, in a
checkout root of its own (configuration and traffic files), run through
the port's plain PyTorch route (`device="cpu"`)."""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import run as RUN  # noqa: E402

TINY_CFG = {"name": "tiny", "n": 8, "m": 2,
            "transcript_label": "AggregateRangeProofBenchmark",
            "reduced": []}
TINY_TRAFFIC = {"system": "prove_batch", "outputs_per_call": 4,
                "pool_batches": 2, "value_bits": 8}


def tiny_bench(cells=(("tiny.prove", "tiny", "tiny"),), like="rp64x16.prove"):
    """The benchmark (with its held-back cells) with the tiny configuration
    and `cells` in place of its own; the tiny cells report the metrics
    that cell `like` does."""
    bench = RUN.load_bench(REPO)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"] = [n for n, _, _ in cells]
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                           "why": "test"} for n, c, t in cells]
    return bench


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A root holding the tiny configuration and traffic, made the
    harness's root -> the benchmark dict of its one cell."""
    for sub, body in (("configs", TINY_CFG), ("traffic", TINY_TRAFFIC)):
        os.makedirs(tmp_path / "portbench" / sub)
        with open(tmp_path / "portbench" / sub / "tiny.json", "w") as fh:
            json.dump(body, fh)
    monkeypatch.setattr(RUN, "ROOT", str(tmp_path))
    return tiny_bench()


def run_tiny(bench, seed=7, trace=False):
    return RUN.run_cell("tiny.prove", seed, 0.01, trace, device="cpu",
                        workers=1, bench=bench, log=lambda *a, **k: None)
