"""The batch prover's own spans (tracing.py) over a benchmark cell, from
the root of a checkout on a CUDA card:

    python -m bulletproofs_tpu_torch.benches.prove_spans
        --workload rp64x16.prove --seed <n> --seconds 40 [--trace 1]

It runs the cell as `python3 -m portbench.run ... --trace <0|1>` does
(`portbench.run.run_cell`), with the port's recorder on, and prints one
JSON line: the benchmark's result, and with `--trace 1` (the default),
under "program", the readings and the table of spans that
`portbench/program_spans.py` computes from the recorder's records laid
over the traced timeline.  With `--trace 0` the run is untraced with the
recorder on: against `python3 -m portbench.run --trace 0` on the same
seed (the recorder off) it gives the recorder's cost."""

from __future__ import annotations

import argparse
import json
import sys


def run(workload: str, seed: int, seconds: float, trace: bool,
        **cell) -> dict:
    """One run of the cell with the recorder on (`cell`: run_cell's
    device, workers, bench) -> its result, with the program's readings
    where traced."""
    from portbench import program_spans as P
    from portbench import run as RUN
    from portbench import trace as T
    from portbench.systems import prove_batch

    from .. import tracing
    kept = {}

    class Timeline(T.Timeline):
        def __init__(self, prof):
            super().__init__(prof)
            kept["tl"] = self

    timeline, install = T.Timeline, prove_batch.System.install

    def install_with_recorder(self, spans):
        install(self, spans)
        tracing.reset()
        tracing.enable()
        spans._undo.append((tracing, "ON", False))

    tracing.reset()
    if trace:
        T.Timeline = Timeline
        prove_batch.System.install = install_with_recorder
    else:
        tracing.enable()
    try:
        result = RUN.run_cell(workload, seed, seconds, trace,
                              log=lambda *a, **k: None, **cell)
    finally:
        T.Timeline = timeline
        prove_batch.System.install = install
        tracing.disable()
    if trace:
        tl, recs = kept["tl"], tracing.records()
        calls = result["attempted"] - result["failed"]
        result["program"] = {"readings": P.readings(tl, recs, calls),
                             "spans": P.span_table(tl, recs, calls),
                             "clock_skew_us": P.clock_skew_us(tl, recs)}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)          # as portbench.run's OMP_NUM_THREADS=1
    if not torch.cuda.is_available():
        print("prove_spans: no CUDA device available", file=sys.stderr)
        return 2
    print(json.dumps(run(args.workload, args.seed, args.seconds,
                         bool(args.trace))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
