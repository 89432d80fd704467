"""Run one cell of BENCHMARK.json once and print the result as the last
line of standard output:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds the port (`bulletproofs_tpu_torch`)
on a machine with the CUDA cards the cell asks for; without them it exits
with 2 and prints no result.  Everything a cell needs is found by name:
its configuration `configs/<config>.json`, its traffic
`traffic/<traffic>.json` and the system under test that the traffic
names, `systems/<system>.py`, and one reader a metric,
`metrics/<metric>.py`.  A cell held back from BENCHMARK.json, its entries
in `pending/<cell>.json`, runs the same way (`load_bench`).

A run: set-up (the system's inputs from the seed, the program's tables,
two warm-up calls of the cell's own shape), then a closed loop of calls
for `--seconds` (the last call that starts in time ends the window),
then the comparison of the calls kept from the window against the plain
reference.  Set-up ends by freezing the heap it made (`gc.freeze`), as a
long-running service does after start-up: the cyclic collector's
collections in the window then scan what the calls made, not the
modules, tables and statement pool of set-up, whose size would set the
length of every full collection.  The calls kept for the comparison are
turned into bytes as they are kept, so that no proof objects outlive
their call.  With `--trace 1` the benchmark's spans and torch.profiler
are on over the window, and the per-layer metrics are read from them in
place of the end-to-end ones."""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import random
import sys
import time
from typing import List, Optional

_T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "bulletproofs_tpu")
KEEP_CALLS = 2


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module was imported where /proc has no record."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def load_json(*parts) -> dict:
    """A JSON file by its path from the checkout's root."""
    with open(os.path.join(ROOT, *parts)) as fh:
        return json.load(fh)


def load_bench(root: Optional[str] = None) -> dict:
    """BENCHMARK.json, with the entries of the cells held back from it
    (`pending/<cell>.json`: a configuration, the cell and its metrics,
    without bounds) that it does not name yet.  A held-back cell runs as
    any other, so that a later PR can measure it before it moves the
    entries into BENCHMARK.json; its metrics list their cells, so no cell
    of BENCHMARK.json reports them."""
    root = root or ROOT
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    pending = os.path.join(root, "portbench", "pending")
    for name in sorted(os.listdir(pending) if os.path.isdir(pending) else ()):
        with open(os.path.join(pending, name)) as fh:
            extra = json.load(fh)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            have = {e["name"] for e in bench[key]}
            bench[key] += [e for e in extra[key] if e["name"] not in have]
    return bench


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that the cell
    reports: those that list it, and those that list no cells (a per-layer
    one then in every cell that reports the end-to-end metric it moves)."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader(name: str):
    return importlib.import_module(f"portbench.metrics.{name}")


class Run:
    """What one run recorded, as the metric readers see it."""

    def __init__(self):
        self.latencies_s: List[float] = []
        self.failed = 0
        self.window_s = 0.0
        self.setup_s = 0.0
        self.outputs = 0
        self.spans = None
        self.timeline = None
        self.card = {}
        self.shape = {}


def cell_parts(bench: dict, workload: str):
    """A cell of `bench` by name -> (its entry, its configuration, its
    traffic, the System class its traffic names)."""
    cell = next((c for c in bench["workloads"] if c["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in the benchmark")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(cfg_entry["file"])
    traffic = load_json("portbench", "traffic", cell["traffic"] + ".json")
    system = importlib.import_module(f"portbench.systems.{traffic['system']}")
    return cell, cfg, traffic, system.System


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", workers: Optional[int] = None,
             bench: Optional[dict] = None, log=print) -> dict:
    """One run of a cell -> the result object (without the check of the
    loaded modules, which main() makes)."""
    bench = bench or load_bench()
    cell, cfg, traffic, System = cell_parts(bench, workload)
    t_in = process_age_s()
    system = System(cfg, traffic, seed, device)
    t_sys = process_age_s()
    import torch
    from . import trace as T
    from .spans import PREFIX, Spans

    run = Run()
    run.shape = system.shape()
    if trace and device != "cpu":
        from . import work
        run.card = work.card()
    system.warm_up()
    if device != "cpu":
        torch.cuda.synchronize()
    log(f"setup: {t_in:.2f} s to the system, {t_sys - t_in:.2f} s in it "
        f"({system.setup_log}), {process_age_s() - t_sys:.2f} s of warm-up",
        file=sys.stderr)
    kept, sampler = [], random.Random(seed * 4 + 2)
    gc.collect()
    gc.freeze()
    if trace:
        run.spans = Spans()
        system.install(run.spans)
        prof = T.start()
        window = torch.profiler.record_function(PREFIX + "window")
        window.__enter__()
    run.setup_s = process_age_s()
    t0 = time.perf_counter()
    i = 0
    try:
        while i == 0 or time.perf_counter() - t0 < seconds:
            try:
                dt, out = system.call(i)
            except Exception as e:           # counted, and the run goes on
                run.failed += 1
                log(f"call {i} failed: {e!r}", file=sys.stderr)
            else:
                run.latencies_s.append(dt)
                # a uniform sample of KEEP_CALLS calls (reservoir)
                if len(kept) < KEEP_CALLS:
                    kept.append(system.record(out))
                else:
                    j = sampler.randrange(i + 1)
                    if j < KEEP_CALLS:
                        kept[j] = system.record(out)
                del out
            i += 1
        run.window_s = time.perf_counter() - t0
    finally:
        gc.unfreeze()
        if trace:
            window.__exit__(None, None, None)
            prof.stop()
            run.spans.close()
    run.outputs = len(run.latencies_s) * system.outputs_per_call
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    if trace:
        t_parse = time.perf_counter()
        run.timeline = T.Timeline(prof)
        log(f"trace: {run.timeline.ops()} device operations, device ranges "
            f"{ {k: len(v) for k, v in run.timeline.mirrored.items()} }, read "
            f"in {time.perf_counter() - t_parse:.1f} s", file=sys.stderr)
        del prof

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, workload, kind):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    records = kept
    system.free()
    t_check = time.perf_counter()
    got = system.compare(records, workers if workers is not None
                         else min(6, os.cpu_count() or 1), sampler)
    log(f"check: {got['checked']} proofs of {len(records)} calls compared in "
        f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    numbers = {k: {"value": v, "limit": got["limits"][k]}
               for k, v in got["numbers"].items()}
    numbers["failed_calls"] = {"value": run.failed, "limit": 0}
    correct = bool(records) and all(x["value"] <= x["limit"]
                                    for x in numbers.values())

    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct,
              "attempted": len(run.latencies_s) + run.failed,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.timeline.busy_s
        dev["window_s"] = run.timeline.window_s
        result["breakdown"] = run.timeline.breakdown()
    result["check"] = numbers
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_bench()
    cell = next((c for c in bench["workloads"]
                 if c["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in the benchmark",
              file=sys.stderr)
        return 2
    # one process with one host thread: the prover's host glue is serial,
    # and idle OpenMP workers on the card's shared cores spread its walls
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
