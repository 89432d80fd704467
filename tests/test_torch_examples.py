"""Each example of the port (bulletproofs_tpu_torch/examples/) runs to
completion on the CPU at the JAX package's test sizes (tests/
test_examples.py) or smaller, in a process of its own, and leaves neither
`jax` nor `bulletproofs_tpu` in that process's sys.modules."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs the module as `python -m` would, then checks what it imported
WRAPPER = """
import runpy, sys
name = sys.argv[1]
sys.argv = [name] + sys.argv[2:]
runpy.run_module(name, run_name="__main__", alter_sys=True)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "bulletproofs_tpu"))
if bad:
    raise SystemExit(f"the example imported {bad[:5]}")
print("no jax, no bulletproofs_tpu")
"""

EXAMPLES = [
    ("range_proof", []),
    ("mpc_aggregation", []),
    ("mpc_multiprocess", ["2"]),
    ("r1cs_gadget", ["4"]),
    ("batch_throughput", ["2"]),
]


@pytest.mark.parametrize("name,args", EXAMPLES, ids=[n for n, _ in EXAMPLES])
def test_example_runs_on_the_cpu(name, args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    # the plain versions are long chains of small ops: one intra-op thread
    # each, as several test workers share the cores
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", WRAPPER,
         f"bulletproofs_tpu_torch.examples.{name}", *args, "--device", "cpu"],
        capture_output=True, timeout=600, text=True, env=env, cwd=ROOT)
    assert proc.returncode == 0, (
        f"{name} failed:\n{proc.stdout}\n{proc.stderr}")
    assert proc.stdout.rstrip().endswith("no jax, no bulletproofs_tpu"), \
        proc.stdout
