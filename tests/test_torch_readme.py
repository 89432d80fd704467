"""The port's README quick start runs as a test, as the JAX package's
does (tests/test_readme_example.py): the first python block under
"### Quick start (the port)" is executed as written (it asks for the
CPU), and its proofs are then verified by the JAX package too."""

import os
import re

import pytest
import torch

import bulletproofs_tpu as J


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions are long chains of small ops, which one intra-op
    thread runs fastest (several test workers share the cores); the
    setting is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _block():
    readme = open(os.path.join(os.path.dirname(__file__), "..",
                               "README.md")).read()
    return re.search(r"### Quick start \(the port\)\s+```python\n(.*?)```",
                     readme, re.S).group(1)


def test_port_readme_quick_start_runs():
    namespace = {}
    exec(compile(_block(), "README.md#quick-start-the-port", "exec"),
         namespace)
    proofs, commitments = namespace["proofs"], namespace["commitments"]
    assert len(proofs) == len(commitments) == len(namespace["values"]) == 2
    bp, pc = J.BulletproofGens(64, 1), J.PedersenGens()
    for p, c, label in zip(proofs, commitments, namespace["labels"]):
        J.RangeProof.from_bytes(p.to_bytes()).verify_single(
            bp, pc, J.Transcript(label), c, 64)


def test_port_readme_quick_start_shape():
    """The block imports only the port, asks for the CPU, and keeps the
    reference doctest's value and label."""
    block = _block()
    assert "bulletproofs_tpu_torch" in block
    assert not re.search(r"\bbulletproofs_tpu\b(?!_torch)", block)
    assert 'device = "cpu"' in block
    assert "1037578891" in block and 'b"doctest example' in block
