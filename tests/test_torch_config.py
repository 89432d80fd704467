"""The port's settings (bulletproofs_tpu_torch.config) against the JAX
package's: every field of the JAX package's `Settings` is the port's too,
with its environment variable and default, except the fields that only
XLA or the TPU read (ROADMAP.md §1, "Left out on purpose")."""

import dataclasses
import os

import pytest

from bulletproofs_tpu import config as JC
from bulletproofs_tpu_torch import config as TC

# field -> why the port has no such knob
LEFT_OUT = {
    "compile_cache_dir": "XLA's persistent compile cache",
    "no_fold_pallas": "the Pallas fold kernel's fallback gate",
    "sharded_canonical": "one XLA-CPU executable shape for sharded MSMs",
    "segmented_round_pairing": "two IPP rounds in one XLA dispatch",
}


def _fields(cls):
    return {f.name: f for f in dataclasses.fields(cls)}


def test_port_has_every_field_but_the_named_ones():
    jax_f, port_f = _fields(JC.Settings), _fields(TC.Settings)
    assert set(jax_f) - set(port_f) == set(LEFT_OUT)
    assert set(port_f) <= set(jax_f)


@pytest.mark.parametrize("name", sorted(
    set(_fields(JC.Settings)) - set(LEFT_OUT)))
def test_shared_field_has_the_jax_default(name, monkeypatch):
    """With no BPTPU_* variable set, both packages' defaults agree."""
    for var in [v for v in os.environ if v.startswith("BPTPU_")]:
        monkeypatch.delenv(var)
    assert getattr(TC.Settings(), name) == getattr(JC.Settings(), name)
