"""Kernel K2 (the batch-verification scalar emit) of the PyTorch port,
through its plain PyTorch version on the CPU, against the JAX package's
XLA twin of the Pallas emit, ops/verify_stages.emit_scalars, on the same
challenge blocks (P = 256 proofs: 32 port tiles, two Pallas tiles).

Compared exactly, as canonical scalars mod l: every dynamic coefficient
(the base-16 sum of the port's signed digits) and every static g/h sum."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bulletproofs_tpu.ops import verify_stages as VST

from bulletproofs_tpu_torch.core.scalar import L as ELL
from bulletproofs_tpu_torch.ops import verify as V
from bulletproofs_tpu_torch.ops.limbs import sc_limbs_to_ints

P = 256


def _jax_ints(cols: np.ndarray):
    """(20, K) 13-bit lazy limbs -> K ints mod l."""
    return [sum(int(v) << (13 * k) for k, v in enumerate(cols[:, i])) % ELL
            for i in range(cols.shape[1])]


@pytest.mark.parametrize("n,m", [(8, 1), (64, 1)])
def test_emit_matches_jax_emit_scalars(n, m):
    lg, nblk, n_dyn = V.shape(n, m)
    r = random.Random(41 + n)
    vals = [r.randrange(ELL) for _ in range(P * nblk)]
    blk = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                        np.uint8).reshape(P * nblk, 32).copy()
    pair = np.zeros((2, 32), np.uint8)
    dyn_ref, static_ref = jax.device_get(
        VST.emit_scalars(n, m, jnp.asarray(blk), jnp.asarray(pair)))

    digits, partial = V.emit(n, m, torch.as_tensor(blk).reshape(P, nblk, 32))
    assert digits.shape == (64, P * n_dyn) and digits.dtype == torch.int8
    assert partial.shape == (P // V.EMIT_TILE, 2, n * m, 9)
    d = digits.numpy().astype(object)
    weights = np.array([1 << (4 * w) for w in range(64)], dtype=object)
    dyn = [int(x) for x in weights @ d]
    assert dyn == _jax_ints(np.asarray(dyn_ref))

    gh = V.tree_sum(partial)                                # (2, nm, 9)
    nm = n * m
    ref = _jax_ints(np.asarray(static_ref))
    assert sc_limbs_to_ints(gh[0].T.numpy()) == ref[2: 2 + nm]
    assert sc_limbs_to_ints(gh[1].T.numpy()) == ref[2 + nm:]


def test_emit_padding_proofs_contribute_nothing():
    """A sub-batch that is not a multiple of the tile: zero challenge
    blocks (the padding of the last tile) add exactly zero to g/h."""
    n, m = 8, 2
    lg, nblk, n_dyn = V.shape(n, m)
    r = random.Random(43)
    vals = [r.randrange(ELL) for _ in range(13 * nblk)]
    blk = torch.as_tensor(np.frombuffer(
        b"".join(v.to_bytes(32, "little") for v in vals), np.uint8
    ).reshape(13, nblk, 32).copy())
    padded = torch.cat([blk, torch.zeros((3, nblk, 32), dtype=torch.uint8)])
    d1, p1 = V.emit(n, m, blk)
    d2, p2 = V.emit(n, m, padded)
    assert torch.equal(d1, d2[:, : 13 * n_dyn])
    assert (d2[:, 13 * n_dyn:] == 0).all()
    assert torch.equal(V.tree_sum(p1), V.tree_sum(p2))


def test_emit_rejects_bad_shapes():
    with pytest.raises(ValueError):
        V.emit(64, 1, torch.zeros((4, 13, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        V.emit(48, 1, torch.zeros((4, 13, 32), dtype=torch.uint8))
