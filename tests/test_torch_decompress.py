"""Kernel K1 (batch ristretto decompression) of the PyTorch port, through
its plain PyTorch version on the CPU, against the JAX package: the Pallas
kernel msm_pallas.decompress_lanes in interpret mode and the XLA
vec_curve.decompress_device, on the same encodings.

Compared at canonical boundaries, exactly: the validity flags, and each
valid point's compressed bytes (ristretto equality) against the JAX
package's point and the input encoding."""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bulletproofs_tpu.ops import msm_pallas as MP
from bulletproofs_tpu.ops import vec_curve as JC

from bulletproofs_tpu_torch.core.field import P
from bulletproofs_tpu_torch.core.ristretto import RISTRETTO_BASEPOINT
from bulletproofs_tpu_torch.core.scalar import L as ELL, Scalar
from bulletproofs_tpu_torch.ops import curve as C

HERE = os.path.dirname(os.path.abspath(__file__))
N = 256


def _encodings() -> np.ndarray:
    """(256, 32) uint8: valid encodings (random multiples of the basepoint
    and the golden vectors' commitments), non-canonical (>= p), negative
    (odd), top-bit-set and random bytes."""
    r = random.Random(21)
    with open(os.path.join(HERE, "golden_vectors.json")) as fh:
        gold = [bytes.fromhex(h) for h in json.load(fh)["value_commitments"]]
    enc = list(gold)
    enc += [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
            .compress() for _ in range(120)]
    enc += [(P + k).to_bytes(32, "little") for k in range(1, 19, 2)]
    enc += [bytes([e[0] | 1]) + e[1:] for e in enc[8:28]]
    enc += [e[:31] + bytes([e[31] | 128]) for e in enc[28:48]]
    enc += [bytes(32)]
    while len(enc) < N:
        b = bytearray(r.randbytes(32))
        b[0] &= 254
        b[31] &= 127
        enc.append(bytes(b))
    return np.frombuffer(b"".join(enc), np.uint8).reshape(N, 32).copy()


@pytest.fixture(scope="module")
def port_result():
    raw = _encodings()
    valid, pts = C.decompress(torch.as_tensor(raw))
    return raw, valid.numpy(), C.lanes_to_points(pts.numpy())


def _check(port_result, j_valid, j_pts):
    raw, valid, pts = port_result
    j_valid = np.asarray(j_valid).astype(bool)
    assert (valid == j_valid).all()
    assert 100 < valid.sum() < N                # both kinds are exercised
    jpoints = JC.lanes_to_points(np.asarray(j_pts))
    for i in np.flatnonzero(valid):
        assert pts[i].compress() == jpoints[i].compress() == raw[i].tobytes()


def test_decompress_matches_jax_pallas_interpret(port_result):
    raw = port_result[0]
    limbs = JC.device_limbs_from_bytes(jnp.asarray(raw))
    old = MP._INTERPRET
    MP._INTERPRET = True
    try:
        valid, pts = MP.decompress_lanes(limbs)
        valid, pts = jax.device_get((valid, pts))
    finally:
        MP._INTERPRET = old
    # the Pallas kernel decodes only; the canonical mask is applied beside it
    canonical = np.asarray(JC.device_canonical_mask(jnp.asarray(raw)))
    _check(port_result, np.asarray(valid) & canonical, pts)


def test_decompress_matches_jax_xla(port_result):
    valid, pts = JC.decompress_device(jnp.asarray(port_result[0]))
    _check(port_result, *jax.device_get((valid, pts)))


def test_decompress_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        C.decompress(torch.zeros((4, 31), dtype=torch.uint8))
    with pytest.raises(ValueError):
        C.decompress(torch.zeros((4, 32), dtype=torch.int32))
