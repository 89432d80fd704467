"""Kernel K5 (batch ristretto compression) of the PyTorch port, through its
plain PyTorch version on the CPU, against the JAX package's XLA
vec_curve.compress, its Pallas kernel msm_pallas.compress_lanes in
interpret mode, and the host RistrettoPoint.compress.

256 points: random multiples of the basepoint in random projective
representations (Z != 1, as the MSMs leave them), the identity in several
representations, and points plus 2- and 4-torsion (the same ristretto
point, so the same encoding).  Compared exactly, byte for byte."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bulletproofs_tpu.ops import msm_pallas as MP
from bulletproofs_tpu.ops import vec_curve as JC

from bulletproofs_tpu_torch.core.field import P, SQRT_M1
from bulletproofs_tpu_torch.core.ristretto import (RISTRETTO_BASEPOINT,
                                                   RistrettoPoint)
from bulletproofs_tpu_torch.core.scalar import L as ELL, Scalar
from bulletproofs_tpu_torch.ops import curve as C

N = 256
T4 = RistrettoPoint(SQRT_M1, 0, 1, 0)          # order 4
T2 = RistrettoPoint(0, P - 1, 1, 0)            # order 2


def _scaled(p, lam):
    """The same Edwards point with projective factor lam."""
    return RistrettoPoint(p.X * lam % P, p.Y * lam % P, p.Z * lam % P,
                          p.T * lam % P)


def _points():
    g = np.random.default_rng(41)
    r = random.Random(int(g.integers(1 << 31)))
    base = [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
            for _ in range(200)]
    pts = [_scaled(p, r.randrange(1, P)) for p in base[:150]]
    pts += [_scaled(p + T4, r.randrange(1, P)) for p in base[150:175]]
    pts += [p + T2 for p in base[175:190]]
    pts += [p + T4 + T2 for p in base[190:200]]
    ident = RistrettoPoint.identity()
    pts += [ident, T4, T2, _scaled(ident, 5), _scaled(T4, 7)]
    while len(pts) < N:
        pts.append(_scaled(base[len(pts) % 200], r.randrange(1, P)))
    return pts


def _jax_bytes(limbs) -> list:
    """(20, N) canonical 13-bit limbs -> encodings."""
    limbs = np.asarray(limbs, np.int64)
    return [sum(int(limbs[k, i]) << (13 * k) for k in range(20))
            .to_bytes(32, "little") for i in range(limbs.shape[1])]


@pytest.fixture(scope="module")
def cases():
    pts = _points()
    port = C.compress(torch.as_tensor(C.points_to_lanes(pts))).numpy()
    return pts, [bytes(r) for r in port]


def test_compress_matches_host(cases):
    pts, port = cases
    assert port == [p.compress() for p in pts]
    assert port[200:205] == [bytes(32)] * 5            # identity classes


def test_compress_matches_jax_xla(cases):
    pts, port = cases
    s = jax.device_get(JC._compress_jit(jnp.asarray(JC.points_to_lanes(pts))))
    assert _jax_bytes(s) == port


def test_compress_matches_jax_pallas_interpret(cases):
    pts, port = cases
    old = MP._INTERPRET
    MP._INTERPRET = True
    try:
        s = jax.device_get(MP.compress_lanes(
            jnp.asarray(JC.points_to_lanes(pts))))
    finally:
        MP._INTERPRET = old
    assert _jax_bytes(s) == port


def test_torsion_does_not_change_the_encoding(cases):
    pts, port = cases
    for i in range(150, 200):
        assert port[i] == pts[i].compress()
        assert (pts[i] == pts[i] + T4) and port[i] != bytes(32)


def test_roundtrip_through_decompress(cases):
    _, port = cases
    raw = torch.as_tensor(np.frombuffer(b"".join(port), np.uint8)
                          .reshape(N, 32).copy())
    valid, pts = C.decompress(raw)
    assert bool(valid.all())
    assert torch.equal(C.compress(pts), raw)


def test_compress_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        C.compress(torch.zeros((3, 10, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        C.compress(torch.zeros((4, 10, 4), dtype=torch.int64))
