"""Kernels K3/K4 (Pippenger MSM over Niels points: bucket accumulation,
bucket reduction, Horner combine with the ristretto identity flag) of the
PyTorch port, through their plain PyTorch versions on the CPU, against the
JAX package's Pallas MSM in interpret mode and the host curve library.

Results are compared exactly: the point by its compressed bytes
(ristretto equality), the identity flag as a boolean."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bulletproofs_tpu.ops import msm_pallas as MP
from bulletproofs_tpu.ops import vec_curve as JC

from bulletproofs_tpu_torch.core.field import SQRT_M1
from bulletproofs_tpu_torch.core.ristretto import (RISTRETTO_BASEPOINT,
                                                   RistrettoPoint,
                                                   multiscalar_mul)
from bulletproofs_tpu_torch.core.scalar import L as ELL, Scalar
from bulletproofs_tpu_torch.ops import curve as C
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops import scalar as S
from bulletproofs_tpu_torch.ops.limbs import sc_ints_to_limbs


def _points(k, seed):
    r = random.Random(seed)
    return [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
            for _ in range(k)]


def _port_msm(points, scalars):
    niels = C.to_niels(torch.as_tensor(C.points_to_lanes(C.normalized(points))))
    digits = S.signed_digits(torch.as_tensor(sc_ints_to_limbs(scalars)))
    out, flag = M.msm_niels(niels, digits)
    return C.lanes_to_points(out.numpy()[:, :, None])[0], bool(flag[0])


def test_msm_matches_jax_niels_interpret():
    """msm_pallas.msm_lanes_niels_flag in interpret mode at N = 8."""
    r = random.Random(31)
    pts = _points(8, 32)
    vals = [r.randrange(ELL) for _ in range(8)]
    jpts = jnp.asarray(JC.points_to_lanes(C.normalized(pts)))
    sbytes = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                           np.uint8).reshape(8, 32).copy()
    old = MP._INTERPRET
    MP._INTERPRET = True
    try:
        out, flag = MP.msm_lanes_niels_flag(
            jpts, MP.device_digits4(jnp.asarray(sbytes)))
        out, flag = jax.device_get((out, flag))
    finally:
        MP._INTERPRET = old
    jres = JC.lanes_to_points(np.asarray(out))[0]
    got, got_flag = _port_msm(pts, vals)
    assert got.compress() == jres.compress()
    assert got_flag == bool(np.asarray(flag)[0]) is False


@pytest.mark.parametrize("n", [1, 17, 300])
def test_msm_matches_host(n):
    """Against core.ristretto.multiscalar_mul; one scalar sits just below
    8 * 2^252, the largest value the signed digits take without a carry
    out of the top window."""
    r = random.Random(33 + n)
    pts = _points(n, 34 + n)
    vals = [r.randrange(ELL) for _ in range(n)]
    vals[-1] = (8 << 252) - 1
    got, flag = _port_msm(pts, vals)
    ref = multiscalar_mul([Scalar(v % ELL) for v in vals], pts)
    assert got.compress() == ref.compress()
    assert flag is False


def test_msm_identity_with_torsioned_representative():
    """s P + (l - s)(P + T4) = (l - s) T4 is 4-torsion in Edwards
    coordinates but the ristretto identity: the flag must be set (an
    Edwards-identity test would reject it)."""
    r = random.Random(35)
    pts = _points(5, 36)
    t4 = RistrettoPoint(SQRT_M1, 0, 1, 0)             # order 4, y = 0
    p_t = pts[0] + t4
    assert p_t == pts[0]
    vals = [r.randrange(ELL) for _ in range(5)]
    s = 2 * r.randrange(1, ELL // 2)        # l - s odd: X != 0, Y == 0
    got, flag = _port_msm([pts[0], p_t, pts[1]], [s, ELL - s, 0])
    edw = C.points_to_lanes(C.normalized([got]))
    assert flag is True and got.is_identity()
    assert not (edw[0] == 0).all()                     # not the Edwards identity
    # and a non-identity sum with the same points is not flagged
    assert _port_msm(pts, vals)[1] is False


def test_accumulate_matches_per_lane_reference():
    """The bucket slab against a per-lane, per-window host accumulation:
    bucket b of lane j holds sum of d_k P_k over the points k = j mod lanes
    with |d_k| = b + 1 (sign applied)."""
    n = 70
    lanes = M.pick_lanes(n)
    pts = _points(n, 37)
    r = random.Random(38)
    vals = [r.randrange(ELL) for _ in range(n)]
    niels = C.to_niels(torch.as_tensor(C.points_to_lanes(C.normalized(pts))))
    digits = S.signed_digits(torch.as_tensor(sc_ints_to_limbs(vals)))
    slab = M.accumulate(niels, digits)
    assert lanes == 32 and slab.shape == (64, 8, 4, 10, lanes) and slab.dtype == torch.int32
    for w, j, b in [(0, 0, 0), (5, 3, 2), (63, 31, 7), (40, 6, 4)]:
        exp = RistrettoPoint.identity()
        for k in range(j, n, lanes):
            d = int(digits[w, k])
            if abs(d) == b + 1:
                exp = exp + (pts[k] if d > 0 else -pts[k])
        got = C.lanes_to_points(slab[w, b, :, :, j: j + 1].numpy())[0]
        assert got.compress() == exp.compress()


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        M.accumulate(torch.zeros((3, 10, 8), dtype=torch.int32),
                     torch.zeros((64, 9), dtype=torch.int8))
    with pytest.raises(ValueError):
        M.accumulate(torch.zeros((3, 20, 8), dtype=torch.int32),
                     torch.zeros((64, 8), dtype=torch.int8))
    with pytest.raises(ValueError):
        M.reduce(torch.zeros((64, 8, 4, 10, 24), dtype=torch.int32))
    with pytest.raises(ValueError):
        M.horner(torch.zeros((64, 9, 4, 10), dtype=torch.int32))
