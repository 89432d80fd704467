"""Kernel K11 (Pippenger bucket accumulation for points of arbitrary Z)
and the MSM it serves, ops/msm.msm_lanes_flag (digits by K10, then K11,
K4a, K4b), through the plain PyTorch versions on the CPU, against the JAX
package's Pallas MSM msm_pallas.msm_lanes_flag in interpret mode at
blk = 32 and the host curve library.

The points carry random projective scalings (Z != 1), as the chunked
verifier's per-chunk partial results do, plus the identity and a
representative with 4-torsion.  Compared exactly: the point by its
compressed bytes (ristretto equality), the identity flag as a boolean."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bulletproofs_tpu.ops import msm_pallas as MP
from bulletproofs_tpu.ops import vec_curve as JC

from bulletproofs_tpu_torch.core.field import P as FP_P, SQRT_M1
from bulletproofs_tpu_torch.core.ristretto import (RISTRETTO_BASEPOINT,
                                                   RistrettoPoint,
                                                   multiscalar_mul)
from bulletproofs_tpu_torch.core.scalar import L as ELL, Scalar
from bulletproofs_tpu_torch.ops import curve as C
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops import scalar as S
from bulletproofs_tpu_torch.ops.limbs import sc_ints_to_limbs

T4 = RistrettoPoint(SQRT_M1, 0, 1, 0)                 # order 4, the identity class


def _scaled(p, r):
    """The same point as (lX : lY : lZ : lT) for a random l != 0."""
    lam = r.randrange(2, FP_P)
    return RistrettoPoint(p.X * lam % FP_P, p.Y * lam % FP_P,
                          p.Z * lam % FP_P, p.T * lam % FP_P)


def _points(k, seed):
    """k points of any Z: random multiples of the base point, scaled; the
    identity (scaled) at index 1, a torsioned representative at 2."""
    r = random.Random(seed)
    pts = [_scaled(RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL))),
                   r) for _ in range(k)]
    pts[1] = _scaled(RistrettoPoint.identity(), r)
    pts[2] = pts[3] + T4
    return pts


def _bytes(vals):
    return np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                         np.uint8).reshape(len(vals), 32).copy()


def _port(points, vals):
    out, flag = M.msm_lanes_flag(torch.as_tensor(C.points_to_lanes(points)),
                                 torch.as_tensor(_bytes(vals)))
    return C.lanes_to_points(out.numpy())[0], bool(flag[0])


def _jax(points, vals):
    sb = np.zeros((len(vals), 33), np.uint8)
    sb[:, :32] = _bytes(vals)
    old = MP._INTERPRET
    MP._INTERPRET = True
    try:
        out, flag = MP.msm_lanes_flag(jnp.asarray(JC.points_to_lanes(points)),
                                      sb, blk=32)
        out, flag = jax.device_get((out, flag))
    finally:
        MP._INTERPRET = old
    return JC.lanes_to_points(np.asarray(out))[0], bool(np.asarray(flag)[0])


def test_msm_matches_jax_interpret():
    pts = _points(40, 41)
    r = random.Random(42)
    vals = [0, 1, ELL - 1] + [r.randrange(ELL) for _ in range(37)]
    got, got_flag = _port(pts, vals)
    want, want_flag = _jax(pts, vals)
    assert got.compress() == want.compress()
    assert got_flag is want_flag is False


def test_identity_flag_matches_jax_interpret():
    """s P + (l - s)(P + T4) is 4-torsion in Edwards coordinates but the
    ristretto identity: both flag it (same shape as the test above, so JAX
    compiles once)."""
    pts = _points(40, 43)
    r = random.Random(44)
    s = r.randrange(1, ELL)
    vals = [0] * 40
    vals[3], vals[2] = s, ELL - s
    got, got_flag = _port(pts, vals)
    want, want_flag = _jax(pts, vals)
    assert got_flag is want_flag is True
    assert got.compress() == want.compress() == bytes(32)


@pytest.mark.parametrize("n", [1, 33, 300])
def test_msm_matches_host(n):
    """Against core.ristretto.multiscalar_mul, scalars anywhere below 2^256
    (taken mod l by K10's reduction)."""
    pts = _points(max(n, 4), 45 + n)[:n]
    r = random.Random(46 + n)
    vals = [r.randrange(1 << 256) for _ in range(n)]
    vals[-1] = (1 << 256) - 1
    got, flag = _port(pts, vals)
    ref = multiscalar_mul([Scalar(v % ELL) for v in vals], pts)
    assert got.compress() == ref.compress()
    assert flag is ref.is_identity()


def test_final_msm_adds_partials_of_any_z():
    """The chunked verifier's final MSM: Z = 1 statics plus partial MSM
    results with scalar 1 equals the whole sum, and feeding the partials
    to the Z = 1 Niels path (kernel K3's) would not."""
    pts = _points(60, 47)
    r = random.Random(48)
    vals = [r.randrange(ELL) for _ in range(60)]
    lanes = torch.as_tensor(C.points_to_lanes(pts))
    sc = torch.as_tensor(_bytes(vals))
    partials = [M.msm_lanes(lanes[:, :, k: k + 20].contiguous(),
                            sc[k: k + 20].contiguous()) for k in (20, 40)]
    statics = torch.as_tensor(C.points_to_lanes(C.normalized(pts[:20])))
    points = torch.cat([statics] + partials, dim=-1)
    scal = torch.cat([sc[:20], torch.as_tensor(_bytes([1, 1]))])
    out, flag = M.msm_lanes_flag(points, scal)
    ref = multiscalar_mul([Scalar(v) for v in vals], pts)
    assert C.lanes_to_points(out.numpy())[0].compress() == ref.compress()
    assert not bool(flag[0])
    niels_out, _ = M.msm_niels(C.to_niels(points).contiguous(),
                               S.signed_digits(S.from_bytes32(scal)))
    assert C.lanes_to_points(niels_out.numpy()[:, :, None])[0].compress() \
        != ref.compress()


def test_accumulate_z_matches_per_lane_reference():
    """Bucket b of lane j holds sum of d_k P_k over the points
    k = j mod lanes with |d_k| = b + 1 (sign applied), for points of any Z."""
    n = 70
    lanes = M.pick_lanes(n)
    pts = _points(n, 49)
    r = random.Random(50)
    digits = S.signed_digits(torch.as_tensor(sc_ints_to_limbs(
        [r.randrange(ELL) for _ in range(n)])))
    slab = M.accumulate_z(torch.as_tensor(C.points_to_lanes(pts)), digits)
    assert slab.shape == (64, 8, 4, 10, lanes) and slab.dtype == torch.int32
    for w, j, b in [(0, 0, 0), (5, 3, 2), (63, 31, 7), (40, 1, 4)]:
        exp = RistrettoPoint.identity()
        for k in range(j, n, lanes):
            d = int(digits[w, k])
            if abs(d) == b + 1:
                exp = exp + (pts[k] if d > 0 else -pts[k])
        got = C.lanes_to_points(slab[w, b, :, :, j: j + 1].numpy())[0]
        assert got.compress() == exp.compress()


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        M.accumulate_z(torch.zeros((3, 10, 8), dtype=torch.int32),
                       torch.zeros((64, 8), dtype=torch.int8))
    with pytest.raises(ValueError):
        M.accumulate_z(torch.zeros((4, 10, 8), dtype=torch.int32),
                       torch.zeros((64, 9), dtype=torch.int8))
    with pytest.raises(ValueError):
        M.msm_lanes_flag(torch.zeros((4, 10, 8), dtype=torch.int32),
                         torch.zeros((8, 33), dtype=torch.uint8))
