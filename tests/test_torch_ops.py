"""The PyTorch port's limb arithmetic (bulletproofs_tpu_torch.ops.field,
.scalar, .limbs) against Python integers and the JAX package's layouts.

All comparisons are exact: the arithmetic is integer arithmetic, so the
tolerance is 0.  Inputs come from seeded `random.Random` streams."""

import os
import random
import re

import numpy as np
import pytest
import torch

from bulletproofs_tpu.ops import vec_curve as JC

from bulletproofs_tpu_torch.core.field import (D, EDWARDS_D2,
                                               INVSQRT_A_MINUS_D, P, SQRT_M1)
from bulletproofs_tpu_torch.core.scalar import L as ELL
from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.ops import limbs as LB
from bulletproofs_tpu_torch.ops import scalar as S

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bulletproofs_tpu_torch", "csrc")


def _fe(vals):
    return torch.as_tensor(LB.fe_ints_to_limbs(vals))


def _sc(vals):
    return torch.as_tensor(LB.sc_ints_to_limbs(vals))


def test_field_ops_match_ints():
    r = random.Random(11)
    a = [r.randrange(P) for _ in range(64)] + [0, 1, P - 1, P - 2]
    b = [r.randrange(P) for _ in range(64)] + [P - 1, P - 1, P - 1, 2]
    A, B = _fe(a), _fe(b)
    prod = F.mul(F.add(A, B), F.sub(A, B))
    assert LB.fe_limbs_to_ints(prod) == [(x + y) * (x - y) % P
                                         for x, y in zip(a, b)]
    # carried limbs stay inside the bound every mul input relies on
    assert int(prod.abs().max()) <= (1 << 25) + 64
    canon = F.canonicalize(F.neg(prod))
    assert LB.limbs_to_ints(canon.numpy(), LB.FE_POS) == [
        (-(x + y) * (x - y)) % P for x, y in zip(a, b)]
    assert LB.fe_limbs_to_ints(F.pow_p58(A)) == [
        pow(x, (P - 5) // 8, P) for x in a]


def test_sqrt_ratio_matches_host():
    from bulletproofs_tpu_torch.core.field import sqrt_ratio_m1
    r = random.Random(12)
    u = [r.randrange(P) for _ in range(48)] + [0, 1]
    v = [r.randrange(1, P) for _ in range(48)] + [1, 0]
    ok, root = F.sqrt_ratio_m1(_fe(u), _fe(v))
    for i in range(len(u)):
        hok, hroot = sqrt_ratio_m1(u[i], v[i])
        assert bool(ok[i]) == bool(hok)
        assert LB.fe_limbs_to_ints(root[:, i: i + 1])[0] == hroot % P


def test_scalar_ops_match_ints():
    r = random.Random(13)
    a = [r.randrange(ELL) for _ in range(64)] + [0, ELL - 1]
    b = [r.randrange(ELL) for _ in range(64)] + [ELL - 1, ELL - 1]
    A, B = _sc(a), _sc(b)
    assert LB.sc_limbs_to_ints(S.smul(A, B)) == [x * y % ELL
                                                 for x, y in zip(a, b)]
    assert LB.sc_limbs_to_ints(S.sadd(A, B)) == [(x + y) % ELL
                                                 for x, y in zip(a, b)]
    assert LB.sc_limbs_to_ints(S.sneg(A)) == [(-x) % ELL for x in a]
    big = [r.randrange(1 << 256) for _ in range(32)] + [(1 << 256) - 1]
    raw = torch.as_tensor(np.frombuffer(
        b"".join(v.to_bytes(32, "little") for v in big), np.uint8
    ).reshape(-1, 32).copy())
    assert LB.sc_limbs_to_ints(S.sreduce(S.from_bytes32(raw))) == [
        v % ELL for v in big]


def test_signed_digits_roundtrip():
    """Digits in [-7, 8] whose base-16 sum is the scalar, for canonical
    values and values up to just below 8 * 2^252."""
    r = random.Random(14)
    vals = [0, 1, ELL - 1, (8 << 252) - 1] + [r.randrange(ELL)
                                              for _ in range(60)]
    d = S.signed_digits(_sc(vals))
    assert d.dtype == torch.int8 and d.shape == (64, len(vals))
    assert int(d.min()) >= -7 and int(d.max()) <= 8
    for i, v in enumerate(vals):
        assert sum(int(d[w, i]) << (4 * w) for w in range(64)) == v


def test_limb_codecs_roundtrip():
    r = random.Random(15)
    vals = [r.randrange(P) for _ in range(40)] + [0, P - 1]
    raw = torch.as_tensor(np.frombuffer(
        b"".join(v.to_bytes(32, "little") for v in vals), np.uint8
    ).reshape(-1, 32).copy())
    fe = LB.fe_from_bytes(raw)
    assert LB.fe_limbs_to_ints(fe) == vals
    assert torch.equal(LB.fe_to_bytes(F.canonicalize(fe)), raw)
    svals = [r.randrange(1 << 256) for _ in range(40)]
    sraw = torch.as_tensor(np.frombuffer(
        b"".join(v.to_bytes(32, "little") for v in svals), np.uint8
    ).reshape(-1, 32).copy())
    assert torch.equal(LB.sc_to_bytes(LB.sc_from_bytes(sraw)), sraw)


def test_canonical_mask_matches_jax():
    """The port's canonical-encoding mask equals the JAX package's host
    and device masks on edge encodings (>= p, odd, top bit set)."""
    r = random.Random(16)
    vals = [P - 1, P, P + 1, P + 2, (1 << 255) - 1, 0, 1, 2] + [
        r.randrange(1 << 256) for _ in range(56)]
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                        np.uint8).reshape(-1, 32).copy()
    got = LB.canonical_mask(torch.as_tensor(raw)).numpy()
    assert (got == JC.canonical_mask(raw)).all()
    assert (got == np.asarray(JC.device_canonical_mask(raw))).all()


def _header_array(name: str, header: str):
    with open(os.path.join(CSRC, header)) as fh:
        text = fh.read()
    body = re.search(name + r"\[\d+\] = \{([^}]*)\}", text).group(1)
    return [int(x) for x in body.replace("\n", " ").split(",") if x.strip()]


@pytest.mark.parametrize("name,value", [
    ("FE_D", D), ("FE_D2", EDWARDS_D2), ("FE_SQRT_M1", SQRT_M1),
    ("FE_INVSQRT_A_MINUS_D", INVSQRT_A_MINUS_D)])
def test_cuda_field_constants(name, value):
    """The limb constants compiled into csrc/fe25519.cuh."""
    assert _header_array(name, "fe25519.cuh") == \
        LB.fe_ints_to_limbs([value])[:, 0].tolist()


@pytest.mark.parametrize("name,value", [
    ("SC_ELL", ELL), ("SC_R2", S.R2), ("SC_ONE_M", S.ONE_M),
    ("SC_SEVENS", sum(7 << (4 * w) for w in range(64)))])
def test_cuda_scalar_constants(name, value):
    """The limb constants compiled into csrc/sc25519.cuh."""
    assert _header_array(name, "sc25519.cuh") == \
        LB.sc_ints_to_limbs([value])[:, 0].tolist()
    with open(os.path.join(CSRC, "sc25519.cuh")) as fh:
        assert f"#define SC_LINV {S.LINV}ull" in fh.read()


def test_from_jax_lanes():
    r = random.Random(17)
    vals = [r.randrange(P) for _ in range(20)]
    jax_limbs = JC.field_to_lanes(vals)                    # (20, N) 13-bit
    assert LB.fe_limbs_to_ints(LB.from_jax_lanes(jax_limbs)) == vals
    assert LB.from_jax_lanes(jax_limbs).dtype == np.int32
