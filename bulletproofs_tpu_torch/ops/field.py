"""GF(2^255 - 19) on int64 tensors: the plain PyTorch version of the field
arithmetic that csrc/fe25519.cuh gives the CUDA kernels.

Layout (ops/limbs.py): (..., 10, N) signed limbs in radix 2^25.5.  The
same ops as the JAX package's ops/vec_field.py and the field half of
ops/pallas_math.py, in the ref10 representation:

* `mul` is the 10 x 10 schoolbook with the odd-odd doubling and the x19
  fold of the upper columns, followed by `carry`;
* `add` / `sub` do not carry: every `mul` input is a sum of at most three
  carried values (|limb| < 2^27), which keeps each column below 2^63;
* `carry` runs three rounded parallel carry rounds, leaving
  |limb| <= 2^25 + 19 (even) / 2^24 + 19 (odd);
* `canonicalize` is ref10's fe_tobytes reduction (exact limbs, value < p),
  used only at compare / encode boundaries.

Every function takes and returns int64 tensors; constants broadcast from
(10, 1) columns.
"""

from __future__ import annotations

import torch

from ..core import field as host_field
from .limbs import FE_LIMBS, FE_WIDTH, fe_ints_to_limbs

L = FE_LIMBS
_W = torch.tensor(FE_WIDTH, dtype=torch.int64)[:, None]
_ODD2 = torch.tensor([1 + (k & 1) for k in range(L)], dtype=torch.int64)[:, None]

_CONST_VALUES = {
    "one": 1,
    "d": host_field.D,
    "d2": host_field.EDWARDS_D2,
    "sqrt_m1": host_field.SQRT_M1,
    "invsqrt_a_minus_d": host_field.INVSQRT_A_MINUS_D,
    # RFC 9496 MAP (curve.elligator_map)
    "one_minus_d_sq": host_field.ONE_MINUS_D_SQ,
    "d_minus_one_sq": host_field.D_MINUS_ONE_SQ,
    "sqrt_ad_minus_one": host_field.SQRT_AD_MINUS_ONE,
}
_CONSTS = {}


def const(name: str, device) -> torch.Tensor:
    """(10, 1) int64 limb column of a named curve constant on `device`."""
    key = (name, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(
            fe_ints_to_limbs([_CONST_VALUES[name]]), device=device)
    return _CONSTS[key]


def _col(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return t.to(ref.device)


def carry(h: torch.Tensor) -> torch.Tensor:
    """Three rounded parallel carry rounds (limb 9 wraps into limb 0 x19)."""
    w = _col(_W, h)
    half = 1 << (w - 1)
    for _ in range(3):
        c = (h + half) >> w
        h = h - (c << w)
        h = h + torch.cat([19 * c[..., L - 1:, :], c[..., :L - 1, :]], dim=-2)
    return h


def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def neg(a):
    return -a


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    b2 = b * _col(_ODD2, b)
    c = torch.zeros(a.shape[:-2] + (2 * L - 1,) + a.shape[-1:],
                    dtype=torch.int64, device=a.device)
    for i in range(L):
        c[..., i: i + L, :] += a[..., i: i + 1, :] * (b2 if i & 1 else b)
    lo = c[..., :L, :].clone()
    lo[..., : L - 1, :] += 19 * c[..., L:, :]
    return carry(lo)


def square(a):
    return mul(a, a)


def mul_small(a, k: int):
    return carry(a * k)


def pow2k(a, k: int):
    for _ in range(k):
        a = square(a)
    return a


def pow_p58(a):
    """a^((p - 5) / 8) = a^(2^252 - 3) (the curve25519 addition chain)."""
    t0 = square(a)
    t1 = square(square(t0))
    t2 = mul(a, t1)
    t3 = mul(t0, t2)
    t4 = square(t3)
    t5 = mul(t2, t4)
    t6 = mul(pow2k(t5, 5), t5)
    t7 = mul(pow2k(t6, 10), t6)
    t8 = mul(pow2k(t7, 20), t7)
    t9 = mul(pow2k(t8, 10), t6)
    t10 = mul(pow2k(t9, 50), t9)
    t11 = mul(pow2k(t10, 100), t10)
    t12 = mul(pow2k(t11, 50), t9)
    return mul(square(square(t12)), a)


def invert(a):
    """a^(p - 2) = (a^((p - 5) / 8))^8 a^3 (0 maps to 0)."""
    return mul(pow2k(pow_p58(a), 3), mul(square(a), a))


def canonicalize(h: torch.Tensor) -> torch.Tensor:
    """Exact limbs (0 <= limb < 2^width) of the value mod p (ref10
    fe_tobytes: q = floor(h / p) from the top limb down, h -= q p)."""
    rows = list(carry(h).unbind(-2))
    q = (19 * rows[9] + (1 << 24)) >> 25
    for k in range(L):
        q = (rows[k] + q) >> FE_WIDTH[k]
    rows[0] = rows[0] + 19 * q
    for k in range(L - 1):
        c = rows[k] >> FE_WIDTH[k]
        rows[k + 1] = rows[k + 1] + c
        rows[k] = rows[k] - (c << FE_WIDTH[k])
    rows[9] = rows[9] & ((1 << 25) - 1)
    return torch.stack(rows, dim=-2)


def is_negative(a):
    """(..., N) int64 0/1: low bit of the canonical encoding."""
    return canonicalize(a)[..., 0, :] & 1


def eq_zero(a):
    """(..., N) bool: value == 0 mod p."""
    return torch.all(canonicalize(a) == 0, dim=-2)


def eq(a, b):
    return eq_zero(sub(a, b))


def select(flag, a, b):
    """flag (..., N) bool -> a where set, else b."""
    return torch.where(flag.unsqueeze(-2), a, b)


def cond_neg(a, flag):
    return select(flag, neg(a), a)


def ct_abs(a):
    return cond_neg(a, is_negative(a) != 0)


def sqrt_ratio_m1(u, v):
    """RFC 9496 SQRT_RATIO_M1 -> (was_square (..., N) bool, r)."""
    sqrt_m1 = const("sqrt_m1", u.device)
    v3 = mul(square(v), v)
    v7 = mul(square(v3), v)
    r = mul(mul(u, v3), pow_p58(mul(u, v7)))
    check = mul(v, square(r))
    neg_u = neg(u)
    correct = eq(check, u)
    flipped = eq(check, neg_u)
    flipped_i = eq(check, mul(neg_u, sqrt_m1))
    r = select(flipped | flipped_i, mul(r, sqrt_m1), r)
    return correct | flipped, ct_abs(r)
