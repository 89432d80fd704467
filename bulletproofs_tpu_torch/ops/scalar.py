"""Arithmetic mod l = 2^252 + 27742317777372353535851937790883648493 on
int64 tensors: the plain PyTorch version of csrc/sc25519.cuh (the JAX
package's ops/vec_scalar.py).

Layout (ops/limbs.py): (..., 9, N) limbs of 29 bits, kept CANONICAL
(exact limbs, value < l) between operations, so sums never need a lazy
headroom analysis and digit extraction needs no renormalisation.
Multiplication is Montgomery (CIOS, R = 2^261): `mont_mul(a, b)` =
a b R^-1 mod l.  Callers either work in the Montgomery domain
(`to_mont` / `from_mont`, as the emit kernel does) or use `smul`, which
multiplies plain canonical values.

`sinv` (the inverse mod l) is the one wrapper of a kernel here: K14 in
csrc/fold.cu for a CUDA tensor, `sinv_plain` for a CPU tensor.

Column bound of `mont_mul`: each of the 9 rounds adds at most two 58-bit
products to a limb position, 9 * 2^59 < 2^63, so int64 holds it.
"""

from __future__ import annotations

import torch

from ..core.scalar import L as ELL
from . import _cuda
from .limbs import SC_BITS, SC_LIMBS, SC_MASK, sc_from_bytes, \
    sc_ints_to_limbs

L = SC_LIMBS
R_BITS = SC_BITS * SC_LIMBS
LINV = (-pow(ELL, -1, 1 << SC_BITS)) % (1 << SC_BITS)     # -l^-1 mod 2^29
R2 = pow(2, 2 * R_BITS, ELL)                              # R^2 mod l
ONE_M = pow(2, R_BITS, ELL)                               # R mod l (1 in Montgomery form)

_CONSTS = {}


def const(v: int, device) -> torch.Tensor:
    """(9, 1) int64 limbs of the Python int v (< 2^261) on `device`."""
    key = (v, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(sc_ints_to_limbs([v]), device=device)
    return _CONSTS[key]


def normalize(t: torch.Tensor) -> torch.Tensor:
    """Sequential carry: exact 29-bit limbs, the top limb keeps the rest
    (signed inputs allowed; the value must be >= 0 for exact limbs)."""
    rows = list(t.unbind(-2))
    for k in range(len(rows) - 1):
        c = rows[k] >> SC_BITS
        rows[k] = rows[k] & SC_MASK
        rows[k + 1] = rows[k + 1] + c
    return torch.stack(rows, dim=-2)


def cond_sub_l(t: torch.Tensor) -> torch.Tensor:
    """Exact limbs of a value < 2l -> the value mod l."""
    d = normalize(t - const(ELL, t.device))
    return torch.where((d[..., L - 1:, :] < 0), t, d)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical a, b -> canonical a b R^-1 mod l (CIOS Montgomery)."""
    a, b = torch.broadcast_tensors(a, b)
    ell = const(ELL, a.device)
    t = torch.zeros(a.shape[:-2] + (L + 1,) + a.shape[-1:],
                    dtype=torch.int64, device=a.device)
    zero = torch.zeros_like(t[..., :1, :])
    for i in range(L):
        t[..., :L, :] += a[..., i: i + 1, :] * b
        mq = ((t[..., :1, :] & SC_MASK) * LINV) & SC_MASK
        t[..., :L, :] += mq * ell
        c = t[..., :1, :] >> SC_BITS
        t = torch.cat([t[..., 1:2, :] + c, t[..., 2:, :], zero], dim=-2)
    return cond_sub_l(normalize(t[..., :L, :]))


def to_mont(x: torch.Tensor) -> torch.Tensor:
    """x (any value < 2^256, exact limbs) -> x R mod l."""
    return mont_mul(x, const(R2, x.device))


def from_mont(x: torch.Tensor) -> torch.Tensor:
    return mont_mul(x, const(1, x.device))


def smul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical a, b -> a b mod l."""
    return mont_mul(mont_mul(a, b), const(R2, a.device))


def sadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return cond_sub_l(normalize(a + b))


def sneg(a: torch.Tensor) -> torch.Tensor:
    return cond_sub_l(normalize(const(ELL, a.device) - a))


def sreduce(x: torch.Tensor) -> torch.Tensor:
    """Exact limbs of any value < 2^256 -> the value mod l."""
    return from_mont(to_mont(x))


def reduce_top(x: torch.Tensor) -> torch.Tensor:
    """Exact limbs of any value < 2^261 -> the value mod l
    (csrc/sc25519.cuh sc_reduce_top): with q = floor(x / 2^252) < 2^9,
    x - q l lies in (-l, 2^252), so one conditional addition of l ends it.
    The identity on canonical x."""
    q = x[..., L - 1:, :] >> 20                  # limb 8 starts at bit 232
    e = normalize(x - q * const(ELL, x.device))
    return normalize(e + torch.where(e[..., L - 1:, :] < 0,
                                     const(ELL, x.device), 0))


# bits of the Fermat exponent l - 2, most significant first
_INV_BITS = [(ELL - 2) >> i & 1
             for i in range((ELL - 2).bit_length() - 1, -1, -1)]


def sinv_plain(x: torch.Tensor) -> torch.Tensor:
    """Canonical x -> x^(l-2) mod l = x^-1, canonical (0 -> 0): the
    square-and-multiply ladder over the static bits of l - 2, most
    significant first, in Montgomery form, starting at the top bit.  Kernel
    K14 (csrc/sc25519.cuh sc_invert) computes the same inverse by another
    algorithm, a safegcd of fixed length; both are exact and canonical, so
    their limbs agree, and each checks the other."""
    xm = to_mont(x)
    acc = xm
    for bit in _INV_BITS[1:]:
        acc = mont_mul(acc, acc)
        if bit:
            acc = mont_mul(acc, xm)
    return from_mont(acc)


def sinv(x: torch.Tensor) -> torch.Tensor:
    """(9, P) canonical scalars -> their inverses mod l, 0 -> 0
    (vec_scalar.sinv): kernel K14 (csrc/fold.cu, a safegcd inversion) on a
    CUDA tensor, the plain version (the Fermat ladder) on a CPU tensor."""
    if x.dim() != 2 or x.shape[0] != L or x.dtype != torch.int64:
        raise ValueError(f"sinv takes a ({L}, P) int64 tensor")
    if x.device.type == "cpu":
        return sinv_plain(x)
    x = _cuda.check(x, torch.int64)
    out = torch.empty_like(x)
    if x.shape[1]:
        _cuda.launch("sinv", "fold", "bp_sinv", x, out, x.shape[1])
    return out


def from_bytes32(raw: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 little-endian -> (9, N) exact limbs (value < 2^256)."""
    return sc_from_bytes(raw)


def from_wide_bytes(raw: torch.Tensor) -> torch.Tensor:
    """(N, 64) uint8 -> (9, N) canonical (lo + 2^256 hi) mod l
    (vec_scalar.from_wide_bytes; the host's rp_reduce_wide)."""
    lo = from_bytes32(raw[:, :32].contiguous())
    hi = from_bytes32(raw[:, 32:].contiguous())
    return sadd(smul(hi, const(pow(2, 256, ELL), raw.device)), sreduce(lo))


def power_sequence(y: torch.Tensor, n: int) -> torch.Tensor:
    """y (9, P) canonical -> (n, 9, P): [1, y, .., y^(n-1)]
    (vec_scalar.power_sequence).  Built by doubling the prefix (log2 n
    vector multiplications instead of n - 1 serial ones); the values are
    canonical, so the order of multiplication does not show."""
    seq = const(1, y.device).expand_as(y)[None]
    step = y
    while seq.shape[0] < n:
        seq = torch.cat([seq, smul(seq, step)])
        step = smul(step, step)
    return seq[:n].contiguous()


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """(n, 9, P) canonical -> (9, P) their sum mod l, by halving over the
    leading axis (vec_scalar.tree_sum)."""
    while v.shape[0] > 1:
        h = v.shape[0] // 2
        lo = sadd(v[:h], v[h: 2 * h])
        v = torch.cat([lo, v[2 * h:]]) if v.shape[0] % 2 else lo
    return v[0]


# 64 nibbles: nibble w covers bits [4w, 4w + 4), inside one limb or across
# two (29 is odd)
_NIB = [((4 * w) // SC_BITS, (4 * w) % SC_BITS) for w in range(64)]


def digits64(x: torch.Tensor) -> torch.Tensor:
    """(..., 9, N) exact limbs (value < 2^256) -> (..., 64, N) int64
    unsigned 4-bit digits."""
    padded = torch.cat([x, torch.zeros_like(x[..., :1, :])], dim=-2)
    rows = []
    for limb, off in _NIB:
        v = padded[..., limb, :] >> off
        if off > SC_BITS - 4:
            v = v | (padded[..., limb + 1, :] << (SC_BITS - off))
        rows.append(v & 15)
    return torch.stack(rows, dim=-2)


_SEVENS = sum(7 << (4 * w) for w in range(64))


def signed_digits(x: torch.Tensor) -> torch.Tensor:
    """(9, N) canonical scalars -> (64, N) int8 signed base-16 digits in
    [-7, 8] with sum_w d_w 16^w = x.  Digits of x + 0x77..7, minus 7: the
    same digits as the sequential recode (msm.to_signed_digits), since
    [-7, 8] is a complete residue system mod 16; valid for x < 8 * 2^252."""
    biased = normalize(x + const(_SEVENS % (1 << 261), x.device))
    return (digits64(biased) - 7).to(torch.int8)
