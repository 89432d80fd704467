"""Ristretto255 over Curve25519 in Python integers: the group the proofs
live in, written from RFC 9496 (sections 4.2-4.3) and the twisted Edwards
formulas of Hisil, Wong, Carter and Dawson (2008).  No part of the program
is used; it is slow and plain on purpose.

Points are extended coordinates (X, Y, Z, T) with x = X / Z, y = Y / Z and
x y = T / Z on -x^2 + y^2 = 1 + d x^2 y^2.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

P = 2 ** 255 - 19
L = 2 ** 252 + 27742317777372353535851937790883648493

D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)


def _is_negative(x: int) -> int:
    return (x % P) & 1


def _abs(x: int) -> int:
    x %= P
    return P - x if x & 1 else x


def sqrt_ratio_m1(u: int, v: int) -> Tuple[bool, int]:
    """RFC 9496 4.2: (u / v is a square, the non-negative root of u / v or
    of SQRT_M1 u / v)."""
    u %= P
    v %= P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct = check == u
    flipped = check == (-u) % P
    flipped_i = check == (-u * SQRT_M1) % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    return correct or flipped, _abs(r)


# RFC 9496 4.1's constants: its root of a d - 1 is the odd one
SQRT_AD_MINUS_ONE = \
    25063068953384623474111414158702152701244531502492656460079210482610430750235
INVSQRT_A_MINUS_D = \
    54469307008909316920995813868745141605393597292927456921205312896311721017578
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P

IDENTITY = (0, 1, 1, 0)
# the Ed25519 base point, which is the ristretto255 generator
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
_BY = 4 * pow(5, P - 2, P) % P
BASEPOINT = (_BX, _BY, 1, _BX * _BY % P)

Point = Tuple[int, int, int, int]
Cached = Tuple[int, int, int, int]


def add(p: Point, q: Point) -> Point:
    """Complete addition (add-2008-hwcd-3, a = -1)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def cached(p: Point) -> Cached:
    """(Y + X, Y - X, 2 d T, 2 Z): an addend that saves two products."""
    x, y, z, t = p
    return ((y + x) % P, (y - x) % P, t * D2 % P, 2 * z % P)


def neg_cached(c: Cached) -> Cached:
    return (c[1], c[0], (-c[2]) % P, c[3])


def add_cached(p: Point, c: Cached) -> Point:
    x1, y1, z1, t1 = p
    a = (y1 - x1) * c[1] % P
    b = (y1 + x1) * c[0] % P
    cc = t1 * c[2] % P
    d = z1 * c[3] % P
    e, f, g, h = b - a, d - cc, d + cc, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def neg(p: Point) -> Point:
    x, y, z, t = p
    return ((-x) % P, y, z, (-t) % P)


def encode(p: Point) -> bytes:
    """RFC 9496 4.3.2: the canonical 32-byte encoding."""
    x0, y0, z0, t0 = p
    u1 = (z0 + y0) * (z0 - y0) % P
    u2 = x0 * y0 % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    if _is_negative(t0 * z_inv):
        x, y = y0 * SQRT_M1 % P, x0 * SQRT_M1 % P
        den_inv = den1 * INVSQRT_A_MINUS_D % P
    else:
        x, y, den_inv = x0, y0, den2
    if _is_negative(x * z_inv):
        y = -y
    s = _abs(den_inv * (z0 - y))
    return s.to_bytes(32, "little")


def decode(b: bytes):
    """RFC 9496 4.3.1: a canonical 32-byte encoding to a point, or None
    where the bytes encode none."""
    s = int.from_bytes(b, "little")
    if len(b) != 32 or s >= P or _is_negative(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs(2 * s * den_x)
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def _map(t: int) -> Point:
    """RFC 9496 4.3.4's MAP: a field element to a point."""
    r = SQRT_M1 * t % P * t % P
    u = (r + 1) * ONE_MINUS_D_SQ % P
    v = (-1 - r * D) * (r + D) % P
    was_square, s = sqrt_ratio_m1(u, v)
    if not was_square:
        s = (-_abs(s * t)) % P
        c = r
    else:
        c = P - 1
    n = (c * (r - 1) % P * D_MINUS_ONE_SQ - v) % P
    w0 = 2 * s * v % P
    w1 = n * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return (w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)


def from_uniform_bytes(b: bytes) -> Point:
    """RFC 9496 4.3.4: 64 uniform bytes to a point (bit 255 of each half
    dropped)."""
    lo = int.from_bytes(b[:32], "little") & ((1 << 255) - 1)
    hi = int.from_bytes(b[32:64], "little") & ((1 << 255) - 1)
    return add(_map(lo % P), _map(hi % P))


def _signed_digits(s: int, c: int, windows: int) -> List[int]:
    """Signed radix-2^c digits of s, each in [-2^(c-1), 2^(c-1))."""
    out, half, mask = [], 1 << (c - 1), (1 << c) - 1
    for _ in range(windows):
        d = s & mask
        s >>= c
        if d >= half:
            d -= 1 << c
            s += 1
        out.append(d)
    return out


def msm(scalars: Sequence[int], points: Sequence[Point],
        cache: Sequence[Cached] = None) -> Point:
    """sum_i scalars[i] points[i] (scalars taken mod L) by Pippenger's
    bucket method over signed digits."""
    n = len(points)
    if cache is None:
        cache = [cached(p) for p in points]
    c = max(4, min(12, int(math.log2(max(n, 2))) - 2))
    windows = -(-254 // c) + 1
    digits = [_signed_digits(s % L, c, windows) for s in scalars]
    negs = [neg_cached(k) for k in cache]
    acc = IDENTITY
    for w in range(windows - 1, -1, -1):
        for _ in range(c):
            acc = add(acc, acc)
        buckets = [None] * (1 << (c - 1))
        for i in range(n):
            d = digits[i][w]
            if d == 0:
                continue
            j = abs(d) - 1
            b = buckets[j]
            if b is None:
                buckets[j] = points[i] if d > 0 else neg(points[i])
            else:
                buckets[j] = add_cached(b, cache[i] if d > 0 else negs[i])
        running = total = IDENTITY
        for b in reversed(buckets):
            if b is not None:
                running = add(running, b)
            total = add(total, running)
        acc = add(acc, total)
    return acc
