"""Scalar/vector-polynomial utilities (host path).

Mirrors the reference's src/util.rs: powers iterators, vector polynomials
with Karatsuba inner products, binary exponentiation, and the O(lg n)
sum-of-powers.  The TPU path computes the same quantities as tensor scans
(`bulletproofs_tpu_torch.ops.scalar`).
"""

from __future__ import annotations

from typing import List

from ..core.scalar import Scalar, L


def inner_product(a: List[Scalar], b: List[Scalar]) -> Scalar:
    if len(a) != len(b):
        raise ValueError("inner_product(a,b): lengths of vectors do not match")
    out = Scalar.zero()
    for x, y in zip(a, b):
        out = out + x * y
    return out


def exp_iter_take(x: Scalar, n: int) -> List[Scalar]:
    """First n powers of x: [1, x, x^2, ...] (reference util.rs:44-67)."""
    out = []
    acc = Scalar.one()
    for _ in range(n):
        out.append(acc)
        acc = acc * x
    return out


def add_vec(a: List[Scalar], b: List[Scalar]) -> List[Scalar]:
    return [x + y for x, y in zip(a, b)]


def scalar_exp_vartime(x: Scalar, n: int) -> Scalar:
    """x^n by binary exponentiation (reference util.rs:222-234)."""
    return Scalar(pow(x.v, n, L))


def sum_of_powers(x: Scalar, n: int) -> Scalar:
    """Sum of x^0..x^(n-1); O(lg n) when n is a power of two
    (reference util.rs:240-261)."""
    if n & (n - 1):
        return Scalar(sum(s.v for s in exp_iter_take(x, n)))
    if n == 0 or n == 1:
        return Scalar(n)
    m = n
    result = Scalar.one() + x
    factor = x
    while m > 2:
        factor = factor * factor
        result = result + factor * result
        m //= 2
    return result


class VecPoly1:
    """Degree-1 vector polynomial a + b*x (reference util.rs:14,86-110)."""

    def __init__(self, c0: List[Scalar], c1: List[Scalar]):
        self.c0 = c0
        self.c1 = c1

    @classmethod
    def zero(cls, n: int) -> "VecPoly1":
        return cls([Scalar.zero()] * n, [Scalar.zero()] * n)

    def inner_product(self, rhs: "VecPoly1") -> "Poly2":
        t0 = inner_product(self.c0, rhs.c0)
        t2 = inner_product(self.c1, rhs.c1)
        t1 = inner_product(add_vec(self.c0, self.c1), add_vec(rhs.c0, rhs.c1)) - t0 - t2
        return Poly2(t0, t1, t2)

    def eval(self, x: Scalar) -> List[Scalar]:
        return [a + b * x for a, b in zip(self.c0, self.c1)]

    def wipe(self) -> None:
        """Best-effort secret clearing (the role clear_on_drop plays for the
        reference, util.rs:170-186).  Python ints are immutable, so this
        drops the references and empties the containers; the native prover
        path additionally memsets its ctypes scalar buffers."""
        self.c0.clear()
        self.c1.clear()


class Poly2:
    """Degree-2 scalar polynomial a + b*x + c*x^2 (reference util.rs:27,157-161)."""

    def __init__(self, a: Scalar, b: Scalar, c: Scalar):
        self.a, self.b, self.c = a, b, c

    def eval(self, x: Scalar) -> Scalar:
        return self.a + x * (self.b + x * self.c)

    def wipe(self) -> None:
        """Best-effort secret clearing (reference util.rs:202-208)."""
        self.a = self.b = self.c = None


class VecPoly3:
    """Degree-3 vector polynomial for R1CS (reference util.rs:19,113-155)."""

    def __init__(self, c0, c1, c2, c3):
        self.c = [c0, c1, c2, c3]

    @classmethod
    def zero(cls, n: int) -> "VecPoly3":
        z = [Scalar.zero()] * n
        return cls(list(z), list(z), list(z), list(z))

    @staticmethod
    def special_inner_product(l: "VecPoly3", r: "VecPoly3") -> "Poly6":
        """Inner product exploiting l.c[0] == 0 and r.c[2] == 0
        (reference util.rs:122-146)."""
        t1 = inner_product(l.c[1], r.c[0])
        t2 = inner_product(l.c[1], r.c[1]) + inner_product(l.c[2], r.c[0])
        t3 = inner_product(l.c[2], r.c[1]) + inner_product(l.c[3], r.c[0])
        t4 = inner_product(l.c[1], r.c[3]) + inner_product(l.c[3], r.c[1])
        t5 = inner_product(l.c[2], r.c[3])
        t6 = inner_product(l.c[3], r.c[3])
        return Poly6(t1, t2, t3, t4, t5, t6)

    def eval(self, x: Scalar) -> List[Scalar]:
        return [c0 + x * (c1 + x * (c2 + x * c3))
                for c0, c1, c2, c3 in zip(*self.c)]

    def wipe(self) -> None:
        """Best-effort secret clearing (reference util.rs:188-200)."""
        for ci in self.c:
            ci.clear()


class Poly6:
    """Degree-6 scalar polynomial with no constant term (reference util.rs:31-38)."""

    def __init__(self, t1, t2, t3, t4, t5, t6):
        self.t = [t1, t2, t3, t4, t5, t6]

    def eval(self, x: Scalar) -> Scalar:
        acc = Scalar.zero()
        for coeff in reversed(self.t):
            acc = x * (coeff + acc)
        return acc

    def wipe(self) -> None:
        """Best-effort secret clearing (reference util.rs:210-217)."""
        self.t = [None] * 6


def read32(data: bytes, offset: int = 0) -> bytes:
    return data[offset: offset + 32]
