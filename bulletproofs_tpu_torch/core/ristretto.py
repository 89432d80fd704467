"""ristretto255 group (host core): extended twisted Edwards points with
compress / decompress / Elligator hash-to-group, plus a host Pippenger MSM.

Semantics match curve25519-dalek's `RistrettoPoint` (the reference's point
layer, SURVEY.md §2b) per RFC 9496: ENCODE, DECODE, MAP, and
`from_uniform_bytes` (two MAPs summed).  Backed by Python ints; the batched
TPU counterpart lives in `bulletproofs_tpu_torch.ops.curve` and is tested
against this implementation.
"""

from __future__ import annotations

import ctypes as _ct

from .field import (P, D, EDWARDS_D2, SQRT_M1, ONE_MINUS_D_SQ, D_MINUS_ONE_SQ,
                    SQRT_AD_MINUS_ONE, INVSQRT_A_MINUS_D,
                    fe_from_bytes, fe_to_bytes, is_negative, ct_abs, invert,
                    sqrt_ratio_m1)
from .scalar import Scalar, L
from ._native import LIB as _NATIVE


def _to_ext(p: "RistrettoPoint") -> bytes:
    """128-byte extended-coordinate boundary encoding for the C backend."""
    return (p.X.to_bytes(32, "little") + p.Y.to_bytes(32, "little")
            + p.Z.to_bytes(32, "little") + p.T.to_bytes(32, "little"))


def _from_ext(b: bytes) -> "RistrettoPoint":
    return RistrettoPoint(
        int.from_bytes(b[0:32], "little"), int.from_bytes(b[32:64], "little"),
        int.from_bytes(b[64:96], "little"), int.from_bytes(b[96:128], "little"))


class RistrettoPoint:
    """Extended twisted Edwards coordinates (X : Y : Z : T), x*y = T/Z."""

    __slots__ = ("X", "Y", "Z", "T")

    def __init__(self, X: int, Y: int, Z: int, T: int):
        self.X, self.Y, self.Z, self.T = X % P, Y % P, Z % P, T % P

    # -- constructors -------------------------------------------------------
    @classmethod
    def identity(cls) -> "RistrettoPoint":
        return cls(0, 1, 1, 0)

    @classmethod
    def from_affine(cls, x: int, y: int) -> "RistrettoPoint":
        return cls(x, y, 1, x * y % P)

    # -- group ops (complete formulas; add-2008-hwcd-3 for a = -1) ----------
    def __add__(self, o: "RistrettoPoint") -> "RistrettoPoint":
        A = (self.Y - self.X) * (o.Y - o.X) % P
        B = (self.Y + self.X) * (o.Y + o.X) % P
        C = self.T * EDWARDS_D2 % P * o.T % P
        Dv = 2 * self.Z * o.Z % P
        E = B - A
        F = Dv - C
        G = Dv + C
        H = B + A
        return RistrettoPoint(E * F, G * H, F * G, E * H)

    def double(self) -> "RistrettoPoint":
        # dbl-2008-hwcd for a = -1
        A = self.X * self.X % P
        B = self.Y * self.Y % P
        C = 2 * self.Z * self.Z % P
        H = A + B
        E = H - (self.X + self.Y) ** 2 % P
        G = A - B
        F = C + G
        return RistrettoPoint(E * F, G * H, F * G, E * H)

    def __neg__(self) -> "RistrettoPoint":
        return RistrettoPoint(-self.X, self.Y, self.Z, -self.T)

    def __sub__(self, o: "RistrettoPoint") -> "RistrettoPoint":
        return self + (-o)

    def __rmul__(self, s) -> "RistrettoPoint":
        return self.scalar_mul(s)

    def scalar_mul(self, s) -> "RistrettoPoint":
        k = s.v if isinstance(s, Scalar) else int(s)
        if _NATIVE is not None and k.bit_length() > 8:
            # mod-l reduction only moves the result within its ristretto
            # coset (all valid representatives have order dividing 4l, and
            # encode/eq quotient out the 4-torsion)
            out = _ct.create_string_buffer(128)
            _NATIVE.rist_scalar_mul(_to_ext(self), (k % L).to_bytes(32, "little"), out)
            return _from_ext(out.raw)
        if k < 0:
            return (-self).scalar_mul(-k)
        acc = RistrettoPoint.identity()
        base = self
        while k:
            if k & 1:
                acc = acc + base
            base = base.double()
            k >>= 1
        return acc

    def __eq__(self, o) -> bool:
        """Ristretto equality: X1*Y2 == Y1*X2 or X1*X2 == Y1*Y2
        (coset-aware; dalek `RistrettoPoint::ct_eq`)."""
        if not isinstance(o, RistrettoPoint):
            return NotImplemented
        a = (self.X * o.Y - self.Y * o.X) % P == 0
        b = (self.X * o.X - self.Y * o.Y) % P == 0
        return a or b

    def __hash__(self):
        return hash(self.compress())

    def is_identity(self) -> bool:
        return self == RistrettoPoint.identity()

    # -- encoding (RFC 9496 ENCODE / dalek compress) ------------------------
    def compress(self) -> bytes:
        if _NATIVE is not None:
            out = _ct.create_string_buffer(32)
            _NATIVE.rist_compress(_to_ext(self), out)
            return out.raw
        return self._compress_py()

    def _compress_py(self) -> bytes:
        u1 = (self.Z + self.Y) * (self.Z - self.Y) % P
        u2 = self.X * self.Y % P
        _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
        den1 = invsqrt * u1 % P
        den2 = invsqrt * u2 % P
        z_inv = den1 * den2 % P * self.T % P
        ix0 = self.X * SQRT_M1 % P
        iy0 = self.Y * SQRT_M1 % P
        enchanted = den1 * INVSQRT_A_MINUS_D % P
        rotate = is_negative(self.T * z_inv % P)
        if rotate:
            x, y, den_inv = iy0, ix0, enchanted
        else:
            x, y, den_inv = self.X, self.Y, den2
        if is_negative(x * z_inv % P):
            y = (P - y) % P
        s = ct_abs(den_inv * ((self.Z - y) % P) % P)
        return fe_to_bytes(s)

    @classmethod
    def decompress(cls, b: bytes):
        """RFC 9496 DECODE; returns None on invalid encodings (canonical-ness,
        negativity, and curve checks match dalek)."""
        if len(b) != 32:
            return None
        if _NATIVE is not None:
            out = _ct.create_string_buffer(128)
            if not _NATIVE.rist_decompress(bytes(b), out):
                return None
            return _from_ext(out.raw)
        s_int = int.from_bytes(b, "little")
        if s_int >= P:  # non-canonical
            return None
        s = s_int
        if is_negative(s):
            return None
        ss = s * s % P
        u1 = (1 - ss) % P
        u2 = (1 + ss) % P
        u2_sqr = u2 * u2 % P
        v = (-(D * u1 % P * u1 % P) - u2_sqr) % P
        was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
        den_x = invsqrt * u2 % P
        den_y = invsqrt * den_x % P * v % P
        x = ct_abs(2 * s % P * den_x % P)
        y = u1 * den_y % P
        t = x * y % P
        if (not was_square) or is_negative(t) or y == 0:
            return None
        return cls(x, y, 1, t)

    # -- hash-to-group (RFC 9496 MAP + dalek from_uniform_bytes) ------------
    @classmethod
    def _elligator_map(cls, t: int) -> "RistrettoPoint":
        r = SQRT_M1 * t % P * t % P
        u = (r + 1) % P * ONE_MINUS_D_SQ % P
        v = (-1 - r * D) % P * ((r + D) % P) % P
        was_square, s = sqrt_ratio_m1(u, v)
        if was_square:
            c = P - 1
        else:
            s = (P - ct_abs(s * t % P)) % P
            c = r
        n = (c * ((r - 1) % P) % P * D_MINUS_ONE_SQ - v) % P
        w0 = 2 * s * v % P
        w1 = n * SQRT_AD_MINUS_ONE % P
        w2 = (1 - s * s) % P
        w3 = (1 + s * s) % P
        return cls(w0 * w3, w2 * w1, w1 * w3, w0 * w2)

    @classmethod
    def from_uniform_bytes(cls, b: bytes) -> "RistrettoPoint":
        assert len(b) == 64
        if _NATIVE is not None:
            out = _ct.create_string_buffer(128)
            _NATIVE.rist_from_uniform_bytes(bytes(b), out)
            return _from_ext(out.raw)
        p1 = cls._elligator_map(fe_from_bytes(b[:32]))
        p2 = cls._elligator_map(fe_from_bytes(b[32:]))
        return p1 + p2

    @classmethod
    def hash_from_bytes_sha3_512(cls, data: bytes) -> "RistrettoPoint":
        """dalek `RistrettoPoint::hash_from_bytes::<Sha3_512>` (used for the
        default Pedersen blinding base, reference src/generators.rs:48-52)."""
        import hashlib
        return cls.from_uniform_bytes(hashlib.sha3_512(data).digest())

    def __repr__(self):
        return f"RistrettoPoint({self.compress().hex()})"


# -- fixed basepoint --------------------------------------------------------
def _basepoint() -> RistrettoPoint:
    y = 4 * invert(5) % P
    x2 = (y * y - 1) * invert(D * y % P * y % P + 1) % P
    _, x = sqrt_ratio_m1(x2, 1)
    # ed25519 basepoint has the even x
    if x & 1:
        x = P - x
    return RistrettoPoint.from_affine(x, y)


RISTRETTO_BASEPOINT = _basepoint()


def pack_points(points) -> bytes:
    """Pack points into the 128-byte-per-point native boundary format once,
    for repeated MSMs over a fixed basis (IPP rounds, fixed generators)."""
    return b"".join(_to_ext(p) for p in points)


def msm_packed(scalars, packed: bytes) -> RistrettoPoint:
    """MSM over a pre-packed point buffer (see pack_points).  `scalars` are
    Scalars or ints; zero scalars cost only digit extraction, so callers
    may mask out points by zeroing their coefficients."""
    n = len(packed) // 128
    assert len(scalars) == n
    if _NATIVE is not None:
        spack = b"".join(
            ((s.v if isinstance(s, Scalar) else int(s)) % L).to_bytes(32, "little")
            for s in scalars)
        out = _ct.create_string_buffer(128)
        _NATIVE.rist_msm(n, spack, packed, out)
        return _from_ext(out.raw)
    return multiscalar_mul(
        scalars, [_from_ext(packed[128 * i:128 * (i + 1)]) for i in range(n)])


def multiscalar_mul_ct(scalars, points) -> RistrettoPoint:
    """Constant-time Straus MSM for witness-dependent commitments.

    Mirrors the reference's `MultiscalarMul` (consttime) vs
    `VartimeMultiscalarMul` split: the prover's bit/blinding commitments
    use this path (reference src/range_proof/party.rs:119-124,
    src/generators.rs:39-41, src/r1cs/prover.rs:433-459), while verifier
    MSMs over public data stay on the vartime Pippenger.  The native
    backend (rist_msm_ct) performs signed radix-16 Straus with branchless
    table scans; without it we fall back to the pure-Python path, which —
    like any Python big-int code — makes no timing guarantees.
    """
    if _NATIVE is None or len(points) == 0:
        if len(points):
            from ..config import vartime_witness_fallback
            vartime_witness_fallback("multiscalar_mul_ct")
        return multiscalar_mul(scalars, points)
    scalars = [s.v if isinstance(s, Scalar) else int(s) for s in scalars]
    points = list(points)
    assert len(scalars) == len(points)
    spack = b"".join((s % L).to_bytes(32, "little") for s in scalars)
    ppack = b"".join(_to_ext(p) for p in points)
    out = _ct.create_string_buffer(128)
    _NATIVE.rist_msm_ct(len(points), spack, ppack, out)
    return _from_ext(out.raw)


def bit_commit(n: int, v: int, Gs, Hs, blind, B_blinding) -> RistrettoPoint:
    """A_j = blind*B̃ + Σ_i (bit_i(v) ? G_i : −H_i), branchless in the value
    bits (reference src/range_proof/party.rs:102-112, which uses
    subtle::ConditionallySelectable for the same reason)."""
    if _NATIVE is not None:
        gpack = b"".join(_to_ext(p) for p in Gs[:n])
        hpack = b"".join(_to_ext(p) for p in Hs[:n])
        sblind = ((blind.v if isinstance(blind, Scalar) else int(blind)) % L
                  ).to_bytes(32, "little")
        out = _ct.create_string_buffer(128)
        _NATIVE.rist_bit_commit(n, v & ((1 << 64) - 1), gpack, hpack,
                                sblind, _to_ext(B_blinding), out)
        return _from_ext(out.raw)
    # pure-Python oracle: same sum as one MSM with scalars v_i and v_i - 1
    from ..config import vartime_witness_fallback
    vartime_witness_fallback("bit_commit")
    bits = [(v >> i) & 1 for i in range(n)]
    return multiscalar_mul(
        [blind] + bits + [b - 1 for b in bits],
        [B_blinding] + list(Gs[:n]) + list(Hs[:n]))


def multiscalar_mul(scalars, points) -> RistrettoPoint:
    """Host Pippenger MSM (test oracle / small-input path).

    The production MSM of this package is the CUDA Pippenger in
    `bulletproofs_tpu_torch.ops.msm`; this
    mirrors the reference's `VartimeMultiscalarMul` role
    (SURVEY.md §2b "the hot loop").
    """
    scalars = [s.v if isinstance(s, Scalar) else int(s) for s in scalars]
    points = list(points)
    assert len(scalars) == len(points)
    n = len(points)
    if n == 0:
        return RistrettoPoint.identity()
    if _NATIVE is not None:
        spack = b"".join((s % L).to_bytes(32, "little") for s in scalars)
        ppack = b"".join(_to_ext(p) for p in points)
        out = _ct.create_string_buffer(128)
        _NATIVE.rist_msm(n, spack, ppack, out)
        return _from_ext(out.raw)
    c = 6 if n < 32 else (8 if n < 512 else 12)
    nwin = (253 + c - 1) // c
    acc = RistrettoPoint.identity()
    for w in range(nwin - 1, -1, -1):
        for _ in range(c if w != nwin - 1 else 0):
            acc = acc.double()
        buckets = [None] * (1 << c)
        for s, pt in zip(scalars, points):
            digit = (s >> (w * c)) & ((1 << c) - 1)
            if digit:
                buckets[digit] = pt if buckets[digit] is None else buckets[digit] + pt
        running = None
        windowsum = None
        for b in range(len(buckets) - 1, 0, -1):
            if buckets[b] is not None:
                running = buckets[b] if running is None else running + buckets[b]
            if running is not None:
                windowsum = running if windowsum is None else windowsum + running
        if windowsum is not None:
            acc = acc + windowsum
    return acc
