"""Scalars mod the ristretto255 group order (host core).

Mirrors curve25519-dalek's `Scalar` semantics (the reference's scalar layer,
SURVEY.md §2b): canonical 32-byte little-endian encodings, wide (64-byte)
reduction, and Montgomery-trick batch inversion
(used by the reference at src/inner_product_proof.rs:227).

Backed by Python ints for the sequential host path; the batched TPU path
operates on packed-limb tensors (`bulletproofs_tpu_torch.ops.scalar`).
"""

from __future__ import annotations

# group order: 2^252 + 27742317777372353535851937790883648493
L = 2 ** 252 + 27742317777372353535851937790883648493


class Scalar:
    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = v % L

    # -- constructors -------------------------------------------------------
    @classmethod
    def zero(cls) -> "Scalar":
        return cls(0)

    @classmethod
    def one(cls) -> "Scalar":
        return cls(1)

    @classmethod
    def from_int(cls, x: int) -> "Scalar":
        return cls(x)

    @classmethod
    def from_bytes_mod_order(cls, b: bytes) -> "Scalar":
        assert len(b) == 32
        return cls(int.from_bytes(b, "little"))

    @classmethod
    def from_bytes_mod_order_wide(cls, b: bytes) -> "Scalar":
        assert len(b) == 64
        return cls(int.from_bytes(b, "little"))

    @classmethod
    def from_canonical_bytes(cls, b: bytes) -> "Scalar":
        """Reject non-canonical encodings (value >= L); reference relies on
        this during deserialization (src/inner_product_proof.rs:395-400)."""
        assert len(b) == 32
        x = int.from_bytes(b, "little")
        if x >= L:
            return None
        return cls(x)

    @classmethod
    def random(cls, rng) -> "Scalar":
        """64 uniform bytes reduced wide (dalek `Scalar::random`)."""
        return cls.from_bytes_mod_order_wide(rng.randbytes(64))

    # -- encoding -----------------------------------------------------------
    def to_bytes(self) -> bytes:
        return self.v.to_bytes(32, "little")

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o: "Scalar") -> "Scalar":
        return Scalar(self.v + o.v)

    def __sub__(self, o: "Scalar") -> "Scalar":
        return Scalar(self.v - o.v)

    def __mul__(self, o: "Scalar") -> "Scalar":
        return Scalar(self.v * o.v)

    def __neg__(self) -> "Scalar":
        return Scalar(-self.v)

    def __eq__(self, o) -> bool:
        return isinstance(o, Scalar) and self.v == o.v

    def __hash__(self):
        return hash(("Scalar", self.v))

    def __repr__(self):
        return f"Scalar({self.v:#x})"

    def invert(self) -> "Scalar":
        from ._native import LIB as _N
        if _N is not None:
            import ctypes
            out = ctypes.create_string_buffer(32)
            _N.sc_invert1(self.v.to_bytes(32, "little"), out)
            return Scalar(int.from_bytes(out.raw, "little"))
        return Scalar(pow(self.v, L - 2, L))

    def is_zero(self) -> bool:
        return self.v == 0


def batch_invert(xs: list) -> "Scalar":
    """Montgomery-trick batch inversion (dalek `Scalar::batch_invert`;
    reference call site src/inner_product_proof.rs:227).

    Replaces each element of `xs` with its inverse and returns the inverse of
    the product of the original elements.
    """
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x.v % L
    allinv = Scalar(prefix[n] % L).invert().v
    acc = allinv
    for i in range(n - 1, -1, -1):
        orig = xs[i].v
        xs[i] = Scalar(acc * prefix[i])
        acc = acc * orig % L
    return Scalar(allinv)
