"""Merlin transcripts and the Bulletproofs transcript protocol.

`Transcript` reimplements the Merlin transcript construction (merlin v2, a
dependency of the reference at dalek-bulletproofs/Cargo.toml:31) on top of
STROBE-128.  The extension methods mirror the reference's
`TranscriptProtocol` trait (dalek-bulletproofs/src/transcript.rs:44-94) with the
same domain-separation labels, so Fiat-Shamir challenges are bit-exact
against the reference's golden proof vectors.

Host-side by design: transcripts are sequential, byte-oriented state
machines; all wide arithmetic driven by the challenges happens on TPU.
"""

from __future__ import annotations

import struct

from .errors import ProofError
from .utils.strobe import Strobe128

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


def _u32le(x: int) -> bytes:
    return struct.pack("<I", x)


def _u64le(x: int) -> bytes:
    return struct.pack("<Q", x)


class Transcript:
    """A Merlin transcript: labeled-message framing over STROBE-128."""

    __slots__ = ("strobe",)

    def __init__(self, label: bytes = None, _strobe: Strobe128 = None):
        if _strobe is not None:
            self.strobe = _strobe
            return
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def clone(self) -> "Transcript":
        return Transcript(_strobe=self.strobe.clone())

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, _u64le(x))

    def append_messages(self, label: bytes, blob: bytes, msg_len: int,
                        count: int) -> None:
        """`count` equal-length messages under one label, byte-identical to
        the append_message loop (batched into one native call when the C++
        strobe backend is loaded -- the R1CS commit hot path)."""
        am = getattr(self.strobe, "append_many", None)
        if am is not None:
            am(label, blob, msg_len, count)
        else:
            for i in range(count):
                self.append_message(label,
                                    blob[i * msg_len: (i + 1) * msg_len])

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(n), True)
        return self.strobe.prf(n, False)

    def build_rng(self) -> "TranscriptRngBuilder":
        return TranscriptRngBuilder(self.strobe.clone())

    # ------------------------------------------------------------------
    # TranscriptProtocol extensions (reference src/transcript.rs:44-94)
    # ------------------------------------------------------------------
    def rangeproof_domain_sep(self, n: int, m: int) -> None:
        self.append_message(b"dom-sep", b"rangeproof v1")
        self.append_u64(b"n", n)
        self.append_u64(b"m", m)

    def innerproduct_domain_sep(self, n: int) -> None:
        self.append_message(b"dom-sep", b"ipp v1")
        self.append_u64(b"n", n)

    def r1cs_domain_sep(self) -> None:
        self.append_message(b"dom-sep", b"r1cs v1")

    def r1cs_1phase_domain_sep(self) -> None:
        self.append_message(b"dom-sep", b"r1cs-1phase")

    def r1cs_2phase_domain_sep(self) -> None:
        self.append_message(b"dom-sep", b"r1cs-2phase")

    def append_scalar(self, label: bytes, scalar) -> None:
        self.append_message(label, scalar.to_bytes())

    def append_point(self, label: bytes, point_bytes: bytes) -> None:
        """Append a 32-byte compressed Ristretto point."""
        self.append_message(label, point_bytes)

    def validate_and_append_point(self, label: bytes, point_bytes: bytes) -> None:
        """Reject the identity point, then append (defense in depth;
        reference src/transcript.rs:75-87)."""
        if point_bytes == bytes(32):
            raise ProofError.verification()
        self.append_message(label, point_bytes)

    def challenge_scalar(self, label: bytes):
        from .core.scalar import Scalar
        return Scalar.from_bytes_mod_order_wide(self.challenge_bytes(label, 64))


class TranscriptRngBuilder:
    """Builds a witness-rekeyed deterministic RNG from a transcript clone
    (merlin's TranscriptRngBuilder; used by the reference R1CS prover at
    src/r1cs/prover.rs:403-413 and verifier at src/r1cs/verifier.rs:447)."""

    __slots__ = ("strobe",)

    def __init__(self, strobe: Strobe128):
        self.strobe = strobe

    def rekey_with_witness_bytes(self, label: bytes, witness: bytes) -> "TranscriptRngBuilder":
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(len(witness)), True)
        self.strobe.key(witness, False)
        return self

    def finalize(self, rng) -> "TranscriptRng":
        random_bytes = rng.randbytes(32)
        self.strobe.meta_ad(b"rng", False)
        self.strobe.key(random_bytes, False)
        return TranscriptRng(self.strobe)


class TranscriptRng:
    """Deterministic RNG bound to the transcript state."""

    __slots__ = ("strobe",)

    def __init__(self, strobe: Strobe128):
        self.strobe = strobe

    def randbytes(self, n: int) -> bytes:
        self.strobe.meta_ad(_u32le(n), False)
        return self.strobe.prf(n, False)
