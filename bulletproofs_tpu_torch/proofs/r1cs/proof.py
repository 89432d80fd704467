"""R1CSProof struct and versioned wire format (reference src/r1cs/proof.rs).

Layout: 1 version byte (0 = one-phase, 1 = two-phase), 8 or 11 compressed
points (A_I1, A_O1, S1, [A_I2, A_O2, S2], T_1, T_3..T_6), three scalars,
then the inner-product proof.  Phase-2 commitments are omitted on the wire
when they are identity points.
"""

from __future__ import annotations

from ...core.scalar import Scalar
from ...errors import R1CSError
from ..ipp import InnerProductProof

ONE_PHASE_COMMITMENTS = 0
TWO_PHASE_COMMITMENTS = 1

_IDENTITY = bytes(32)


class R1CSProof:
    __slots__ = ("A_I1", "A_O1", "S1", "A_I2", "A_O2", "S2",
                 "T_1", "T_3", "T_4", "T_5", "T_6",
                 "t_x", "t_x_blinding", "e_blinding", "ipp_proof")

    def __init__(self, A_I1, A_O1, S1, A_I2, A_O2, S2,
                 T_1, T_3, T_4, T_5, T_6, t_x, t_x_blinding, e_blinding,
                 ipp_proof: InnerProductProof):
        self.A_I1, self.A_O1, self.S1 = A_I1, A_O1, S1
        self.A_I2, self.A_O2, self.S2 = A_I2, A_O2, S2
        self.T_1, self.T_3, self.T_4, self.T_5, self.T_6 = T_1, T_3, T_4, T_5, T_6
        self.t_x, self.t_x_blinding, self.e_blinding = t_x, t_x_blinding, e_blinding
        self.ipp_proof = ipp_proof

    def missing_phase2_commitments(self) -> bool:
        return (self.A_I2 == _IDENTITY and self.A_O2 == _IDENTITY
                and self.S2 == _IDENTITY)

    def serialized_size(self) -> int:
        elements = 11 if self.missing_phase2_commitments() else 14
        return 1 + elements * 32 + self.ipp_proof.serialized_size()

    def to_bytes(self) -> bytes:
        buf = bytearray()
        if self.missing_phase2_commitments():
            buf.append(ONE_PHASE_COMMITMENTS)
            buf += self.A_I1 + self.A_O1 + self.S1
        else:
            buf.append(TWO_PHASE_COMMITMENTS)
            buf += self.A_I1 + self.A_O1 + self.S1
            buf += self.A_I2 + self.A_O2 + self.S2
        buf += self.T_1 + self.T_3 + self.T_4 + self.T_5 + self.T_6
        buf += self.t_x.to_bytes()
        buf += self.t_x_blinding.to_bytes()
        buf += self.e_blinding.to_bytes()
        buf += self.ipp_proof.to_bytes()
        return bytes(buf)

    @classmethod
    def from_bytes(cls, data: bytes) -> "R1CSProof":
        if len(data) < 1:
            raise R1CSError(R1CSError.FORMAT)
        version = data[0]
        body = data[1:]
        if len(body) % 32 != 0:
            raise R1CSError(R1CSError.FORMAT)

        if version == ONE_PHASE_COMMITMENTS:
            min_elements = 11
        elif version == TWO_PHASE_COMMITMENTS:
            min_elements = 14
        else:
            raise R1CSError(R1CSError.FORMAT)
        if len(body) // 32 < min_elements:
            raise R1CSError(R1CSError.FORMAT)

        def word(i):
            return body[32 * i: 32 * (i + 1)]

        A_I1, A_O1, S1 = word(0), word(1), word(2)
        if version == TWO_PHASE_COMMITMENTS:
            A_I2, A_O2, S2 = word(3), word(4), word(5)
            off = 6
        else:
            A_I2, A_O2, S2 = _IDENTITY, _IDENTITY, _IDENTITY
            off = 3
        T_1, T_3, T_4, T_5, T_6 = (word(off + i) for i in range(5))
        off += 5
        t_x = Scalar.from_canonical_bytes(word(off))
        t_x_blinding = Scalar.from_canonical_bytes(word(off + 1))
        e_blinding = Scalar.from_canonical_bytes(word(off + 2))
        if t_x is None or t_x_blinding is None or e_blinding is None:
            raise R1CSError(R1CSError.FORMAT)
        off += 3
        try:
            ipp = InnerProductProof.from_bytes(body[32 * off:])
        except Exception:
            raise R1CSError(R1CSError.FORMAT)
        return cls(A_I1, A_O1, S1, A_I2, A_O2, S2, T_1, T_3, T_4, T_5, T_6,
                   t_x, t_x_blinding, e_blinding, ipp)
