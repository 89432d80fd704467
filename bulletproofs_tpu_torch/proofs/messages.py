"""Messages passed between parties and dealer in the aggregated-rangeproof
MPC protocol, plus per-share auditing.

Mirrors dalek-bulletproofs/src/range_proof/messages.rs.  The dataclasses are
the de-facto wire format (each has to_bytes/from_bytes); the same objects
flow in-process for single-party proving, across processes for true MPC, or
as tensors reduced with psum in the collective path
(bulletproofs_tpu_torch.parallel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..core.ristretto import RistrettoPoint, multiscalar_mul
from ..core.scalar import Scalar
from ..utils.util import exp_iter_take, scalar_exp_vartime, sum_of_powers, inner_product


@dataclass
class BitCommitment:
    """V_j (compressed), A_j, S_j (reference messages.rs:18-22)."""
    V_j: bytes
    A_j: RistrettoPoint
    S_j: RistrettoPoint


@dataclass
class BitChallenge:
    y: Scalar
    z: Scalar


@dataclass
class PolyCommitment:
    T_1_j: RistrettoPoint
    T_2_j: RistrettoPoint


@dataclass
class PolyChallenge:
    x: Scalar


@dataclass
class ProofShare:
    """A party's share, ready for aggregation (reference messages.rs:47-53)."""
    t_x: Scalar
    t_x_blinding: Scalar
    e_blinding: Scalar
    l_vec: List[Scalar]
    r_vec: List[Scalar]

    def check_size(self, expected_n: int, bp_gens, j: int) -> bool:
        """Size consistency (reference messages.rs:57-80)."""
        if len(self.l_vec) != expected_n:
            return False
        if len(self.r_vec) != expected_n:
            return False
        if expected_n > bp_gens.gens_capacity:
            return False
        if j >= bp_gens.party_capacity:
            return False
        return True

    def audit_share(self, bp_gens, pc_gens, j: int,
                    bit_commitment: BitCommitment,
                    bit_challenge: BitChallenge,
                    poly_commitment: PolyCommitment,
                    poly_challenge: PolyChallenge) -> bool:
        """Verify the two per-share equations (reference messages.rs:84-167);
        used by the dealer to pinpoint dishonest parties."""
        n = len(self.l_vec)
        if not self.check_size(n, bp_gens, j):
            return False

        y, z = bit_challenge.y, bit_challenge.z
        x = poly_challenge.x
        zz = z * z
        minus_z = -z
        z_j = scalar_exp_vartime(z, j)
        y_jn = scalar_exp_vartime(y, j * n)
        y_jn_inv = y_jn.invert()
        y_inv = y.invert()

        if self.t_x != inner_product(self.l_vec, self.r_vec):
            return False

        exp_2 = exp_iter_take(Scalar(2), n)
        exp_y_inv = exp_iter_take(y_inv, n)

        g = [minus_z - l_i for l_i in self.l_vec]
        h = [z + ey * y_jn_inv * (-r_i) + ey * y_jn_inv * (zz * z_j * e2)
             for r_i, e2, ey in zip(self.r_vec, exp_2, exp_y_inv)]

        P_check = multiscalar_mul(
            [Scalar.one(), x, -self.e_blinding] + g + h,
            [bit_commitment.A_j, bit_commitment.S_j, pc_gens.B_blinding]
            + bp_gens.share(j).G(n) + bp_gens.share(j).H(n))
        if not P_check.is_identity():
            return False

        V_j = RistrettoPoint.decompress(bit_commitment.V_j)
        if V_j is None:
            return False

        sum_y = sum_of_powers(y, n)
        sum_2 = sum_of_powers(Scalar(2), n)
        delta = (z - zz) * sum_y * y_jn - z * zz * sum_2 * z_j
        t_check = multiscalar_mul(
            [zz * z_j, x, x * x, delta - self.t_x, -self.t_x_blinding],
            [V_j, poly_commitment.T_1_j, poly_commitment.T_2_j,
             pc_gens.B, pc_gens.B_blinding])
        return t_check.is_identity()


# ---------------------------------------------------------------------------
# Wire codecs: bincode-compatible framing (fixed 32-byte points/scalars;
# u64-LE length prefixes for vectors), matching how the reference's
# serde-derived messages serialize under bincode (tests/range_proof.rs uses
# bincode for proofs; messages.rs:17-53 derives Serialize/Deserialize).
# ---------------------------------------------------------------------------

import struct as _struct


def _point_bytes(p: RistrettoPoint) -> bytes:
    return p.compress()


def _read_point(data: bytes, off: int):
    p = RistrettoPoint.decompress(data[off:off + 32])
    if p is None:
        raise ValueError("invalid point encoding")
    return p, off + 32


def _read_scalar(data: bytes, off: int):
    s = Scalar.from_canonical_bytes(data[off:off + 32])
    if s is None:
        raise ValueError("invalid scalar encoding")
    return s, off + 32


def bit_commitment_to_bytes(m: BitCommitment) -> bytes:
    return m.V_j + _point_bytes(m.A_j) + _point_bytes(m.S_j)


def bit_commitment_from_bytes(data: bytes) -> BitCommitment:
    A, off = _read_point(data, 32)
    S, off = _read_point(data, off)
    return BitCommitment(V_j=data[:32], A_j=A, S_j=S)


def bit_challenge_to_bytes(m: BitChallenge) -> bytes:
    return m.y.to_bytes() + m.z.to_bytes()


def bit_challenge_from_bytes(data: bytes) -> BitChallenge:
    y, off = _read_scalar(data, 0)
    z, off = _read_scalar(data, off)
    return BitChallenge(y=y, z=z)


def poly_commitment_to_bytes(m: PolyCommitment) -> bytes:
    return _point_bytes(m.T_1_j) + _point_bytes(m.T_2_j)


def poly_commitment_from_bytes(data: bytes) -> PolyCommitment:
    T1, off = _read_point(data, 0)
    T2, off = _read_point(data, off)
    return PolyCommitment(T_1_j=T1, T_2_j=T2)


def poly_challenge_to_bytes(m: PolyChallenge) -> bytes:
    return m.x.to_bytes()


def poly_challenge_from_bytes(data: bytes) -> PolyChallenge:
    x, _ = _read_scalar(data, 0)
    return PolyChallenge(x=x)


def proof_share_to_bytes(m: ProofShare) -> bytes:
    buf = bytearray()
    buf += m.t_x.to_bytes() + m.t_x_blinding.to_bytes() + m.e_blinding.to_bytes()
    buf += _struct.pack("<Q", len(m.l_vec))
    for s in m.l_vec:
        buf += s.to_bytes()
    buf += _struct.pack("<Q", len(m.r_vec))
    for s in m.r_vec:
        buf += s.to_bytes()
    return bytes(buf)


def proof_share_from_bytes(data: bytes) -> ProofShare:
    t_x, off = _read_scalar(data, 0)
    t_x_blinding, off = _read_scalar(data, off)
    e_blinding, off = _read_scalar(data, off)
    (n,) = _struct.unpack_from("<Q", data, off)
    off += 8
    l_vec = []
    for _ in range(n):
        s, off = _read_scalar(data, off)
        l_vec.append(s)
    (n,) = _struct.unpack_from("<Q", data, off)
    off += 8
    r_vec = []
    for _ in range(n):
        s, off = _read_scalar(data, off)
        r_vec.append(s)
    return ProofShare(t_x=t_x, t_x_blinding=t_x_blinding, e_blinding=e_blinding,
                      l_vec=l_vec, r_vec=r_vec)
