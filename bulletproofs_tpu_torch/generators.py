"""Pedersen and Bulletproofs generators.

Matches the reference's generator derivation exactly
(dalek-bulletproofs/src/generators.rs): the Pedersen base pair is the
ristretto255 basepoint plus SHA3-512 hash-to-group of its encoding; the
per-party G/H chains are SHAKE256("GeneratorsChain" || label) XOF output fed
64 bytes at a time into ristretto255 hash-to-group, with labels
b"G"||LE32(party) / b"H"||LE32(party).

Generators are derived once on host and cached; `device_gens` uploads the
aggregated G/H vectors to the TPU as packed-limb tensors for the MSM
kernels.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List

from .core.ristretto import (RistrettoPoint, RISTRETTO_BASEPOINT,
                             multiscalar_mul_ct)
from .core.scalar import Scalar


class PedersenGens:
    """Base points for Pedersen commitments (reference src/generators.rs:30-53)."""

    __slots__ = ("B", "B_blinding")

    def __init__(self, B: RistrettoPoint = None, B_blinding: RistrettoPoint = None):
        self.B = B if B is not None else RISTRETTO_BASEPOINT
        self.B_blinding = (B_blinding if B_blinding is not None
                           else RistrettoPoint.hash_from_bytes_sha3_512(
                               RISTRETTO_BASEPOINT.compress()))

    def commit(self, value: Scalar, blinding: Scalar) -> RistrettoPoint:
        # consttime 2-term MSM: value/blinding are witness data (the
        # reference uses MultiscalarMul here, src/generators.rs:39-41)
        return multiscalar_mul_ct([value, blinding], [self.B, self.B_blinding])

    def commit_many(self, values, blindings):
        """Batched `commit` + compress: q consttime 2-term MSMs over the
        shared [B, B~] basis in ONE native call (large-circuit provers
        commit tens of thousands of values; the per-call ctypes round
        trip dominates the loop form).  Returns a list of q compressed
        32-byte encodings.  Falls back to the per-commit path without
        the native backend."""
        from .core.ristretto import _NATIVE, pack_points
        if len(values) != len(blindings):
            raise ValueError(
                f"commit_many: {len(values)} values vs {len(blindings)} "
                "blindings (a silent zip-truncation would emit identity "
                "commitments for the tail)")
        q = len(values)
        if _NATIVE is None or q < 16:
            return [self.commit(v, b).compress()
                    for v, b in zip(values, blindings)]
        import ctypes as _ct
        sc = bytearray(64 * q)
        for i, (v, b) in enumerate(zip(values, blindings)):
            sc[64 * i: 64 * i + 32] = v.to_bytes()
            sc[64 * i + 32: 64 * i + 64] = b.to_bytes()
        basis = pack_points([self.B, self.B_blinding])
        out = _ct.create_string_buffer(128 * q)
        _NATIVE.rist_msm_rows_ct(q, 2, bytes(sc), basis, out)
        comp = _ct.create_string_buffer(32 * q)
        _NATIVE.rist_batch_compress(q, out, comp)
        raw = comp.raw
        return [raw[32 * i: 32 * i + 32] for i in range(q)]


class GeneratorsChain:
    """Deterministic arbitrary-length generator stream
    (reference src/generators.rs:58-104)."""

    def __init__(self, label: bytes):
        self._shake = hashlib.shake_256(b"GeneratorsChain" + label)
        self._offset = 0

    def fast_forward(self, n: int) -> "GeneratorsChain":
        self._offset += n
        return self

    def take(self, count: int) -> List[RistrettoPoint]:
        # hashlib's shake has no streaming reader; squeeze the whole prefix
        # and slice (identical output to an XOF reader).
        total = (self._offset + count) * 64
        stream = self._shake.digest(total)
        out = []
        for i in range(self._offset, self._offset + count):
            out.append(RistrettoPoint.from_uniform_bytes(stream[64 * i: 64 * i + 64]))
        self._offset += count
        return out


class BulletproofGens:
    """Generators for aggregating up to `party_capacity` proofs of up to
    `gens_capacity` bits each (reference src/generators.rs:133-287).

    Per-party namespacing keeps aggregation size orthogonal to bitsize and
    lets `increase_capacity` extend without regenerating.
    """

    def __init__(self, gens_capacity: int, party_capacity: int):
        self.gens_capacity = 0
        self.party_capacity = party_capacity
        self.G_vec: List[List[RistrettoPoint]] = [[] for _ in range(party_capacity)]
        self.H_vec: List[List[RistrettoPoint]] = [[] for _ in range(party_capacity)]
        self._device_cache = {}
        self.increase_capacity(gens_capacity)

    def increase_capacity(self, new_capacity: int) -> None:
        if self.gens_capacity >= new_capacity:
            return
        grow = new_capacity - self.gens_capacity
        for i in range(self.party_capacity):
            label = struct.pack("<I", i)
            self.G_vec[i].extend(
                GeneratorsChain(b"G" + label).fast_forward(self.gens_capacity).take(grow))
            self.H_vec[i].extend(
                GeneratorsChain(b"H" + label).fast_forward(self.gens_capacity).take(grow))
        self.gens_capacity = new_capacity
        self._device_cache.clear()
        if hasattr(self, "_ipp_basis_cache"):
            self._ipp_basis_cache.clear()

    def share(self, j: int) -> "BulletproofGensShare":
        return BulletproofGensShare(self, j)

    def G(self, n: int, m: int) -> List[RistrettoPoint]:
        """Aggregated G generators: party-major interleaving
        (reference src/generators.rs:207-233)."""
        return [self.G_vec[j][i] for j in range(m) for i in range(n)]

    def H(self, n: int, m: int) -> List[RistrettoPoint]:
        return [self.H_vec[j][i] for j in range(m) for i in range(n)]


class BulletproofGensShare:
    """One party's view of the generators (reference src/generators.rs:270-287)."""

    __slots__ = ("gens", "share")

    def __init__(self, gens: BulletproofGens, share: int):
        self.gens = gens
        self.share = share

    def G(self, n: int) -> List[RistrettoPoint]:
        return self.gens.G_vec[self.share][:n]

    def H(self, n: int) -> List[RistrettoPoint]:
        return self.gens.H_vec[self.share][:n]
