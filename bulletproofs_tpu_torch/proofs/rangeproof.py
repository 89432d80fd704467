"""Aggregated range proofs (prove / verify / wire format).

Protocol, transcript schedule, and serialization match the reference
(dalek-bulletproofs/src/range_proof/mod.rs).  Proving runs the MPC protocol
locally (dealer + m parties in-process, reference mod.rs:243-287).
Verification replays the transcript and reduces to ONE mega-MSM over
2nm + 2lg(nm) + m + 8 points (reference mod.rs:421-451) -- the kernel the
TPU path shards across chips (bulletproofs_tpu_torch.parallel.batch_verify).

`verify_multiple` accepts an optional `msm` callable so the device MSM can
be injected.  Without one it takes the batch verifier's C++ route
(parallel/batch_verify.host_verify_one) where the JAX package does: the
native library built, n in {8, 16, 32, 64}, m a power of two within the
generators' capacities, a native-backed transcript; else it replays in
Python and runs the host Pippenger MSM.
"""

from __future__ import annotations

import secrets
from typing import List

from ..core.ristretto import RistrettoPoint, multiscalar_mul
from ..core.scalar import Scalar
from ..errors import ProofError, MPCError
from ..generators import BulletproofGens, PedersenGens
from ..transcript import Transcript
from ..utils.util import exp_iter_take, sum_of_powers
from .ipp import InnerProductProof


class SystemRandom:
    """Default RNG: OS entropy."""

    @staticmethod
    def randbytes(n: int) -> bytes:
        return secrets.token_bytes(n)


class RangeProof:
    __slots__ = ("A", "S", "T_1", "T_2", "t_x", "t_x_blinding", "e_blinding",
                 "ipp_proof")

    def __init__(self, A: bytes, S: bytes, T_1: bytes, T_2: bytes,
                 t_x: Scalar, t_x_blinding: Scalar, e_blinding: Scalar,
                 ipp_proof: InnerProductProof):
        self.A, self.S, self.T_1, self.T_2 = A, S, T_1, T_2
        self.t_x = t_x
        self.t_x_blinding = t_x_blinding
        self.e_blinding = e_blinding
        self.ipp_proof = ipp_proof

    # ------------------------------------------------------------------
    # proving (reference mod.rs:135-311): run the MPC protocol locally
    # ------------------------------------------------------------------
    @classmethod
    def prove_single(cls, bp_gens: BulletproofGens, pc_gens: PedersenGens,
                     transcript: Transcript, v: int, v_blinding: Scalar,
                     n: int, rng=None):
        proof, Vs = cls.prove_multiple(bp_gens, pc_gens, transcript,
                                       [v], [v_blinding], n, rng=rng)
        return proof, Vs[0]

    @classmethod
    def prove_multiple(cls, bp_gens: BulletproofGens, pc_gens: PedersenGens,
                       transcript: Transcript, values: List[int],
                       blindings: List[Scalar], n: int, rng=None):
        from .dealer import Dealer
        from .party import Party

        rng = rng or SystemRandom()
        if len(values) != len(blindings):
            raise ProofError(ProofError.WRONG_NUM_BLINDING_FACTORS,
                             "Wrong number of blinding factors supplied.")

        try:
            dealer = Dealer.new(bp_gens, pc_gens, transcript, n, len(values))

            parties = [Party.new(bp_gens, pc_gens, v, vb, n)
                       for v, vb in zip(values, blindings)]

            states, bit_commitments = zip(*[
                p.assign_position(j, rng) for j, p in enumerate(parties)])
            value_commitments = [bc.V_j for bc in bit_commitments]

            dealer, bit_challenge = dealer.receive_bit_commitments(list(bit_commitments))

            states, poly_commitments = zip(*[
                p.apply_challenge(bit_challenge, rng) for p in states])

            dealer, poly_challenge = dealer.receive_poly_commitments(list(poly_commitments))

            proof_shares = [p.apply_challenge(poly_challenge) for p in states]

            proof = dealer.receive_trusted_shares(proof_shares)
        except MPCError as e:
            raise ProofError.from_mpc(e)

        return proof, value_commitments

    # ------------------------------------------------------------------
    # verification (reference mod.rs:345-451)
    # ------------------------------------------------------------------
    def verify_single(self, bp_gens, pc_gens, transcript, V: bytes, n: int,
                      rng=None, msm=None):
        return self.verify_multiple(bp_gens, pc_gens, transcript, [V], n,
                                    rng=rng, msm=msm)

    def verification_scalars_and_points(self, bp_gens, pc_gens, transcript,
                                        value_commitments: List[bytes], n: int,
                                        rng=None):
        """Replay the transcript and emit (scalars, points) for the single
        mega-MSM check.  Shared by host and device verification paths; the
        batch verifier concatenates these across proofs into one fused MSM.

        Points are returned as 32-byte compressed encodings for the proof
        data and host `RistrettoPoint`s for the cached generators.
        """
        rng = rng or SystemRandom()
        m = len(value_commitments)

        if n not in (8, 16, 32, 64):
            raise ProofError.invalid_bitsize()
        if bp_gens.gens_capacity < n:
            raise ProofError.invalid_generators_length()
        if bp_gens.party_capacity < m:
            raise ProofError.invalid_generators_length()

        transcript.rangeproof_domain_sep(n, m)

        for V in value_commitments:
            # zero commitments allowed (reference mod.rs:370-374)
            transcript.append_point(b"V", V)

        transcript.validate_and_append_point(b"A", self.A)
        transcript.validate_and_append_point(b"S", self.S)

        y = transcript.challenge_scalar(b"y")
        z = transcript.challenge_scalar(b"z")
        zz = z * z
        minus_z = -z

        transcript.validate_and_append_point(b"T_1", self.T_1)
        transcript.validate_and_append_point(b"T_2", self.T_2)

        x = transcript.challenge_scalar(b"x")

        transcript.append_scalar(b"t_x", self.t_x)
        transcript.append_scalar(b"t_x_blinding", self.t_x_blinding)
        transcript.append_scalar(b"e_blinding", self.e_blinding)

        w = transcript.challenge_scalar(b"w")

        # batching scalar for combining the two verification equations
        c = Scalar.random(rng)

        x_sq, x_inv_sq, s = self.ipp_proof.verification_scalars(n * m, transcript)
        s_inv = list(reversed(s))

        a = self.ipp_proof.a
        b = self.ipp_proof.b

        powers_of_2 = exp_iter_take(Scalar(2), n)
        powers_of_z = exp_iter_take(z, m)
        concat_z_and_2 = [e2 * ez for ez in powers_of_z for e2 in powers_of_2]

        y_inv_pows = exp_iter_take(y.invert(), n * m)
        g = [minus_z - a * s_i for s_i in s]
        h = [z + ey * (zz * z2 - b * si) for si, ey, z2
             in zip(s_inv, y_inv_pows, concat_z_and_2)]

        value_commitment_scalars = [c * zz * ez for ez in powers_of_z]
        basepoint_scalar = w * (self.t_x - a * b) + c * (delta(n, m, y, z) - self.t_x)

        scalars = ([Scalar.one(), x, c * x, c * x * x]
                   + x_sq + x_inv_sq
                   + [-self.e_blinding - c * self.t_x_blinding, basepoint_scalar]
                   + g + h + value_commitment_scalars)
        compressed_points = ([self.A, self.S, self.T_1, self.T_2]
                             + self.ipp_proof.L_vec + self.ipp_proof.R_vec)
        static_points = ([pc_gens.B_blinding, pc_gens.B]
                         + bp_gens.G(n, m) + bp_gens.H(n, m))
        return scalars, compressed_points, static_points, list(value_commitments)

    def verification_scalars_ints(self, bp_gens, pc_gens, transcript,
                                  value_commitments: List[bytes], n: int,
                                  rng=None):
        """Raw-integer fast path for batched verification: identical math to
        `verification_scalars_and_points` but on Python ints mod l (no
        Scalar wrappers -- this is per-proof host work on the batched-verify
        critical path).

        Returns (dyn_scalars, static_scalars, dyn_point_bytes) where
        dyn_point_bytes = [A, S, T1, T2, L..., R..., V...] and
        static order = [B_blinding, B, G(n,m)..., H(n,m)...].
        """
        from ..core.scalar import L as ELL

        rng = rng or SystemRandom()
        m = len(value_commitments)

        if n not in (8, 16, 32, 64):
            raise ProofError.invalid_bitsize()
        if bp_gens.gens_capacity < n or bp_gens.party_capacity < m:
            raise ProofError.invalid_generators_length()

        transcript.rangeproof_domain_sep(n, m)
        for V in value_commitments:
            transcript.append_point(b"V", V)
        transcript.validate_and_append_point(b"A", self.A)
        transcript.validate_and_append_point(b"S", self.S)
        y = transcript.challenge_scalar(b"y").v
        z = transcript.challenge_scalar(b"z").v
        zz = z * z % ELL
        transcript.validate_and_append_point(b"T_1", self.T_1)
        transcript.validate_and_append_point(b"T_2", self.T_2)
        x = transcript.challenge_scalar(b"x").v
        transcript.append_scalar(b"t_x", self.t_x)
        transcript.append_scalar(b"t_x_blinding", self.t_x_blinding)
        transcript.append_scalar(b"e_blinding", self.e_blinding)
        w = transcript.challenge_scalar(b"w").v
        c = int.from_bytes(rng.randbytes(64), "little") % ELL

        # ipp challenges (transcript) + s-vector, all raw ints
        lg_n = len(self.ipp_proof.L_vec)
        if lg_n >= 32 or n * m != (1 << lg_n):
            raise ProofError.verification()
        transcript.innerproduct_domain_sep(n * m)
        challenges = []
        for Lp, Rp in zip(self.ipp_proof.L_vec, self.ipp_proof.R_vec):
            transcript.validate_and_append_point(b"L", Lp)
            transcript.validate_and_append_point(b"R", Rp)
            challenges.append(transcript.challenge_scalar(b"u").v)
        prod = 1
        for u in challenges:
            prod = prod * u % ELL
        allinv = pow(prod, ELL - 2, ELL)
        # individual inverses via suffix products
        inv = []
        acc = allinv
        suffix = [1] * (lg_n + 1)
        for i in range(lg_n - 1, -1, -1):
            suffix[i] = suffix[i + 1] * challenges[i] % ELL
        prefix = 1
        for i in range(lg_n):
            inv.append(allinv * prefix % ELL * suffix[i + 1] % ELL)
            prefix = prefix * challenges[i] % ELL
        x_sq = [u * u % ELL for u in challenges]
        x_inv_sq = [u * u % ELL for u in inv]
        nm = n * m
        s = [allinv]
        for i in range(1, nm):
            lg_i = i.bit_length() - 1
            s.append(s[i - (1 << lg_i)] * x_sq[(lg_n - 1) - lg_i] % ELL)

        a = self.ipp_proof.a.v
        b = self.ipp_proof.b.v

        # concat_z_and_2 and y^-i powers
        pow2 = [pow(2, i, ELL) for i in range(n)]
        y_inv = pow(y, ELL - 2, ELL)
        zpow = [1] * m
        for j in range(1, m):
            zpow[j] = zpow[j - 1] * z % ELL
        z_and_2 = [pow2[i] * zpow[j] % ELL for j in range(m) for i in range(n)]
        yi = 1
        minus_z = (-z) % ELL
        g = []
        h = []
        for i in range(nm):
            g.append((minus_z - a * s[i]) % ELL)
            h.append((z + yi * (zz * z_and_2[i] - b * s[nm - 1 - i])) % ELL)
            yi = yi * y_inv % ELL

        vc_scalars = [c * zz % ELL * zj % ELL for zj in zpow]
        delta_v = delta(n, m, Scalar(y), Scalar(z)).v
        basepoint_scalar = (w * (self.t_x.v - a * b) + c * (delta_v - self.t_x.v)) % ELL

        dyn_scalars = ([1, x, c * x % ELL, c * x % ELL * x % ELL]
                       + x_sq + x_inv_sq + vc_scalars)
        static_scalars = ([(-self.e_blinding.v - c * self.t_x_blinding.v) % ELL,
                           basepoint_scalar] + g + h)
        dyn_points = ([self.A, self.S, self.T_1, self.T_2]
                      + self.ipp_proof.L_vec + self.ipp_proof.R_vec
                      + list(value_commitments))
        return dyn_scalars, static_scalars, dyn_points

    def verify_multiple(self, bp_gens, pc_gens, transcript,
                        value_commitments: List[bytes], n: int,
                        rng=None, msm=None):
        # one C++ call (replay, batch decompression, one Pippenger MSM)
        # shared with the batch verifier, under the JAX package's
        # conditions: the native library built, a supported shape, a
        # native-backed transcript and no injected msm
        if msm is None:
            from ..core.ristretto import _NATIVE
            m = len(value_commitments)
            if (_NATIVE is not None
                    and n in (8, 16, 32, 64)
                    and m >= 1 and (m & (m - 1)) == 0
                    and bp_gens.gens_capacity >= n
                    and bp_gens.party_capacity >= m
                    and hasattr(transcript.strobe, "buf")):
                from ..parallel.batch_verify import host_verify_one
                return host_verify_one(self, bp_gens, pc_gens, transcript,
                                       value_commitments, n,
                                       rng or SystemRandom())
        scalars, compressed, static_pts, vcs = self.verification_scalars_and_points(
            bp_gens, pc_gens, transcript, value_commitments, n, rng=rng)

        dyn = [RistrettoPoint.decompress(p) for p in compressed + vcs]
        if any(p is None for p in dyn):
            raise ProofError.verification()
        points = dyn[:len(compressed)] + static_pts + dyn[len(compressed):]

        if msm is None:
            msm = multiscalar_mul      # the native host MSM (rist_msm)
        mega_check = msm(scalars, points)
        if not mega_check.is_identity():
            raise ProofError.verification()

    # ------------------------------------------------------------------
    # serialization (reference mod.rs:474-538)
    # ------------------------------------------------------------------
    def to_bytes(self) -> bytes:
        buf = bytearray()
        buf += self.A
        buf += self.S
        buf += self.T_1
        buf += self.T_2
        buf += self.t_x.to_bytes()
        buf += self.t_x_blinding.to_bytes()
        buf += self.e_blinding.to_bytes()
        buf += self.ipp_proof.to_bytes()
        return bytes(buf)

    @classmethod
    def from_bytes(cls, data: bytes) -> "RangeProof":
        if len(data) % 32 != 0:
            raise ProofError.format()
        if len(data) < 7 * 32:
            raise ProofError.format()
        A = data[0:32]
        S = data[32:64]
        T_1 = data[64:96]
        T_2 = data[96:128]
        t_x = Scalar.from_canonical_bytes(data[128:160])
        t_x_blinding = Scalar.from_canonical_bytes(data[160:192])
        e_blinding = Scalar.from_canonical_bytes(data[192:224])
        if t_x is None or t_x_blinding is None or e_blinding is None:
            raise ProofError.format()
        ipp_proof = InnerProductProof.from_bytes(data[224:])
        return cls(A, S, T_1, T_2, t_x, t_x_blinding, e_blinding, ipp_proof)


def delta(n: int, m: int, y: Scalar, z: Scalar) -> Scalar:
    """delta(y,z) = (z - z^2) <1, y^(nm)> - sum_j z^(j+3) <1, 2^n>
    (reference mod.rs:583-593)."""
    sum_y = sum_of_powers(y, n * m)
    sum_2 = sum_of_powers(Scalar(2), n)
    sum_z = sum_of_powers(z, m)
    return (z - z * z) * sum_y - z * z * z * sum_2 * sum_z
