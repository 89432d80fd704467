"""Dealer state machine for the aggregated-rangeproof MPC protocol.

Mirrors dalek-bulletproofs/src/range_proof/dealer.rs: the dealer snapshots the
initial transcript (for later self-verification), aggregates commitments
across parties (the psum-shaped reductions of SURVEY.md §2c.5), issues
challenges, and assembles proof shares into the final RangeProof; on
verification failure it audits each share and reports the bad parties.
"""

from __future__ import annotations

from typing import List

from ..core.ristretto import RistrettoPoint
from ..core.scalar import Scalar
from ..errors import MPCError
from ..generators import BulletproofGens, PedersenGens
from ..transcript import Transcript
from ..utils.util import exp_iter_take
from .ipp import InnerProductProof
from .messages import BitCommitment, BitChallenge, PolyCommitment, PolyChallenge, ProofShare


class Dealer:
    @staticmethod
    def new(bp_gens: BulletproofGens, pc_gens: PedersenGens,
            transcript: Transcript, n: int, m: int) -> "DealerAwaitingBitCommitments":
        """Validate parameters and snapshot the transcript
        (reference dealer.rs:37-81)."""
        if n not in (8, 16, 32, 64):
            raise MPCError(MPCError.INVALID_BITSIZE)
        if m & (m - 1) or m == 0:
            raise MPCError(MPCError.INVALID_AGGREGATION)
        if bp_gens.gens_capacity < n:
            raise MPCError(MPCError.INVALID_GENERATORS_LENGTH)
        if bp_gens.party_capacity < m:
            raise MPCError(MPCError.INVALID_GENERATORS_LENGTH)

        initial_transcript = transcript.clone()
        transcript.rangeproof_domain_sep(n, m)
        return DealerAwaitingBitCommitments(
            bp_gens, pc_gens, transcript, initial_transcript, n, m)


class _OneShot:
    _used = False

    def _consume(self):
        if self._used:
            raise RuntimeError("MPC state already consumed (session types)")
        self._used = True


class DealerAwaitingBitCommitments(_OneShot):
    def __init__(self, bp_gens, pc_gens, transcript, initial_transcript, n, m):
        self.bp_gens = bp_gens
        self.pc_gens = pc_gens
        self.transcript = transcript
        self.initial_transcript = initial_transcript
        self.n = n
        self.m = m

    def receive_bit_commitments(self, bit_commitments: List[BitCommitment]):
        """Aggregate A = sum A_j, S = sum S_j; derive y, z
        (reference dealer.rs:98-137)."""
        self._consume()
        if self.m != len(bit_commitments):
            raise MPCError(MPCError.WRONG_NUM_BIT_COMMITMENTS)

        for vc in bit_commitments:
            self.transcript.append_point(b"V", vc.V_j)

        A = bit_commitments[0].A_j
        for vc in bit_commitments[1:]:
            A = A + vc.A_j
        self.transcript.append_point(b"A", A.compress())

        S = bit_commitments[0].S_j
        for vc in bit_commitments[1:]:
            S = S + vc.S_j
        self.transcript.append_point(b"S", S.compress())

        y = self.transcript.challenge_scalar(b"y")
        z = self.transcript.challenge_scalar(b"z")
        bit_challenge = BitChallenge(y=y, z=z)

        return (DealerAwaitingPolyCommitments(
            self.n, self.m, self.transcript, self.initial_transcript,
            self.bp_gens, self.pc_gens, bit_challenge, bit_commitments, A, S),
            bit_challenge)


class DealerAwaitingPolyCommitments(_OneShot):
    def __init__(self, n, m, transcript, initial_transcript, bp_gens, pc_gens,
                 bit_challenge, bit_commitments, A, S):
        self.n, self.m = n, m
        self.transcript = transcript
        self.initial_transcript = initial_transcript
        self.bp_gens = bp_gens
        self.pc_gens = pc_gens
        self.bit_challenge = bit_challenge
        self.bit_commitments = bit_commitments
        self.A, self.S = A, S

    def receive_poly_commitments(self, poly_commitments: List[PolyCommitment]):
        """T_1 = sum T_1_j, T_2 = sum T_2_j; derive x (reference dealer.rs:160-197)."""
        self._consume()
        if self.m != len(poly_commitments):
            raise MPCError(MPCError.WRONG_NUM_POLY_COMMITMENTS)

        T_1 = poly_commitments[0].T_1_j
        T_2 = poly_commitments[0].T_2_j
        for pc in poly_commitments[1:]:
            T_1 = T_1 + pc.T_1_j
            T_2 = T_2 + pc.T_2_j

        self.transcript.append_point(b"T_1", T_1.compress())
        self.transcript.append_point(b"T_2", T_2.compress())

        x = self.transcript.challenge_scalar(b"x")
        poly_challenge = PolyChallenge(x=x)

        return (DealerAwaitingProofShares(
            self.n, self.m, self.transcript, self.initial_transcript,
            self.bp_gens, self.pc_gens, self.bit_challenge,
            self.bit_commitments, poly_challenge, poly_commitments,
            self.A, self.S, T_1, T_2),
            poly_challenge)


class DealerAwaitingProofShares(_OneShot):
    def __init__(self, n, m, transcript, initial_transcript, bp_gens, pc_gens,
                 bit_challenge, bit_commitments, poly_challenge,
                 poly_commitments, A, S, T_1, T_2):
        self.n, self.m = n, m
        self.transcript = transcript
        self.initial_transcript = initial_transcript
        self.bp_gens = bp_gens
        self.pc_gens = pc_gens
        self.bit_challenge = bit_challenge
        self.bit_commitments = bit_commitments
        self.poly_challenge = poly_challenge
        self.poly_commitments = poly_commitments
        self.A, self.S, self.T_1, self.T_2 = A, S, T_1, T_2

    def _assemble_shares(self, proof_shares: List[ProofShare]):
        """Sum share scalars, derive w, run the IPP (reference dealer.rs:222-293)."""
        from .rangeproof import RangeProof

        if self.m != len(proof_shares):
            raise MPCError(MPCError.WRONG_NUM_PROOF_SHARES)

        bad_shares = [j for j, share in enumerate(proof_shares)
                      if not share.check_size(self.n, self.bp_gens, j)]
        if bad_shares:
            raise MPCError.malformed_proof_shares(bad_shares)

        t_x = Scalar(sum(ps.t_x.v for ps in proof_shares))
        t_x_blinding = Scalar(sum(ps.t_x_blinding.v for ps in proof_shares))
        e_blinding = Scalar(sum(ps.e_blinding.v for ps in proof_shares))

        self.transcript.append_scalar(b"t_x", t_x)
        self.transcript.append_scalar(b"t_x_blinding", t_x_blinding)
        self.transcript.append_scalar(b"e_blinding", e_blinding)

        w = self.transcript.challenge_scalar(b"w")
        Q = self.pc_gens.B.scalar_mul(w)

        G_factors = [Scalar.one()] * (self.n * self.m)
        H_factors = exp_iter_take(self.bit_challenge.y.invert(), self.n * self.m)

        l_vec = [s for ps in proof_shares for s in ps.l_vec]
        r_vec = [s for ps in proof_shares for s in ps.r_vec]

        G_pts = list(self.bp_gens.G(self.n, self.m))
        H_pts = list(self.bp_gens.H(self.n, self.m))
        # packed [G | H] basis for the native IPP round loop, cached per
        # (n, m) on the generator object (generators are immutable per
        # capacity; resizing replaces the vectors, so clear on growth --
        # see BulletproofGens.increase_capacity)
        packed = None
        try:
            from ..core.ristretto import _NATIVE, pack_points
            if _NATIVE is not None:
                cache = getattr(self.bp_gens, "_ipp_basis_cache", None)
                if cache is None:
                    cache = self.bp_gens._ipp_basis_cache = {}
                packed = cache.get((self.n, self.m))
                if packed is None:
                    packed = cache[(self.n, self.m)] = pack_points(G_pts + H_pts)
        except Exception:
            packed = None

        ipp_proof = InnerProductProof.create(
            self.transcript, Q, G_factors, H_factors, G_pts, H_pts,
            l_vec, r_vec, packed_gh=packed)

        return RangeProof(
            A=self.A.compress(), S=self.S.compress(),
            T_1=self.T_1.compress(), T_2=self.T_2.compress(),
            t_x=t_x, t_x_blinding=t_x_blinding, e_blinding=e_blinding,
            ipp_proof=ipp_proof)

    def receive_shares(self, proof_shares: List[ProofShare], rng):
        """Assemble, then self-verify against the transcript snapshot; on
        failure audit each share individually (reference dealer.rs:305-355)."""
        self._consume()
        proof = self._assemble_shares(proof_shares)

        Vs = [vc.V_j for vc in self.bit_commitments]
        transcript = self.initial_transcript
        try:
            proof.verify_multiple(self.bp_gens, self.pc_gens, transcript, Vs,
                                  self.n, rng=rng)
            return proof
        except Exception:
            bad_shares = []
            for j in range(self.m):
                ok = proof_shares[j].audit_share(
                    self.bp_gens, self.pc_gens, j,
                    self.bit_commitments[j], self.bit_challenge,
                    self.poly_commitments[j], self.poly_challenge)
                if not ok:
                    bad_shares.append(j)
            raise MPCError.malformed_proof_shares(bad_shares)

    def receive_trusted_shares(self, proof_shares: List[ProofShare]):
        """Skip validation (local single-party path; reference dealer.rs:357-376)."""
        self._consume()
        return self._assemble_shares(proof_shares)
