"""Party state machine for the aggregated-rangeproof MPC protocol.

Mirrors dalek-bulletproofs/src/range_proof/party.rs: a session-typed chain
Party -> PartyAwaitingPosition -> PartyAwaitingBitChallenge ->
PartyAwaitingPolyChallenge, where each transition consumes the previous
state (enforced here with a `_used` guard, since Python lacks move
semantics).  Secrets are best-effort wiped on transition.

The reference's constant-time bit-commitment selection
(party.rs:102-112, via `subtle`) maps to branch-free arithmetic select on
TPU; on the host path it is a data-independent table select.
"""

from __future__ import annotations

from typing import List

from ..core.ristretto import RistrettoPoint, bit_commit, multiscalar_mul_ct
from ..core.scalar import Scalar
from ..errors import MPCError
from ..generators import BulletproofGens, PedersenGens
from ..utils.util import VecPoly1, Poly2, scalar_exp_vartime
from .messages import BitCommitment, BitChallenge, PolyCommitment, PolyChallenge, ProofShare


class Party:
    """Constructs a `PartyAwaitingPosition` (reference party.rs:37-61)."""

    @staticmethod
    def new(bp_gens: BulletproofGens, pc_gens: PedersenGens,
            v: int, v_blinding: Scalar, n: int) -> "PartyAwaitingPosition":
        if n not in (8, 16, 32, 64):
            raise MPCError(MPCError.INVALID_BITSIZE)
        if bp_gens.gens_capacity < n:
            raise MPCError(MPCError.INVALID_GENERATORS_LENGTH)
        V = pc_gens.commit(Scalar(v), v_blinding).compress()
        return PartyAwaitingPosition(bp_gens, pc_gens, n, v, v_blinding, V)


class _OneShot:
    _used = False

    def _consume(self):
        if self._used:
            raise RuntimeError("MPC state already consumed (session types)")
        self._used = True


class PartyAwaitingPosition(_OneShot):
    def __init__(self, bp_gens, pc_gens, n, v, v_blinding, V):
        self.bp_gens = bp_gens
        self.pc_gens = pc_gens
        self.n = n
        self.v = v
        self.v_blinding = v_blinding
        self.V = V

    def assign_position(self, j: int, rng) -> tuple:
        """Commit to the bits of the value (reference party.rs:87-146)."""
        self._consume()
        if self.bp_gens.party_capacity <= j:
            raise MPCError(MPCError.INVALID_GENERATORS_LENGTH)
        share = self.bp_gens.share(j)

        a_blinding = Scalar.random(rng)
        # A = <a_L, G> + <a_R, H> + a_blinding * B_blinding, where
        # a_L[i] = bit i, a_R[i] = a_L[i] - 1: each term is +G_i or -H_i,
        # selected branchlessly in native code (reference party.rs:102-112
        # uses subtle::ConditionallySelectable for the same reason)
        Gs, Hs = share.G(self.n), share.H(self.n)
        A = bit_commit(self.n, self.v, Gs, Hs, a_blinding,
                       self.pc_gens.B_blinding)

        s_blinding = Scalar.random(rng)
        s_L = [Scalar.random(rng) for _ in range(self.n)]
        s_R = [Scalar.random(rng) for _ in range(self.n)]

        # consttime Straus: s_L/s_R blind the secret bits later, so their
        # digits must not leak (reference party.rs:119-124, MultiscalarMul)
        S = multiscalar_mul_ct([s_blinding] + s_L + s_R,
                               [self.pc_gens.B_blinding] + Gs + Hs)

        bit_commitment = BitCommitment(V_j=self.V, A_j=A, S_j=S)
        next_state = PartyAwaitingBitChallenge(
            n=self.n, v=self.v, v_blinding=self.v_blinding,
            pc_gens=self.pc_gens, j=j,
            a_blinding=a_blinding, s_blinding=s_blinding, s_L=s_L, s_R=s_R)
        # best-effort wipe of the consumed state (reference party.rs:148-153
        # zeroizes PartyAwaitingPosition on Drop)
        self.v = self.v_blinding = None
        return next_state, bit_commitment


class PartyAwaitingBitChallenge(_OneShot):
    def __init__(self, n, v, v_blinding, pc_gens, j,
                 a_blinding, s_blinding, s_L, s_R):
        self.n = n
        self.v = v
        self.v_blinding = v_blinding
        self.pc_gens = pc_gens
        self.j = j
        self.a_blinding = a_blinding
        self.s_blinding = s_blinding
        self.s_L = s_L
        self.s_R = s_R

    def apply_challenge(self, vc: BitChallenge, rng) -> tuple:
        """Build l/r polynomials with party offsets and commit T_1, T_2
        (reference party.rs:182-237)."""
        self._consume()
        n = self.n
        offset_y = scalar_exp_vartime(vc.y, self.j * n)
        offset_z = scalar_exp_vartime(vc.z, self.j)

        l_poly = VecPoly1.zero(n)
        r_poly = VecPoly1.zero(n)

        offset_zz = vc.z * vc.z * offset_z
        exp_y = offset_y
        exp_2 = Scalar.one()
        for i in range(n):
            a_L_i = Scalar((self.v >> i) & 1)
            a_R_i = a_L_i - Scalar.one()
            l_poly.c0[i] = a_L_i - vc.z
            l_poly.c1[i] = self.s_L[i]
            r_poly.c0[i] = exp_y * (a_R_i + vc.z) + offset_zz * exp_2
            r_poly.c1[i] = exp_y * self.s_R[i]
            exp_y = exp_y * vc.y
            exp_2 = exp_2 + exp_2

        t_poly = l_poly.inner_product(r_poly)

        t_1_blinding = Scalar.random(rng)
        t_2_blinding = Scalar.random(rng)
        T_1 = self.pc_gens.commit(t_poly.b, t_1_blinding)
        T_2 = self.pc_gens.commit(t_poly.c, t_2_blinding)

        poly_commitment = PolyCommitment(T_1_j=T_1, T_2_j=T_2)
        next_state = PartyAwaitingPolyChallenge(
            v_blinding=self.v_blinding, a_blinding=self.a_blinding,
            s_blinding=self.s_blinding, offset_zz=offset_zz,
            l_poly=l_poly, r_poly=r_poly, t_poly=t_poly,
            t_1_blinding=t_1_blinding, t_2_blinding=t_2_blinding)
        # wipe what the next state does not carry forward (reference
        # party.rs:241-259 zeroizes PartyAwaitingBitChallenge on Drop)
        self.v = self.v_blinding = self.a_blinding = self.s_blinding = None
        self.s_L.clear()
        self.s_R.clear()
        return next_state, poly_commitment


class PartyAwaitingPolyChallenge(_OneShot):
    def __init__(self, v_blinding, a_blinding, s_blinding, offset_zz,
                 l_poly, r_poly, t_poly, t_1_blinding, t_2_blinding):
        self.v_blinding = v_blinding
        self.a_blinding = a_blinding
        self.s_blinding = s_blinding
        self.offset_zz = offset_zz
        self.l_poly = l_poly
        self.r_poly = r_poly
        self.t_poly = t_poly
        self.t_1_blinding = t_1_blinding
        self.t_2_blinding = t_2_blinding

    def apply_challenge(self, pc: PolyChallenge) -> ProofShare:
        """Evaluate the share (reference party.rs:274-306).  Rejects x = 0,
        which would annihilate the blinding factors (MaliciousDealer)."""
        self._consume()
        if pc.x.is_zero():
            raise MPCError.malicious_dealer()

        t_blinding_poly = Poly2(
            self.offset_zz * self.v_blinding,
            self.t_1_blinding,
            self.t_2_blinding)

        share = ProofShare(
            t_x=self.t_poly.eval(pc.x),
            t_x_blinding=t_blinding_poly.eval(pc.x),
            e_blinding=self.a_blinding + self.s_blinding * pc.x,
            l_vec=self.l_poly.eval(pc.x),
            r_vec=self.r_poly.eval(pc.x))
        # final-state wipe (reference party.rs:309-319)
        self.l_poly.wipe()
        self.r_poly.wipe()
        self.t_poly.wipe()
        t_blinding_poly.wipe()
        self.v_blinding = self.a_blinding = self.s_blinding = None
        self.t_1_blinding = self.t_2_blinding = self.offset_zz = None
        return share
