"""R1CS prover (reference src/r1cs/prover.rs).

Holds the witness (multiplier assignments a_L/a_R/a_O and committed value
openings), accumulates constraints and deferred randomized-constraint
callbacks, and consumes itself in `prove`: two phases of vector commitments
(phase-2 points are identity when no randomized multipliers exist), the
witness-rekeyed transcript RNG, degree-3 vector polynomials with the
t_2-coefficient recovered from <wV, v_blinding>, and the final
inner-product proof with G-factors 1^n1 || u^(n2+pad).

MSMs accept an injectable `msm` callable; by default they run on the
host's constant-time C++ Straus MSM (the prover holds the witness).
"""

from __future__ import annotations

import secrets
from typing import Callable, List, Optional, Tuple

from ...core.ristretto import RistrettoPoint, multiscalar_mul
from ...core.scalar import Scalar
from ...errors import R1CSError
from ...generators import BulletproofGens, PedersenGens
from ...transcript import Transcript
from ...utils.util import (VecPoly3, Poly6, exp_iter_take,
                           scalar_exp_vartime)
from ..ipp import InnerProductProof
from .constraint_system import (ConstraintSystem, RandomizableConstraintSystem,
                                RandomizedConstraintSystem)
from .linear_combination import LinearCombination, Variable, to_lc
from .proof import R1CSProof, _IDENTITY

# shared immutable -1 coefficient for the multiplier constraints
_NEG_ONE = Scalar(-1)


# circuits at or above this multiplier count route their O(n) scalar
# vector math through the native backend (tests lower it to cross-check)
_NATIVE_MIN_N = 1024


class _SysRandom:
    @staticmethod
    def randbytes(n):
        return secrets.token_bytes(n)


class Prover(RandomizableConstraintSystem):
    def __init__(self, pc_gens: PedersenGens, transcript: Transcript):
        transcript.r1cs_domain_sep()
        self._transcript = transcript
        self.pc_gens = pc_gens
        self.constraints: List[LinearCombination] = []
        self.a_L: List[Scalar] = []
        self.a_R: List[Scalar] = []
        self.a_O: List[Scalar] = []
        self.v: List[Scalar] = []
        self.v_blinding: List[Scalar] = []
        self.deferred_constraints: List[Callable] = []
        self.pending_multiplier: Optional[int] = None

    # -- ConstraintSystem ----------------------------------------------------
    def transcript(self) -> Transcript:
        return self._transcript

    def multiply(self, left, right) -> Tuple[Variable, Variable, Variable]:
        left = to_lc(left)
        right = to_lc(right)
        l = self.eval(left)
        r = self.eval(right)
        o = l * r

        l_var = Variable.multiplier_left(len(self.a_L))
        r_var = Variable.multiplier_right(len(self.a_R))
        o_var = Variable.multiplier_output(len(self.a_O))
        self.a_L.append(l)
        self.a_R.append(r)
        self.a_O.append(o)

        # left + (-1)*l_var == 0, appended directly (the generic LC
        # __add__/constrain pair re-copies terms on every call)
        self.constraints.append(
            LinearCombination(left.terms + [(l_var, _NEG_ONE)]))
        self.constraints.append(
            LinearCombination(right.terms + [(r_var, _NEG_ONE)]))
        return l_var, r_var, o_var

    def allocate(self, assignment: Optional[Scalar]) -> Variable:
        if assignment is None:
            raise R1CSError.missing_assignment()
        if self.pending_multiplier is None:
            i = len(self.a_L)
            self.pending_multiplier = i
            self.a_L.append(assignment)
            self.a_R.append(Scalar.zero())
            self.a_O.append(Scalar.zero())
            return Variable.multiplier_left(i)
        i = self.pending_multiplier
        self.pending_multiplier = None
        self.a_R[i] = assignment
        self.a_O[i] = self.a_L[i] * self.a_R[i]
        return Variable.multiplier_right(i)

    def allocate_multiplier(self, input_assignments):
        if input_assignments is None:
            raise R1CSError.missing_assignment()
        l, r = input_assignments
        o = l * r
        l_var = Variable.multiplier_left(len(self.a_L))
        r_var = Variable.multiplier_right(len(self.a_R))
        o_var = Variable.multiplier_output(len(self.a_O))
        self.a_L.append(l)
        self.a_R.append(r)
        self.a_O.append(o)
        return l_var, r_var, o_var

    def multipliers_len(self) -> int:
        return len(self.a_L)

    def constrain(self, lc) -> None:
        self.constraints.append(to_lc(lc))

    def specify_randomized_constraints(self, callback: Callable) -> None:
        self.deferred_constraints.append(callback)

    # -- prover-specific -----------------------------------------------------
    def commit(self, v: Scalar, v_blinding: Scalar) -> Tuple[bytes, Variable]:
        i = len(self.v)
        self.v.append(v)
        self.v_blinding.append(v_blinding)
        V = self.pc_gens.commit(v, v_blinding).compress()
        self._transcript.append_point(b"V", V)
        return V, Variable.committed(i)

    def commit_many(self, values, blindings):
        """Batched `commit`: one native consttime MSM pass over all
        (value, blinding) pairs (PedersenGens.commit_many), then the
        same per-V transcript appends in order -- bit-identical to the
        commit() loop, ~10x faster at large-circuit commitment counts.
        Returns a list of (compressed V, Variable) pairs."""
        comps = self.pc_gens.commit_many(values, blindings)
        base = len(self.v)
        self.v.extend(values)
        self.v_blinding.extend(blindings)
        self._transcript.append_messages(b"V", b"".join(comps), 32,
                                         len(comps))
        return [(V, Variable.committed(base + i))
                for i, V in enumerate(comps)]

    def eval(self, lc: LinearCombination) -> Scalar:
        acc = Scalar.zero()
        for var, coeff in lc.terms:
            if var.is_multiplier_left():
                acc = acc + coeff * self.a_L[var.index]
            elif var.is_multiplier_right():
                acc = acc + coeff * self.a_R[var.index]
            elif var.is_multiplier_output():
                acc = acc + coeff * self.a_O[var.index]
            elif var.is_committed():
                acc = acc + coeff * self.v[var.index]
            else:
                acc = acc + coeff
        return acc

    def flattened_constraints(self, z: Scalar):
        """Fold Q constraints into (wL, wR, wO, wV) with powers of z
        (reference prover.rs:301-338)."""
        from ...core.scalar import L as _L
        n = len(self.a_L)
        m = len(self.v)
        # int accumulators with lazy reduction (see the verifier's twin)
        wL = [0] * n
        wR = [0] * n
        wO = [0] * n
        wV = [0] * m

        zv = z.v
        exp_z = zv
        for lc in self.constraints:
            for var, coeff in lc.terms:
                if var.is_multiplier_left():
                    wL[var.index] += exp_z * coeff.v
                elif var.is_multiplier_right():
                    wR[var.index] += exp_z * coeff.v
                elif var.is_multiplier_output():
                    wO[var.index] += exp_z * coeff.v
                elif var.is_committed():
                    wV[var.index] -= exp_z * coeff.v
                # One(): constant terms don't affect the prover
            exp_z = exp_z * zv % _L
        return ([Scalar(x) for x in wL], [Scalar(x) for x in wR],
                [Scalar(x) for x in wO], [Scalar(x) for x in wV])

    def _create_randomized_constraints(self) -> None:
        self.pending_multiplier = None
        if not self.deferred_constraints:
            self._transcript.r1cs_1phase_domain_sep()
            return
        self._transcript.r1cs_2phase_domain_sep()
        callbacks = self.deferred_constraints
        self.deferred_constraints = []
        wrapped = RandomizingProver(self)
        for cb in callbacks:
            cb(wrapped)

    def prove(self, bp_gens: BulletproofGens, rng=None, msm=None) -> R1CSProof:
        rng = rng or _SysRandom()
        if msm is None:
            # witness commitments default to the consttime Straus path, as
            # the reference does (prover.rs:433-459 uses MultiscalarMul, not
            # Vartime*).  Callers may inject another msm.
            from ...core.ristretto import multiscalar_mul_ct as msm
        transcript = self._transcript

        transcript.append_u64(b"m", len(self.v))

        # witness-rekeyed deterministic RNG (reference prover.rs:400-413)
        rng_builder = transcript.build_rng()
        for v_b in self.v_blinding:
            rng_builder = rng_builder.rekey_with_witness_bytes(b"v_blinding", v_b.to_bytes())
        det_rng = rng_builder.finalize(rng)

        n1 = len(self.a_L)
        if bp_gens.gens_capacity < n1:
            raise R1CSError(R1CSError.INVALID_GENERATORS_LENGTH)
        gens = bp_gens.share(0)

        i_blinding1 = Scalar.random(det_rng)
        o_blinding1 = Scalar.random(det_rng)
        s_blinding1 = Scalar.random(det_rng)
        s_L1 = [Scalar.random(det_rng) for _ in range(n1)]
        s_R1 = [Scalar.random(det_rng) for _ in range(n1)]

        G1, H1 = gens.G(n1), gens.H(n1)
        B_b = self.pc_gens.B_blinding

        A_I1 = msm([i_blinding1] + self.a_L + self.a_R, [B_b] + G1 + H1).compress()
        A_O1 = msm([o_blinding1] + self.a_O, [B_b] + G1).compress()
        S1 = msm([s_blinding1] + s_L1 + s_R1, [B_b] + G1 + H1).compress()

        transcript.append_point(b"A_I1", A_I1)
        transcript.append_point(b"A_O1", A_O1)
        transcript.append_point(b"S1", S1)

        self._create_randomized_constraints()

        n = len(self.a_L)
        n2 = n - n1
        padded_n = 1 if n == 0 else 1 << (n - 1).bit_length()
        pad = padded_n - n
        if bp_gens.gens_capacity < padded_n:
            raise R1CSError(R1CSError.INVALID_GENERATORS_LENGTH)

        has_phase2 = n2 > 0
        if has_phase2:
            i_blinding2 = Scalar.random(det_rng)
            o_blinding2 = Scalar.random(det_rng)
            s_blinding2 = Scalar.random(det_rng)
        else:
            i_blinding2 = o_blinding2 = s_blinding2 = Scalar.zero()
        s_L2 = [Scalar.random(det_rng) for _ in range(n2)]
        s_R2 = [Scalar.random(det_rng) for _ in range(n2)]

        if has_phase2:
            Gn, Hn = gens.G(n), gens.H(n)
            A_I2 = msm([i_blinding2] + self.a_L[n1:] + self.a_R[n1:],
                       [B_b] + Gn[n1:] + Hn[n1:]).compress()
            A_O2 = msm([o_blinding2] + self.a_O[n1:], [B_b] + Gn[n1:]).compress()
            S2 = msm([s_blinding2] + s_L2 + s_R2,
                     [B_b] + Gn[n1:] + Hn[n1:]).compress()
        else:
            A_I2 = A_O2 = S2 = _IDENTITY

        transcript.append_point(b"A_I2", A_I2)
        transcript.append_point(b"A_O2", A_O2)
        transcript.append_point(b"S2", S2)

        y = transcript.challenge_scalar(b"y")
        z = transcript.challenge_scalar(b"z")

        wL, wR, wO, wV = self.flattened_constraints(z)

        sL = s_L1 + s_L2
        sR = s_R1 + s_R2
        y_inv = y.invert()

        from ...core._native import LIB as _NV
        use_native_vecs = _NV is not None and n >= _NATIVE_MIN_N
        if use_native_vecs:
            # large-circuit path: the O(n) scalar vector math runs in the
            # native backend on packed 32-byte scalars (same formulas,
            # prover.rs:549-579); Python keeps only the transcript flow
            import ctypes as _ct

            def pk(xs):
                return b"".join(s.to_bytes() for s in xs)

            vecs = [_ct.create_string_buffer(32 * n) for _ in range(6)]
            t_out = _ct.create_string_buffer(32 * 6)
            _NV.r1cs_lr_polys(n, y.to_bytes(), y_inv.to_bytes(),
                              pk(self.a_L), pk(self.a_R), pk(self.a_O),
                              pk(sL), pk(sR), pk(wL), pk(wR), pk(wO),
                              *vecs, t_out)
            t_poly = Poly6(*[Scalar(int.from_bytes(
                t_out.raw[32 * k: 32 * k + 32], "little")) for k in range(6)])
            l_poly = r_poly = None
        else:
            exp_y_iter = Scalar.one()
            exp_y_inv = exp_iter_take(y_inv, padded_n)
            l_poly = VecPoly3.zero(n)
            r_poly = VecPoly3.zero(n)
            for i in range(n):
                l_poly.c[1][i] = self.a_L[i] + exp_y_inv[i] * wR[i]
                l_poly.c[2][i] = self.a_O[i]
                l_poly.c[3][i] = sL[i]
                r_poly.c[0][i] = wO[i] - exp_y_iter
                r_poly.c[1][i] = exp_y_iter * self.a_R[i] + wL[i]
                r_poly.c[3][i] = exp_y_iter * sR[i]
                exp_y_iter = exp_y_iter * y

            t_poly = VecPoly3.special_inner_product(l_poly, r_poly)

        t_1_blinding = Scalar.random(det_rng)
        t_3_blinding = Scalar.random(det_rng)
        t_4_blinding = Scalar.random(det_rng)
        t_5_blinding = Scalar.random(det_rng)
        t_6_blinding = Scalar.random(det_rng)

        T_1 = self.pc_gens.commit(t_poly.t[0], t_1_blinding).compress()
        T_3 = self.pc_gens.commit(t_poly.t[2], t_3_blinding).compress()
        T_4 = self.pc_gens.commit(t_poly.t[3], t_4_blinding).compress()
        T_5 = self.pc_gens.commit(t_poly.t[4], t_5_blinding).compress()
        T_6 = self.pc_gens.commit(t_poly.t[5], t_6_blinding).compress()

        transcript.append_point(b"T_1", T_1)
        transcript.append_point(b"T_3", T_3)
        transcript.append_point(b"T_4", T_4)
        transcript.append_point(b"T_5", T_5)
        transcript.append_point(b"T_6", T_6)

        u = transcript.challenge_scalar(b"u")
        x = transcript.challenge_scalar(b"x")

        # t_2 blinding recovered from the committed values' blindings
        t_2_blinding = Scalar.zero()
        for c, vb in zip(wV, self.v_blinding):
            t_2_blinding = t_2_blinding + c * vb

        t_blinding_poly = Poly6(t_1_blinding, t_2_blinding, t_3_blinding,
                                t_4_blinding, t_5_blinding, t_6_blinding)

        t_x = t_poly.eval(x)
        t_x_blinding = t_blinding_poly.eval(x)
        if use_native_vecs:
            import ctypes as _ct
            l_buf = _ct.create_string_buffer(32 * padded_n)
            r_buf = _ct.create_string_buffer(32 * padded_n)
            y_n = scalar_exp_vartime(y, n)
            _NV.r1cs_lr_eval(n, padded_n, x.to_bytes(), y.to_bytes(),
                             y_n.to_bytes(), vecs[0].raw, vecs[1].raw,
                             vecs[2].raw, vecs[3].raw, vecs[4].raw,
                             vecs[5].raw, l_buf, r_buf)
            l_vec = r_vec = None
        else:
            exp_y = scalar_exp_vartime(y, n)
            l_vec = l_poly.eval(x) + [Scalar.zero()] * pad
            r_vec = r_poly.eval(x) + [Scalar.zero()] * pad
            for i in range(n, padded_n):
                r_vec[i] = -exp_y
                exp_y = exp_y * y

        i_blinding = i_blinding1 + u * i_blinding2
        o_blinding = o_blinding1 + u * o_blinding2
        s_blinding = s_blinding1 + u * s_blinding2
        e_blinding = x * (i_blinding + x * (o_blinding + x * s_blinding))

        transcript.append_scalar(b"t_x", t_x)
        transcript.append_scalar(b"t_x_blinding", t_x_blinding)
        transcript.append_scalar(b"e_blinding", e_blinding)

        w = transcript.challenge_scalar(b"w")
        Q = self.pc_gens.B.scalar_mul(w)

        if use_native_vecs:
            import ctypes as _ct
            gf_buf = _ct.create_string_buffer(32 * padded_n)
            hf_buf = _ct.create_string_buffer(32 * padded_n)
            _NV.r1cs_hg_factors(padded_n, n1, y_inv.to_bytes(),
                                u.to_bytes(), gf_buf, hf_buf)
            cache = getattr(bp_gens, "_ipp_basis_cache", None)
            if cache is None:
                cache = bp_gens._ipp_basis_cache = {}
            packed_gh = cache.get((padded_n, 1))
            if packed_gh is None:
                from ...core.ristretto import pack_points
                packed_gh = cache[(padded_n, 1)] = pack_points(
                    list(gens.G(padded_n)) + list(gens.H(padded_n)))
            ipp_proof = InnerProductProof.create(
                transcript, Q, [], [], [], [], [], [],
                packed_gh=packed_gh,
                packed_scalars=(l_buf.raw, r_buf.raw, gf_buf.raw, hf_buf.raw),
                n=padded_n)
            for buf in vecs + [l_buf, r_buf]:
                _ct.memset(buf, 0, _ct.sizeof(buf))
        else:
            exp_y_inv = exp_iter_take(y_inv, padded_n)
            G_factors = [Scalar.one()] * n1 + [u] * (n2 + pad)
            H_factors = [yi * ui for yi, ui in zip(exp_y_inv, G_factors)]
            ipp_proof = InnerProductProof.create(
                transcript, Q, G_factors, H_factors,
                list(gens.G(padded_n)), list(gens.H(padded_n)), l_vec, r_vec)

        # best-effort wipe of the blinding vectors and secret polys
        # (reference prover.rs:672-679 zeroizes s_L/s_R; the poly types
        # zeroize on Drop via clear_on_drop)
        s_L1.clear()
        s_R1.clear()
        s_L2.clear()
        s_R2.clear()
        if l_poly is not None:
            l_poly.wipe()
            r_poly.wipe()
        t_poly.wipe()
        t_blinding_poly.wipe()

        return R1CSProof(A_I1, A_O1, S1, A_I2, A_O2, S2,
                         T_1, T_3, T_4, T_5, T_6,
                         t_x, t_x_blinding, e_blinding, ipp_proof)


class RandomizingProver(RandomizedConstraintSystem):
    """Prover wrapper for the randomization phase (reference prover.rs:53-63)."""

    def __init__(self, prover: Prover):
        self.prover = prover

    def transcript(self):
        return self.prover._transcript

    def multiply(self, left, right):
        return self.prover.multiply(left, right)

    def allocate(self, assignment):
        return self.prover.allocate(assignment)

    def allocate_multiplier(self, input_assignments):
        return self.prover.allocate_multiplier(input_assignments)

    def multipliers_len(self):
        return self.prover.multipliers_len()

    def constrain(self, lc):
        self.prover.constrain(lc)

    def challenge_scalar(self, label: bytes) -> Scalar:
        return self.prover._transcript.challenge_scalar(label)
