"""Inner-product argument: the logarithmic-size core engine behind every
Bulletproofs proof.

Protocol semantics and wire format match the reference
(dalek-bulletproofs/src/inner_product_proof.rs): lg(n) folding rounds, the
first round absorbing the G/H factors into the L/R MSMs; the verifier-side
`verification_scalars` (challenges, batch inversion, the inductive s-vector)
that lets a parent protocol fold everything into ONE mega-MSM.

This module is the host protocol driver.  The MSMs and vector folds run on
the device path when a `backend` is provided (bulletproofs_tpu_torch.ops);
otherwise the host Pippenger oracle is used.  Transcript interaction is
inherently sequential (each round's challenge depends on the previous L/R),
so the round loop itself stays on host (SURVEY.md §7 "host/device chatter").
"""

from __future__ import annotations

from typing import List

from ..core.ristretto import RistrettoPoint, multiscalar_mul
from ..core.scalar import Scalar, batch_invert, L as _L_ORDER
from ..errors import ProofError
from ..transcript import Transcript
from ..utils.util import inner_product


class InnerProductProof:
    __slots__ = ("L_vec", "R_vec", "a", "b")

    def __init__(self, L_vec: List[bytes], R_vec: List[bytes], a: Scalar, b: Scalar):
        self.L_vec = L_vec  # compressed points
        self.R_vec = R_vec
        self.a = a
        self.b = b

    @classmethod
    def create(cls, transcript: Transcript, Q: RistrettoPoint,
               G_factors: List[Scalar], H_factors: List[Scalar],
               G: List[RistrettoPoint], H: List[RistrettoPoint],
               a: List[Scalar], b: List[Scalar],
               packed_gh: bytes = None,
               packed_scalars=None, n: int = None) -> "InnerProductProof":
        """Prover (reference src/inner_product_proof.rs:38-196).

        Takes ownership of G/H/a/b (they are consumed by in-place halving).
        `packed_gh` optionally supplies the [G | H] extended-coordinate
        blob (pack_points(G + H)) so repeat provers over the same
        generator set skip the per-call packing (dealer caches it on the
        BulletproofGens object).  `packed_scalars=(a, b, g_factors,
        h_factors)` -- each n*32 packed bytes -- feeds the native round
        loop directly (the large-circuit R1CS prover stays in byte-land);
        G/H/a/b lists may then be empty with `n` given explicitly.
        """
        if n is None:
            n = len(G)
        if packed_scalars is None:
            assert len(H) == n and len(a) == n and len(b) == n
            assert len(G_factors) == n and len(H_factors) == n
        assert n & (n - 1) == 0, "n must be a power of two"

        transcript.innerproduct_domain_sep(n)

        L_vec: List[bytes] = []
        R_vec: List[bytes] = []

        # Generator folding never materializes: the round-r folded generator
        # G'[i] equals sum_{k = i (mod 2m)} g_coef[k] * G[k] over the
        # ORIGINAL generators, with g_coef[k] the running product of the
        # u / u^-1 challenges selected by k's high bits (the prover-side
        # mirror of the verifier's s-vector, reference
        # src/inner_product_proof.rs:228-253).  Each round's L/R is then one
        # (n+1)-term MSM over the fixed G/H -- point work goes through the
        # native/backend MSM instead of 2n per-element point folds.  The
        # G_factors/H_factors of the reference's first round (:77-141) are
        # simply the initial coefficients.
        n_full = n
        from ..core.ristretto import _NATIVE, pack_points

        if packed_scalars is not None and _NATIVE is None:
            raise RuntimeError("packed-scalar IPP create requires the "
                               "native backend")
        if _NATIVE is not None and n > 1:
            # Fully-native round loop: pack the fixed basis [G | H | Q] and
            # the scalar state once; each round is two C calls (scalar prep
            # incl. c_L/c_R, then fold) plus two native MSM+compress calls.
            # Python only orchestrates the lg(n) transcript interactions.
            import ctypes as _ct
            if packed_gh is None:
                packed_gh = pack_points(list(G) + list(H))
            basis = packed_gh + pack_points([Q])
            total = 2 * n_full + 1

            def _pack_sc(xs):
                data = b"".join(s.v.to_bytes(32, "little") for s in xs)
                return _ct.create_string_buffer(data, len(data))

            if packed_scalars is not None:
                a_raw, b_raw, gf_raw, hf_raw = packed_scalars
                a_buf = _ct.create_string_buffer(bytes(a_raw), 32 * n)
                b_buf = _ct.create_string_buffer(bytes(b_raw), 32 * n)
                g_buf = _ct.create_string_buffer(bytes(gf_raw), 32 * n)
                h_buf = _ct.create_string_buffer(bytes(hf_raw), 32 * n)
            else:
                a_buf = _pack_sc(a)
                b_buf = _pack_sc(b)
                g_buf = _pack_sc(G_factors)
                h_buf = _pack_sc(H_factors)
            scL = _ct.create_string_buffer(32 * total)
            scR = _ct.create_string_buffer(32 * total)
            cL32 = _ct.create_string_buffer(32)
            cR32 = _ct.create_string_buffer(32)
            pt = _ct.create_string_buffer(128)
            enc = _ct.create_string_buffer(32)

            while n != 1:
                n //= 2
                # the c_L/c_R slot is the basis tail (Q)
                _NATIVE.ipp_round_scalars(n_full, n, a_buf, b_buf,
                                          g_buf, h_buf, scL, scR, cL32, cR32)
                scL[32 * (total - 1):32 * total] = cL32.raw[:32]
                scR[32 * (total - 1):32 * total] = cR32.raw[:32]
                _NATIVE.rist_msm(total, scL, basis, pt)
                _NATIVE.rist_compress(pt, enc)
                Lc = enc.raw[:32]
                _NATIVE.rist_msm(total, scR, basis, pt)
                _NATIVE.rist_compress(pt, enc)
                Rc = enc.raw[:32]

                L_vec.append(Lc)
                R_vec.append(Rc)
                transcript.append_point(b"L", Lc)
                transcript.append_point(b"R", Rc)

                u = transcript.challenge_scalar(b"u")
                u_inv = u.invert()
                _NATIVE.ipp_fold(n_full, n, a_buf, b_buf, g_buf, h_buf,
                                 u.v.to_bytes(32, "little"),
                                 u_inv.v.to_bytes(32, "little"))

            a0 = Scalar(int.from_bytes(a_buf[0:32], "little"))
            b0 = Scalar(int.from_bytes(b_buf[0:32], "little"))
            # genuine zeroization of the native secret buffers (the role
            # clear_on_drop plays for the reference, util.rs:170-217); the
            # Python-side Scalar lists are the caller's to drop
            for buf in (a_buf, b_buf, g_buf, h_buf, scL, scR):
                _ct.memset(buf, 0, _ct.sizeof(buf))
            return cls(L_vec, R_vec, a0, b0)

        # Pure-Python fallback (test oracle / native backend unbuilt).
        # The a/b vectors are witness data: refuse or warn before running
        # them through variable-time Python big-int code.
        from ..config import vartime_witness_fallback
        vartime_witness_fallback("InnerProductProof.create")
        g_coef = [s.v for s in G_factors]
        h_coef = [s.v for s in H_factors]
        _msm = multiscalar_mul
        G0 = list(G)
        H0 = list(H)

        while n != 1:
            n //= 2
            a_L, a_R = a[:n], a[n:]
            b_L, b_R = b[:n], b[n:]

            c_L = inner_product(a_L, b_R)
            c_R = inner_product(a_R, b_L)

            period = 2 * n
            sc_L = [c_L]
            pt_L = [Q]
            sc_R = [c_R]
            pt_R = [Q]
            for k in range(n_full):
                r = k % period
                if r >= n:  # k lands in the current G_R / H_R half
                    sc_L.append(a_L[r - n].v * g_coef[k] % _L_ORDER)
                    pt_L.append(G0[k])
                    sc_R.append(b_L[r - n].v * h_coef[k] % _L_ORDER)
                    pt_R.append(H0[k])
                else:       # current G_L / H_L half
                    sc_R.append(a_R[r].v * g_coef[k] % _L_ORDER)
                    pt_R.append(G0[k])
                    sc_L.append(b_R[r].v * h_coef[k] % _L_ORDER)
                    pt_L.append(H0[k])
            L = _msm(sc_L, pt_L)
            R = _msm(sc_R, pt_R)

            Lc, Rc = L.compress(), R.compress()
            L_vec.append(Lc)
            R_vec.append(Rc)
            transcript.append_point(b"L", Lc)
            transcript.append_point(b"R", Rc)

            u = transcript.challenge_scalar(b"u")
            u_inv = u.invert()
            uv, uiv = u.v, u_inv.v

            for i in range(n):
                a_L[i] = a_L[i] * u + u_inv * a_R[i]
                b_L[i] = b_L[i] * u_inv + u * b_R[i]
            for k in range(n_full):
                if k % period >= n:  # folded in from the R half: G' = uG_R + ...
                    g_coef[k] = g_coef[k] * uv % _L_ORDER
                    h_coef[k] = h_coef[k] * uiv % _L_ORDER
                else:                # L half: G' = u^-1 G_L + ...
                    g_coef[k] = g_coef[k] * uiv % _L_ORDER
                    h_coef[k] = h_coef[k] * uv % _L_ORDER

            a, b = a_L, b_L

        return cls(L_vec, R_vec, a[0], b[0])

    def verification_scalars(self, n: int, transcript: Transcript):
        """Recompute challenges and the s-vector for the parent protocol's
        combined MSM (reference src/inner_product_proof.rs:198-253).

        Returns (challenges_sq, challenges_inv_sq, s).
        """
        lg_n = len(self.L_vec)
        if lg_n >= 32:
            raise ProofError.verification()
        if n != (1 << lg_n):
            raise ProofError.verification()

        transcript.innerproduct_domain_sep(n)

        challenges = []
        for L, R in zip(self.L_vec, self.R_vec):
            transcript.validate_and_append_point(b"L", L)
            transcript.validate_and_append_point(b"R", R)
            challenges.append(transcript.challenge_scalar(b"u"))

        challenges_inv = list(challenges)
        allinv = batch_invert(challenges_inv)

        challenges_sq = [u * u for u in challenges]
        challenges_inv_sq = [u * u for u in challenges_inv]

        # s computed inductively: s[0] = prod(u_i^-1); s[i] = s[i - 2^lg(i)] * u_{...}^2
        s = [allinv]
        for i in range(1, n):
            lg_i = i.bit_length() - 1
            k = 1 << lg_i
            u_lg_i_sq = challenges_sq[(lg_n - 1) - lg_i]
            s.append(s[i - k] * u_lg_i_sq)

        return challenges_sq, challenges_inv_sq, s

    def verify(self, n: int, transcript: Transcript,
               G_factors: List[Scalar], H_factors: List[Scalar],
               P: RistrettoPoint, Q: RistrettoPoint,
               G: List[RistrettoPoint], H: List[RistrettoPoint]) -> None:
        """Standalone verification (test path; reference :260-326).  Raises
        ProofError on failure."""
        u_sq, u_inv_sq, s = self.verification_scalars(n, transcript)

        g_scalars = [(self.a * s_i) * g_i for g_i, s_i in zip(G_factors, s)]
        inv_s = list(reversed(s))
        h_scalars = [(self.b * s_inv) * h_i for h_i, s_inv in zip(H_factors, inv_s)]
        neg_u_sq = [-u for u in u_sq]
        neg_u_inv_sq = [-u for u in u_inv_sq]

        Ls = [RistrettoPoint.decompress(p) for p in self.L_vec]
        Rs = [RistrettoPoint.decompress(p) for p in self.R_vec]
        if any(p is None for p in Ls + Rs):
            raise ProofError.verification()

        expect_P = multiscalar_mul(
            [self.a * self.b] + g_scalars + h_scalars + neg_u_sq + neg_u_inv_sq,
            [Q] + G + H + Ls + Rs)

        if not (expect_P == P):
            raise ProofError.verification()

    # -- serialization (reference :330-407) ---------------------------------
    def serialized_size(self) -> int:
        return (len(self.L_vec) * 2 + 2) * 32

    def to_bytes(self) -> bytes:
        buf = bytearray()
        for l, r in zip(self.L_vec, self.R_vec):
            buf += l
            buf += r
        buf += self.a.to_bytes()
        buf += self.b.to_bytes()
        return bytes(buf)

    @classmethod
    def from_bytes(cls, data: bytes) -> "InnerProductProof":
        if len(data) % 32 != 0:
            raise ProofError.format()
        num_elements = len(data) // 32
        if num_elements < 2 or (num_elements - 2) % 2 != 0:
            raise ProofError.format()
        lg_n = (num_elements - 2) // 2
        if lg_n >= 32:
            raise ProofError.format()
        L_vec, R_vec = [], []
        for i in range(lg_n):
            pos = 2 * i * 32
            L_vec.append(data[pos: pos + 32])
            R_vec.append(data[pos + 32: pos + 64])
        pos = 2 * lg_n * 32
        a = Scalar.from_canonical_bytes(data[pos: pos + 32])
        b = Scalar.from_canonical_bytes(data[pos + 32: pos + 64])
        if a is None or b is None:
            raise ProofError.format()
        return cls(L_vec, R_vec, a, b)
