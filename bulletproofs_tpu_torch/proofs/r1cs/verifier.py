"""R1CS verifier (reference src/r1cs/verifier.rs).

Mirror of the prover without witness data: builds the same constraints
symbolically (num_vars counter), flattens with the constant term wc, then
checks everything in one mega-MSM with a transcript-RNG batching scalar r.
The MSM accepts an injectable `msm` callable.  `verify` and
`batch_verify` take `device=` ("cuda" by default; "cpu" runs the plain
PyTorch versions of the kernels): from settings.r1cs_device_msm_floor up
the mega-MSM runs there (K1 decompress, K10 digits, K11, K4a, K4b).
"""

from __future__ import annotations

import functools
import secrets
from typing import Callable, List, Optional, Tuple

import torch

from ...core.ristretto import RistrettoPoint, multiscalar_mul
from ...core.scalar import Scalar
from ...device import resolve_device
from ...errors import R1CSError
from ...generators import BulletproofGens, PedersenGens
from ...transcript import Transcript
from ...utils.util import exp_iter_take, inner_product
from .constraint_system import (RandomizableConstraintSystem,
                                RandomizedConstraintSystem)
from .linear_combination import Variable, to_lc
from .proof import R1CSProof

# the compact constraint store: a term is the int index << 3 | kind
# beside its coefficient's int (Verifier._add_constraint)
_LEFT, _RIGHT, _OUTPUT, _COMMITTED, _ONE = range(5)
_KIND = {"MultiplierLeft": _LEFT, "MultiplierRight": _RIGHT,
         "MultiplierOutput": _OUTPUT, "Committed": _COMMITTED, "One": _ONE}
# the -1 coefficient of the multiplier constraints
_NEG_ONE = Scalar(-1).v


# see prover._NATIVE_MIN_N
_NATIVE_MIN_N = 1024

# from settings.r1cs_device_msm_floor up, the verification mega-MSM
# (~2*padded_n + dyn points, reference verifier.rs:456-491) runs on the
# device: the static [G | H] generator lanes are cached there, so a verify
# uploads the scalar stream (32 B/point) and the COMPRESSED dynamic points
# (32 B each, decompressed by K1) and nothing else


def _use_device_msm(padded_n: int) -> bool:
    """The size rule alone (the JAX package also asks for a TPU; here the
    torch device decides between the kernels and their plain versions)."""
    from ...config import settings
    return padded_n >= settings.r1cs_device_msm_floor


def _device_gh_lanes(bp_gens: BulletproofGens, gens, padded_n: int,
                     device) -> torch.Tensor:
    """[G(padded_n) | H(padded_n)] as (4, 10, 2 padded_n) int32 lanes on
    `device`, cached on the generator object per (size, device)."""
    from ...ops import curve as C
    cache = getattr(bp_gens, "_torch_gh_cache", None)
    if cache is None:
        cache = bp_gens._torch_gh_cache = {}
    key = (padded_n, str(device))
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.as_tensor(C.points_to_lanes(
            gens.G(padded_n) + gens.H(padded_n))).to(device)
    return t


def _device_msm_is_identity(bp_gens, gens, padded_n: int,
                            head_cbytes, head_sc: bytes, static_pts,
                            bb_sc: bytes, gh_sc: bytes,
                            tail_cbytes, tail_sc: bytes, device) -> bool:
    """One device mega-MSM over [head_dyn | B | B~ | G | H | tail_dyn].

    The dynamic points (head and tail together) are uploaded compressed
    once and decoded by K1 (`curve.decompress`); the host never
    decompresses them.  K1 and K11 take any point count, so nothing is
    padded and the scalar blob follows the point order exactly.  Returns
    (every dynamic point decodes) AND (the MSM is the identity)."""
    from ...ops import curve as C
    from ...ops import msm as M
    nh = len(head_cbytes)
    valid, dyn = C.decompress(M.bytes_tensor(
        b"".join(head_cbytes) + b"".join(tail_cbytes), device))
    pts = torch.cat([dyn[..., :nh],
                     torch.as_tensor(C.points_to_lanes(static_pts)).to(device),
                     _device_gh_lanes(bp_gens, gens, padded_n, device),
                     dyn[..., nh:]], dim=-1)
    sc = M.bytes_tensor(head_sc + bb_sc + gh_sc + tail_sc, device)
    _, flag = M.msm_lanes_flag(pts, sc)
    return bool(valid.all() & flag[0])


class PackedScalarVec:
    """n packed 32-byte scalars.  The large-circuit verifier keeps its g/h
    scalar streams in this form end-to-end (native emit -> native MSM);
    iteration/indexing lazily materializes Scalars for any generic
    consumer."""

    __slots__ = ("raw", "n")

    def __init__(self, raw: bytes, n: int):
        assert len(raw) == 32 * n
        self.raw = raw
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self.n))]
        return Scalar(int.from_bytes(self.raw[32 * i: 32 * i + 32], "little"))

    def __iter__(self):
        for i in range(self.n):
            yield self[i]


class _SysRandom:
    @staticmethod
    def randbytes(n):
        return secrets.token_bytes(n)


class Verifier(RandomizableConstraintSystem):
    """The constraints are kept as flat lists of ints, not as the gadget's
    LinearCombination objects: a k = 2^15 shuffle builds ~2^17
    constraints, and holding their ~10^6 terms, tuples, Variables and
    Scalars alive made every verify run several full collections of
    Python's cyclic GC over the whole heap."""

    def __init__(self, transcript: Transcript):
        transcript.r1cs_domain_sep()
        self._transcript = transcript
        # term codes and coefficients of every constraint, in order, and
        # each constraint's end offset into them
        self._codes: List[int] = []
        self._coeffs: List[int] = []
        self._ends: List[int] = []
        self.num_vars = 0
        self.V: List[bytes] = []
        self.deferred_constraints: List[Callable] = []
        self.pending_multiplier: Optional[int] = None

    # -- ConstraintSystem ----------------------------------------------------
    def transcript(self) -> Transcript:
        return self._transcript

    def multiply(self, left, right) -> Tuple[Variable, Variable, Variable]:
        left = to_lc(left)
        right = to_lc(right)
        var = self.num_vars
        self.num_vars += 1
        # left - l_var == 0 and right - r_var == 0
        self._add_constraint(left.terms, var << 3 | _LEFT)
        self._add_constraint(right.terms, var << 3 | _RIGHT)
        return (Variable.multiplier_left(var), Variable.multiplier_right(var),
                Variable.multiplier_output(var))

    def _add_constraint(self, terms, minus=None) -> None:
        """Append one constraint, sum of terms (less the variable of code
        `minus`) == 0, to the compact store."""
        codes, coeffs = self._codes, self._coeffs
        for v, c in terms:
            codes.append(v.index << 3 | _KIND[v.kind])
            coeffs.append(c.v)
        if minus is not None:
            codes.append(minus)
            coeffs.append(_NEG_ONE)
        self._ends.append(len(codes))

    def allocate(self, assignment=None) -> Variable:
        if self.pending_multiplier is None:
            i = self.num_vars
            self.num_vars += 1
            self.pending_multiplier = i
            return Variable.multiplier_left(i)
        i = self.pending_multiplier
        self.pending_multiplier = None
        return Variable.multiplier_right(i)

    def allocate_multiplier(self, input_assignments=None):
        var = self.num_vars
        self.num_vars += 1
        return (Variable.multiplier_left(var), Variable.multiplier_right(var),
                Variable.multiplier_output(var))

    def multipliers_len(self) -> int:
        return self.num_vars

    def constrain(self, lc) -> None:
        self._add_constraint(to_lc(lc).terms)

    def specify_randomized_constraints(self, callback: Callable) -> None:
        self.deferred_constraints.append(callback)

    # -- verifier-specific ---------------------------------------------------
    def commit(self, commitment: bytes) -> Variable:
        i = len(self.V)
        self.V.append(commitment)
        self._transcript.append_point(b"V", commitment)
        return Variable.committed(i)

    def commit_many(self, commitments) -> List[Variable]:
        """Batched `commit` (API twin of Prover.commit_many): one batched
        transcript absorb instead of a per-point call (the 2^16-commitment
        shuffle pays ~1 s in the per-commit loop)."""
        commitments = list(commitments)
        base = len(self.V)
        self.V.extend(commitments)
        self._transcript.append_messages(b"V", b"".join(commitments), 32,
                                         len(commitments))
        return [Variable.committed(base + i)
                for i in range(len(commitments))]

    def _fold(self, z: Scalar):
        """The z-weighted fold of the constraints (reference
        verifier.rs:260-298) as raw Python ints (lazy reduction: one mod per
        slot by the caller): (wL, wR, wO, wV, wc).  The hot loop of
        large-circuit verification."""
        from ...core.scalar import L as _L
        w = ([0] * self.num_vars, [0] * self.num_vars, [0] * self.num_vars)
        wV = [0] * len(self.V)
        wc = 0
        codes, coeffs = self._codes, self._coeffs
        zv = z.v
        exp_z = zv
        start = 0
        for end in self._ends:
            for j in range(start, end):
                code, t = codes[j], exp_z * coeffs[j]
                kind = code & 7
                if kind < _COMMITTED:
                    w[kind][code >> 3] += t
                elif kind == _COMMITTED:
                    wV[code >> 3] -= t
                else:
                    wc -= t
            exp_z = exp_z * zv % _L
            start = end
        return w[0], w[1], w[2], wV, wc

    def flattened_constraints(self, z: Scalar):
        """Like the prover's, plus the constant term wc
        (reference verifier.rs:260-298), as Scalars."""
        wL, wR, wO, wV, wc = self._fold(z)
        return ([Scalar(x) for x in wL], [Scalar(x) for x in wR],
                [Scalar(x) for x in wO], [Scalar(x) for x in wV],
                Scalar(wc))

    def flattened_constraints_packed(self, z: Scalar, padded_n: int):
        """Large-circuit form of `flattened_constraints`: wL/wR/wO emitted
        as padded 32-byte-little-endian blobs for the native scalar stages
        (skipping ~3n Scalar allocations and a second to-bytes pass), wV as
        Scalars, wc as a Scalar.  Semantically identical to the Scalar form
        (cross-checked in tests/test_r1cs.py)."""
        from ...core.scalar import L as _L
        wL, wR, wO, wV, wc = self._fold(z)
        pad = b"\x00" * (32 * (padded_n - self.num_vars))
        return (b"".join((x % _L).to_bytes(32, "little") for x in wL) + pad,
                b"".join((x % _L).to_bytes(32, "little") for x in wR) + pad,
                b"".join((x % _L).to_bytes(32, "little") for x in wO) + pad,
                [Scalar(x) for x in wV], Scalar(wc))

    def _create_randomized_constraints(self) -> None:
        self.pending_multiplier = None
        if not self.deferred_constraints:
            self._transcript.r1cs_1phase_domain_sep()
            return
        self._transcript.r1cs_2phase_domain_sep()
        callbacks = self.deferred_constraints
        self.deferred_constraints = []
        wrapped = RandomizingVerifier(self)
        for cb in callbacks:
            cb(wrapped)

    def verify(self, proof: R1CSProof, pc_gens: PedersenGens,
               bp_gens: BulletproofGens, rng=None, msm=None,
               device="cuda") -> None:
        """Raises R1CSError unless the proof verifies.  `device` is the
        torch device of the mega-MSM ("cuda" must have a card; "cpu" runs
        the kernels' plain versions)."""
        dev = resolve_device(device)
        rng = rng or _SysRandom()
        msm_injected = msm is not None
        if msm is None:
            from ...ops.msm import msm_host_auto
            msm = functools.partial(msm_host_auto, device=dev)
        (dyn_scalars, dyn_compressed, b_scalar, bb_scalar, g_scalars,
         h_scalars, padded_n) = self.verification_scalars(proof, bp_gens, rng)
        gens = bp_gens.share(0)
        k = len(dyn_compressed) - 2 * len(proof.ipp_proof.L_vec)

        from ...core.ristretto import _NATIVE, pack_points
        if (isinstance(g_scalars, PackedScalarVec) and _NATIVE is not None
                and not msm_injected and _use_device_msm(padded_n)):
            # device mega-MSM (cached device-resident G/H): the per-verify
            # upload is the scalar stream + the COMPRESSED dyn points,
            # decompressed and validity-checked on device -- the host
            # never touches the point coordinates
            if not _device_msm_is_identity(
                    bp_gens, gens, padded_n,
                    dyn_compressed[:k],
                    b"".join(s.to_bytes() for s in dyn_scalars[:k]),
                    [pc_gens.B, pc_gens.B_blinding],
                    b_scalar.to_bytes() + bb_scalar.to_bytes(),
                    g_scalars.raw + h_scalars.raw,
                    dyn_compressed[k:],
                    b"".join(s.to_bytes() for s in dyn_scalars[k:]), dev):
                raise R1CSError(R1CSError.VERIFICATION)
            return

        dyn = [RistrettoPoint.decompress(p) for p in dyn_compressed]
        if any(p is None for p in dyn):
            raise R1CSError(R1CSError.VERIFICATION)

        if (isinstance(g_scalars, PackedScalarVec) and _NATIVE is not None
                and not msm_injected):
            # byte-path mega-MSM: dyn points packed fresh (a handful), the
            # static [G | H] generators cached on the generator object
            sc_blob = (b"".join(s.to_bytes() for s in dyn_scalars[:k])
                       + b_scalar.to_bytes() + bb_scalar.to_bytes()
                       + g_scalars.raw + h_scalars.raw
                       + b"".join(s.to_bytes() for s in dyn_scalars[k:]))
            cache = getattr(bp_gens, "_ipp_basis_cache", None)
            if cache is None:
                cache = bp_gens._ipp_basis_cache = {}
            packed_gh = cache.get((padded_n, 1))
            if packed_gh is None:
                packed_gh = cache[(padded_n, 1)] = pack_points(
                    gens.G(padded_n) + gens.H(padded_n))
            pt_blob = (pack_points(dyn[:k] + [pc_gens.B, pc_gens.B_blinding])
                       + packed_gh + pack_points(dyn[k:]))
            total = len(dyn) + 2 + 2 * padded_n
            import ctypes as _ct
            out = _ct.create_string_buffer(128)
            _NATIVE.rist_msm(total, sc_blob, pt_blob, out)
            if not _NATIVE.rist_is_identity(out.raw):
                raise R1CSError(R1CSError.VERIFICATION)
            return

        scalars = (dyn_scalars[:k] + [b_scalar, bb_scalar]
                   + list(g_scalars) + list(h_scalars) + dyn_scalars[k:])
        points = (dyn[:k] + [pc_gens.B, pc_gens.B_blinding]
                  + gens.G(padded_n) + gens.H(padded_n) + dyn[k:])
        if not msm(scalars, points).is_identity():
            raise R1CSError(R1CSError.VERIFICATION)

    def verification_scalars(self, proof: R1CSProof,
                             bp_gens: BulletproofGens, rng=None):
        """Replay the transcript and emit this proof's share of the
        mega-MSM: (dyn_scalars, dyn_compressed_points, B_scalar,
        B_blinding_scalar, g_scalars, h_scalars, padded_n).  dyn pairs
        scalars[i] with compressed points[i] ([A_I1, A_O1, S1, A_I2, A_O2,
        S2, V.., T.., L.., R..]); the static B/B~/G/H scalars let
        `batch_verify` accumulate many proofs onto shared generators
        (the same random-linear-combination trick the reference applies
        to the two per-proof equations, verifier.rs:447-449).

        One-shot: replaying consumes the verifier's transcript and deferred
        constraints, so a second call raises (rebuild the verifier -- gadget
        construction is cheap -- to retry or bisect)."""
        if getattr(self, "_consumed", False):
            raise RuntimeError(
                "Verifier already consumed (transcript replayed); build a "
                "fresh Verifier to verify again")
        self._consumed = True
        rng = rng or _SysRandom()
        transcript = self._transcript

        transcript.append_u64(b"m", len(self.V))

        n1 = self.num_vars
        try:
            transcript.validate_and_append_point(b"A_I1", proof.A_I1)
            transcript.validate_and_append_point(b"A_O1", proof.A_O1)
            transcript.validate_and_append_point(b"S1", proof.S1)
        except Exception:
            raise R1CSError(R1CSError.VERIFICATION)

        self._create_randomized_constraints()

        n = self.num_vars
        n2 = n - n1
        padded_n = 1 if n == 0 else 1 << (n - 1).bit_length()
        pad = padded_n - n
        if bp_gens.gens_capacity < padded_n:
            raise R1CSError(R1CSError.INVALID_GENERATORS_LENGTH)

        transcript.append_point(b"A_I2", proof.A_I2)
        transcript.append_point(b"A_O2", proof.A_O2)
        transcript.append_point(b"S2", proof.S2)

        y = transcript.challenge_scalar(b"y")
        z = transcript.challenge_scalar(b"z")

        try:
            transcript.validate_and_append_point(b"T_1", proof.T_1)
            transcript.validate_and_append_point(b"T_3", proof.T_3)
            transcript.validate_and_append_point(b"T_4", proof.T_4)
            transcript.validate_and_append_point(b"T_5", proof.T_5)
            transcript.validate_and_append_point(b"T_6", proof.T_6)
        except Exception:
            raise R1CSError(R1CSError.VERIFICATION)

        u = transcript.challenge_scalar(b"u")
        x = transcript.challenge_scalar(b"x")

        transcript.append_scalar(b"t_x", proof.t_x)
        transcript.append_scalar(b"t_x_blinding", proof.t_x_blinding)
        transcript.append_scalar(b"e_blinding", proof.e_blinding)

        w = transcript.challenge_scalar(b"w")

        a = proof.ipp_proof.a
        b = proof.ipp_proof.b
        y_inv = y.invert()

        from ...core._native import LIB as _NV
        use_native = _NV is not None and padded_n >= _NATIVE_MIN_N
        if use_native:
            wL_b, wR_b, wO_b, wV, wc = self.flattened_constraints_packed(
                z, padded_n)
        else:
            wL, wR, wO, wV, wc = self.flattened_constraints(z)
        if use_native:
            # large-circuit path: challenges replayed here, then the
            # s-vector and g/h scalar streams (verifier.rs:398-445) run in
            # the native backend on packed scalars
            ipp = proof.ipp_proof
            lg_n = len(ipp.L_vec)
            if (lg_n >= 32 or padded_n != (1 << lg_n)
                    or len(ipp.R_vec) != lg_n or a is None or b is None):
                raise R1CSError(R1CSError.VERIFICATION)
            transcript.innerproduct_domain_sep(padded_n)
            chal = []
            try:
                for Lb, Rb in zip(ipp.L_vec, ipp.R_vec):
                    transcript.validate_and_append_point(b"L", Lb)
                    transcript.validate_and_append_point(b"R", Rb)
                    chal.append(transcript.challenge_scalar(b"u"))
            except Exception:
                raise R1CSError(R1CSError.VERIFICATION)
            import ctypes as _ct

            g_buf = _ct.create_string_buffer(32 * padded_n)
            h_buf = _ct.create_string_buffer(32 * padded_n)
            d_buf = _ct.create_string_buffer(32)
            usq_buf = _ct.create_string_buffer(32 * lg_n)
            uisq_buf = _ct.create_string_buffer(32 * lg_n)
            _NV.r1cs_verify_scalars(
                padded_n, n1, lg_n,
                b"".join(c.to_bytes() for c in chal),
                x.to_bytes(), y_inv.to_bytes(), u.to_bytes(),
                a.to_bytes(), b.to_bytes(),
                wL_b, wR_b, wO_b,
                g_buf, h_buf, d_buf, usq_buf, uisq_buf)

            def unpk(buf, k):
                return [Scalar(int.from_bytes(buf.raw[32 * i: 32 * i + 32],
                                              "little")) for i in range(k)]

            u_sq = unpk(usq_buf, lg_n)
            u_inv_sq = unpk(uisq_buf, lg_n)
            g_scalars = PackedScalarVec(g_buf.raw, padded_n)
            h_scalars = PackedScalarVec(h_buf.raw, padded_n)
            delta = Scalar(int.from_bytes(d_buf.raw, "little"))
        else:
            try:
                u_sq, u_inv_sq, s = proof.ipp_proof.verification_scalars(
                    padded_n, transcript)
            except Exception:
                raise R1CSError(R1CSError.VERIFICATION)

            y_inv_vec = exp_iter_take(y_inv, padded_n)
            yneg_wR = [wRi * yi for wRi, yi in zip(wR, y_inv_vec)] + [Scalar.zero()] * pad

            delta = inner_product(yneg_wR[:n], wL)

            u_or_1 = [Scalar.one()] * n1 + [u] * (n2 + pad)

            g_scalars = [ui * (x * ywr - a * si)
                         for ywr, ui, si in zip(yneg_wR, u_or_1, s)]
            wL_pad = wL + [Scalar.zero()] * pad
            wO_pad = wO + [Scalar.zero()] * pad
            s_rev = list(reversed(s))
            h_scalars = [ui * (yi * (x * wLi + wOi - b * s_inv) - Scalar.one())
                         for yi, ui, s_inv, wLi, wOi
                         in zip(y_inv_vec, u_or_1, s_rev, wL_pad, wO_pad)]

        # transcript-RNG batching scalar (no witness; external entropy only)
        det_rng = transcript.build_rng().finalize(rng)
        r = Scalar.random(det_rng)

        xx = x * x
        rxx = r * xx
        xxx = x * xx

        T_scalars = [r * x, rxx * x, rxx * xx, rxx * xxx, rxx * xx * xx]
        T_points = [proof.T_1, proof.T_3, proof.T_4, proof.T_5, proof.T_6]

        dyn_scalars = ([x, xx, xxx, u * x, u * xx, u * xxx]
                       + [wVi * rxx for wVi in wV]
                       + T_scalars
                       + u_sq + u_inv_sq)
        b_scalar = (w * (proof.t_x - a * b)
                    + r * (xx * (wc + delta) - proof.t_x))
        bb_scalar = -proof.e_blinding - r * proof.t_x_blinding
        dyn_compressed = ([proof.A_I1, proof.A_O1, proof.S1,
                           proof.A_I2, proof.A_O2, proof.S2]
                          + self.V + T_points
                          + list(proof.ipp_proof.L_vec)
                          + list(proof.ipp_proof.R_vec))
        return (dyn_scalars, dyn_compressed, b_scalar, bb_scalar,
                g_scalars, h_scalars, padded_n)


def batch_verify(items, pc_gens: PedersenGens, bp_gens: BulletproofGens,
                 rng=None, msm=None, device="cuda") -> None:
    """Verify many R1CS proofs in ONE mega-MSM.

    `items` is a sequence of (verifier, proof) pairs -- each verifier has
    its gadget constraints built against its own transcript, exactly as for
    a single `verify` call.  Per-proof checks combine with random weights
    w_p (an extension of the reference's in-proof equation batching,
    verifier.rs:447-449); the shared static generators B, B~, G, H
    accumulate one scalar each across all proofs, so batch cost grows only
    by each proof's dynamic points.  Raises R1CSError on any failure; to
    locate a failing proof, bisect with FRESH verifiers per attempt
    (verifiers are one-shot -- replaying consumes their transcript).
    `device` as for Verifier.verify."""
    dev = resolve_device(device)
    rng = rng or _SysRandom()
    if not items:
        raise ValueError("batch_verify requires at least one proof "
                         "(an empty batch would vacuously accept)")
    msm_injected = msm is not None
    if msm is None:
        from ...ops.msm import msm_host_auto
        msm = functools.partial(msm_host_auto, device=dev)
    from ...core._native import LIB as _NV
    if msm_injected:
        _NV = None   # honor the injected MSM: stay on the Scalar path
    zero = Scalar.zero()
    acc_b = acc_bb = zero
    acc_g: List[Scalar] = []
    acc_h: List[Scalar] = []
    acc_g_buf = acc_h_buf = None       # native byte accumulators
    acc_n = 0
    all_dyn_s: List[Scalar] = []
    all_dyn_p: List[bytes] = []
    import ctypes as _ct
    for verifier, proof in items:
        (ds, dp, bs, bbs, gs, hs, pn) = verifier.verification_scalars(
            proof, bp_gens, rng)
        wgt = Scalar.random(rng)
        all_dyn_s.extend(wgt * s for s in ds)
        all_dyn_p.extend(dp)
        acc_b = acc_b + wgt * bs
        acc_bb = acc_bb + wgt * bbs
        if isinstance(gs, PackedScalarVec) and _NV is not None:
            # byte path: acc += wgt * gs via the native axpy.  The buffer
            # must cover BOTH this proof's pn and any longer accumulator
            # state left by earlier proofs (byte OR python path) -- a mixed
            # batch [pn_big byte, small python, pn_small byte] previously
            # allocated 32*pn_small and crashed copying the longer blob in.
            need = max(pn, acc_n, len(acc_g))
            if acc_g_buf is None or acc_n < need:
                new_g = _ct.create_string_buffer(32 * need)
                new_h = _ct.create_string_buffer(32 * need)
                if acc_g_buf is not None:
                    new_g[: 32 * acc_n] = acc_g_buf.raw[: 32 * acc_n]
                    new_h[: 32 * acc_n] = acc_h_buf.raw[: 32 * acc_n]
                elif acc_g:   # earlier python-path proofs accumulated
                    blob_g = b"".join(s.to_bytes() for s in acc_g)
                    blob_h = b"".join(s.to_bytes() for s in acc_h)
                    new_g[: len(blob_g)] = blob_g
                    new_h[: len(blob_h)] = blob_h
                    acc_g, acc_h = [], []
                acc_g_buf, acc_h_buf = new_g, new_h
                acc_n = need
            _NV.sc_vec_axpy(pn, acc_g_buf, wgt.to_bytes(), gs.raw)
            _NV.sc_vec_axpy(pn, acc_h_buf, wgt.to_bytes(), hs.raw)
        else:
            if acc_g_buf is not None:
                # fold the byte accumulator back to Scalars (mixed sizes)
                acc_g = list(PackedScalarVec(acc_g_buf.raw, acc_n))
                acc_h = list(PackedScalarVec(acc_h_buf.raw, acc_n))
                acc_g_buf = acc_h_buf = None
            if len(acc_g) < pn:
                acc_g.extend([zero] * (pn - len(acc_g)))
                acc_h.extend([zero] * (pn - len(acc_h)))
            for i, s in enumerate(gs):
                acc_g[i] = acc_g[i] + wgt * s
            for i, s in enumerate(hs):
                acc_h[i] = acc_h[i] + wgt * s

    gens = bp_gens.share(0)
    if acc_g_buf is not None:
        if acc_g:   # python-path proofs accumulated first at smaller pn
            blob = b"".join(s.to_bytes() for s in acc_g)
            _NV.sc_vec_axpy(len(acc_g), acc_g_buf, Scalar.one().to_bytes(),
                            blob)
            blob = b"".join(s.to_bytes() for s in acc_h)
            _NV.sc_vec_axpy(len(acc_h), acc_h_buf, Scalar.one().to_bytes(),
                            blob)
        from ...core.ristretto import _NATIVE, pack_points
        if _use_device_msm(acc_n):
            if not _device_msm_is_identity(
                    bp_gens, gens, acc_n,
                    all_dyn_p, b"".join(s.to_bytes() for s in all_dyn_s),
                    [pc_gens.B, pc_gens.B_blinding],
                    acc_b.to_bytes() + acc_bb.to_bytes(),
                    acc_g_buf.raw + acc_h_buf.raw, [], b"", dev):
                raise R1CSError(R1CSError.VERIFICATION)
            return
        dyn = [RistrettoPoint.decompress(p) for p in all_dyn_p]
        if any(p is None for p in dyn):
            raise R1CSError(R1CSError.VERIFICATION)
        sc_blob = (b"".join(s.to_bytes() for s in all_dyn_s)
                   + acc_b.to_bytes() + acc_bb.to_bytes()
                   + acc_g_buf.raw + acc_h_buf.raw)
        cache = getattr(bp_gens, "_ipp_basis_cache", None)
        if cache is None:
            cache = bp_gens._ipp_basis_cache = {}
        packed_gh = cache.get((acc_n, 1))
        if packed_gh is None:
            packed_gh = cache[(acc_n, 1)] = pack_points(
                gens.G(acc_n) + gens.H(acc_n))
        pt_blob = (pack_points(dyn + [pc_gens.B, pc_gens.B_blinding])
                   + packed_gh)
        total = len(dyn) + 2 + 2 * acc_n
        out = _ct.create_string_buffer(128)
        _NATIVE.rist_msm(total, sc_blob, pt_blob, out)
        if not _NATIVE.rist_is_identity(out.raw):
            raise R1CSError(R1CSError.VERIFICATION)
        return

    dyn = [RistrettoPoint.decompress(p) for p in all_dyn_p]
    if any(p is None for p in dyn):
        raise R1CSError(R1CSError.VERIFICATION)
    scalars = all_dyn_s + [acc_b, acc_bb] + acc_g + acc_h
    points = (dyn + [pc_gens.B, pc_gens.B_blinding]
              + gens.G(len(acc_g)) + gens.H(len(acc_h)))
    if not msm(scalars, points).is_identity():
        raise R1CSError(R1CSError.VERIFICATION)


class RandomizingVerifier(RandomizedConstraintSystem):
    """Verifier wrapper for the randomization phase
    (reference verifier.rs:52-58)."""

    def __init__(self, verifier: Verifier):
        self.verifier = verifier

    def transcript(self):
        return self.verifier._transcript

    def multiply(self, left, right):
        return self.verifier.multiply(left, right)

    def allocate(self, assignment=None):
        return self.verifier.allocate(assignment)

    def allocate_multiplier(self, input_assignments=None):
        return self.verifier.allocate_multiplier(input_assignments)

    def multipliers_len(self):
        return self.verifier.multipliers_len()

    def constrain(self, lc):
        self.verifier.constrain(lc)

    def challenge_scalar(self, label: bytes) -> Scalar:
        return self.verifier._transcript.challenge_scalar(label)
