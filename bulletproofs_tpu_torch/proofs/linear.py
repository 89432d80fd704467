"""Linear proof: lightweight inner-product variant (GHL'21 §E.3).

Proves <a, b> = c where a is secret and b is public, with blinded folding
rounds (fresh s_j, t_j blinding per round) and a Schnorr-style base case.
Protocol, transcript schedule, and wire format match the reference
(dalek-bulletproofs/src/linear_proof.rs).  Note the verifier's L/R weighting
is x_j / x_j^{-1} (the GHL'21 paper has them reversed; the reference
documents this at linear_proof.rs:214-218), and the subset-product s-vector
uses exponents in {0, 1}, not the Bulletproofs {-1, +1}.
"""

from __future__ import annotations

import functools
from typing import List

import torch

from ..core.ristretto import RistrettoPoint, multiscalar_mul
from ..core.scalar import Scalar, batch_invert
from ..device import resolve_device
from ..errors import ProofError
from ..transcript import Transcript
from ..utils.util import inner_product


def _device_linear_check(dyn_bytes, dyn_sc_blob: bytes,
                         static_sc_blob: bytes, static_points,
                         device) -> bool:
    """Fused device check for LinearProof.batch_verify: K1 decompresses the
    compressed dynamic points (uploaded once), one msm_lanes_flag over
    [dyn | B, F, G..] on `device`; returns (all valid) AND (the result is
    the identity).  Scalars arrive as packed 32-byte-little-endian blobs
    (the native replay emits them in that form).  Nothing is padded: K1 and
    K11 take any point count."""
    from ..ops import curve as C
    from ..ops import msm as M
    valid, dyn = C.decompress(M.bytes_tensor(b"".join(dyn_bytes), device))
    static = torch.as_tensor(C.points_to_lanes(static_points)).to(device)
    pts = torch.cat([dyn, static], dim=-1)
    sc = M.bytes_tensor(dyn_sc_blob + static_sc_blob, device)
    _, flag = M.msm_lanes_flag(pts, sc)
    return bool(valid.all() & flag[0])


class LinearProof:
    __slots__ = ("L_vec", "R_vec", "S", "a", "r")

    def __init__(self, L_vec: List[bytes], R_vec: List[bytes], S: bytes,
                 a: Scalar, r: Scalar):
        self.L_vec = L_vec
        self.R_vec = R_vec
        self.S = S
        self.a = a
        self.r = r

    @classmethod
    def create(cls, transcript: Transcript, rng, C: bytes, r: Scalar,
               a_vec: List[Scalar], b_vec: List[Scalar],
               G_vec: List[RistrettoPoint], F: RistrettoPoint,
               B: RistrettoPoint) -> "LinearProof":
        """Prover (reference linear_proof.rs:40-162).  C is the compressed
        commitment <a, G> + r*B; consumes a/b/G by in-place halving."""
        n = len(b_vec)
        if len(G_vec) != n:
            raise ProofError.invalid_generators_length()
        if len(a_vec) != n:
            raise ProofError(ProofError.INVALID_INPUT_LENGTH)
        if n == 0 or n & (n - 1):
            raise ProofError(ProofError.INVALID_INPUT_LENGTH)

        # Append all public data (reference :71-81)
        transcript.innerproduct_domain_sep(n)
        transcript.append_point(b"C", C)
        for b_i in b_vec:
            transcript.append_scalar(b"b_i", b_i)
        for G_i in G_vec:
            transcript.append_point(b"G_i", G_i.compress())
        transcript.append_point(b"F", F.compress())
        transcript.append_point(b"B", B.compress())

        a, b = list(a_vec), list(b_vec)
        L_vec: List[bytes] = []
        R_vec: List[bytes] = []

        # Generator folding (reference :131-143 `G_L[i] <- G_L[i] + x_j G_R[i]`)
        # never materializes: the current G'[i] equals
        # sum_{k = i (mod 2m)} g_coef[k] * G_vec[k] with g_coef[k] the
        # subset product of past challenges selected by k's high bits
        # (exponents in {0,1} -- the prover-side mirror of `subset_product`,
        # reference :292-314).  L/R become single MSMs over the fixed G_vec.
        n_full = n
        g_coef = [Scalar.one()] * n_full
        G0 = list(G_vec)

        while n != 1:
            n //= 2
            a_L, a_R = a[:n], a[n:]
            b_L, b_R = b[:n], b[n:]

            c_L = inner_product(a_L, b_R)
            c_R = inner_product(a_R, b_L)

            s_j = Scalar.random(rng)
            t_j = Scalar.random(rng)

            period = 2 * n
            sc_L = [s_j, c_L]
            pt_L = [B, F]
            sc_R = [t_j, c_R]
            pt_R = [B, F]
            for k in range(n_full):
                rk = k % period
                if rk >= n:  # current G_R half
                    sc_L.append(a_L[rk - n] * g_coef[k])
                    pt_L.append(G0[k])
                else:        # current G_L half
                    sc_R.append(a_R[rk] * g_coef[k])
                    pt_R.append(G0[k])
            L = multiscalar_mul(sc_L, pt_L).compress()
            R = multiscalar_mul(sc_R, pt_R).compress()

            L_vec.append(L)
            R_vec.append(R)
            transcript.append_point(b"L", L)
            transcript.append_point(b"R", R)

            x_j = transcript.challenge_scalar(b"x_j")
            x_j_inv = x_j.invert()

            for i in range(n):
                a_L[i] = a_L[i] + x_j_inv * a_R[i]
                b_L[i] = b_L[i] + x_j * b_R[i]
            for k in range(n_full):
                if k % period >= n:  # folded in from the R half with weight x_j
                    g_coef[k] = g_coef[k] * x_j
            a, b = a_L, b_L
            r = r + x_j * s_j + x_j_inv * t_j

        s_star = Scalar.random(rng)
        t_star = Scalar.random(rng)
        G_final = multiscalar_mul(g_coef, G0)
        S = (B.scalar_mul(t_star) + F.scalar_mul(s_star * b[0])
             + G_final.scalar_mul(s_star)).compress()
        transcript.append_point(b"S", S)

        x_star = transcript.challenge_scalar(b"x_star")
        return cls(L_vec, R_vec, S,
                   a=s_star + x_star * a[0],
                   r=t_star + x_star * r)

    def verification_scalars(self, n: int, transcript: Transcript,
                             b_vec: List[Scalar]):
        """(challenges, inverses, b_0): folds b in place while replaying
        (reference linear_proof.rs:251-290)."""
        lg_n = len(self.L_vec)
        if lg_n >= 32:
            raise ProofError.verification()
        if n != (1 << lg_n):
            raise ProofError.verification()

        b = list(b_vec)
        n_mut = n
        challenges = []
        for L, R in zip(self.L_vec, self.R_vec):
            transcript.validate_and_append_point(b"L", L)
            transcript.validate_and_append_point(b"R", R)
            x_j = transcript.challenge_scalar(b"x_j")
            challenges.append(x_j)
            n_mut //= 2
            b = [b[i] + x_j * b[n_mut + i] for i in range(n_mut)]

        challenges_inv = list(challenges)
        batch_invert(challenges_inv)
        return challenges, challenges_inv, b[0]

    def subset_product(self, n: int, challenges: List[Scalar]) -> List[Scalar]:
        """s_i with exponents in {0,1} (reference linear_proof.rs:292-314)."""
        lg_n = len(self.L_vec)
        s = [Scalar.one()]
        for i in range(1, n):
            lg_i = i.bit_length() - 1
            k = 1 << lg_i
            s.append(s[i - k] * challenges[(lg_n - 1) - lg_i])
        return s

    def verify(self, transcript: Transcript, C: bytes,
               G: List[RistrettoPoint], F: RistrettoPoint, B: RistrettoPoint,
               b_vec: List[Scalar], msm=None, device="cuda") -> None:
        """Verifier (reference linear_proof.rs:164-249); raises on failure.
        `msm` is injectable; by default ops/msm.msm_host_auto on `device`
        ("cuda" must have a card; "cpu" runs the plain versions) takes the
        n-point generator MSM from settings.msm_device_floor points up."""
        dev = resolve_device(device)
        if msm is None:
            from ..ops.msm import msm_host_auto
            msm = functools.partial(msm_host_auto, device=dev)
        n = len(b_vec)
        if len(G) != n:
            raise ProofError.invalid_generators_length()

        transcript.innerproduct_domain_sep(n)
        transcript.append_point(b"C", C)
        for b_i in b_vec:
            transcript.append_scalar(b"b_i", b_i)
        for G_i in G:
            transcript.append_point(b"G_i", G_i.compress())
        transcript.append_point(b"F", F.compress())
        transcript.append_point(b"B", B.compress())

        x_vec, x_inv_vec, b_0 = self.verification_scalars(n, transcript, b_vec)
        transcript.append_point(b"S", self.S)
        x_star = transcript.challenge_scalar(b"x_star")

        Ls = [RistrettoPoint.decompress(p) for p in self.L_vec]
        Rs = [RistrettoPoint.decompress(p) for p in self.R_vec]
        if any(p is None for p in Ls + Rs):
            raise ProofError.verification()

        L_R_factors = multiscalar_mul(x_vec + x_inv_vec, Ls + Rs)
        s = self.subset_product(n, x_vec)
        G_0 = msm(s, G)

        S = RistrettoPoint.decompress(self.S)
        C_pt = RistrettoPoint.decompress(C)
        if S is None or C_pt is None:
            raise ProofError.verification()

        expect_S = (B.scalar_mul(self.r) + F.scalar_mul(self.a * b_0)
                    - (C_pt + L_R_factors).scalar_mul(x_star)
                    + G_0.scalar_mul(self.a))
        if not (expect_S == S):
            raise ProofError.verification()

    @staticmethod
    def batch_verify(items, G: List[RistrettoPoint], F: RistrettoPoint,
                     B: RistrettoPoint, rng=None, msm=None,
                     use_device=None, device="cuda") -> None:
        """Verify many linear proofs sharing generators (G, F, B) in ONE
        MSM == identity.

        `items` is a sequence of (proof, transcript, C_bytes, b_vec) --
        b_vec (and therefore n = len(b_vec) <= len(G), proofs use the
        G[:n] prefix) may differ per proof.  Each proof's check

          S - r*B - (a*b_0)*F + x**C + sum x**x_i*L_i + x**x_inv_i*R_i
            - sum a*s_i*G_i  ==  0        (reference linear_proof.rs:237-247
                                           rearranged to one equation)

        gets a random weight; the shared G/F/B scalars accumulate across
        proofs.  Raises ProofError on any failure; bisect sub-batches with
        fresh transcripts to isolate a failing proof.

        `use_device=None` (auto) routes the fused MSM to the device --
        dynamic points upload COMPRESSED (32 B each) and K1 decompresses
        them -- once the batch reaches settings.linear_device_msm_floor
        points; True/False force/forbid it (`msm` injection wins).  (The
        JAX package names this flag `device`.)  `device` is the torch
        device: "cuda" (the default) must have a card, "cpu" runs the
        kernels' plain versions."""
        dev = resolve_device(device)
        import secrets as _secrets
        rng = rng or type("R", (), {"randbytes": staticmethod(
            _secrets.token_bytes)})()
        if not items:
            raise ProofError.verification()
        msm_injected = msm is not None
        if msm is None:
            from ..ops.msm import msm_host_auto
            msm = functools.partial(msm_host_auto, device=dev)
        zero = Scalar.zero()
        acc_b = acc_f = zero
        acc_g = [zero] * len(G)
        dyn_scalars: List[Scalar] = []
        dyn_points: List[RistrettoPoint] = []
        dyn_bytes: List[bytes] = []
        if use_device is None:
            from ..config import settings
            total = (sum(2 + 2 * len(p.L_vec) for p, _, _, _ in items)
                     + 2 + len(G))
            use_device = (not msm_injected
                          and total >= settings.linear_device_msm_floor)
        else:
            use_device = bool(use_device) and not msm_injected

        # native batched replay (uniform n): ONE C++ call runs every
        # proof's transcript replay (8-lockstep Keccak), b-fold, challenge
        # inversion (one shared Montgomery pass), subset products, and the
        # G-scalar accumulation -- the per-proof Python loop below is the
        # semantic oracle for it (reference linear_proof.rs:164-314)
        from ..core.ristretto import _NATIVE as _NC
        ns = {len(b_vec) for _, _, _, b_vec in items}
        if (_NC is not None and not msm_injected and len(ns) == 1
                and hasattr(_NC, "linear_verify_replay_batch_c")):
            return LinearProof._batch_verify_native(items, G, F, B, rng,
                                                    use_device, dev)

        for proof, transcript, C, b_vec in items:
            n = len(b_vec)
            if len(G) < n:
                raise ProofError.invalid_generators_length()
            Gp = G[:n]

            transcript.innerproduct_domain_sep(n)
            transcript.append_point(b"C", C)
            for b_i in b_vec:
                transcript.append_scalar(b"b_i", b_i)
            for G_i in Gp:
                transcript.append_point(b"G_i", G_i.compress())
            transcript.append_point(b"F", F.compress())
            transcript.append_point(b"B", B.compress())
            x_vec, x_inv_vec, b_0 = proof.verification_scalars(
                n, transcript, b_vec)
            transcript.append_point(b"S", proof.S)
            x_star = transcript.challenge_scalar(b"x_star")

            if use_device:
                # device path: collect compressed bytes; decompression and
                # validity checks run on device in one program
                dyn_bytes.extend([bytes(proof.S), bytes(C)]
                                 + list(proof.L_vec) + list(proof.R_vec))
            else:
                S = RistrettoPoint.decompress(proof.S)
                C_pt = RistrettoPoint.decompress(C)
                Ls = [RistrettoPoint.decompress(p) for p in proof.L_vec]
                Rs = [RistrettoPoint.decompress(p) for p in proof.R_vec]
                if S is None or C_pt is None or any(
                        p is None for p in Ls + Rs):
                    raise ProofError.verification()

            w = Scalar.random(rng)
            acc_b = acc_b - w * proof.r
            acc_f = acc_f - w * (proof.a * b_0)
            s = proof.subset_product(n, x_vec)
            wa = w * proof.a
            for i in range(n):
                acc_g[i] = acc_g[i] - wa * s[i]
            wx = w * x_star
            dyn_scalars.extend([w, wx]
                               + [wx * x for x in x_vec]
                               + [wx * xi for xi in x_inv_vec])
            if not use_device:
                dyn_points.extend([S, C_pt] + Ls + Rs)

        if use_device:
            if not _device_linear_check(
                    dyn_bytes,
                    b"".join(s.to_bytes() for s in dyn_scalars),
                    b"".join(s.to_bytes()
                             for s in [acc_b, acc_f] + acc_g),
                    [B, F] + list(G), dev):
                raise ProofError.verification()
            return
        result = msm(dyn_scalars + [acc_b, acc_f] + acc_g,
                     dyn_points + [B, F] + list(G))
        if not result.is_identity():
            raise ProofError.verification()

    @staticmethod
    def _batch_verify_native(items, G, F, B, rng, use_device,
                             device) -> None:
        """C++-replay batch verification (uniform n): one
        linear_verify_replay_batch_c call, then one mega-MSM -- native
        Pippenger on host, or the fused device route (compressed dyn
        upload + device decompress) when use_device."""
        import ctypes as _ct
        from ..core.ristretto import _NATIVE as _NC
        from ..core.ristretto import pack_points

        count = len(items)
        n = len(items[0][3])
        if n == 0 or n & (n - 1) or len(G) < n:
            raise ProofError.invalid_generators_length()
        lg = n.bit_length() - 1
        plen = 32 * (2 * lg + 3)

        pblobs = []
        for proof, _, _, _ in items:
            pb = proof.to_bytes()
            if len(pb) != plen:
                raise ProofError.verification()
            pblobs.append(pb)
        proofs_blob = b"".join(pblobs)
        cs_blob = b"".join(bytes(C) for _, _, C, _ in items)
        bs_blob = b"".join(b"".join(s.to_bytes() for s in bv)
                           for _, _, _, bv in items)
        g_comp = b"".join(p.compress() for p in G[:n])

        strobe_size = len(items[0][1].strobe.buf.raw)
        strobes = _ct.create_string_buffer(
            b"".join(t.strobe.buf.raw for _, t, _, _ in items),
            strobe_size * count)
        w_wides = rng.randbytes(64 * count)
        dyn_sz = 32 * (2 + 2 * lg)
        dyn_sc = _ct.create_string_buffer(dyn_sz * count)
        static_acc = _ct.create_string_buffer(32 * (2 + n))
        rc = _NC.linear_verify_replay_batch_c(
            strobes, _ct.c_size_t(strobe_size),
            proofs_blob, _ct.c_size_t(plen), cs_blob, bs_blob,
            g_comp, F.compress(), B.compress(),
            _ct.c_uint64(n), _ct.c_uint64(count), w_wides,
            dyn_sc, static_acc)
        if rc != 0:
            raise ProofError.verification()
        sraw = strobes.raw
        for i, (_, t, _, _) in enumerate(items):
            t.strobe.buf.raw = sraw[i * strobe_size: (i + 1) * strobe_size]

        # dyn points in scalar order: per proof [S, C, L.., R..]
        dyn_bytes = []
        for (proof, _, C, _), pb in zip(items, pblobs):
            dyn_bytes.append(bytes(proof.S))
            dyn_bytes.append(bytes(C))
            dyn_bytes.extend(proof.L_vec)
            dyn_bytes.extend(proof.R_vec)
        n_dyn = count * (2 + 2 * lg)

        if use_device:
            if not _device_linear_check(dyn_bytes, dyn_sc.raw,
                                        static_acc.raw, [B, F] + G[:n],
                                        device):
                raise ProofError.verification()
            return

        dyn_blob = b"".join(dyn_bytes)
        dyn_ext = _ct.create_string_buffer(128 * n_dyn)
        ok = _ct.create_string_buffer(n_dyn)
        good = _NC.rist_batch_decompress(
            _ct.c_size_t(n_dyn), dyn_blob, dyn_ext, ok)
        if good != n_dyn:
            raise ProofError.verification()
        static_ext = pack_points([B, F] + G[:n])
        out = _ct.create_string_buffer(128)
        _NC.rist_msm(_ct.c_size_t(n_dyn + 2 + n),
                     dyn_sc.raw + static_acc.raw,
                     dyn_ext.raw + static_ext, out)
        if not _NC.rist_is_identity(out):
            raise ProofError.verification()

    # -- serialization (reference linear_proof.rs:316-407) ------------------
    def serialized_size(self) -> int:
        return (len(self.L_vec) * 2 + 3) * 32

    def to_bytes(self) -> bytes:
        buf = bytearray()
        for l, r in zip(self.L_vec, self.R_vec):
            buf += l
            buf += r
        buf += self.S
        buf += self.a.to_bytes()
        buf += self.r.to_bytes()
        return bytes(buf)

    @classmethod
    def from_bytes(cls, data: bytes) -> "LinearProof":
        if len(data) % 32 != 0:
            raise ProofError.format()
        num_elements = len(data) // 32
        if num_elements < 3 or (num_elements - 3) % 2 != 0:
            raise ProofError.format()
        lg_n = (num_elements - 3) // 2
        if lg_n >= 32:
            raise ProofError.format()
        L_vec, R_vec = [], []
        for i in range(lg_n):
            pos = 2 * i * 32
            L_vec.append(data[pos: pos + 32])
            R_vec.append(data[pos + 32: pos + 64])
        pos = 2 * lg_n * 32
        S = data[pos: pos + 32]
        a = Scalar.from_canonical_bytes(data[pos + 32: pos + 64])
        r = Scalar.from_canonical_bytes(data[pos + 64: pos + 96])
        if a is None or r is None:
            raise ProofError.format()
        return cls(L_vec, R_vec, S, a, r)
