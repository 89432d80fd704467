"""Batched range proving on the card: many proofs driven through the
device stages at once (the JAX package's proofs/batch_prover.py).  m = 1
proves one value per proof; m > 1 proves aggregated statements of m values
per proof, as the reference's `prove_multiple` and its local dealer do.

Two routes, both the JAX package's device routes:

* the device-transcript route (`fused = True`, the default;
  `_prove_batch_device_fused`): stage 0 on the device (the blinding draws,
  ChaCha20 from one 32-byte key per half-batch, and V / A / S), ONE host
  Fiat-Shamir step (C++ rp_ts_yz, the only transcript segment whose byte
  positions depend on the caller's prior content), then everything else on
  the device with no host round trip (ops/prover_stages.prove_rest, the
  JAX package's segmented form for every m): the transcripts
  (ops/transcript_device, kernel K13), T_1 / T_2, the IPP rounds with
  their challenges and inverses (kernel K14), the canonical output
  scalars.
* the per-stage route (`fused = False`; `_prove_batch_device`): the same
  device stages, with the host's C++ transcript (rp_ts_yz, rp_ts_x,
  rp_ts_w, rp_ts_round) between two of them.

Both give the same proofs for the same inputs and rng bytes.

With `prefer_host=True` the prover takes the JAX package's off-TPU route
instead and builds no device tables: for m = 1 the C++ stage engine
(`_prove_batch_host`: native/prove_prep.cpp rp_prove_stage0/1/2,
rp_prove_round_coefs / absorb, rp_prove_finish, with the row MSMs by the
C++ rist_msm_rows(_ct) over the packed bases), for m > 1
RangeProof.prove_multiple per proof.  It draws the rng as JAX's host route
does and gives its proofs byte for byte.  Points are
fixed-base MSMs over [B, B~, G.., H..] (kernels K6 or K12, and K7),
compressed by K5; the mod-l vectors go through K8-K10 and plain PyTorch.
Large batches run as two interleaved halves (from 2048 proofs on the
device-transcript route, from 1024 on the per-stage one), so the host work
of one half overlaps the device work of the other.  The transcripts
advance in place, as the reference's prover does; if the device-transcript
route raises, every transcript is restored to its bytes before the call.
Outputs have the reference crate's wire format and verify with
RangeProof.verify_single / verify_multiple and BatchVerifier.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..core._native import LIB as _NATIVE
from ..core.scalar import Scalar
from ..device import resolve_device
from ..errors import MPCError
from ..generators import BulletproofGens, PedersenGens
from ..ops import chacha
from ..ops import fixed_msm
from ..ops import prover_stages as PS
from ..transcript import Transcript
from .ipp import InnerProductProof
from .rangeproof import RangeProof, SystemRandom


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"native prove engine failed in {what} (rc={rc})")


def _fetch(x):
    """A device tensor, or a tuple of them, -> numpy (waits for the card:
    one blocking copy a tensor, each counted in `syncs`)."""
    xs = x if isinstance(x, tuple) else (x,)
    with tracing.span("prove.fetch"):
        out = tuple(t.cpu().numpy() for t in xs)
        if tracing.ON:
            tracing.count("syncs", len(out))
            tracing.count("d2h_bytes", sum(a.nbytes for a in out))
    return out if isinstance(x, tuple) else out[0]


class BatchProver:
    """Device tables for (n, m) and batched range proving on them."""

    HALVES_FROM = 1024          # per-stage route: batches this large (and
    FUSED_HALVES_FROM = 2048    # even) run as halves; device-transcript route

    def __init__(self, bp_gens: BulletproofGens, pc_gens: PedersenGens,
                 n: int, m: int = 1, device="cuda", prefer_host: bool = False):
        if n not in (8, 16, 32, 64):
            raise MPCError(MPCError.INVALID_BITSIZE)
        if m == 0 or m & (m - 1):
            raise MPCError(MPCError.INVALID_AGGREGATION)
        if _NATIVE is None:
            raise RuntimeError("the batch prover needs the native host "
                               "library (core/_native.py)")
        self.n, self.m, self.N = n, m, n * m
        self.bp_gens, self.pc_gens = bp_gens, pc_gens
        self.device = resolve_device(device)
        self.fused = True           # False: the per-stage route
        # the host route (module docstring), fixed at construction: its
        # tables are host-only, so its rows go to the C++ row MSM
        self.prefer_host = prefer_host
        bases = [pc_gens.B, pc_gens.B_blinding] + bp_gens.G(n, m) \
            + bp_gens.H(n, m)
        self.tables = fixed_msm.FixedBaseTables(
            bases, None if prefer_host else self.device)
        self.tables_bb = fixed_msm.SubsetTables(self.tables, [0, 1])
        if prefer_host:
            return
        # compact stage-0 streams: A touches only window 0 of each G / H
        # (coefficients in {0, +-1}); S drops the zero-coefficient B
        self.a_tables = fixed_msm.StreamSubsetTables(
            self.tables, PS.a_stream_sel(self.N))
        self.s_tables = fixed_msm.SubsetTables(
            self.tables, PS.s_base_sel(self.N))
        # per-round row maps of the per-stage route's active bases: half
        # the G's and the other half of the H's
        self.round_rows = {}
        nk = self.N
        while nk > 1:
            self.round_rows[nk] = tuple(
                torch.as_tensor(fixed_msm.base_rows(bases),
                                device=self.tables.niels.device)
                for bases in PS.round_base_sets(self.N, nk))
            nk //= 2

    def prove_batch(self, values: Sequence, blindings: Sequence,
                    transcripts: List[Transcript], rng=None
                    ) -> Tuple[List[RangeProof], List[bytes]]:
        """Prove one n-bit statement per transcript -> (proofs, value
        commitments).  For m = 1 each statement is one value and each
        commitment one compressed point; for m > 1 each is a list of m
        values (blindings) and a list of m compressed points.  Each proof
        verifies against its transcript's label as RangeProof.prove_single
        / prove_multiple's does.  `rng` (anything with .randbytes) seeds the
        blinding draws: 32 bytes per half-batch."""
        rng = rng or SystemRandom()
        with tracing.span("prove"):
            with tracing.span("prove.check"):
                values, blindings = self._checked(values, blindings,
                                                  transcripts)
            if self.prefer_host:
                return self._prove_host(values, blindings, transcripts, rng)
            if not self.fused:
                return self._prove_halves(self._prove_half_gen,
                                          self.HALVES_FROM, values, blindings,
                                          transcripts, rng)
            return self._prove_batch_device_fused(values, blindings,
                                                  transcripts, rng)

    def _checked(self, values, blindings, transcripts):
        """prove_batch's arguments as (values, blindings): m per
        statement, values Python ints in [0, 2^n)."""
        if not (len(values) == len(blindings) == len(transcripts)):
            raise ValueError("values, blindings and transcripts differ in "
                             "length")
        if not values:
            raise ValueError("prove_batch requires at least one value")
        if self.m == 1:
            values = [[v] for v in values]
            blindings = [[b] for b in blindings]
        values = [[int(v) for v in vs] for vs in values]
        for vs, bs in zip(values, blindings):
            if len(vs) != self.m or len(bs) != self.m:
                raise ValueError(f"expected {self.m} values and blindings "
                                 f"per statement")
            for v in vs:
                if v < 0 or v >> self.n:
                    raise ValueError(
                        f"value out of range for {self.n}-bit proof")
        return values, blindings

    def _prove_host(self, values, blindings, transcripts, rng):
        """JAX's off-TPU routing: the C++ stage engine for m = 1, the
        protocol's prove_multiple (dealer and parties on the host curve
        backend) per proof for m > 1."""
        if self.m == 1:
            return self._prove_batch_host([vs[0] for vs in values],
                                          [bs[0] for bs in blindings],
                                          transcripts, rng)
        proofs, vcs = [], []
        for vs, bs, t in zip(values, blindings, transcripts):
            p, vc = RangeProof.prove_multiple(self.bp_gens, self.pc_gens, t,
                                              vs, bs, self.n, rng=rng)
            proofs.append(p)
            vcs.append(vc)
        return proofs, vcs

    def _prove_batch_host(self, values, blindings, transcripts, rng):
        """The C++ stage engine, m = 1 (JAX _prove_batch_host): per stage
        one C++ call over every proof's state, the row MSMs between; rng
        draws count * (2 + 2n) * 64 bytes (blindings, sL, sR), then
        count * 128 (the T blindings).  The transcripts advance in
        place."""
        n, nb = self.n, self.tables.num_bases
        count = len(values)
        state = ctypes.create_string_buffer(_NATIVE.rp_state_size(n) * count)
        strobe_size = len(transcripts[0].strobe.buf.raw)
        strobes = ctypes.create_string_buffer(
            b"".join(t.strobe.buf.raw for t in transcripts),
            strobe_size * count)

        # stage 0: blindings -> V / A / S coefficient rows; they carry the
        # witness (values, bits, blindings): constant-time rows
        vals = (ctypes.c_uint64 * count)(*values)
        vblind = b"".join(b.to_bytes() for b in blindings)
        rand0 = rng.randbytes(count * (2 + 2 * n) * 64)
        coef0 = np.zeros((3 * count, nb, 32), np.uint8)
        _check_rc(_NATIVE.rp_prove_stage0(
            count, n, vals, vblind, rand0, state,
            coef0.ctypes.data_as(ctypes.c_char_p)), "rp_prove_stage0")
        vas = fixed_msm.msm_rows_compressed(self.tables, coef0,
                                            consttime=True)

        # stage 1: y, z; l / r polynomials; T_1 / T_2 rows (the secret
        # t-polynomial: constant-time rows)
        rand1 = rng.randbytes(count * 128)
        coef1 = np.zeros((2 * count, 2, 32), np.uint8)
        _check_rc(_NATIVE.rp_prove_stage1(
            count, n, strobes, strobe_size, vas.tobytes(), rand1, state,
            coef1.ctypes.data_as(ctypes.c_char_p)), "rp_prove_stage1")
        tb = fixed_msm.msm_rows_compressed(self.tables_bb, coef1,
                                           consttime=True)

        # stage 2: x; the share scalars; w; the IPP's start
        _check_rc(_NATIVE.rp_prove_stage2(
            count, n, strobes, strobe_size, tb.tobytes(), state),
            "rp_prove_stage2")

        # IPP rounds: L / R rows are public (vartime rows)
        L_rows, R_rows = [], []
        nk = n
        coefr = np.zeros((2 * count, nb, 32), np.uint8)
        while nk > 1:
            _check_rc(_NATIVE.rp_prove_round_coefs(
                count, n, nk, state, coefr.ctypes.data_as(ctypes.c_char_p)),
                "rp_prove_round_coefs")
            lr = fixed_msm.msm_rows_compressed(self.tables, coefr)
            L_rows.append(lr[:count])
            R_rows.append(lr[count:])
            _check_rc(_NATIVE.rp_prove_round_absorb(
                count, n, nk, strobes, strobe_size, lr.tobytes(), state),
                "rp_prove_round_absorb")
            nk //= 2

        scal = ctypes.create_string_buffer(count * 5 * 32)
        _check_rc(_NATIVE.rp_prove_finish(count, n, state, scal),
                  "rp_prove_finish")
        sraw = strobes.raw
        for i, t in enumerate(transcripts):
            t.strobe.buf.raw = sraw[i * strobe_size: (i + 1) * strobe_size]

        out = scal.raw

        def sc(off) -> Scalar:
            return Scalar.from_canonical_bytes(out[off: off + 32])

        proofs = []
        for p in range(count):
            off = p * 160
            ipp = InnerProductProof(
                L_vec=[bytes(rows[p]) for rows in L_rows],
                R_vec=[bytes(rows[p]) for rows in R_rows],
                a=sc(off + 96), b=sc(off + 128))
            proofs.append(RangeProof(
                A=bytes(vas[count + p]), S=bytes(vas[2 * count + p]),
                T_1=bytes(tb[p]), T_2=bytes(tb[count + p]), t_x=sc(off),
                t_x_blinding=sc(off + 32), e_blinding=sc(off + 64),
                ipp_proof=ipp))
        return proofs, [bytes(vas[p]) for p in range(count)]

    def _prove_batch_device_fused(self, values, blindings, transcripts, rng):
        """The device-transcript route.  With interleaved halves, one half
        may have written its transcripts back before the other raises, so
        every transcript's bytes are kept first and restored on an error,
        which then propagates (there is no fallback route)."""
        snaps = [t.strobe.buf.raw for t in transcripts]
        try:
            return self._prove_halves(self._prove_half_fused_gen,
                                      self.FUSED_HALVES_FROM, values,
                                      blindings, transcripts, rng)
        except BaseException:
            for t, snap in zip(transcripts, snaps):
                t.strobe.buf.raw = snap
            raise

    def _prove_halves(self, half_gen, halves_from, values, blindings,
                      transcripts, rng):
        """Drive one generator per half: each yields device tensors right
        after queueing a stage and receives them as numpy, so that while
        the host works on one half's bytes the card runs the other's."""
        count = len(values)
        if count >= halves_from and count % 2 == 0:
            h = count // 2
            parts = [slice(0, h), slice(h, count)]
        else:
            parts = [slice(0, count)]
        gens, pend = [], []
        for s in parts:
            g = half_gen(values[s], blindings[s], transcripts[s], rng)
            gens.append(g)
            pend.append(next(g))        # primes: queues its stage 0
        results = [None] * len(gens)
        live = list(range(len(gens)))
        while live:
            for i in list(live):
                try:
                    pend[i] = gens[i].send(_fetch(pend[i]))
                except StopIteration as e:
                    results[i] = e.value
                    live.remove(i)
        proofs, vcs = [], []
        for r in results:
            proofs.extend(r[0])
            vcs.extend(r[1])
        return proofs, vcs

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array -> a tensor on the device; to a card from pinned
        memory without waiting for it."""
        t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
        if tracing.ON:
            tracing.count("h2d_bytes", arr.nbytes)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _rows32(self, raw: bytes, rows: int) -> torch.Tensor:
        """rows 32-byte rows -> a (rows, 32) uint8 tensor on the device."""
        return self._upload(np.frombuffer(raw, np.uint8).reshape(rows, 32))

    def _statements(self, values, blindings):
        """-> (v_bytes, vb_bytes (m P, 32) party-major rows j P + p, bits
        (N, P) int32, row j n + i the bit i of party j's value)."""
        n, m, count = self.n, self.m, len(values)
        with tracing.span("prove.statements"):
            v_bytes = self._rows32(b"".join(
                values[p][j].to_bytes(32, "little")
                for j in range(m) for p in range(count)), m * count)
            vb_bytes = self._rows32(b"".join(
                blindings[p][j].to_bytes()
                for j in range(m) for p in range(count)), m * count)
            vals_np = np.array(values, np.uint64).T             # (m, count)
            bits = self._upload(((vals_np[:, None, :] >> np.arange(
                n, dtype=np.uint64)[None, :, None]) & 1).reshape(self.N, count)
                .astype(np.int32))
        return v_bytes, vb_bytes, bits

    def _prove_half_fused_gen(self, values, blindings, transcripts, rng):
        """Generator of the device-transcript route (JAX
        _prove_half_fused_gen): two yields, stage 0's rows and the rest's
        outputs."""
        n, m, count = self.n, self.m, len(values)
        key = rng.randbytes(32)
        v_bytes, vb_bytes, bits = self._statements(values, blindings)
        vas_dev, red = PS.stage0_eager(
            n, m, self.tables_bb.niels, self.a_tables.niels,
            self.s_tables.niels, key, v_bytes, vb_bytes, bits)
        vas = yield vas_dev

        # host Fiat-Shamir: dom-sep, V / A / S -> y, z (and 1/y); after z's
        # PRF every transcript sits at PS._ROUND_COUNTERS
        with tracing.span("prove.fs"):
            strobe_size = len(transcripts[0].strobe.buf.raw)
            strobes = ctypes.create_string_buffer(
                b"".join(t.strobe.buf.raw for t in transcripts),
                strobe_size * count)
            yz = ctypes.create_string_buffer(3 * count * 32)
            _check_rc(_NATIVE.rp_ts_yz(count, strobes, strobe_size, n, m,
                                       vas.tobytes(), yz), "rp_ts_yz")
            states_z = self._upload(np.frombuffer(strobes.raw, np.uint8)
                                    .reshape(count, strobe_size)[:, :200].T)
            yz_bytes = self._rows32(yz.raw, 3 * count)
        tb, lr_all, fin, st = yield PS.prove_rest(
            n, m, self.tables, states_z, red, bits, yz_bytes, vb_bytes)

        with tracing.span("prove.writeback"):
            posf, pbf, flf = PS._ROUND_COUNTERS
            for i, t in enumerate(transcripts):
                buf = bytearray(t.strobe.buf.raw)
                buf[:200] = st[:, i].tobytes()
                buf[200], buf[201], buf[202] = posf, pbf, flf
                t.strobe.buf.raw = bytes(buf)
        return self._assemble(vas, tb, lr_all, fin)

    def _prove_half_gen(self, values, blindings, transcripts, rng):
        """Generator of the per-stage route (JAX _prove_half_gen): yields
        after queueing each stage, the host's C++ transcript between."""
        n, m, N, count = self.n, self.m, self.N, len(values)
        strobe_size = len(transcripts[0].strobe.buf.raw)
        strobes = ctypes.create_string_buffer(
            b"".join(t.strobe.buf.raw for t in transcripts),
            strobe_size * count)

        # blinding draws [ab][sb][t1b][t2b] (count each), then [sl][sr]
        # (N * count each, i-major), from one key
        red = chacha.random_scalars(rng.randbytes(32), count * (4 + 2 * N),
                                    self.device)
        v_bytes, vb_bytes, bits = self._statements(values, blindings)

        vas = yield PS.stage0_fused(n, m, self.tables_bb.niels,
                                    self.a_tables.niels, self.s_tables.niels,
                                    red, v_bytes, vb_bytes, bits)
        yz = ctypes.create_string_buffer(3 * count * 32)
        with tracing.span("prove.fs"):
            _check_rc(_NATIVE.rp_ts_yz(count, strobes, strobe_size, n, m,
                                       vas.tobytes(), yz), "rp_ts_yz")

        (tb_dev, l0, l1, r0, r1, t0, t1, t2, zz_zpow, yinv) = PS.stage1_fused(
            n, m, self.tables_bb.niels, bits, red,
            self._rows32(yz.raw, 3 * count))
        tb = yield tb_dev
        x_buf = ctypes.create_string_buffer(count * 32)
        with tracing.span("prove.fs"):
            _check_rc(_NATIVE.rp_ts_x(count, strobes, strobe_size,
                                      tb.tobytes(), x_buf), "rp_ts_x")

        (txs_dev, a, b, gw, hw, t_x, t_xb, e_b) = PS.stage2_fused(
            n, m, self._rows32(x_buf.raw, count), l0, l1, r0, r1, t0, t1, t2,
            zz_zpow, red, vb_bytes, yinv)
        txs = (yield txs_dev).reshape(3, count, 32)
        w_buf = ctypes.create_string_buffer(count * 32)
        with tracing.span("prove.fs"):
            _check_rc(_NATIVE.rp_ts_w(
                count, strobes, strobe_size, N,
                np.ascontiguousarray(txs.transpose(1, 0, 2)).tobytes(),
                w_buf), "rp_ts_w")
        w_bytes = self._rows32(w_buf.raw, count)

        lrs = []
        u_bytes = ui_bytes = None
        nk = N
        while nk > 1:
            sel_l, sel_r = self.round_rows[nk]
            if nk == N:
                lr_dev = PS.round_emit(N, N, self.tables, sel_l, sel_r, a, b,
                                       gw, hw, w_bytes)
            else:
                lr_dev, a, b, gw, hw = PS.roundk_fused(
                    N, nk, self.tables, sel_l, sel_r, a, b, gw, hw, u_bytes,
                    ui_bytes, w_bytes)
            lr = yield lr_dev
            lrs.append(lr)
            u_buf = ctypes.create_string_buffer(count * 32)
            ui_buf = ctypes.create_string_buffer(count * 32)
            with tracing.span("prove.fs"):
                _check_rc(_NATIVE.rp_ts_round(count, strobes, strobe_size,
                                              lr.tobytes(), u_buf, ui_buf),
                          "rp_ts_round")
            u_bytes = self._rows32(u_buf.raw, count)
            ui_bytes = self._rows32(ui_buf.raw, count)
            nk //= 2

        fin = (yield PS.final_fused(N, a, b, gw, hw, u_bytes, ui_bytes, t_x,
                                    t_xb, e_b)).reshape(5, count, 32)
        sraw = strobes.raw
        for i, t in enumerate(transcripts):
            t.strobe.buf.raw = sraw[i * strobe_size: (i + 1) * strobe_size]
        return self._assemble(vas, tb, np.stack(lrs), fin)

    def _assemble(self, vas, tb, lr_all, fin):
        """Host proof objects from the fetched bytes: vas ((m + 2) P, 32)
        rows [V | A | S], tb (2P, 32) [T_1 | T_2], lr_all (R, 2P, 32)
        [L | R] per round, fin (5, P, 32) canonical [t_x, t_x_blinding,
        e_blinding, a, b] -> (proofs, value commitments)."""
        m, count = self.m, fin.shape[1]

        def sc(row) -> Scalar:
            return Scalar.from_canonical_bytes(row.tobytes())

        proofs, vcs = [], []
        with tracing.span("prove.assemble"):
            for p in range(count):
                ipp = InnerProductProof(
                    L_vec=[bytes(lr[p]) for lr in lr_all],
                    R_vec=[bytes(lr[count + p]) for lr in lr_all],
                    a=sc(fin[3, p]), b=sc(fin[4, p]))
                proofs.append(RangeProof(
                    A=bytes(vas[m * count + p]),
                    S=bytes(vas[(m + 1) * count + p]),
                    T_1=bytes(tb[p]), T_2=bytes(tb[count + p]),
                    t_x=sc(fin[0, p]), t_x_blinding=sc(fin[1, p]),
                    e_blinding=sc(fin[2, p]), ipp_proof=ipp))
                if m == 1:
                    vcs.append(bytes(vas[p]))
                else:
                    vcs.append([bytes(vas[j * count + p]) for j in range(m)])
        return proofs, vcs
