"""Batched range proving on the card: many proofs driven through the
device stages at once (the JAX package's proofs/batch_prover.py, its
per-stage route `_prove_batch_device` / `_prove_half_gen`).  m = 1 proves
one value per proof; m > 1 proves aggregated statements of m values per
proof, as the reference's `prove_multiple` and its local dealer do.

Split of labour:

* device (ops/prover_stages.py): the blinding draws (ChaCha20 from one
  32-byte key per half-batch), every commitment and every IPP L / R as
  fixed-base MSMs over [B, B~, G.., H..] (kernels K6, K7), their
  compression (K5), the digit streams (K10), the IPP fold (K8, K9) and the
  rest of the mod-l vector math;
* host (native/prove_prep.cpp through core/_native.py): Fiat-Shamir, one
  batched C++ call between two device stages (rp_ts_yz, rp_ts_x, rp_ts_w,
  rp_ts_round).

Large batches run as two interleaved halves, so the host's transcript work
of one half overlaps the device work of the other.  The transcripts
advance in place, as the reference's prover does.  Outputs have the
reference crate's wire format and verify with RangeProof.verify_single /
verify_multiple and BatchVerifier.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

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


class BatchProver:
    """Device tables for (n, m) and batched range proving on them."""

    HALVES_FROM = 1024          # batches this large (and even) run as halves

    def __init__(self, bp_gens: BulletproofGens, pc_gens: PedersenGens,
                 n: int, m: int = 1, device="cuda"):
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
        bases = [pc_gens.B, pc_gens.B_blinding] + bp_gens.G(n, m) \
            + bp_gens.H(n, m)
        self.tables = fixed_msm.FixedBaseTables(bases, self.device)
        self.tables_bb = fixed_msm.SubsetTables(self.tables, [0, 1])
        # compact stage-0 streams: A touches only window 0 of each G / H
        # (coefficients in {0, +-1}); S drops the zero-coefficient B
        self.a_tables = fixed_msm.StreamSubsetTables(
            self.tables, PS.a_stream_sel(self.N))
        self.s_tables = fixed_msm.SubsetTables(
            self.tables, PS.s_base_sel(self.N))
        # per-round active bases: half the G's and the other half of the H's
        self.round_tables = {}
        nk = self.N
        while nk > 1:
            l_set, r_set = PS.round_base_sets(self.N, nk)
            self.round_tables[nk] = (
                fixed_msm.SubsetTables(self.tables, l_set),
                fixed_msm.SubsetTables(self.tables, r_set))
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
        count = len(values)
        if count >= self.HALVES_FROM and count % 2 == 0:
            h = count // 2
            parts = [slice(0, h), slice(h, count)]
        else:
            parts = [slice(0, count)]
        gens, pend = [], []
        for s in parts:
            g = self._prove_half_gen(values[s], blindings[s], transcripts[s],
                                     rng)
            gens.append(g)
            pend.append(next(g))        # primes: queues its stage 0
        results = [None] * len(gens)
        live = list(range(len(gens)))
        while live:
            for i in list(live):
                try:
                    pend[i] = gens[i].send(pend[i].cpu().numpy())
                except StopIteration as e:
                    results[i] = e.value
                    live.remove(i)
        proofs, vcs = [], []
        for r in results:
            proofs.extend(r[0])
            vcs.extend(r[1])
        return proofs, vcs

    def _upload(self, raw: bytes, rows: int) -> torch.Tensor:
        """rows 32-byte rows -> a (rows, 32) uint8 tensor on the device."""
        return torch.from_numpy(np.frombuffer(raw, np.uint8).reshape(
            rows, 32).copy()).to(self.device)

    def _prove_half_gen(self, values, blindings, transcripts, rng):
        """Generator: yields a device tensor right after queueing each
        stage and receives its bytes (numpy), so that prove_batch can
        interleave two halves."""
        n, m, N, count = self.n, self.m, self.N, len(values)
        strobe_size = len(transcripts[0].strobe.buf.raw)
        strobes = ctypes.create_string_buffer(
            b"".join(t.strobe.buf.raw for t in transcripts),
            strobe_size * count)

        # blinding draws [ab][sb][t1b][t2b] (count each), then [sl][sr]
        # (N * count each, i-major), from one key
        red = chacha.random_scalars(rng.randbytes(32), count * (4 + 2 * N),
                                    self.device)
        # party-major scalars (column j * count + p) and bits (N, count),
        # row k = j * n + i the bit i of party j's value
        v_bytes = self._upload(b"".join(
            values[p][j].to_bytes(32, "little")
            for j in range(m) for p in range(count)), m * count)
        vb_bytes = self._upload(b"".join(
            blindings[p][j].to_bytes() for j in range(m) for p in range(count)),
            m * count)
        vals_np = np.array(values, np.uint64).T                 # (m, count)
        bits = torch.from_numpy(((vals_np[:, None, :] >> np.arange(
            n, dtype=np.uint64)[None, :, None]) & 1).reshape(N, count)
            .astype(np.int32)).to(self.device)

        vas = yield PS.stage0_fused(n, m, self.tables_bb.niels,
                                    self.a_tables.niels, self.s_tables.niels,
                                    red, v_bytes, vb_bytes, bits)
        yz = ctypes.create_string_buffer(3 * count * 32)
        _check_rc(_NATIVE.rp_ts_yz(count, strobes, strobe_size, n, m,
                                   vas.tobytes(), yz), "rp_ts_yz")

        (tb_dev, l0, l1, r0, r1, t0, t1, t2, zz_zpow, yinv) = PS.stage1_fused(
            n, m, self.tables_bb.niels, bits, red,
            self._upload(yz.raw, 3 * count))
        tb = yield tb_dev
        x_buf = ctypes.create_string_buffer(count * 32)
        _check_rc(_NATIVE.rp_ts_x(count, strobes, strobe_size, tb.tobytes(),
                                  x_buf), "rp_ts_x")

        (txs_dev, a, b, gw, hw, t_x, t_xb, e_b) = PS.stage2_fused(
            n, m, self._upload(x_buf.raw, count), l0, l1, r0, r1, t0, t1, t2,
            zz_zpow, red, vb_bytes, yinv)
        txs = (yield txs_dev).reshape(3, count, 32)
        w_buf = ctypes.create_string_buffer(count * 32)
        _check_rc(_NATIVE.rp_ts_w(
            count, strobes, strobe_size, N,
            np.ascontiguousarray(txs.transpose(1, 0, 2)).tobytes(), w_buf),
            "rp_ts_w")
        w_bytes = self._upload(w_buf.raw, count)

        L_rows, R_rows = [], []
        u_bytes = ui_bytes = None
        nk = N
        while nk > 1:
            niels_l, niels_r = (t.niels for t in self.round_tables[nk])
            if nk == N:
                lr_dev = PS.round_emit(N, N, niels_l, niels_r, a, b, gw, hw,
                                       w_bytes)
            else:
                lr_dev, a, b, gw, hw = PS.roundk_fused(
                    N, nk, niels_l, niels_r, a, b, gw, hw, u_bytes, ui_bytes,
                    w_bytes)
            lr = yield lr_dev
            L_rows.append(lr[:count])
            R_rows.append(lr[count:])
            u_buf = ctypes.create_string_buffer(count * 32)
            ui_buf = ctypes.create_string_buffer(count * 32)
            _check_rc(_NATIVE.rp_ts_round(count, strobes, strobe_size,
                                          lr.tobytes(), u_buf, ui_buf),
                      "rp_ts_round")
            u_bytes = self._upload(u_buf.raw, count)
            ui_bytes = self._upload(ui_buf.raw, count)
            nk //= 2

        fin = (yield PS.final_fused(N, a, b, gw, hw, u_bytes, ui_bytes, t_x,
                                    t_xb, e_b)).reshape(5, count, 32)
        sraw = strobes.raw
        for i, t in enumerate(transcripts):
            t.strobe.buf.raw = sraw[i * strobe_size: (i + 1) * strobe_size]

        def sc(row) -> Scalar:
            return Scalar.from_canonical_bytes(row.tobytes())

        proofs, vcs = [], []
        for p in range(count):
            ipp = InnerProductProof(
                L_vec=[bytes(Lr[p]) for Lr in L_rows],
                R_vec=[bytes(Rr[p]) for Rr in R_rows],
                a=sc(fin[3, p]), b=sc(fin[4, p]))
            proofs.append(RangeProof(
                A=bytes(vas[m * count + p]), S=bytes(vas[(m + 1) * count + p]),
                T_1=bytes(tb[p]), T_2=bytes(tb[count + p]),
                t_x=sc(fin[0, p]), t_x_blinding=sc(fin[1, p]),
                e_blinding=sc(fin[2, p]), ipp_proof=ipp))
            if m == 1:
                vcs.append(bytes(vas[p]))
            else:
                vcs.append([bytes(vas[j * count + p]) for j in range(m)])
        return proofs, vcs
