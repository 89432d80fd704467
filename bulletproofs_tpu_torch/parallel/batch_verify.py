"""Batched range-proof verification on the card: many proofs fused into
multi-scalar multiplications (the JAX package's parallel/batch_verify.py,
its fused and chunked routes).

    sum_p r_p * MegaCheck_p == identity

Each proof contributes 4 + 2 lg(nm) + m dynamic points (A, S, T_1, T_2,
L_i, R_i, V_j); the 2nm + 2 static points (B_blinding, B, G, H) are
shared and their per-proof scalars are summed.

Aggregations up to nm = settings.fused_verify_max_nm (256) take the fused
route, per sub-batch of up to 2048 proofs:
  1. the dynamic point bytes go to the device and kernel K1 decompresses
     them (asynchronous: the host goes on at once);
  2. one C++ call replays the transcripts (native/verify_prep.cpp
     rangeproof_verify_replay_batch_c) and writes each proof's compact
     challenge block; the replayed transcript states are written back;
  3. the blocks go to the device and ops/verify.fused_tail runs the emit
     (K2), the static sums, the mega-MSM (K3, K4) and the accept flag.
Host-to-device copies leave pinned buffers with non_blocking=True, so the
next sub-batch's host replay overlaps this one's kernels; the flags are
read in one synchronisation at the end.

Larger aggregations take the chunked route (`_verify_chunked`, JAX
`_verify_native_chunked` without its mesh branch), per chunk of
settings.verify_chunk_pts dynamic points:
  1. K1 decompresses the chunk's dynamic points;
  2. one C++ call (native/verify_prep.cpp rangeproof_verify_prep_batch)
     replays the transcripts and emits every dynamic point's scalar; the
     static scalars accumulate across the chunks in one host buffer;
  3. the chunk's partial MSM runs K10 (digits), K11 (accumulation for
     points of any Z), K4a and K4b.
Then one final MSM over the static points and the partial results (scalar
1 each; their Z is arbitrary, hence K11 and not K3) gives the flag, ANDed
with every chunk's validity.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from ..config import settings
from ..core._native import LIB as _NATIVE
from ..device import resolve_device
from ..errors import ProofError
from ..generators import BulletproofGens, PedersenGens
from ..ops import curve as C
from ..ops import msm as M
from ..ops import verify as V
from ..proofs.rangeproof import SystemRandom
from ..transcript import Transcript


class BatchVerifier:
    """Device-resident generators for (n, m) and batched verification of
    aggregated range proofs: one fused MSM per sub-batch, or for large nm
    one MSM per chunk and a final one."""

    SUB_BATCH = 2048

    def __init__(self, bp_gens: BulletproofGens, pc_gens: PedersenGens,
                 n: int, m: int = 1, device="cuda"):
        if _NATIVE is None:
            raise RuntimeError("the batch verifier needs the native host "
                               "library (core/_native.py)")
        self.bp_gens, self.pc_gens = bp_gens, pc_gens
        self.n, self.m = n, m
        self.device = resolve_device(device)
        static = ([pc_gens.B_blinding, pc_gens.B]
                  + bp_gens.G(n, m) + bp_gens.H(n, m))
        # Z = 1 copies (a change of representation only), so the MSM runs
        # the Niels mixed addition for every input
        self.static_lanes = C.points_to_lanes(C.normalized(static))
        self.static_pts = torch.as_tensor(self.static_lanes).to(self.device)
        self.static_niels = C.to_niels(self.static_pts)

    @property
    def sub_batch(self) -> int:
        """Proofs per sub-batch: settings.fused_verify_chunk, else 2048."""
        return settings.fused_verify_chunk or self.SUB_BATCH

    def verify_batch(self, proofs: Sequence, value_commitments: List[List[bytes]],
                     transcripts: List[Transcript], rng=None) -> None:
        """Verify every proof or raise ProofError.  Each proof has its own
        transcript (replayed in place) and its m value commitments."""
        if not (len(proofs) == len(value_commitments) == len(transcripts)):
            raise ValueError("proofs, value_commitments and transcripts "
                             "differ in length")
        if not proofs:
            raise ValueError("verify_batch requires at least one proof "
                             "(an empty batch would vacuously accept)")
        rng = rng or SystemRandom()
        lg, _, n_dyn = V.shape(self.n, self.m)
        plen = 32 * (9 + 2 * lg)
        proofs_blob, vcs_blob, dyn_raw = self._serialize(
            proofs, value_commitments, lg, n_dyn, plen)
        if self.n * self.m > settings.fused_verify_max_nm:
            ok = self._verify_chunked(proofs_blob, vcs_blob, dyn_raw,
                                      transcripts, rng, n_dyn, plen)
            if not bool(ok.all()):
                raise ProofError.verification()
            return
        flags = []
        step = self.sub_batch
        for lo in range(0, len(proofs), step):
            hi = min(lo + step, len(proofs))
            flags.append(self._subbatch(
                proofs_blob[lo * plen: hi * plen],
                vcs_blob[lo * 32 * self.m: hi * 32 * self.m],
                dyn_raw[lo * n_dyn: hi * n_dyn], transcripts[lo:hi], rng))
        if not bool(torch.cat(flags).all()):
            raise ProofError.verification()

    def _serialize(self, proofs, value_commitments, lg, n_dyn, plen):
        """Proof blobs and the proof-major dynamic point bytes
        [A, S, T1, T2, L.., R.., V..] (pure slices)."""
        pblobs = []
        for proof, vcs in zip(proofs, value_commitments):
            if len(vcs) != self.m or len(proof.ipp_proof.L_vec) != lg:
                raise ProofError.verification()
            pb = proof.to_bytes()
            if len(pb) != plen:
                raise ProofError.verification()
            pblobs.append(pb)
        count = len(proofs)
        proofs_blob = b"".join(pblobs)
        vcs_blob = b"".join(b"".join(v) for v in value_commitments)
        parr = np.frombuffer(proofs_blob, np.uint8).reshape(count, plen)
        lr = parr[:, 224: 224 + 64 * lg].reshape(count, lg, 2, 32)
        varr = np.frombuffer(vcs_blob, np.uint8).reshape(count, self.m, 32)
        dyn_raw = np.concatenate(
            [parr[:, :128].reshape(count, 4, 32), lr[:, :, 0], lr[:, :, 1],
             varr], axis=1).reshape(count * n_dyn, 32)
        return proofs_blob, vcs_blob, dyn_raw

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.array(arr, copy=True))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _subbatch(self, proofs_blob, vcs_blob, dyn_raw, transcripts, rng):
        """One sub-batch; returns its (1,) accept flag on the device without
        synchronising."""
        valid, dyn_pts = C.decompress(self._upload(dyn_raw))
        blk, pair = self.replay(proofs_blob, vcs_blob, transcripts, rng)
        return V.fused_tail(self.n, self.m, self._upload(blk),
                            self._upload(pair), self.static_niels, dyn_pts,
                            valid)

    def replay(self, proofs_blob: bytes, vcs_blob: bytes, transcripts, rng):
        """One C++ call: replay the transcripts (written back in place) and
        derive the challenges -> (challenge blocks (count, lg + 8, 32)
        uint8, B_blinding / B scalar sums (2, 32) uint8)."""
        _, nblk, _ = V.shape(self.n, self.m)
        count = len(transcripts)
        blocks = ctypes.create_string_buffer(32 * nblk * count)
        pair = ctypes.create_string_buffer(64)
        self._native_replay(_NATIVE.rangeproof_verify_replay_batch_c,
                            proofs_blob, vcs_blob, transcripts, rng, blocks,
                            pair)
        return (np.frombuffer(blocks.raw, np.uint8).reshape(count, nblk, 32),
                np.frombuffer(pair.raw, np.uint8).reshape(2, 32))

    def prep(self, proofs_blob: bytes, vcs_blob: bytes, transcripts, rng,
             static_acc) -> np.ndarray:
        """One C++ call: replay the transcripts (written back in place) and
        emit each proof's dynamic scalars -> (count * n_dyn, 32) uint8,
        proof-major as the dynamic points; the static scalars are ADDED
        into static_acc ((2 + 2nm) * 32 bytes, zero before the first
        chunk)."""
        _, _, n_dyn = V.shape(self.n, self.m)
        count = len(transcripts)
        dyn = ctypes.create_string_buffer(32 * n_dyn * count)
        self._native_replay(_NATIVE.rangeproof_verify_prep_batch,
                            proofs_blob, vcs_blob, transcripts, rng, dyn,
                            static_acc)
        return np.frombuffer(dyn.raw, np.uint8).reshape(count * n_dyn, 32)

    def _native_replay(self, fn, proofs_blob, vcs_blob, transcripts, rng,
                       out_a, out_b) -> None:
        """Call a C++ replay entry point on the transcripts' states with
        128 rng bytes per proof (the weights), raise ProofError on a
        malformed proof, write the advanced states back."""
        count = len(transcripts)
        strobe_size = len(transcripts[0].strobe.buf.raw)
        strobes = ctypes.create_string_buffer(
            b"".join(t.strobe.buf.raw for t in transcripts),
            strobe_size * count)
        cr = rng.randbytes(128 * count)
        rc = fn(strobes, strobe_size, proofs_blob, len(proofs_blob) // count,
                vcs_blob, self.n, self.m, count, cr, out_a, out_b)
        if rc != 0:
            raise ProofError.verification()
        sraw = strobes.raw
        for i, t in enumerate(transcripts):
            t.strobe.buf.raw = sraw[i * strobe_size: (i + 1) * strobe_size]

    def _verify_chunked(self, proofs_blob, vcs_blob, dyn_raw, transcripts,
                        rng, n_dyn: int, plen: int) -> torch.Tensor:
        """The chunked route (module docstring) -> (1,) accept flag on the
        device, without synchronising."""
        m = self.m
        count = len(transcripts)
        step = max(1, settings.verify_chunk_pts // n_dyn)
        n_static = self.static_pts.shape[-1]
        static_acc = ctypes.create_string_buffer(32 * n_static)
        valid, partials = [], []
        for lo in range(0, count, step):
            hi = min(lo + step, count)
            ok, pts = C.decompress(self._upload(dyn_raw[lo * n_dyn:
                                                        hi * n_dyn]))
            valid.append(ok.all())
            dyn_sc = self.prep(proofs_blob[lo * plen: hi * plen],
                               vcs_blob[lo * 32 * m: hi * 32 * m],
                               transcripts[lo:hi], rng, static_acc)
            partials.append(M.msm_lanes(pts, self._upload(dyn_sc)))
        scalars = np.zeros((n_static + len(partials), 32), np.uint8)
        scalars[:n_static] = np.frombuffer(static_acc.raw, np.uint8).reshape(
            n_static, 32)
        scalars[n_static:, 0] = 1
        _, flag = M.msm_lanes_flag(torch.cat([self.static_pts] + partials,
                                             dim=-1),
                                   self._upload(scalars))
        return flag & torch.stack(valid).all()

