"""Batched range-proof verification on the card: many proofs fused into one
multi-scalar multiplication per sub-batch (the JAX package's
parallel/batch_verify.py, fused route).

    sum_p r_p * MegaCheck_p == identity

Each proof contributes 4 + 2 lg(nm) + m dynamic points (A, S, T_1, T_2,
L_i, R_i, V_j); the 2nm + 2 static points (B_blinding, B, G, H) are
shared and their per-proof scalars are summed on the device.

Per sub-batch of up to 2048 proofs:
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
from ..ops import verify as V
from ..proofs.rangeproof import SystemRandom
from ..transcript import Transcript


class BatchVerifier:
    """Device-resident generators for (n, m) and batched verification of
    aggregated range proofs, one fused MSM per sub-batch."""

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
        self.static_niels = C.to_niels(
            torch.as_tensor(self.static_lanes)).to(self.device)

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
        n, m = self.n, self.m
        _, nblk, _ = V.shape(n, m)
        count = len(transcripts)
        strobe_size = len(transcripts[0].strobe.buf.raw)
        strobes = ctypes.create_string_buffer(
            b"".join(t.strobe.buf.raw for t in transcripts),
            strobe_size * count)
        cr = rng.randbytes(128 * count)
        blocks = ctypes.create_string_buffer(32 * nblk * count)
        pair = ctypes.create_string_buffer(64)
        rc = _NATIVE.rangeproof_verify_replay_batch_c(
            strobes, strobe_size, proofs_blob, len(proofs_blob) // count,
            vcs_blob, n, m, count, cr, blocks, pair)
        if rc != 0:
            raise ProofError.verification()
        sraw = strobes.raw
        for i, t in enumerate(transcripts):
            t.strobe.buf.raw = sraw[i * strobe_size: (i + 1) * strobe_size]
        return (np.frombuffer(blocks.raw, np.uint8).reshape(count, nblk, 32),
                np.frombuffer(pair.raw, np.uint8).reshape(2, 32))

