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
with every chunk's validity.  With a mesh (`mesh=`, parallel/sharded_msm),
every aggregation takes the chunked route, and when the mesh has more than
one entry each chunk's MSM and the final one are sharded over it
(sharded_msm_lanes); K1 and the replay stay on the verifier's device, the
mesh's first.

Two more routes, the JAX package's:
* `prefer_host=True` (with the native library and no mesh), `_verify_host`:
  all in C++, one rangeproof_verify_prep_batch over the batch, one
  rist_batch_decompress, one rist_msm over the static and dynamic points;
* `use_native=False`, `_verify_python`: each proof's Python replay
  (RangeProof.verification_scalars_ints) and 64 rng bytes of weight, then
  K1 on the dynamic points and one MSM (K10, K11, K4a, K4b) on the device,
  or sharded over the mesh.
`prefer_host=None` (the default) keeps the device routes: unlike the JAX
package, which takes the host route whenever no TPU is attached, the port
never moves to the host unasked.

`host_verify_one` verifies one proof on the C++ route with a verifier
cached per generators; RangeProof.verify_multiple takes it.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import List, Sequence

import numpy as np
import torch

from ..config import settings
from ..core._native import LIB as _NATIVE
from ..core.ristretto import pack_points
from ..core.scalar import L as ELL
from ..device import resolve_device
from ..errors import ProofError
from ..generators import BulletproofGens, PedersenGens
from ..ops import curve as C
from ..ops import msm as M
from ..ops import verify as V
from ..proofs.rangeproof import SystemRandom
from ..transcript import Transcript
from .sharded_msm import Mesh, sharded_msm_lanes


class BatchVerifier:
    """Device-resident generators for (n, m) and batched verification of
    aggregated range proofs: one fused MSM per sub-batch, or for large nm
    or a mesh one MSM per chunk and a final one; or the C++ route
    (`prefer_host=True`) or the Python replay (`use_native=False`).  With
    a mesh, `device` is ignored: the verifier's device is the mesh's
    first."""

    SUB_BATCH = 2048

    def __init__(self, bp_gens: BulletproofGens, pc_gens: PedersenGens,
                 n: int, m: int = 1, mesh: Mesh = None,
                 use_native: bool = True, prefer_host=None, device="cuda"):
        if use_native and _NATIVE is None:
            raise RuntimeError("the batch verifier's native routes need the "
                               "native host library (core/_native.py); "
                               "use_native=False takes the Python replay")
        self.bp_gens, self.pc_gens = bp_gens, pc_gens
        self.n, self.m = n, m
        self.mesh = mesh
        self.use_native = use_native
        self.prefer_host = prefer_host
        self.device = resolve_device(device if mesh is None
                                     else mesh.devices[0])
        static = ([pc_gens.B_blinding, pc_gens.B]
                  + bp_gens.G(n, m) + bp_gens.H(n, m))
        self._static_host = static
        self._static_packed = None          # packed by the C++ route
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
        if not self.use_native:
            return self._verify_python(proofs, value_commitments, transcripts,
                                       rng)
        lg, _, n_dyn = V.shape(self.n, self.m)
        plen = 32 * (9 + 2 * lg)
        proofs_blob, vcs_blob, dyn_raw = self._serialize(
            proofs, value_commitments, lg, n_dyn, plen)
        if self.prefer_host and self.mesh is None:
            return self._verify_host(proofs_blob, vcs_blob, dyn_raw,
                                     transcripts, rng)
        if self.mesh is not None \
                or self.n * self.m > settings.fused_verify_max_nm:
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

    @property
    def sharded(self) -> bool:
        """Whether the MSMs are sharded: a mesh of more than one entry."""
        return self.mesh is not None and self.mesh.size > 1

    def _msm_flag(self, points: torch.Tensor, scalars: np.ndarray):
        """One MSM of the verifier: (4, 10, N) points and (N, 32) uint8
        scalar rows -> (point (4, 10, 1), is-identity flag (1,)) on the
        verifier's device; sharded over the mesh when it has more than one
        entry."""
        if self.sharded:
            out = sharded_msm_lanes(points, scalars, self.mesh)
            return out, C.is_identity(C.to_coords(out))
        return M.msm_lanes_flag(points, self._upload(scalars))

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
            partials.append(self._msm_flag(pts, dyn_sc)[0])
        scalars = np.zeros((n_static + len(partials), 32), np.uint8)
        scalars[:n_static] = np.frombuffer(static_acc.raw, np.uint8).reshape(
            n_static, 32)
        scalars[n_static:, 0] = 1
        _, flag = self._msm_flag(torch.cat([self.static_pts] + partials,
                                           dim=-1), scalars)
        return flag & torch.stack(valid).all()

    def _verify_host(self, proofs_blob, vcs_blob, dyn_raw, transcripts, rng):
        """The C++ route (JAX _verify_host): one replay of the batch that
        emits every dynamic point's scalar and the static sums (128 rng
        bytes a proof; the transcripts are written back), one batch
        decompression, one vartime MSM over the static points (packed
        once) and the dynamic ones."""
        n_dyn = dyn_raw.shape[0]
        n_static = len(self._static_host)
        static_sc = ctypes.create_string_buffer(32 * n_static)
        dyn_sc = self.prep(proofs_blob, vcs_blob, transcripts, rng,
                           static_sc)
        dyn_ext = ctypes.create_string_buffer(128 * n_dyn)
        ok = ctypes.create_string_buffer(n_dyn)
        if _NATIVE.rist_batch_decompress(n_dyn, dyn_raw.tobytes(), dyn_ext,
                                         ok) != n_dyn:
            raise ProofError.verification()
        if self._static_packed is None:
            self._static_packed = pack_points(self._static_host)
        out = ctypes.create_string_buffer(128)
        _NATIVE.rist_msm(n_static + n_dyn, static_sc.raw + dyn_sc.tobytes(),
                         self._static_packed + dyn_ext.raw, out)
        if not _NATIVE.rist_is_identity(out):
            raise ProofError.verification()

    def _verify_python(self, proofs, value_commitments, transcripts, rng):
        """The Python replay (JAX _verify_python): per proof its
        verification scalars, then 64 rng bytes of its weight r; K1 on
        the dynamic points and one MSM of the dynamic and the static
        points on the device, or sharded over the mesh."""
        n_static = len(self._static_host)
        dyn_ints, dyn_bytes = [], []
        static_acc = [0] * n_static
        for proof, vcs, transcript in zip(proofs, value_commitments,
                                          transcripts):
            if len(vcs) != self.m:
                raise ProofError.verification()
            dyn_s, static_s, dyn_pts = proof.verification_scalars_ints(
                self.bp_gens, self.pc_gens, transcript, vcs, self.n, rng=rng)
            r = int.from_bytes(rng.randbytes(64), "little") % ELL
            dyn_ints.extend(r * s % ELL for s in dyn_s)
            dyn_bytes.extend(dyn_pts)
            for j, s in enumerate(static_s):
                static_acc[j] = (static_acc[j] + r * s) % ELL
        dyn_raw = np.frombuffer(b"".join(dyn_bytes), np.uint8).reshape(-1, 32)
        valid, dyn_pts = C.decompress(self._upload(dyn_raw))
        scalars = np.frombuffer(b"".join(
            s.to_bytes(32, "little") for s in dyn_ints + static_acc),
            np.uint8).reshape(-1, 32)
        _, flag = self._msm_flag(torch.cat([dyn_pts, self.static_pts],
                                           dim=-1), scalars)
        if not bool((flag & valid.all()).all()):
            raise ProofError.verification()



# verifiers of the C++ route, per generators and then per (n, m)
_HOST_CTX = weakref.WeakKeyDictionary()


def host_verify_one(proof, bp_gens, pc_gens, transcript, value_commitments,
                    n: int, rng) -> None:
    """Verify one (possibly aggregated) range proof on the C++ route
    (replay, batch decompression, one MSM) with a BatchVerifier cached per
    generators (JAX host_verify_one); raises ProofError.  Takes no
    device."""
    m = len(value_commitments)
    per_gens = _HOST_CTX.get(bp_gens)
    if per_gens is None:
        per_gens = _HOST_CTX[bp_gens] = {}
    bv = per_gens.get((n, m))
    if bv is None or bv.pc_gens is not pc_gens:
        bv = BatchVerifier(bp_gens, pc_gens, n=n, m=m, prefer_host=True,
                           device="cpu")
        per_gens[(n, m)] = bv
    bv.verify_batch([proof], [value_commitments], [transcript], rng=rng)
