"""The system under test for prove traffic: `BatchProver.prove_batch` of
the port, one closed-loop client.

Set-up draws a pool of `pool_batches` batches of statements from the
seed (values uniform in [0, 2^value_bits), blindings uniform mod l) and
builds the prover's tables.  Call i proves batch i mod pool_batches on
fresh transcripts (the configuration's label, then the statement's
index i * proofs + p as the u64 "statement") with its own rng, a SHAKE256
stream of the seed and i, so no two calls make the same proofs."""

from __future__ import annotations

import hashlib
import random
import time
from typing import List

from .. import check

L = 2 ** 252 + 27742317777372353535851937790883648493
CALL_TAG = b"portbench call"


class CallRng:
    """The byte source of one call: SHAKE256(tag, seed, call) read in
    order; keeps what it gave for the reference."""

    def __init__(self, tag: bytes, seed: int, call: int):
        self._xof = hashlib.shake_256(tag + seed.to_bytes(16, "little",
                                                            signed=True)
                                      + call.to_bytes(16, "little",
                                                      signed=True))
        self.drawn: List[bytes] = []
        self._at = 0

    def randbytes(self, n: int) -> bytes:
        out = self._xof.digest(self._at + n)[self._at:]
        self._at += n
        self.drawn.append(out)
        return out


def statements(traffic: dict, m: int, seed: int):
    """The pool: [(values, blindings)] of `pool_batches` batches of
    outputs_per_call / m statements of m values each."""
    rnd = random.Random(seed * 4 + 1)
    proofs = traffic["outputs_per_call"] // m
    pool = []
    for _ in range(traffic["pool_batches"]):
        vals = [[rnd.randrange(1 << traffic["value_bits"]) for _ in range(m)]
                for _ in range(proofs)]
        blinds = [[rnd.randrange(L) for _ in range(m)] for _ in range(proofs)]
        pool.append((vals, blinds))
    return pool


def call_key(seed: int, call: int) -> bytes:
    """The 32 bytes a one-key batch draws from call `call`'s rng."""
    return CallRng(CALL_TAG, seed, call).randbytes(32)


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        import torch
        from bulletproofs_tpu_torch import (BatchProver, BulletproofGens,
                                            PedersenGens, Scalar, Transcript)
        self._torch, self._Transcript = torch, Transcript
        self.cfg, self.seed, self.device = cfg, seed, device
        self.n, self.m = cfg["n"], cfg["m"]
        self.proofs = traffic["outputs_per_call"] // self.m
        self.outputs_per_call = self.proofs * self.m
        self.label = cfg["transcript_label"].encode()
        t0 = time.perf_counter()
        self.pool = []
        for vals, blinds in statements(traffic, self.m, seed):
            sc = [[Scalar(b) for b in bs] for bs in blinds]
            if self.m == 1:
                self.pool.append((vals, blinds, [v[0] for v in vals],
                                  [s[0] for s in sc]))
            else:
                self.pool.append((vals, blinds, vals, sc))
        t1 = time.perf_counter()
        self.prover = BatchProver(BulletproofGens(self.n, self.m),
                                  PedersenGens(), self.n, self.m,
                                  device=device)
        self._sync()
        self.setup_log = (f"inputs {t1 - t0:.2f} s, prover tables "
                          f"{time.perf_counter() - t1:.2f} s")

    def _sync(self):
        if self.device != "cpu":
            self._torch.cuda.synchronize()

    def shape(self) -> dict:
        return {"n": self.n, "m": self.m, "proofs": self.proofs}

    def install(self, spans) -> None:
        """The spans the per-layer metrics read."""
        from bulletproofs_tpu_torch.ops import fixed_msm
        from bulletproofs_tpu_torch.proofs import batch_prover
        spans.wrap(batch_prover.BatchProver, "prove_batch", "prove_batch")
        spans.wrap(batch_prover.BatchProver, "_statements", "statements")
        spans.wrap(batch_prover.BatchProver, "_assemble", "assemble")
        spans.wrap_library(batch_prover, "_NATIVE",
                           ("rp_ts_yz", "rp_ts_x", "rp_ts_w", "rp_ts_round"),
                           "host_fs")
        spans.wrap(fixed_msm, "msm_digits_niels", "fixed_msm")

    def call(self, i: int, tag: bytes = CALL_TAG):
        """Prove batch i mod pool on fresh transcripts -> (seconds from the
        call's start to a synchronize after it, what to keep)."""
        _, _, vals, sc = self.pool[i % len(self.pool)]
        base = max(i, 0) * self.proofs
        ts = []
        for p in range(self.proofs):
            t = self._Transcript(self.label)
            t.append_u64(b"statement", base + p)
            ts.append(t)
        rng = CallRng(tag, self.seed, i)
        t0 = time.perf_counter()
        proofs, vcs = self.prover.prove_batch(vals, sc, ts, rng=rng)
        self._sync()
        return time.perf_counter() - t0, (i, proofs, vcs, ts, rng)

    def warm_up(self, calls: int = 2) -> None:
        for k in range(calls):
            self.call(-1 - k, tag=b"portbench warm-up")

    def record(self, kept) -> dict:
        """A kept call's outputs as bytes, for the comparison."""
        i, proofs, vcs, ts, rng = kept
        vals, blinds, _, _ = self.pool[i % len(self.pool)]
        if len(rng.drawn) != 1 or len(rng.drawn[0]) != 32:
            raise RuntimeError(f"the prover drew {[len(d) for d in rng.drawn]} "
                               f"rng bytes; the reference knows one 32-byte "
                               f"key a batch")
        return {"base": i * self.proofs, "key": rng.drawn[0],
                "values": vals, "blindings": blinds,
                "proofs": [p.to_bytes() for p in proofs],
                "V": [v if self.m > 1 else [v] for v in vcs],
                "states": [t.strobe.buf.raw[:203] for t in ts]}

    def free(self) -> None:
        del self.prover
        if self.device != "cpu":
            self._torch.cuda.empty_cache()

    def compare(self, records, workers: int, sampler) -> dict:
        """The comparison of the kept calls, with the proofs each makes
        whole drawn from `sampler`."""
        for rec in records:
            rec["exact"] = check.sample(sampler, self.proofs)
        return check.compare(self.cfg, records, workers)
