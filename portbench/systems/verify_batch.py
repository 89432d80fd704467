"""The system under test for verify traffic: `BatchVerifier.verify_batch`
of the port, one closed-loop client.

Set-up draws `proved_batches` batches of statements from the seed (values
uniform in [0, 2^value_bits), blindings uniform mod l), as the prove
traffic does, and proves them once with the port's `BatchProver`: each
proof on its own transcript (the configuration's label, then its index
among the proved statements as the u64 "statement").  The prover and its
tables are then freed, and the card's peak memory counted anew: a
verifying node proves nothing.  The pool holds `pool_batches` batches,
batch b a copy of proved batch b mod proved_batches on the same
statements; the verifier keeps nothing from one call to the next, so a
copy costs a call what a fresh batch would.

The pool's labels cover each part of the batch and each check on its
own.  The traffic's `invalid` kinds, one a batch, go to as many batches
chosen from the seed; the batch is cut into as many equal slices, and the
kinds to the slices in an order drawn from the seed, so every slice holds
the invalid proof of one batch (at 8,192 proofs a call and four kinds,
one in each of the verifier's four 2,048-proof sub-batches).  The kinds
(`invalid_wire`):

* `t_x`: t_x + 1 mod l.  t_x enters the transcript before w and the u_k:
  both checks fail;
* `range`: a proof of a value 2^value_bits or more, made whole by the
  plain reference prover (`reference/rangeproof.py`) on the statement's
  transcript, with its own commitment: its inner-product argument holds,
  and only the t-polynomial check (the range guarantee) fails;
* `a`: the inner-product argument's final a + 1 mod l.  a is not in the
  transcript: only the inner-product check fails;
* `e_blinding`: e_blinding + 1 mod l.  It enters the transcript after x:
  the t-polynomial check holds, the inner-product check fails.

Every scalar is re-encoded canonically, so no proof is rejected before
its equation.  The proofs' wire bytes are parsed into the port's
`RangeProof` objects in set-up (an unedited copy shares its source's), as
a node holds the proofs it has received.

Call i verifies batch i mod pool_batches on fresh transcripts of its
statements, with weights drawn from a SHAKE256 stream of the seed and i.
`ProofError` is the call's verdict False; the verdict of every call of the
window is kept for the comparison (`check_verify.py`)."""

from __future__ import annotations

import hashlib
import random
import time

from .. import check, check_verify
from ..reference import rangeproof as RP
from .prove_batch import L, CallRng, statements

WEIGHTS_TAG = b"portbench verify weights"
POOL_TAG = b"portbench verify pool"
STATE_BYTES = 203
# the scalar each edit bumps, by its offset in the wire format
SCALAR_AT = {"t_x": 128, "e_blinding": 192, "a": -64}


class WeightRng:
    """The verifier's weight bytes for one call: draw k is
    SHAKE256(tag, seed, call, k), so each draw costs its own length.  The
    prove system's `CallRng` reads one stream from its start at every
    draw, which would put a few MB of SHAKE256 into each verify call (four
    draws of 128 bytes a proof); its prove cells' streams stay as they
    are."""

    def __init__(self, tag: bytes, seed: int, call: int):
        self._prefix = (tag + seed.to_bytes(16, "little", signed=True)
                        + call.to_bytes(16, "little", signed=True))
        self._k = 0

    def randbytes(self, n: int) -> bytes:
        out = hashlib.shake_256(self._prefix + self._k.to_bytes(
            8, "little")).digest(n)
        self._k += 1
        return out


def layout(seed: int, pool_batches: int, proofs: int, kinds) -> dict:
    """{batch: (kind, position)} of the pool's invalid proofs: one kind a
    batch, the batches drawn from the seed, kind j's proof in slice
    order[j] of the batch's len(kinds) equal slices."""
    k = len(kinds)
    if k > pool_batches or proofs % k:
        raise ValueError(f"{k} invalid kinds need as many pool batches "
                         f"and a batch of a multiple of {k} proofs")
    rnd = random.Random(seed * 4 + 3)
    batches = rnd.sample(range(pool_batches), k)
    order = rnd.sample(range(k), k)
    width = proofs // k
    return {b: (kind, s * width + rnd.randrange(width))
            for b, kind, s in zip(batches, kinds, order)}


def bump(wire: bytes, at: int) -> bytes:
    """The wire bytes with the scalar at offset `at` plus 1 mod l,
    canonical."""
    at %= len(wire)
    s = int.from_bytes(wire[at: at + 32], "little")
    return wire[:at] + ((s + 1) % L).to_bytes(32, "little") + wire[at + 32:]


def out_of_range(cfg: dict, traffic: dict, seed: int, statement: int):
    """A proof of statement `statement` whose first value is 2^value_bits
    or more, made whole by the plain reference prover -> (wire bytes, its
    m value commitments)."""
    n, m, bits = cfg["n"], cfg["m"], traffic["value_bits"]
    rnd = random.Random(seed * 4 + 0)
    values = [(1 << bits) + rnd.randrange(1 << bits)] + [
        rnd.randrange(1 << bits) for _ in range(m - 1)]
    blindings = [rnd.randrange(L) for _ in range(m)]
    blinds = RP.draws(rnd.getrandbits(256).to_bytes(32, "little"), 1, n * m,
                      [0])[0]
    t = check.transcript(cfg["transcript_label"].encode(), statement)
    out = RP.prove(check._gens(n, m), values, blindings, blinds, t)
    return out["proof"], out["V"]


def invalid_wire(kind: str, wire: bytes, V, cfg, traffic, seed, statement):
    """The proof `wire` on `statement` made invalid by `kind` (module
    docstring) -> (wire bytes, value commitments)."""
    if kind == "range":
        return out_of_range(cfg, traffic, seed, statement)
    return bump(wire, SCALAR_AT[kind]), V


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        import torch
        from bulletproofs_tpu_torch import (BatchProver, BatchVerifier,
                                            BulletproofGens, PedersenGens,
                                            ProofError, RangeProof, Scalar,
                                            Transcript)
        self._torch, self._Transcript = torch, Transcript
        self._ProofError = ProofError
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.n, self.m = cfg["n"], cfg["m"]
        self.proofs = traffic["outputs_per_call"] // self.m
        self.outputs_per_call = self.proofs * self.m
        self.label = cfg["transcript_label"].encode()
        self.proved = traffic["proved_batches"]
        self.invalid = layout(seed, traffic["pool_batches"], self.proofs,
                              traffic["invalid"])
        t0 = time.perf_counter()
        prover = BatchProver(BulletproofGens(self.n, self.m), PedersenGens(),
                             self.n, self.m, device=device)
        # per proved batch: wire bytes, value commitments (m each)
        wires, vcs = [], []
        proved = dict(traffic, pool_batches=self.proved)
        for q, (vals, blinds) in enumerate(statements(proved, self.m, seed)):
            sc = [[Scalar(x) for x in bs] for bs in blinds]
            if self.m == 1:
                vals, sc = [v[0] for v in vals], [s[0] for s in sc]
            proofs, vc = prover.prove_batch(
                vals, sc, self._transcripts(q), rng=CallRng(POOL_TAG, seed, q))
            wires.append([p.to_bytes() for p in proofs])
            vcs.append([[v] if self.m == 1 else list(v) for v in vc])
        del prover, proofs
        self._free_device()
        t1 = time.perf_counter()
        # the pool: copies of the proved batches, the invalid proofs put in
        parsed = [[RangeProof.from_bytes(w) for w in ws] for ws in wires]
        self.wires, self.vcs, self.parsed = [], [], []
        for b in range(traffic["pool_batches"]):
            q = b % self.proved
            ws, vs, ps = list(wires[q]), list(vcs[q]), list(parsed[q])
            if b in self.invalid:
                kind, p = self.invalid[b]
                ws[p], vs[p] = invalid_wire(kind, ws[p], vs[p], cfg, traffic,
                                            seed, q * self.proofs + p)
                ps[p] = RangeProof.from_bytes(ws[p])
            self.wires.append(ws)
            self.vcs.append(vs)
            self.parsed.append(ps)
        self.verifier = BatchVerifier(BulletproofGens(self.n, self.m),
                                      PedersenGens(), self.n, self.m,
                                      device=device)
        self._sync()
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        self.verdicts = {}
        self.setup_log = (f"proving {self.proved} batches {t1 - t0:.2f} s, "
                          f"the pool and the verifier "
                          f"{time.perf_counter() - t1:.2f} s")

    def _sync(self):
        if self.device != "cpu":
            self._torch.cuda.synchronize()

    def _free_device(self):
        if self.device != "cpu":
            self._torch.cuda.synchronize()
            self._torch.cuda.empty_cache()

    def _transcripts(self, q: int):
        """Fresh transcripts of proved batch q's statements."""
        ts = []
        for p in range(self.proofs):
            t = self._Transcript(self.label)
            t.append_u64(b"statement", q * self.proofs + p)
            ts.append(t)
        return ts

    def label_of(self, i: int) -> bool:
        """The verdict call i must give."""
        return i % len(self.wires) not in self.invalid

    def shape(self) -> dict:
        return {"n": self.n, "m": self.m, "proofs": self.proofs}

    def install(self, spans) -> None:
        """The spans the per-layer metrics read and the breakdown names."""
        from bulletproofs_tpu_torch.parallel.batch_verify import BatchVerifier
        for attr, name in (("verify_batch", "verify_batch"),
                           ("_serialize", "serialize"), ("_upload", "upload"),
                           ("replay", "replay"), ("_subbatch", "subbatch")):
            spans.wrap(BatchVerifier, attr, name)

    def call(self, i: int, tag: bytes = WEIGHTS_TAG):
        """Verify batch i mod pool on fresh transcripts -> (seconds from the
        call's start to a synchronize after it, what to keep)."""
        b = i % len(self.wires)
        ts = self._transcripts(b % self.proved)
        rng = WeightRng(tag, self.seed, i)
        t0 = time.perf_counter()
        try:
            self.verifier.verify_batch(self.parsed[b], self.vcs[b], ts,
                                       rng=rng)
            ok = True
        except self._ProofError:
            ok = False
        self._sync()
        dt = time.perf_counter() - t0
        if i >= 0:
            self.verdicts[i] = ok
        return dt, (i, ok, ts)

    def warm_up(self, calls: int = 2) -> None:
        for k in range(calls):
            self.call(-1 - k, tag=b"portbench warm-up")

    def pool_record(self, i: int) -> dict:
        """What the comparison reads of call i's batch: its proofs' wire
        bytes and commitments, and the invalid proof's position or None."""
        b = i % len(self.wires)
        return {"call": i, "base": b % self.proved * self.proofs,
                "wires": self.wires[b], "V": self.vcs[b],
                "bad": self.invalid[b][1] if b in self.invalid else None}

    def record(self, kept) -> dict:
        """A kept call's batch and its transcripts' states, as bytes."""
        i, _, ts = kept
        return dict(self.pool_record(i), states=[
            t.strobe.buf.raw[:STATE_BYTES] for t in ts])

    def free(self) -> None:
        del self.verifier, self.parsed
        self._free_device()

    def compare(self, records, workers: int, sampler) -> dict:
        """The comparison of every call's verdict and of the kept calls,
        with the proofs the reference replays drawn from `sampler`."""
        check_verify.draw(records, sampler, self.traffic["check_proofs"])
        verdicts = [(ok, self.label_of(i)) for i, ok in self.verdicts.items()]
        return check_verify.compare(self.cfg, records, verdicts, workers)
