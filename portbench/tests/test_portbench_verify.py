"""The verify cell's comparison, on a tiny verify cell through the port's
CPU route (n = 8, m = 1, four proofs a call, one proved batch and five
pool batches, four of them with one invalid proof of each kind, one in
each quarter): a sound run is correct, with every call's verdict
matching its label; each invalid kind fails the check the cell's
traffic says it fails, and only that one; each fault a verifier can
have, planted under the timed path, makes a run not correct; and the
control (the reference with 32-byte challenges in the program's place)
fails the comparison.

A verify call of the CPU route takes about a second a sub-batch whatever
its size (the plain Horner step of the MSM), and proving the pool
several: the runs share one system, set up once, each with a verifier
and verdicts of its own.  Seed 58 puts the out-of-range proof in batch 0,
in the batch's last quarter, and leaves batch 1 valid, so the first call
of a window rejects and the second accepts."""

import copy
import json
import os

import pytest
from conftest import TINY_CFG, tiny_bench

from portbench import run as RUN
from portbench.systems import verify_batch as VB

KINDS = ["t_x", "range", "a", "e_blinding"]
TINY_VERIFY = {"system": "verify_batch", "outputs_per_call": 4,
               "pool_batches": 5, "proved_batches": 1, "invalid": KINDS,
               "value_bits": 8, "check_proofs": 4}
SEED = 58


@pytest.fixture(scope="module")
def built():
    """The tiny verify system, its pool proved on the CPU route, and the
    seconds of one of its calls here."""
    system = VB.System(dict(TINY_CFG, m=1), TINY_VERIFY, SEED, "cpu")
    assert system.invalid[0] == ("range", 3) and 1 not in system.invalid
    call_s, _ = system.call(-1)
    return system, call_s


@pytest.fixture
def tiny_verify(tmp_path, monkeypatch, built):
    """A root holding the tiny m = 1 configuration and the tiny verify
    traffic, made the harness's root, whose runs take a copy of `built`
    -> (the benchmark dict of its cell, the seconds of a call)."""
    from bulletproofs_tpu_torch import (BatchVerifier, BulletproofGens,
                                        PedersenGens)
    for sub, body in (("configs", dict(TINY_CFG, m=1)),
                      ("traffic", TINY_VERIFY)):
        os.makedirs(tmp_path / "portbench" / sub)
        with open(tmp_path / "portbench" / sub / "tiny.json", "w") as fh:
            json.dump(body, fh)
    monkeypatch.setattr(RUN, "ROOT", str(tmp_path))

    def system(cfg, traffic, seed, device):
        assert (cfg["m"], traffic, seed, device) == (1, TINY_VERIFY, SEED,
                                                    "cpu")
        s = copy.copy(built[0])
        s.verdicts = {}
        s.verifier = BatchVerifier(BulletproofGens(s.n, s.m), PedersenGens(),
                                   s.n, s.m, device="cpu")
        s.warm_up = lambda calls=2: None    # nothing to warm on the CPU
        return s
    monkeypatch.setattr(VB, "System", system)
    bench = tiny_bench(cells=(("tiny.verify", "tiny", "tiny"),),
                       like="rp64x1.verify")
    return bench, built[1]


def run_tiny_verify(tiny, calls=2):
    """A run of the tiny cell whose window holds one call (batch 0, which
    rejects), or two calls or more (batch 1 accepts)."""
    bench, call_s = tiny
    return RUN.run_cell("tiny.verify", SEED, 0 if calls == 1 else 2 * call_s,
                        False, device="cpu", workers=1, bench=bench,
                        log=lambda *a, **k: None)


def test_sound_run_is_correct(tiny_verify):
    res = run_tiny_verify(tiny_verify)
    assert res["correct"], res["check"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert res["check"]["verdict_mismatches"]["value"] == 0
    assert set(res["check"]) == {"verdict_mismatches", "reference_mismatches",
                                 "replay_mismatches", "failed_calls"}
    assert set(res["metrics"]) == {"verify_outputs_per_s",
                                   "verify_call_p90_ms", "setup_s"}


def test_the_pool_covers_every_quarter_and_kind():
    """Each kind in a batch of its own and a quarter of its own, drawn from
    the seed; the edits re-encode canonically."""
    for seed in (5, 2 ** 31 + 17):
        lay = VB.layout(seed, 8, 8192, KINDS)
        assert lay == VB.layout(seed, 8, 8192, KINDS)
        assert sorted(k for k, _ in lay.values()) == sorted(KINDS)
        assert sorted(p // 2048 for _, p in lay.values()) == [0, 1, 2, 3]
    assert len({tuple(sorted(VB.layout(s, 8, 8192, KINDS)))
                for s in range(40)}) > 20
    wire = bytes(range(32)) * 4 + (VB.L - 1).to_bytes(32, "little") + bytes(64)
    bumped = VB.bump(wire, VB.SCALAR_AT["t_x"])
    assert bumped[128:160] == bytes(32) and bumped[:128] + bumped[160:] \
        == wire[:128] + wire[160:]


def _sum_is_identity(gens, wire, V, statement, weights):
    """Whether sum_k r_k (the proof's terms at c = c_k) is the identity,
    each on a fresh transcript: (c, r) = (0, 1) is the inner-product check
    alone, (1, 1) and (0, -1) together the t-polynomial check alone."""
    from portbench import check
    from portbench.reference import verify as RV
    acc = RV.batch(gens.n * gens.m)
    for c, r in weights:
        t = check.transcript(TINY_CFG["transcript_label"].encode(), statement)
        RV.add(acc, RV.terms(gens, wire, V, t, c), r % VB.L)
    return check.points_match([RV.part(acc)], gens)


@pytest.mark.parametrize("kind,t_holds,ipp_holds", [
    ("t_x", False, False), ("range", False, True), ("a", True, False),
    ("e_blinding", True, False)])
def test_each_invalid_kind_fails_its_own_check(built, kind, t_holds,
                                               ipp_holds):
    """By the plain reference: the pool's invalid proof of each kind fails
    the check its kind names and only that one; its valid source passes
    both."""
    from portbench import check
    system = built[0]
    gens = check._gens(system.n, system.m)
    b = next(b for b, (k, _) in system.invalid.items() if k == kind)
    p = system.invalid[b][1]
    rec = system.pool_record(b)
    source = system.pool_record(next(i for i in range(5)
                                     if system.label_of(i)))
    for r, want in ((rec, (t_holds, ipp_holds)), (source, (True, True))):
        args = (gens, r["wires"][p], r["V"][p], r["base"] + p)
        assert (_sum_is_identity(*args, [(1, 1), (0, -1)]),
                _sum_is_identity(*args, [(0, 1)])) == want


def test_every_invalid_batch_rejects_on_the_cpu_route(built):
    """The port rejects each invalid batch of the pool (calls 2-4; the sound
    run's window holds calls 0 and 1)."""
    system = built[0]
    for i in (2, 3, 4):
        assert not system.label_of(i)
        assert system.call(i)[1][1] is False, system.invalid[i]
    system.verdicts.clear()


def _verify_batch(monkeypatch, fault):
    """Put fault(real, self, proofs, vcs, transcripts, rng) in the place of
    BatchVerifier.verify_batch."""
    from bulletproofs_tpu_torch.parallel.batch_verify import BatchVerifier
    real = BatchVerifier.verify_batch

    def planted(self, proofs, vcs, transcripts, rng=None):
        return fault(real, self, proofs, vcs, transcripts, rng)
    monkeypatch.setattr(BatchVerifier, "verify_batch", planted)


def _accepts_every_call(real, self, proofs, vcs, ts, rng):
    from bulletproofs_tpu_torch import ProofError
    try:
        real(self, proofs, vcs, ts, rng)
    except ProofError:
        pass


def _rejects_every_call(real, self, proofs, vcs, ts, rng):
    from bulletproofs_tpu_torch import ProofError
    real(self, proofs, vcs, ts, rng)
    raise ProofError.verification()


def _state_unchanged(real, self, proofs, vcs, ts, rng):
    snaps = [t.strobe.buf.raw for t in ts]
    try:
        real(self, proofs, vcs, ts, rng)
    finally:
        for t, s in zip(ts, snaps):
            t.strobe.buf.raw = s


def _other_label(real, self, proofs, vcs, ts, rng):
    from bulletproofs_tpu_torch import Transcript
    for t in ts:
        t.strobe.buf.raw = Transcript(b"another label").strobe.buf.raw
    real(self, proofs, vcs, ts, rng)


def _half_batch(real, self, proofs, vcs, ts, rng):
    h = max(1, len(proofs) // 2)
    real(self, proofs[:h], vcs[:h], ts[:h], rng)


def _raises(real, self, proofs, vcs, ts, rng):
    raise RuntimeError("planted")


class _NoC:
    """The weights rng with every proof's c (the first 64 of its 128 bytes)
    zero: the c-weighted terms, the whole t-polynomial check (V, T_1, T_2,
    t_x, delta), drop out."""

    def __init__(self, rng):
        self.rng = rng

    def randbytes(self, n):
        raw = bytearray(self.rng.randbytes(n))
        for k in range(0, n, 128):
            raw[k: k + 64] = bytes(64)
        return bytes(raw)


def _no_t_check(real, self, proofs, vcs, ts, rng):
    real(self, proofs, vcs, ts, _NoC(rng))


def _last_subbatch_flag_ignored(real, self, proofs, vcs, ts, rng):
    """Every sub-batch verified in full, the flag of the last of the two
    (the call's last two proofs) read as accepting."""
    import torch
    from bulletproofs_tpu_torch.config import settings
    from bulletproofs_tpu_torch.parallel.batch_verify import BatchVerifier
    sub, chunk, seen = BatchVerifier._subbatch, settings.fused_verify_chunk, []

    def planted(self, *a):
        flag = sub(self, *a)
        seen.append(flag)
        return torch.ones_like(flag) if len(seen) == 2 else flag
    BatchVerifier._subbatch, settings.fused_verify_chunk = planted, 2
    try:
        real(self, proofs, vcs, ts, rng)
    finally:
        BatchVerifier._subbatch, settings.fused_verify_chunk = sub, chunk


@pytest.mark.parametrize("fault,numbers,calls", [
    (_accepts_every_call, ["verdict_mismatches"], 1),
    (_rejects_every_call, ["verdict_mismatches"], 2),
    (_state_unchanged, ["replay_mismatches"], 1),
    (_other_label, ["replay_mismatches", "verdict_mismatches"], 2),
    (_half_batch, ["replay_mismatches"], 1),
    (_raises, ["failed_calls"], 1),
    (_no_t_check, ["verdict_mismatches"], 1),
    (_last_subbatch_flag_ignored, ["verdict_mismatches"], 1),
])
def test_fault_makes_the_run_not_correct(tiny_verify, monkeypatch, fault,
                                         numbers, calls):
    _verify_batch(monkeypatch, fault)
    res = run_tiny_verify(tiny_verify, calls)
    assert not res["correct"]
    for k in numbers:
        assert res["check"][k]["value"] > res["check"][k]["limit"], k


def test_control_fails_the_comparison(built):
    """The control: the reference with 32-byte challenges put in the
    program's place reads a mismatch on every transcript it replays and
    a wrong verdict on the valid call."""
    from portbench import control_verify
    got = control_verify.control_reading(built[0], SEED, workers=1)
    assert got["numbers"]["replay_mismatches"] == got["checked"] > 0
    assert got["numbers"]["verdict_mismatches"] == 1
    assert got["numbers"]["reference_mismatches"] == 0
