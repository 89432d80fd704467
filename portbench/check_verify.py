"""The comparison that decides `correct` for a verify cell: what the timed
calls produced, a verdict a call and the transcripts the verifier left,
against the plain reference verifier (`reference/verify.py`).

* `verdict_mismatches`: every call of the window, not only those kept:
  the call's verdict against its batch's label (False for the one batch
  that holds the invalid proof);
* `reference_mismatches`: for each call kept from the window, the
  reference's verdict on the invalid proof alone, where the batch holds
  it, and on a sample of the batch's other proofs, drawn from the seed
  and checked as one random 128-bit weighted sum, against the labels;
* `replay_mismatches`: for the same proofs of each kept call, the
  transcript state the program wrote back against the reference's
  replay of the proof on a fresh transcript.

`failed_calls` (calls that raised anything but ProofError) is counted by
the run.  Every number is a count of differences, and every limit is 0:
the arithmetic is exact."""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

from . import check
from .reference import verify as RV

LIMITS = {"verdict_mismatches": 0, "reference_mismatches": 0,
          "replay_mismatches": 0}
CHUNK = 32


def draw(kept: List[dict], sampler, size: int) -> None:
    """Give each kept call (with "wires" and "bad", the invalid proof's
    position or None) the sorted positions of `size` of its valid proofs
    ("sample") and a 32-byte key for its weights ("key")."""
    for rec in kept:
        valid = [p for p in range(len(rec["wires"])) if p != rec["bad"]]
        rec["sample"] = sorted(sampler.sample(valid, min(size, len(valid))))
        rec["key"] = sampler.getrandbits(256).to_bytes(32, "little")


def weights(key: bytes, statement: int) -> Tuple[int, int]:
    """(c, r) of one proof: the weight that joins its two checks and its
    weight in the batch, 128 bits each, from the call's key."""
    raw = hashlib.shake_256(b"portbench verify" + key + statement.to_bytes(
        8, "little")).digest(32)
    return int.from_bytes(raw[:16], "little"), int.from_bytes(raw[16:],
                                                               "little")


def replay_chunk(task: dict) -> dict:
    """The reference over some proofs of one call: each replayed on a fresh
    transcript -> {"states": {proof: state}, "rejected": proofs the crate
    rejects before their equation, "part": their weighted sum}.  Runs in
    a worker process."""
    gens = check._gens(task["n"], task["m"])
    acc = RV.batch(task["n"] * task["m"])
    states, rejected = {}, 0
    for p, (statement, wire, V) in task["proofs"].items():
        t = check.transcript(task["label"], statement,
                             task.get("challenge_len", 64))
        c, r = weights(task["key"], statement)
        tm = RV.terms(gens, wire, V, t, c)
        states[p] = t.state()
        if tm is None:
            rejected += 1
        else:
            RV.add(acc, tm, r)
    return {"states": states, "rejected": rejected, "part": RV.part(acc)}


def keyed_replay_chunk(task: dict):
    return task["key_id"], replay_chunk(task)


def tasks(cfg: dict, kept: List[dict], challenge_len: int = 64) -> List[dict]:
    """The reference's work over the kept calls: chunks of each call's
    valid sample, and the invalid proof alone."""
    n, m = cfg["n"], cfg["m"]
    label = cfg["transcript_label"].encode()
    out = []
    for c, rec in enumerate(kept):
        groups = [("valid", rec["sample"][k: k + CHUNK])
                  for k in range(0, len(rec["sample"]), CHUNK)]
        if rec["bad"] is not None:
            groups.append(("invalid", [rec["bad"]]))
        for kind, ps in groups:
            out.append({"n": n, "m": m, "label": label, "key": rec["key"],
                        "challenge_len": challenge_len, "call": c,
                        "kind": kind, "proofs": {
                            p: (rec["base"] + p, rec["wires"][p], rec["V"][p])
                            for p in ps}})
    return out


def run(cfg: dict, kept: List[dict], workers: int,
        challenge_len: int = 64) -> Tuple[List[dict], List[dict]]:
    """The tasks over the kept calls and their results, in task order."""
    ts = tasks(cfg, kept, challenge_len)
    results = dict(check.run_tasks(keyed_replay_chunk, [
        dict(t, key_id=i) for i, t in enumerate(ts)], workers))
    return ts, [results[i] for i in range(len(ts))]


def verdicts_of(cfg: dict, ts: List[dict], results: List[dict]) -> dict:
    """{(call, kind): whether the reference accepts those proofs}: none
    rejected before its equation, and the weighted sum the identity."""
    gens = check._gens(cfg["n"], cfg["m"])
    groups = {}
    for t, res in zip(ts, results):
        groups.setdefault((t["call"], t["kind"]), []).append(res)
    return {k: (not any(r["rejected"] for r in rs)
                and check.points_match([r["part"] for r in rs], gens))
            for k, rs in groups.items()}


def compare(cfg: dict, kept: List[dict], verdicts: Sequence[Tuple[bool, bool]],
            workers: int) -> dict:
    """kept: [{"base", "wires", "V" (lists of encodings), "bad", "sample",
    "key", "states" (the program's, by proof)}]; verdicts: (the call's
    verdict, its label) for every call of the window -> {"numbers":
    {number: value}, "limits": LIMITS, "checked": proofs}."""
    got = {k: 0 for k in LIMITS}
    got["verdict_mismatches"] = sum(v != want for v, want in verdicts)
    ts, results = run(cfg, kept, workers)
    for (call, kind), accepts in verdicts_of(cfg, ts, results).items():
        got["reference_mismatches"] += accepts != (kind == "valid")
    checked = 0
    for t, res in zip(ts, results):
        states = kept[t["call"]]["states"]
        for p, state in res["states"].items():
            checked += 1
            got["replay_mismatches"] += (p >= len(states)
                                         or states[p] != state)
    return {"numbers": got, "limits": LIMITS, "checked": checked}
