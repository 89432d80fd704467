"""The comparison that decides `correct` for a prove cell: what the timed
calls produced, against the plain reference (`reference/rangeproof.py`).

For each call kept from the window:

* every proof is replayed: the reference runs the protocol with the
  proof's own commitments and IPP points taken into a fresh transcript,
  and works out every scalar (t_x, t_x_blinding, e_blinding, the final
  a and b) from the statement and the blinding draws; the proof's wire
  bytes and its transcript's state after the call must equal the
  replay's (`replay_mismatches`);
* every point of every proof (the value commitments, A, S, T_1, T_2 and
  each round's L and R) must be the one the reference makes: the replay
  knows each point's secrets, so a random weighted sum of all of a
  call's points, the weights drawn from the call's key, must equal the
  one weighted sum of the generators that the secrets give
  (`reference.rangeproof.combination`).  A wrong point survives this
  with odds of 2^-128 (`point_mismatches`, calls);
* two proofs, one from each half of the batch, are made whole by the
  reference, its own multi-scalar multiplications included: wire bytes,
  value commitments and transcript state must be equal
  (`exact_mismatches`);
* the call must return one proof and m commitments a statement
  (`missing_proofs`).

Every number is a count of differences, and every limit is 0: the
arithmetic is exact."""

from __future__ import annotations

import hashlib
import multiprocessing
from typing import List, Sequence

from .reference import curve as C
from .reference import rangeproof as R
from .reference.merlin import Transcript

LIMITS = {"missing_proofs": 0, "replay_mismatches": 0, "point_mismatches": 0,
          "exact_mismatches": 0}
WEIGHT_BITS = 128

_GENS = {}


def _gens(n: int, m: int) -> R.Generators:
    if (n, m) not in _GENS:
        _GENS[(n, m)] = R.Generators(n, m)
    return _GENS[(n, m)]


def parse(wire: bytes, V: Sequence[bytes], rounds: int) -> dict:
    """The points of a proof in the crate's wire format."""
    at = 7 * 32
    lr = [wire[at + 32 * k: at + 32 * k + 32] for k in range(2 * rounds)]
    return {"V": list(V), "A": wire[0:32], "S": wire[32:64],
            "T_1": wire[64:96], "T_2": wire[96:128], "L": lr[0::2],
            "R": lr[1::2]}


def transcript(label: bytes, statement: int, challenge_len: int = 64):
    """The fresh transcript the traffic gives a statement."""
    t = Transcript(label, challenge_len)
    t.append_u64(b"statement", statement)
    return t


def weights(key: bytes, statement: int, m: int, rounds: int) -> dict:
    """The weights of one proof's points in its call's sum, drawn from the
    call's key and the statement's index."""
    k = m + 4 + 2 * rounds
    raw = hashlib.shake_256(b"portbench weights" + key + statement.to_bytes(
        8, "little")).digest(k * WEIGHT_BITS // 8)
    w = [int.from_bytes(raw[16 * i: 16 * i + 16], "little") for i in range(k)]
    return {"V": w[:m], "A": w[m], "S": w[m + 1], "T_1": w[m + 2],
            "T_2": w[m + 3], "L": w[m + 4::2], "R": w[m + 5::2]}


def reference_proofs(task: dict) -> dict:
    """The reference's outputs for the proofs `task["proofs"]` of one call:
    replayed on the given points (`task["points"]`, by proof) or made
    whole -> {"proofs": {proof: outputs}, "sum": None or, for a replay,
    the program's points' weighted sum (`sum`, `undecodable`) and the
    generators' coefficients that the secrets give}.  Runs in a worker
    process."""
    n, m, count = task["n"], task["m"], task["count"]
    gens = _gens(n, m)
    blinds = R.draws(task["key"], count, n * m, task["proofs"])
    out, acc, scalars, points = {}, None, [], []
    if task.get("points"):
        acc = {"G": [0] * (n * m), "H": [0] * (n * m), "B": 0,
               "B_blinding": 0, "undecodable": 0}
    for p in task["proofs"]:
        t = transcript(task["label"], task["base"] + p,
                       task.get("challenge_len", 64))
        pts = task["points"].get(p) if acc else None
        res = R.prove(gens, task["values"][p], task["blindings"][p],
                      blinds[p], t, points=pts)
        if acc:
            r = weights(task["key"], task["base"] + p, m, len(pts["L"]))
            R.combination(res.pop("secrets"), r, acc)
            for wt, enc in ([(r[k], pts[k]) for k in ("A", "S", "T_1", "T_2")]
                            + list(zip(r["V"], pts["V"]))
                            + list(zip(r["L"], pts["L"]))
                            + list(zip(r["R"], pts["R"]))):
                pt = C.decode(enc)
                if pt is None:
                    acc["undecodable"] += 1
                else:
                    scalars.append(wt)
                    points.append(pt)
        out[p] = res
    if acc:
        acc["sum"] = C.msm(scalars, points) if points else C.IDENTITY
    return {"proofs": out, "sum": acc}


def run_tasks(fn, tasks: List[dict], workers: int) -> List:
    """fn over the tasks, in `workers` spawned processes (here if 1)."""
    if workers <= 1:
        return [fn(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(workers)
    try:
        return list(pool.imap_unordered(fn, tasks))
    finally:
        pool.close()
        pool.join()


def sample(rng, count: int) -> List[int]:
    """One proof from each half of a batch of `count` (two or more)."""
    h = count // 2
    return [rng.randrange(h), h + rng.randrange(count - h)]


def compare(cfg: dict, kept: List[dict], workers: int, chunk: int = 32,
            replay: bool = True) -> dict:
    """kept: [{"base", "key", "values", "blindings", "proofs" (wire bytes
    by proof), "V" (lists of encodings), "states", "exact" (proof
    indices)}] -> {"numbers": {number: value}, "limits": LIMITS,
    "checked": proofs}.
    `replay=False` compares the exact proofs alone (the control)."""
    n, m = cfg["n"], cfg["m"]
    rounds = (n * m).bit_length() - 1
    label = cfg["transcript_label"].encode()
    got = {k: 0 for k in LIMITS}
    tasks, replays, checked = [], [], 0
    for c, call in enumerate(kept):
        count = len(call["values"])
        common = {"n": n, "m": m, "count": count, "key": call["key"],
                  "base": call["base"], "label": label,
                  "values": call["values"], "blindings": call["blindings"]}
        for p in call["exact"]:
            tasks.append(dict(common, call=c, exact=True, proofs=[p]))
        if not replay:
            continue
        missing = count - min(len(call["proofs"]), len(call["V"]))
        missing += sum(1 for v in call["V"] if len(v) != m)
        got["missing_proofs"] += max(0, missing)
        have = range(min(count, len(call["proofs"]), len(call["V"])))
        for lo in range(0, len(have), chunk):
            ps = list(have[lo: lo + chunk])
            replays.append(dict(common, call=c, exact=False, proofs=ps, points={
                p: parse(call["proofs"][p], call["V"][p], rounds)
                for p in ps}))
    # the whole proofs take longest: first to the workers
    tasks += replays
    results = dict(run_tasks(keyed_reference_proofs, [
        dict(t, key_id=i) for i, t in enumerate(tasks)], workers))
    sums = {}
    for i, task in enumerate(tasks):
        res, call = results[i], kept[task["call"]]
        if res["sum"] is not None:
            sums.setdefault(task["call"], []).append(res["sum"])
        for p, ref in res["proofs"].items():
            checked += 1
            if p >= len(call["proofs"]) or call["proofs"][p] is None:
                continue
            same = (ref["proof"] == call["proofs"][p]
                    and ref["state"] == call["states"][p])
            if task["exact"]:
                same = same and ref["V"] == list(call["V"][p])
                got["exact_mismatches"] += not same
            else:
                got["replay_mismatches"] += not same
    for parts in sums.values():
        got["point_mismatches"] += not points_match(parts, _gens(n, m))
    return {"numbers": got, "limits": LIMITS, "checked": checked}


def points_match(parts: List[dict], gens: R.Generators) -> bool:
    """Whether a call's points are the reference's: the program's points'
    weighted sum (added over the call's chunks) less the generators'
    weighted sum that the secrets give is the identity."""
    if any(q["undecodable"] for q in parts):
        return False
    total = C.IDENTITY
    coef = [0] * (2 * gens.n * gens.m + 2)
    for q in parts:
        total = C.add(total, q["sum"])
        for k, c in enumerate(q["G"] + q["H"] + [q["B"], q["B_blinding"]]):
            coef[k] += c
    want = C.msm(coef, gens.G + gens.H + [gens.B, gens.B_blinding],
                 gens.G_cached + gens.H_cached
                 + [gens.B_cached, C.cached(gens.B_blinding)])
    return C.encode(C.add(total, C.neg(want))) == bytes(32)


def keyed_reference_proofs(task: dict):
    return task["key_id"], reference_proofs(task)
