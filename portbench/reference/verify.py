"""The range proof's verification, as the `bulletproofs` crate makes it
(range_proof/mod.rs verify_multiple_with_rng, inner_product_proof.rs
verification_scalars, transcript.rs), in Python integers over `curve.py`
and `merlin.py`.

`terms` replays one proof's wire bytes and its m value commitments on the
proof's transcript, which it leaves advanced as the crate's verifier
does, and returns the terms of the proof's verification equation

    A + x S + c x T_1 + c x^2 T_2 + sum_k (u_k^2 L_k + u_k^-2 R_k)
      - (e_blinding + c t_x_blinding) B~ + (w (t_x - a b) + c (delta - t_x)) B
      + sum_i (g_i G_i + h_i H_i) + sum_j c z^(j+2) V_j  =  identity

with c the random weight the crate draws to join its two checks, or None
where the crate rejects the proof before the equation: a wrong length, a
non-canonical scalar, or the identity where a point is validated.  `add`
puts a proof's terms, times a random weight r, into a batch: its dynamic
points' weighted sum and the static generators' coefficients.  A batch
accepts when the two together are the identity (`check.points_match`,
which holds a weighted sum of points to one of the generators, so the
batch keeps the static coefficients negated).  A proof that fails its
equation survives 128-bit weights with odds of about 2^-125."""

from __future__ import annotations

from typing import Optional, Sequence

from . import curve as C
from .merlin import Transcript
from .rangeproof import L, Generators

IDENTITY_BYTES = bytes(32)


def _canonical(b: bytes) -> Optional[int]:
    s = int.from_bytes(b, "little")
    return s if s < L else None


def parse(wire: bytes, n: int, m: int) -> Optional[dict]:
    """A proof's fields from the crate's wire format, or None where
    RangeProof::from_bytes rejects it or its rounds are not lg(nm)."""
    lg = (n * m).bit_length() - 1
    if len(wire) != 32 * (9 + 2 * lg):
        return None
    at = [128, 160, 192, len(wire) - 64, len(wire) - 32]
    t_x, t_xb, e_b, a, b = (_canonical(wire[k: k + 32]) for k in at)
    if None in (t_x, t_xb, e_b, a, b):
        return None
    lr = [wire[224 + 32 * k: 256 + 32 * k] for k in range(2 * lg)]
    return {"A": wire[0:32], "S": wire[32:64], "T_1": wire[64:96],
            "T_2": wire[96:128], "t_x": t_x, "t_xb": t_xb, "e_b": e_b,
            "scalar_bytes": [wire[k: k + 32] for k in at[:3]],
            "L": lr[0::2], "R": lr[1::2], "a": a, "b": b}


def _validated(t: Transcript, label: bytes, point: bytes) -> bool:
    if point == IDENTITY_BYTES:
        return False
    t.append_message(label, point)
    return True


def terms(gens: Generators, wire: bytes, V: Sequence[bytes],
          t: Transcript, c: int) -> Optional[dict]:
    """One proof's verification terms (module docstring) -> {"dyn":
    [(scalar, encoding)], "G": [N], "H": [N], "B", "B_blinding"}, or None;
    `t` is left as the crate's verifier leaves it."""
    n, m = gens.n, gens.m
    N = n * m
    p = parse(wire, n, m)
    if p is None or len(V) != m:
        return None
    t.append_message(b"dom-sep", b"rangeproof v1")
    t.append_u64(b"n", n)
    t.append_u64(b"m", m)
    for v in V:
        t.append_message(b"V", v)
    if not (_validated(t, b"A", p["A"]) and _validated(t, b"S", p["S"])):
        return None
    y = t.challenge_scalar(b"y", L)
    z = t.challenge_scalar(b"z", L)
    if not (_validated(t, b"T_1", p["T_1"])
            and _validated(t, b"T_2", p["T_2"])):
        return None
    x = t.challenge_scalar(b"x", L)
    for label, raw in zip((b"t_x", b"t_x_blinding", b"e_blinding"),
                          p["scalar_bytes"]):
        t.append_message(label, raw)
    w = t.challenge_scalar(b"w", L)

    # inner_product_proof.rs verification_scalars
    t.append_message(b"dom-sep", b"ipp v1")
    t.append_u64(b"n", N)
    u = []
    for Lk, Rk in zip(p["L"], p["R"]):
        if not (_validated(t, b"L", Lk) and _validated(t, b"R", Rk)):
            return None
        u.append(t.challenge_scalar(b"u", L))
    lg = len(u)
    uinv = [pow(k, L - 2, L) for k in u]
    usq = [k * k % L for k in u]
    uinvsq = [k * k % L for k in uinv]
    s = [1] * N
    for k in uinv:
        s[0] = s[0] * k % L
    for i in range(1, N):
        lg_i = i.bit_length() - 1
        s[i] = s[i - (1 << lg_i)] * usq[lg - 1 - lg_i] % L

    a, b = p["a"], p["b"]
    zz = z * z % L
    zp = [1] * m
    for j in range(1, m):
        zp[j] = zp[j - 1] * z % L
    yinv = pow(y, L - 2, L)
    g, h = [0] * N, [0] * N
    sum_y, yk, yik = 0, 1, 1
    for i in range(N):
        sum_y += yk
        yk = yk * y % L
        g[i] = (-z - a * s[i]) % L
        h[i] = (z + yik * (zz * zp[i // n] * (1 << (i % n))
                           - b * s[N - 1 - i])) % L
        yik = yik * yinv % L
    delta = ((z - zz) * sum_y - zz * z * ((1 << n) - 1) * sum(zp)) % L
    dyn = ([(1, p["A"]), (x, p["S"]), (c * x, p["T_1"]),
            (c * x * x, p["T_2"])]
           + list(zip(usq, p["L"])) + list(zip(uinvsq, p["R"]))
           + [(c * zz * zp[j], v) for j, v in enumerate(V)])
    return {"dyn": dyn, "G": g, "H": h,
            "B": w * (p["t_x"] - a * b) + c * (delta - p["t_x"]),
            "B_blinding": -p["e_b"] - c * p["t_xb"]}


def batch(N: int) -> dict:
    """An empty batch over N G and N H generators."""
    return {"G": [0] * N, "H": [0] * N, "B": 0, "B_blinding": 0,
            "scalars": [], "points": [], "undecodable": 0}


def add(acc: dict, tm: dict, r: int) -> None:
    """Add r times a proof's terms to the batch `acc`: its dynamic points
    decoded (an encoding that decodes to no point is counted, and the
    batch then rejects), the static coefficients negated."""
    for sc, enc in tm["dyn"]:
        pt = C.decode(enc)
        if pt is None:
            acc["undecodable"] += 1
        else:
            acc["scalars"].append(r * sc % L)
            acc["points"].append(pt)
    for key in ("G", "H"):
        col = acc[key]
        for i, v in enumerate(tm[key]):
            col[i] = (col[i] - r * v) % L
    for key in ("B", "B_blinding"):
        acc[key] = (acc[key] - r * tm[key]) % L


def part(acc: dict) -> dict:
    """A batch reduced to what `check.points_match` reads: the dynamic
    points' weighted sum, the undecodable count, the static
    coefficients."""
    out = {k: acc[k] for k in ("G", "H", "B", "B_blinding", "undecodable")}
    out["sum"] = (C.msm(acc["scalars"], acc["points"]) if acc["points"]
                  else C.IDENTITY)
    return out
