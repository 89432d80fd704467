"""The aggregated range proof of the `bulletproofs` crate (range_proof/
mod.rs, party.rs, dealer.rs, inner_product_proof.rs), in Python integers
over `curve.py` and `merlin.py`, with the program's draw of the blinding
scalars: one 32-byte ChaCha20 key a batch, block k of its keystream
(RFC 8439, nonce 0, counter k) reduced mod l for draw k, in the order
[a_blinding][s_blinding][t1_blinding][t2_blinding] (one a proof each),
then s_L and s_R (N a proof each, component-major).  One blinding of each
kind a proof, where the crate's local dealer sums one a party: the
program's statement of the protocol.

`prove(...)` makes one proof whole.  Given `points`, the program's
commitments and IPP points for that proof, it takes those into the
transcript in place of its own and computes only the scalars: the replay
that checks every proof of a call without its multi-scalar
multiplications.  The replay also returns the proof's secrets, from which
`combination` writes any weighted sum of the proof's points as one
weighted sum of the generators: what the points have to be, checked for
a whole call at once against the program's points (`check.py`).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import numpy as np

from . import curve as C
from .merlin import Transcript

L = C.L

_SIGMA = np.frombuffer(b"expand 32-byte k", dtype="<u4").astype(np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def chacha_blocks(key: bytes, counters: np.ndarray) -> np.ndarray:
    """RFC 8439 ChaCha20 blocks of `key` at nonce 0 and the given block
    counters -> (len(counters), 64) uint8."""
    k = np.frombuffer(key, dtype="<u4").astype(np.uint32)
    n = len(counters)
    init = [np.full(n, w, np.uint32) for w in list(_SIGMA) + list(k)]
    init += [counters.astype(np.uint32)] + [np.zeros(n, np.uint32)] * 3
    x = [v.copy() for v in init]

    def quarter(a, b, c, d):
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 7)

    for _ in range(10):
        quarter(0, 4, 8, 12)
        quarter(1, 5, 9, 13)
        quarter(2, 6, 10, 14)
        quarter(3, 7, 11, 15)
        quarter(0, 5, 10, 15)
        quarter(1, 6, 11, 12)
        quarter(2, 7, 8, 13)
        quarter(3, 4, 9, 14)
    words = np.stack([a + b for a, b in zip(x, init)], axis=1)
    return words.astype("<u4").view(np.uint8).reshape(n, 64)


def draws(key: bytes, count: int, N: int, proofs: Sequence[int]
          ) -> Dict[int, dict]:
    """The blinding scalars of the given proofs of a batch of `count`
    proofs drawn from one key -> {proof: {ab, sb, t1b, t2b, sl, sr}}."""
    proofs = list(proofs)
    p = np.asarray(proofs, np.int64)
    i = np.arange(N, dtype=np.int64)
    ctr = np.concatenate([
        np.stack([p + k * count for k in range(4)], axis=1),
        (4 + i[None, :]) * count + p[:, None],
        (4 + N + i[None, :]) * count + p[:, None]], axis=1)
    blocks = chacha_blocks(key, ctr.reshape(-1)).reshape(len(proofs), -1, 64)
    out = {}
    for row, q in zip(blocks, proofs):
        s = [int.from_bytes(b.tobytes(), "little") % L for b in row]
        out[q] = {"ab": s[0], "sb": s[1], "t1b": s[2], "t2b": s[3],
                  "sl": s[4: 4 + N], "sr": s[4 + N: 4 + 2 * N]}
    return out


class Generators:
    """PedersenGens::default() and BulletproofGens(n, m).G(n, m) / H(n, m):
    B, B~ = hash_from_bytes::<Sha3_512>(B's encoding), and party j's n
    G (H) points from SHAKE256("GeneratorsChain" || "G" (or "H") || j as
    four little-endian bytes), 64 bytes a point."""

    def __init__(self, n: int, m: int):
        self.n, self.m = n, m
        self.B = C.BASEPOINT
        self.B_blinding = C.from_uniform_bytes(
            hashlib.sha3_512(C.encode(C.BASEPOINT)).digest())
        self.G = self._chain(b"G")
        self.H = self._chain(b"H")
        self.G_cached = [C.cached(p) for p in self.G]
        self.H_cached = [C.cached(p) for p in self.H]
        self.B_cached = C.cached(self.B)

    def _chain(self, kind: bytes) -> List[C.Point]:
        pts = []
        for j in range(self.m):
            raw = hashlib.shake_256(b"GeneratorsChain" + kind +
                                    j.to_bytes(4, "little")).digest(64 * self.n)
            pts += [C.from_uniform_bytes(raw[64 * i: 64 * i + 64])
                    for i in range(self.n)]
        return pts


def _sc(x: int) -> bytes:
    return (x % L).to_bytes(32, "little")


def prove(gens: Generators, values: Sequence[int], blindings: Sequence[int],
          blinds: dict, transcript: Transcript, points: dict = None) -> dict:
    """One aggregated proof of `values` (m of them, n bits each) with value
    blindings `blindings`, blinding draws `blinds` (`draws`), on a fresh
    `transcript` -> {"V": [m encodings], "proof": wire bytes, "state":
    the transcript's state after it}.  With `points` ({"V", "A", "S",
    "T_1", "T_2", "L", "R"} as encodings), those are taken in place of
    computing them."""
    n, m = gens.n, gens.m
    N = n * m
    t = transcript
    own = points is None
    pts = {} if own else points

    def enc(scalars, bases, cache=None):
        return C.encode(C.msm(scalars, bases, cache))

    t.append_message(b"dom-sep", b"rangeproof v1")
    t.append_u64(b"n", n)
    t.append_u64(b"m", m)
    if own:
        pts["V"] = [enc([v, g], [gens.B, gens.B_blinding])
                    for v, g in zip(values, blindings)]
    for V in pts["V"]:
        t.append_message(b"V", V)

    bits = [(values[k // n] >> (k % n)) & 1 for k in range(N)]
    ab, sb, t1b, t2b = blinds["ab"], blinds["sb"], blinds["t1b"], blinds["t2b"]
    sl, sr = blinds["sl"], blinds["sr"]
    if own:
        # a_L = bits, a_R = bits - 1: G_k where the bit is set, else -H_k
        A = C.msm([ab], [gens.B_blinding])
        for k in range(N):
            A = (C.add_cached(A, gens.G_cached[k]) if bits[k] else
                 C.add_cached(A, C.neg_cached(gens.H_cached[k])))
        pts["A"] = C.encode(A)
        pts["S"] = enc([sb] + sl + sr, [gens.B_blinding] + gens.G + gens.H,
                       [C.cached(gens.B_blinding)] + gens.G_cached +
                       gens.H_cached)
    t.append_message(b"A", pts["A"])
    t.append_message(b"S", pts["S"])
    y = t.challenge_scalar(b"y", L)
    z = t.challenge_scalar(b"z", L)

    zz = z * z % L
    ypow = [1] * N
    for k in range(1, N):
        ypow[k] = ypow[k - 1] * y % L
    zpow = [zz]
    for j in range(1, m):
        zpow.append(zpow[-1] * z % L)
    l0 = [(bits[k] - z) % L for k in range(N)]
    l1 = sl
    r0 = [(ypow[k] * (bits[k] - 1 + z) + zpow[k // n] * (1 << (k % n))) % L
          for k in range(N)]
    r1 = [ypow[k] * sr[k] % L for k in range(N)]
    t0 = sum(a * b for a, b in zip(l0, r0)) % L
    t2 = sum(a * b for a, b in zip(l1, r1)) % L
    t1 = (sum((a + b) * (c + d) for a, b, c, d in zip(l0, l1, r0, r1))
          - t0 - t2) % L
    if own:
        pts["T_1"] = enc([t1, t1b], [gens.B, gens.B_blinding])
        pts["T_2"] = enc([t2, t2b], [gens.B, gens.B_blinding])
    t.append_message(b"T_1", pts["T_1"])
    t.append_message(b"T_2", pts["T_2"])
    x = t.challenge_scalar(b"x", L)

    t_x = (t0 + t1 * x + t2 * x * x) % L
    t_xb = (sum(zp * g for zp, g in zip(zpow, blindings)) + t1b * x
            + t2b * x * x) % L
    e_b = (ab + sb * x) % L
    t.append_message(b"t_x", _sc(t_x))
    t.append_message(b"t_x_blinding", _sc(t_xb))
    t.append_message(b"e_blinding", _sc(e_b))
    w = t.challenge_scalar(b"w", L)

    # the inner-product argument over G (factors 1) and H (factors y^-k);
    # gf / hf hold each original base's factor in the folded bases, so L
    # and R are multi-scalar multiplications over the original bases
    a = [(p + q * x) % L for p, q in zip(l0, l1)]
    b = [(p + q * x) % L for p, q in zip(r0, r1)]
    yinv = pow(y, L - 2, L)
    gf = [1] * N
    hf = [1] * N
    for k in range(1, N):
        hf[k] = hf[k - 1] * yinv % L
    t.append_message(b"dom-sep", b"ipp v1")
    t.append_u64(b"n", N)
    Ls, Rs, rounds = [], [], []
    nk, rnd = N, 0
    while nk > 1:
        h = nk // 2
        c_l = sum(p * q for p, q in zip(a[:h], b[h:])) % L
        c_r = sum(p * q for p, q in zip(a[h:], b[:h])) % L
        if own:
            sl_, bl_, cl_ = [], [], []
            sr_, br_, cr_ = [], [], []
            for k in range(N):
                i = k % nk
                if i >= h:
                    sl_.append(a[i - h] * gf[k])
                    bl_.append(gens.G[k])
                    cl_.append(gens.G_cached[k])
                    sr_.append(b[i - h] * hf[k])
                    br_.append(gens.H[k])
                    cr_.append(gens.H_cached[k])
                else:
                    sl_.append(b[i + h] * hf[k])
                    bl_.append(gens.H[k])
                    cl_.append(gens.H_cached[k])
                    sr_.append(a[i + h] * gf[k])
                    br_.append(gens.G[k])
                    cr_.append(gens.G_cached[k])
            Ls.append(enc(sl_ + [c_l * w], bl_ + [gens.B],
                          cl_ + [gens.B_cached]))
            Rs.append(enc(sr_ + [c_r * w], br_ + [gens.B],
                          cr_ + [gens.B_cached]))
        else:
            Ls.append(pts["L"][rnd])
            Rs.append(pts["R"][rnd])
        t.append_message(b"L", Ls[-1])
        t.append_message(b"R", Rs[-1])
        u = t.challenge_scalar(b"u", L)
        uinv = pow(u, L - 2, L)
        if not own:
            rounds.append((a, b, u, uinv, c_l, c_r))
        a = [(a[i] * u + uinv * a[i + h]) % L for i in range(h)]
        b = [(b[i] * uinv + u * b[i + h]) % L for i in range(h)]
        if own:
            for k in range(N):
                if k % nk >= h:
                    gf[k] = gf[k] * u % L
                    hf[k] = hf[k] * uinv % L
                else:
                    gf[k] = gf[k] * uinv % L
                    hf[k] = hf[k] * u % L
        nk, rnd = h, rnd + 1

    wire = b"".join([pts["A"], pts["S"], pts["T_1"], pts["T_2"], _sc(t_x),
                     _sc(t_xb), _sc(e_b)]
                    + [q for pair in zip(Ls, Rs) for q in pair]
                    + [_sc(a[0]), _sc(b[0])])
    out = {"V": list(pts["V"]), "proof": wire, "state": t.state()}
    if not own:
        out["secrets"] = {"values": list(values), "blindings": list(blindings),
                          "bits": bits, "sl": sl, "sr": sr, "ab": ab, "sb": sb,
                          "t1": t1, "t1b": t1b, "t2": t2, "t2b": t2b,
                          "yinv": yinv, "w": w, "rounds": rounds}
    return out


def combination(sec: dict, r: dict, acc: dict) -> None:
    """Add to `acc` ({"G": [N], "H": [N], "B", "B_blinding"}) the
    generators' coefficients of sum_P r[P] P over one proof's points, as
    the secrets `sec` (a replay's) make them:

        V_j = v_j B + g_j B~,  T_k = t_k B + t_k~ B~,
        A = ab B~ + sum a_L G + a_R H,  S = sb B~ + sum s_L G + s_R H,
        L = <a_lo, G_hi> + <b_hi, H'_lo> + c_L w B,
        R = <a_hi, G_lo> + <b_lo, H'_hi> + c_R w B

    over each round's folded G and H' = y^-k H.  A round's coefficients
    are unfolded to the round before it (G' = u^-1 G_lo + u G_hi,
    H' = u H_lo + u^-1 H_hi), so the IPP costs two passes over N, not one
    a round.  r: {"V": [m], "A", "S", "T_1", "T_2", "L": [rounds],
    "R": [rounds]}."""
    cB = (sum(rv * v for rv, v in zip(r["V"], sec["values"]))
          + r["T_1"] * sec["t1"] + r["T_2"] * sec["t2"])
    cBb = (sum(rv * g for rv, g in zip(r["V"], sec["blindings"]))
           + r["A"] * sec["ab"] + r["S"] * sec["sb"]
           + r["T_1"] * sec["t1b"] + r["T_2"] * sec["t2b"])
    wg, wh = [0], [0]
    for k in range(len(sec["rounds"]) - 1, -1, -1):
        a, b, u, uinv, c_l, c_r = sec["rounds"][k]
        rl, rr = r["L"][k], r["R"][k]
        h = len(a) // 2
        cB += sec["w"] * (rl * c_l + rr * c_r)
        wg = ([(rr * a[i + h] + wg[i] * uinv) % L for i in range(h)]
              + [(rl * a[i] + wg[i] * u) % L for i in range(h)])
        wh = ([(rl * b[i + h] + wh[i] * u) % L for i in range(h)]
              + [(rr * b[i] + wh[i] * uinv) % L for i in range(h)])
    ra, rs, yinv = r["A"], r["S"], sec["yinv"]
    G, H = acc["G"], acc["H"]
    yk = 1
    for k, (bit, sl, sr) in enumerate(zip(sec["bits"], sec["sl"], sec["sr"])):
        G[k] = (G[k] + ra * bit + rs * sl + wg[k]) % L
        H[k] = (H[k] + ra * (bit - 1) + rs * sr + wh[k] * yk) % L
        yk = yk * yinv % L
    acc["B"] = (acc["B"] + cB) % L
    acc["B_blinding"] = (acc["B_blinding"] + cBb) % L
