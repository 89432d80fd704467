"""The batch range prover's device stages: every point and every mod-l
vector of the proofs, in PyTorch on the prover's device (the JAX
package's ops/prover_stages.py, names kept).

Two routes share the stages.  On the per-stage route Fiat-Shamir stays on
the host (native/prove_prep.cpp rp_ts_*, one batched C++ call between two
stages); a "fused" function there covers one whole phase between two
challenges and returns the bytes that the next host call absorbs.  On the
device-transcript route (the section at the end) the host draws only y
and z; the transcripts, every later challenge and the IPP rounds stay on
the device.  Points go through the fixed-base MSM (ops/fixed_msm.py,
kernels K6 and K7) and compression (ops/curve.compress, kernel K5).  The
witness rows (V, A, S, T_1 / T_2) take K6's one-hot form (the default
`consttime=True`); the IPP rounds' L / R rows are public and alone pass
`consttime=False`, K6's direct form (the JAX package's host route sends
them to the vartime `rist_msm_rows`).  The
mod-l vector math runs on canonical scalars: every digit stream through
kernel K10 and the IPP fold through K8 / K9 (ops/fold.py, where the JAX
package calls ops/fold_pallas.py), the rest through ops/scalar.py and
ops/chacha.py, one launch of K17-K20 a call on a card (where the JAX
package's vector code is XLA).

Protocol math mirrors the reference party / dealer / IPP prover
(src/range_proof/party.rs:182-237, dealer.rs:226-293,
src/inner_product_proof.rs:38-185): the IPP state is the folded (a, b) and
the weights gw / hw of the ORIGINAL generators, so each round's L and R
are fixed-base MSMs over those generators.

Shapes: P proofs on the last axis; per-proof scalars (9, P); length-N
vectors (N, 9, P) (vector index first, then limbs, then proofs: the
port's limb axis is -2); digit streams (rows, Q) int8 with row
s = j * 64 + w over the table's bases j.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import tracing
from ..core.scalar import L as ELL
from . import chacha
from . import curve as C
from . import fixed_msm as FM
from . import fold as FO
from . import scalar as S
from .limbs import SC_LIMBS, sc_ints_to_limbs, sc_to_bytes
from .transcript_device import DeviceStrobe

L = SC_LIMBS


def _coef_digits(coef: torch.Tensor) -> torch.Tensor:
    """(nb, 9, Q) canonical coefficients -> (nb * 64, Q) int8 signed digit
    stream, row j * 64 + w (fixed_msm's table order), by kernel K10."""
    return FO.digits_lanes(coef.contiguous())


def v_digits(v_sc: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """Value commitments V = v B + vb B~: v_sc, vb (9, Q) -> digit stream
    (128, Q) over [B, B~]."""
    return _coef_digits(torch.stack([v_sc, vb]))


def a_stream_sel(N: int):
    """Stream rows (into the [B, B~, G..(N), H..(N)] table, s = j * 64 + w)
    of the compact A commitment: [B~ all 64 windows, G_i window 0, H_i
    window 0].  A = ab B~ + sum aL_i G_i + sum aR_i H_i with aL in {0, 1},
    aR in {0, -1} (reference party.rs:102-112)."""
    rows = [1 * 64 + w for w in range(64)]
    rows += [(2 + i) * 64 for i in range(N)]
    rows += [(2 + N + i) * 64 for i in range(N)]
    return rows


def a_digits(N: int, bits: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """Digit stream (64 + 2N, P) over a_stream_sel's rows: ab's 64 windows,
    aL_i = bit_i, then aR_i = bit_i - 1."""
    aL = (bits != 0).to(torch.int8)
    return torch.cat([FO.digits_lanes(ab.contiguous()), aL, aL - 1])


def s_base_sel(N: int):
    """Bases of the S commitment: every base but B (coefficient 0)."""
    return list(range(1, 2 * N + 2))


def s_digits(N: int, sb: torch.Tensor, sl: torch.Tensor,
             sr: torch.Tensor) -> torch.Tensor:
    """S = sb B~ + <sL, G> + <sR, H> (reference party.rs:119-124): digit
    stream ((2N + 1) * 64, P) over s_base_sel's bases."""
    return _coef_digits(torch.cat([sb[None], sl, sr]))


@lru_cache(maxsize=None)
def _pow2_const(n: int, device) -> torch.Tensor:
    """(n, 9, 1) limbs of [1, 2, 4, .., 2^(n-1)]."""
    return torch.as_tensor(sc_ints_to_limbs([1 << i for i in range(n)]).T[
        :, :, None].copy(), device=device)


def stage1(n: int, m: int, bits, y, z, sl, sr, t1b, t2b):
    """bits (N, P); y, z, t1b, t2b (9, P); sl, sr (N, 9, P).  Party j's bits
    sit at rows [j n, (j + 1) n), position k = j n + i carries y^k and
    z^(2+j) 2^i (reference party.rs:182-237).

    -> (l0, l1, r0, r1 (N, 9, P), t0, t1, t2 (9, P), zz_zpow (m, 9, P)
    the per-party z^(2+j), T digit stream (128, 2P) over [B, B~])."""
    N = n * m
    dev = y.device
    ypow = S.power_sequence(y, N)
    zz = S.smul(z, z)
    zz_zpow = S.smul(S.power_sequence(z, m), zz)
    offset_zz = zz_zpow[:, None].expand(m, n, L, y.shape[-1]).reshape(N, L, -1)
    neg_z = S.sneg(z)
    z_m1 = S.sadd(z, S.const(ELL - 1, dev))
    one_minus_z = S.sadd(neg_z, S.const(1, dev))

    bit_mask = (bits != 0)[:, None, :]
    l0 = torch.where(bit_mask, one_minus_z, neg_z)
    l1 = sl
    aRz = torch.where(bit_mask, z, z_m1)
    pow2 = _pow2_const(n, dev).repeat(m, 1, 1)
    r0 = S.sadd(S.smul(ypow, aRz), S.smul(offset_zz, pow2))
    r1 = S.smul(ypow, sr)

    t0 = S.tree_sum(S.smul(l0, r0))
    t2 = S.tree_sum(S.smul(l1, r1))
    tm = S.tree_sum(S.smul(S.sadd(l0, l1), S.sadd(r0, r1)))
    t1 = S.sadd(tm, S.sneg(S.sadd(t0, t2)))

    coef = torch.stack([torch.cat([t1, t2], dim=-1),
                        torch.cat([t1b, t2b], dim=-1)])
    return l0, l1, r0, r1, t0, t1, t2, zz_zpow, _coef_digits(coef)


def stage2(n: int, x, l0, l1, r0, r1, t0, t1, t2, zz_zpow, vb, t1b, t2b,
           ab, sb, yinv):
    """Challenge x -> (a, b, gw, hw (N, 9, P), t_x, t_x_blinding,
    e_blinding (9, P)).  n is the TOTAL vector length N; zz_zpow and vb are
    (m, 9, P): t_x_blinding = sum_j z^(2+j) vb_j + t1b x + t2b x^2 (the
    party shares of reference party.rs:292-296 summed by the dealer)."""
    xx = S.smul(x, x)
    t_x = S.sadd(t0, S.sadd(S.smul(t1, x), S.smul(t2, xx)))
    zvb = S.tree_sum(S.smul(zz_zpow, vb))
    t_xb = S.sadd(zvb, S.sadd(S.smul(t1b, x), S.smul(t2b, xx)))
    e_b = S.sadd(ab, S.smul(sb, x))
    a = S.sadd(l0, S.smul(l1, x))
    b = S.sadd(r0, S.smul(r1, x))
    gw = S.const(1, x.device).expand_as(a).contiguous()
    hw = S.power_sequence(yinv, n)
    return a, b, gw, hw, t_x, t_xb, e_b


def _slot_maps(n: int, nk: int):
    h = nk // 2
    s = np.arange(n) % nk
    hi = (s >= h)                                  # G_j in the hi half
    a_lo_idx = np.where(hi, s - h, 0)              # L-row gather
    a_hi_idx = np.where(~hi, s + h, 0)             # R-row gather
    b_hi_idx = np.where(~hi, s + h, 0)             # L-row H gather
    b_lo_idx = np.where(hi, s - h, 0)              # R-row H gather
    return hi, a_lo_idx, a_hi_idx, b_hi_idx, b_lo_idx


def _rows(v: torch.Tensor, idx) -> torch.Tensor:
    return v[torch.as_tensor(np.asarray(idx, np.int64), device=v.device)]


def round_digits_compact(n: int, nk: int, a, b, gw, hw, w):
    """Digit streams over the round's ACTIVE bases only: (digits_L,
    digits_R), each ((n + 1) * 64, P), for the base orders [B, G_hi..,
    H_lo..] and [B, G_lo.., H_hi..] (hi / lo by slot j mod nk)."""
    h = nk // 2
    hi, a_lo_idx, a_hi_idx, b_hi_idx, b_lo_idx = _slot_maps(n, nk)
    hi_sel = np.nonzero(hi)[0]
    lo_sel = np.nonzero(~hi)[0]

    cL = S.tree_sum(S.smul(a[:h], b[h:nk]))
    cR = S.tree_sum(S.smul(a[h:nk], b[:h]))

    alphaL = S.smul(_rows(a, a_lo_idx[hi_sel]), _rows(gw, hi_sel))
    betaL = S.smul(_rows(b, b_hi_idx[lo_sel]), _rows(hw, lo_sel))
    alphaR = S.smul(_rows(a, a_hi_idx[lo_sel]), _rows(gw, lo_sel))
    betaR = S.smul(_rows(b, b_lo_idx[hi_sel]), _rows(hw, hi_sel))

    coef_l = torch.cat([S.smul(cL, w)[None], alphaL, betaL])
    coef_r = torch.cat([S.smul(cR, w)[None], alphaR, betaR])
    return _coef_digits(coef_l), _coef_digits(coef_r)


def round_base_sets(n: int, nk: int):
    """Base-index lists (into [B, B~, G.., H..]) in round_digits_compact's
    column order."""
    hi, *_ = _slot_maps(n, nk)
    hi_sel = np.nonzero(hi)[0]
    lo_sel = np.nonzero(~hi)[0]
    L_set = [0] + [2 + int(j) for j in hi_sel] + [2 + n + int(j) for j in lo_sel]
    R_set = [0] + [2 + int(j) for j in lo_sel] + [2 + n + int(j) for j in hi_sel]
    return L_set, R_set


def _fold_rows(N: int, h: int):
    """Row maps (numpy) of a fold into width h over N rows: (idx, mask) with
    mask[j] = j < h and idx[j] = j + h there, else 0."""
    j = np.arange(N)
    return np.where(j < h, j + h, 0), j < h


@lru_cache(maxsize=None)
def _fold_maps(N: int, h: int, device):
    """_fold_rows on `device` (uploaded once)."""
    return tuple(torch.as_tensor(t, device=device) for t in _fold_rows(N, h))


def round_fold(n: int, nk: int, a, b, gw, hw, u, uinv):
    """Fold a, b with the round's challenge (kernel K8, one launch for
    both); update gw, hw (kernel K9, one launch for both).  The folded
    halves land in slots [0, nk / 2); the stale upper slots are copied
    through and never read.  u, uinv (9, P) are per proof: the kernels
    read them by proof, so nothing is broadcast over the rows."""
    hi, *_ = _slot_maps(n, nk)
    lo_m = torch.as_tensor(~hi, device=a.device)
    a, b = FO.fold_pair(a, b, u, uinv, *_fold_maps(n, nk // 2, a.device))
    gw, hw = FO.smul_pair(gw, hw, lo_m, uinv, u)
    return a, b, gw, hw


def final_scalars(a, b, t_x, t_xb, e_b) -> torch.Tensor:
    """-> (5, 9, P) stack [t_x, t_x_blinding, e_blinding, a0, b0]."""
    return torch.stack([t_x, t_xb, e_b, a[0], b[0]])


def _canonical_rows(x: torch.Tensor) -> torch.Tensor:
    """(k, 9, P) canonical scalars -> (k P, 32) uint8, rows scalar-major
    (vec_scalar.canonical_bytes32: the port's scalars are canonical
    already, so this is the byte codec alone)."""
    k, _, p = x.shape
    return sc_to_bytes(x.permute(1, 0, 2).reshape(L, k * p))


# -- one Fiat-Shamir phase per call ---------------------------------------------------

def _blind_slices(N: int, p: int, red: torch.Tensor):
    """Split the (9, (4 + 2N) P) blinding draws into (ab, sb, t1b, t2b
    (9, P), sl, sr (N, 9, P)), in the prover's draw order [ab][sb][t1b]
    [t2b][sl][sr], the vectors i-major."""
    ab, sb, t1b, t2b = (red[:, k * p: (k + 1) * p] for k in range(4))
    sl = red[:, 4 * p: (4 + N) * p].reshape(L, N, p).transpose(0, 1)
    sr = red[:, (4 + N) * p: (4 + 2 * N) * p].reshape(L, N, p).transpose(0, 1)
    return ab, sb, t1b, t2b, sl, sr


def stage0_fused(n: int, m: int, niels_bb, niels_a, niels_s, red, v_bytes,
                 vb_bytes, bits) -> torch.Tensor:
    """Value commitments V_j, the compact A and S, compressed to (
    (m + 2) P, 32) uint8 rows [V (m P) | A (P) | S (P)] (reference
    party.rs:87-124, summed by the local dealer)."""
    N, p = n * m, bits.shape[-1]
    ab, sb, _, _, sl, sr = _blind_slices(N, p, red)
    vpts = FM.msm_digits_niels(niels_bb, v_digits(S.from_bytes32(v_bytes),
                                                  S.from_bytes32(vb_bytes)))
    apts = FM.msm_digits_niels(niels_a, a_digits(N, bits, ab))
    spts = FM.msm_digits_niels(niels_s, s_digits(N, sb, sl, sr))
    return C.compress(torch.cat([vpts, apts, spts], dim=-1))


def stage1_fused(n: int, m: int, niels_bb, bits, red, yz_bytes):
    """The l / r polynomial pieces, the t-polynomial and compressed T_1 /
    T_2 rows (2P, 32).  yz_bytes is the (3P, 32) block [y | z | y^-1] of
    the C++ transcript stage."""
    N, p = n * m, bits.shape[-1]
    _, _, t1b, t2b, sl, sr = _blind_slices(N, p, red)
    yzi = S.from_bytes32(yz_bytes)
    y, z, yinv = yzi[:, :p], yzi[:, p: 2 * p], yzi[:, 2 * p:]
    l0, l1, r0, r1, t0, t1, t2, zz_zpow, tdig = stage1(
        n, m, bits, y, z, sl, sr, t1b, t2b)
    tb = C.compress(FM.msm_digits_niels(niels_bb, tdig))
    return tb, l0, l1, r0, r1, t0, t1, t2, zz_zpow, yinv


def stage2_fused(n: int, m: int, x_bytes, l0, l1, r0, r1, t0, t1, t2,
                 zz_zpow, red, vb_bytes, yinv):
    """The shares at x and the IPP state; returns the (3P, 32) canonical
    rows [t_x | t_x_blinding | e_blinding] and the state."""
    N, p = n * m, l0.shape[-1]
    ab, sb, t1b, t2b, _, _ = _blind_slices(N, p, red)
    x = S.from_bytes32(x_bytes)
    vb = S.from_bytes32(vb_bytes).reshape(L, m, p).transpose(0, 1)
    a, b, gw, hw, t_x, t_xb, e_b = stage2(
        N, x, l0, l1, r0, r1, t0, t1, t2, zz_zpow, vb, t1b, t2b, ab, sb, yinv)
    txs = _canonical_rows(torch.stack([t_x, t_xb, e_b]))
    return txs, a, b, gw, hw, t_x, t_xb, e_b


def round_emit(N, nk, tables, sel_l, sel_r, a, b, gw, hw, w_bytes):
    """One IPP round's L / R: both digit streams, both MSMs (K6's direct
    form over the full tables' rows sel_l / sel_r, the round's base subsets'
    row maps), compression -> (2P, 32) rows [L | R] (_round_emit; the first
    round, nk = N, is this alone: round_first_fused)."""
    w = S.from_bytes32(w_bytes)
    dig_l, dig_r = round_digits_compact(N, nk, a, b, gw, hw, w)
    pts = torch.cat([FM.msm_digits_niels(tables.table_rows(sel), dig,
                                         consttime=False)
                     for sel, dig in ((sel_l, dig_l), (sel_r, dig_r))],
                    dim=-1)
    return C.compress(pts)


def roundk_fused(N: int, nk: int, tables, sel_l, sel_r, a, b, gw, hw,
                 u_bytes, ui_bytes, w_bytes):
    """A later IPP round: fold the previous one (2 nk -> nk) with its
    challenge, then emit this round's L / R."""
    u = S.from_bytes32(u_bytes)
    uinv = S.from_bytes32(ui_bytes)
    a, b, gw, hw = round_fold(N, 2 * nk, a, b, gw, hw, u, uinv)
    lr = round_emit(N, nk, tables, sel_l, sel_r, a, b, gw, hw, w_bytes)
    return lr, a, b, gw, hw


def final_fused(N: int, a, b, gw, hw, u_bytes, ui_bytes, t_x, t_xb, e_b):
    """The last fold (2 -> 1) and the (5P, 32) canonical rows [t_x |
    t_x_blinding | e_blinding | a0 | b0]."""
    u = S.from_bytes32(u_bytes)
    uinv = S.from_bytes32(ui_bytes)
    a, b, _, _ = round_fold(N, 2, a, b, gw, hw, u, uinv)
    return _canonical_rows(final_scalars(a, b, t_x, t_xb, e_b))


# -- the device-transcript route ------------------------------------------------------
#
# The JAX package's default prove route on its accelerator
# (prover_stages.py:453-912): stage 0 (blinds, V / A / S), one host
# Fiat-Shamir step (C++ rp_ts_yz, the only one whose byte positions depend
# on the caller's transcript), then everything else on the device with no
# host round trip: the transcripts (ops/transcript_device.DeviceStrobe over
# kernel K13), the challenges' inverses (kernel K14) and a shape-uniform
# IPP round body whose per-round slot structure is runtime gather maps,
# uploaded once per N.  JAX compiles that rest as one program (m = 1) or
# three (the segmented form, m > 1); the port has the segmented form only
# (prove_rest), for every m: each round finds its maps by a device round
# index, so every round runs the same tensors and launches, which is what a
# CUDA graph of one round would need.

# entry / exit counters of every IPP round body: the last operation before
# and after each round is a 64-byte challenge PRF (a permutation, then a
# squeeze of 64 bytes from position 0)
_ROUND_COUNTERS = (64, 0, 7)   # pos, pos_begin, FLAG_I | FLAG_A | FLAG_C


def _dyn_round_maps(N: int):
    """Per-round gather maps (numpy) -> (emit, folds): emit[k] covers the
    L / R emission at width nk = N >> k, folds[k - 1] the fold into width
    nk (rounds k >= 1)."""
    emit, folds = [], []
    j = np.arange(N)
    nk = N
    while nk > 1:
        h = nk // 2
        s = j % nk
        hi = s >= h
        hi_sel = np.nonzero(hi)[0]
        lo_sel = np.nonzero(~hi)[0]
        L_bases = np.concatenate([[0], 2 + hi_sel, 2 + N + lo_sel])
        R_bases = np.concatenate([[0], 2 + lo_sel, 2 + N + hi_sel])
        w64 = np.arange(64)
        emit.append(dict(
            idx_partner=np.where(j < h, j + h, 0),
            half=np.int64(h),
            hi_sel=hi_sel, lo_sel=lo_sel,
            al=hi_sel % nk - h, bl=lo_sel % nk + h,
            ar=lo_sel % nk + h, br=hi_sel % nk - h,
            sel_l=(L_bases[:, None] * 64 + w64[None, :]).reshape(-1),
            sel_r=(R_bases[:, None] * 64 + w64[None, :]).reshape(-1),
        ))
        if nk < N:
            idx_fold, mask_fold = _fold_rows(N, nk)
            folds.append(dict(mask_fold=mask_fold, idx_fold=idx_fold,
                              glo=(j % (2 * nk)) < nk))
        nk //= 2
    return emit, folds


@lru_cache(maxsize=None)
def _round0_maps(N: int, device) -> dict:
    """Round 0's emission maps on `device` (uploaded once)."""
    emit, _ = _dyn_round_maps(N)
    return {k: torch.as_tensor(v, device=device) for k, v in emit[0].items()}


@lru_cache(maxsize=None)
def dyn_round_xs(N: int, device) -> dict:
    """The maps of rounds 1 .. R - 1 stacked, (R - 1, ...) tensors on
    `device` (uploaded once per N; ~0.5 MB at N = 1024), and under "k" the
    round indices 0 .. R - 2 as a device int64 vector."""
    emit, folds = _dyn_round_maps(N)
    xs = {k: np.stack([em[k] for em in emit[1:]]) for k in emit[0]}
    for k in folds[0]:
        xs[k] = np.stack([f[k] for f in folds])
    xs["k"] = np.arange(len(folds))
    return {k: torch.as_tensor(v, device=device) for k, v in xs.items()}


def fold_dyn(a, b, gw, hw, u, uinv, mask_fold, idx_fold, glo):
    """Shape-uniform fold of all N rows, a and b in one launch of kernel
    K8: a[j] <- u a[j] + u^-1 a[j + nk] and b with u, u^-1 swapped where
    mask_fold (j < nk), the rows above copied through with their stale
    values (never read again); gw / hw take u^-1 or u by the lo / hi slot
    pattern glo (kernel K9, one launch for both)."""
    a, b = FO.fold_pair(a, b, u, uinv, idx_fold, mask_fold)
    gw, hw = FO.smul_pair(gw, hw, glo, uinv, u)
    return a, b, gw, hw


def round_emit_dyn(a, b, gw, hw, w, em):
    """round_digits_compact with runtime gather maps -> (dig_l, dig_r), each
    ((N + 1) * 64, P) over the base orders em["sel_l"] / em["sel_r"].  The
    six vector products of the round are one `smul` over their rows
    stacked (the JAX package makes six), the two cross terms one prefix
    tree sum over the first em["half"] rows (the JAX package masks the
    rest)."""
    N, P = a.shape[0], a.shape[-1]
    h = em["hi_sel"].shape[0]
    x = torch.cat([a, a.index_select(0, em["idx_partner"]),
                   a.index_select(0, em["al"]), b.index_select(0, em["bl"]),
                   a.index_select(0, em["ar"]), b.index_select(0, em["br"])])
    y = torch.cat([b.index_select(0, em["idx_partner"]), b,
                   gw.index_select(0, em["hi_sel"]),
                   hw.index_select(0, em["lo_sel"]),
                   gw.index_select(0, em["lo_sel"]),
                   hw.index_select(0, em["hi_sel"])])
    prod = S.smul(x, y)
    cross = S.tree_sum_prefix(prod[:N], prod[N: 2 * N], em["half"])
    cw = S.smul(cross, torch.cat([w, w], dim=-1))          # [cL w | cR w]
    alpha_l, beta_l, alpha_r, beta_r = prod[2 * N:].split(h)
    coef_l = torch.cat([cw[None, :, :P], alpha_l, beta_l])
    coef_r = torch.cat([cw[None, :, P:], alpha_r, beta_r])
    return _coef_digits(coef_l), _coef_digits(coef_r)


def _emit_lr(tables, em, a, b, gw, hw, w) -> torch.Tensor:
    """One round's L / R over the full tables' rows em["sel_l"] /
    em["sel_r"] (K6's direct form reads its multiples through the row map)
    -> (2P, 32) compressed rows [L | R]."""
    dig_l, dig_r = round_emit_dyn(a, b, gw, hw, w, em)
    pts = torch.cat([
        FM.msm_digits_niels(tables.table_rows(em[key]), dig, consttime=False)
        for dig, key in ((dig_l, "sel_l"), (dig_r, "sel_r"))], dim=-1)
    return C.compress(pts)


def _absorb_round(ts, lr: torch.Tensor):
    """Absorb L and R, draw u -> (u, u^-1 by kernel K14)."""
    P = lr.shape[0] // 2
    ts.append_rows(b"L", lr[:P].T)
    ts.append_rows(b"R", lr[P:].T)
    u = ts.challenge_scalar(b"u")
    if ts.counters() != _ROUND_COUNTERS:
        raise RuntimeError("device transcript left the round schedule")
    return u, S.sinv(u)


def stage0_eager(n: int, m: int, niels_bb, niels_a, niels_s, key: bytes,
                 v_bytes, vb_bytes, bits):
    """Stage 0 of the device-transcript route: the blinding draws from one
    32-byte ChaCha key, then V / A / S (stage0_fused) -> (vas ((m + 2) P,
    32) compressed rows for the host's Fiat-Shamir step, red (9,
    (4 + 2N) P) the blinds that the rest consumes)."""
    N, P = n * m, bits.shape[-1]
    with tracing.span("prove.stage0"):
        red = chacha.random_scalars(key, P * (4 + 2 * N), bits.device)
        return stage0_fused(n, m, niels_bb, niels_a, niels_s, red, v_bytes,
                            vb_bytes, bits), red


def prove_mid_fused(n: int, m: int, tables, states_z, red, bits, yz_bytes,
                    vb_bytes):
    """Everything between the challenges z and the first u: stage 1 (T_1,
    T_2), x, stage 2, w, the IPP domain separator and round 0, with the
    transcripts on the device.

    tables: the full FixedBaseTables (its Niels stream (3, 10, (2N + 2) 64)
    and multiples); states_z: (200, P)
    post-z STROBE states (every transcript at _ROUND_COUNTERS); red:
    stage 0's blinds; bits (N, P); yz_bytes (3P, 32) rows [y | z | y^-1]
    of rp_ts_yz; vb_bytes (m P, 32) the value blindings.

    -> (tb (2P, 32), lr0 (2P, 32), w, a, b, gw, hw, u, u^-1, states
    (200, P), the canonical rows of t_x, t_x_blinding, e_blinding (P, 32))."""
    N, P = n * m, bits.shape[-1]
    ab, sb, t1b, t2b, sl, sr = _blind_slices(N, P, red)
    yzi = S.from_bytes32(yz_bytes)
    y, z, yinv = yzi[:, :P], yzi[:, P: 2 * P], yzi[:, 2 * P:]
    ts = DeviceStrobe(states_z, *_ROUND_COUNTERS)

    l0, l1, r0, r1, t0, t1, t2, zz_zpow, tdig = stage1(
        n, m, bits, y, z, sl, sr, t1b, t2b)
    tb = C.compress(FM.msm_digits_niels(tables.niels[:, :, :128].contiguous(),
                                        tdig))
    ts.append_rows(b"T_1", tb[:P].T)
    ts.append_rows(b"T_2", tb[P:].T)
    x = ts.challenge_scalar(b"x")

    vb = S.from_bytes32(vb_bytes).reshape(L, m, P).transpose(0, 1)
    a, b, gw, hw, t_x, t_xb, e_b = stage2(
        N, x, l0, l1, r0, r1, t0, t1, t2, zz_zpow, vb, t1b, t2b, ab, sb, yinv)
    txs = [sc_to_bytes(v) for v in (t_x, t_xb, e_b)]
    for label, rows in zip((b"t_x", b"t_x_blinding", b"e_blinding"), txs):
        ts.append_rows(label, rows.T)
    w = ts.challenge_scalar(b"w")
    ts.innerproduct_domain_sep(N)

    lr0 = _emit_lr(tables, _round0_maps(N, bits.device), a, b, gw, hw, w)
    u, uinv = _absorb_round(ts, lr0)
    return (tb, lr0, w, a, b, gw, hw, u, uinv, ts.state()) + tuple(txs)


def round_step_fused(tables, xs, k, w, a, b, gw, hw, u, uinv, st):
    """One shape-uniform IPP round (1 .. R - 1) whose maps come from the
    stacked xs (dyn_round_xs) by `k`, a (1,) device int64 index (rounds
    1, 2, .. are k = 0, 1, ..): the same tensors and launches for every
    round.  Fold with the previous challenge, emit L / R, absorb, draw u
    -> (lr, a, b, gw, hw, u, u^-1, states)."""
    em = {key: v.index_select(0, k)[0] for key, v in xs.items() if key != "k"}
    a, b, gw, hw = fold_dyn(a, b, gw, hw, u, uinv, em["mask_fold"],
                            em["idx_fold"], em["glo"])
    lr = _emit_lr(tables, em, a, b, gw, hw, w)
    ts = DeviceStrobe(st, *_ROUND_COUNTERS)
    u, uinv = _absorb_round(ts, lr)
    return lr, a, b, gw, hw, u, uinv, ts.state()


def prove_fin_fused(lrs, a, b, u, uinv, tx_by, txb_by, eb_by):
    """The last fold (2 -> 1, kernel K8, one launch for a and b) ->
    (lr_all (R, 2P, 32), fin (5, P, 32) canonical rows [t_x, t_x_blinding,
    e_blinding, a0, b0])."""
    a2, b2 = FO.fold_pair(a[:2], b[:2], u, uinv, *_fold_maps(2, 1, a.device))
    a0, b0 = a2[0], b2[0]
    fin = torch.stack([tx_by, txb_by, eb_by, sc_to_bytes(a0),
                       sc_to_bytes(b0)])
    return torch.stack(lrs), fin


def prove_rest(n: int, m: int, tables, states_z, red, bits, yz_bytes,
               vb_bytes):
    """Everything after the y / z challenges (prove_mid_fused's inputs), as
    three segments: prove_mid_fused, round_step_fused for rounds 1 .. R - 1
    (one body, its maps chosen by a device round index), prove_fin_fused
    -> (tb (2P, 32), lr_all (R, 2P, 32), fin (5, P, 32), states (200, P));
    the final counters are _ROUND_COUNTERS.  Each segment is a span
    (prove.mid, one prove.round a round, prove.fin)."""
    with tracing.span("prove.mid"):
        (tb, lr0, w, a, b, gw, hw, u, uinv, st,
         tx_by, txb_by, eb_by) = prove_mid_fused(n, m, tables, states_z, red,
                                                 bits, yz_bytes, vb_bytes)
    lrs = [lr0]
    xs = dyn_round_xs(n * m, bits.device)
    for k in range(xs["k"].shape[0]):
        with tracing.span("prove.round"):
            lr, a, b, gw, hw, u, uinv, st = round_step_fused(
                tables, xs, xs["k"][k: k + 1], w, a, b, gw, hw, u, uinv, st)
        lrs.append(lr)
    with tracing.span("prove.fin"):
        lr_all, fin = prove_fin_fused(lrs, a, b, u, uinv, tx_by, txb_by,
                                      eb_by)
    return tb, lr_all, fin, st
