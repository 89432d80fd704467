"""The batch range prover's device stages: every point and every mod-l
vector of the proofs, in PyTorch on the prover's device (the per-stage
part of the JAX package's ops/prover_stages.py, names kept).

Fiat-Shamir stays on the host (native/prove_prep.cpp rp_ts_*, one batched
C++ call between two stages); a "fused" function here covers one whole
phase between two challenges and returns the bytes that the next host
call absorbs.  Points go through the fixed-base MSM (ops/fixed_msm.py,
kernels K6 and K7) and compression (ops/curve.compress, kernel K5).  The
mod-l vector math runs on canonical scalars: every digit stream through
kernel K10 and the IPP fold through K8 / K9 (ops/fold.py, where the JAX
package calls ops/fold_pallas.py), the rest in plain PyTorch
(ops/scalar.py, where the JAX package's `_vmul` is XLA).

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

from ..core.scalar import L as ELL
from . import curve as C
from . import fixed_msm as FM
from . import fold as FO
from . import scalar as S
from .limbs import SC_LIMBS, sc_ints_to_limbs, sc_to_bytes

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
    offset_zz = zz_zpow.repeat_interleave(n, dim=0)
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


def round_fold(n: int, nk: int, a, b, gw, hw, u, uinv):
    """Fold a, b with the round's challenge (kernel K8); update gw, hw
    (kernel K9).  The folded halves land in slots [0, nk / 2); the stale
    upper slots are never read.  u, uinv (9, P) are per proof: the kernels
    read them by proof, so nothing is broadcast over the rows."""
    h = nk // 2
    hi, *_ = _slot_maps(n, nk)
    lo_m = torch.as_tensor(~hi, device=a.device)
    na = FO.fold_lanes(a[:h], a[h:nk], u, uinv)
    nb = FO.fold_lanes(b[:h], b[h:nk], uinv, u)
    a = torch.cat([na, a[h:]])
    b = torch.cat([nb, b[h:]])
    gw = FO.smul_lanes(gw, lo_m, uinv, u)
    hw = FO.smul_lanes(hw, lo_m, u, uinv)
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


def round_emit(N, nk, niels_l, niels_r, a, b, gw, hw, w_bytes):
    """One IPP round's L / R: both digit streams, both MSMs, compression ->
    (2P, 32) rows [L | R] (_round_emit; the first round, nk = N, is this
    alone: round_first_fused)."""
    w = S.from_bytes32(w_bytes)
    dig_l, dig_r = round_digits_compact(N, nk, a, b, gw, hw, w)
    pts = torch.cat([FM.msm_digits_niels(niels_l, dig_l),
                     FM.msm_digits_niels(niels_r, dig_r)], dim=-1)
    return C.compress(pts)


def roundk_fused(N: int, nk: int, niels_l, niels_r, a, b, gw, hw, u_bytes,
                 ui_bytes, w_bytes):
    """A later IPP round: fold the previous one (2 nk -> nk) with its
    challenge, then emit this round's L / R."""
    u = S.from_bytes32(u_bytes)
    uinv = S.from_bytes32(ui_bytes)
    a, b, gw, hw = round_fold(N, 2 * nk, a, b, gw, hw, u, uinv)
    lr = round_emit(N, nk, niels_l, niels_r, a, b, gw, hw, w_bytes)
    return lr, a, b, gw, hw


def final_fused(N: int, a, b, gw, hw, u_bytes, ui_bytes, t_x, t_xb, e_b):
    """The last fold (2 -> 1) and the (5P, 32) canonical rows [t_x |
    t_x_blinding | e_blinding | a0 | b0]."""
    u = S.from_bytes32(u_bytes)
    uinv = S.from_bytes32(ui_bytes)
    a, b, _, _ = round_fold(N, 2, a, b, gw, hw, u, uinv)
    return _canonical_rows(final_scalars(a, b, t_x, t_xb, e_b))
