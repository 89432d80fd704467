"""Batch-verification scalar emit (kernel K2, csrc/emit.cu) and the fused
device tail of one sub-batch: emit -> static scalars -> mega-MSM -> accept.

The JAX package's ops/verify_pallas.py (`emit_digits`, `_lane_tree_sum`,
`fused_tail`).  Its challenge-block layout (written by the host replay,
native/verify_prep.cpp rangeproof_verify_replay_batch_c), per proof:
  [0..lg) u | lg+0 r | +1 x | +2 rc | +3 z | +4 y^-1 | +5 -a | +6 -b
  | +7 prod(u)^-1
All scalars stay canonical; the arithmetic runs in the Montgomery domain
(ops/scalar.py).  The emit writes the dynamic coefficients' digits in
proof-major order (column p * n_dyn + slot), the order of the dynamic
points, and per-tile partial sums of the static g/h coefficients.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..core.scalar import L as ELL
from . import _cuda
from . import msm as M
from . import scalar as S
from .limbs import SC_LIMBS, sc_ints_to_limbs

EMIT_TILE = 8          # proofs per emit block, a warp each (a g/h partial)
_LG_MAX, _M_MAX = 10, 16


def shape(n: int, m: int):
    """(lg, challenge-block scalars per proof, dynamic points per proof)."""
    lg = (n * m).bit_length() - 1
    return lg, lg + 8, 4 + 2 * lg + m


@lru_cache(maxsize=None)
def _pow2_mont(n: int):
    """(n, 9) int32 limbs of 2^i R mod l, i < n."""
    return torch.as_tensor(sc_ints_to_limbs(
        [(pow(2, i, ELL) * S.ONE_M) % ELL for i in range(n)]).T.copy(),
        dtype=torch.int32)


# -- K2: emit ------------------------------------------------------------------

_LO_BITS = 6           # K2's tables split at 64 rows (csrc/emit.cuh)


def _emit_products(n: int, m: int):
    """K2's products for one proof, in an order that computes every operand
    first: (ops, header fields, dynamic slots).  Slots 0 .. lg + 7 hold
    the challenge block (rc, -a and -b as read, the others in the
    Montgomery domain), lg + 8 Montgomery one, lg + 9 r as read, then
    2^(2^b) R for b < log2(n); an op (dst, a, b) is dst = a b R^-1, its
    first operand the one that may be a scalar as read.  A product of a
    scalar as read and one in the Montgomery domain is out of that domain,
    so the dynamic coefficients, the g and h terms and their tables are
    made plain from r, rc, -a and -b as read, and nothing is converted
    out."""
    lg, _, _ = shape(n, m)
    lg_n = n.bit_length() - 1
    lo_bits = min(lg, _LO_BITS)
    hi_bits = lg - lo_bits
    one, r_in, pw2 = lg + 8, lg + 9, lg + 10
    top = [lg + 10 + lg_n]
    ops = []

    def new(k=1):
        top[0] += k
        return top[0] - k

    def mul(a, b, dst=None):
        dst = new() if dst is None else dst
        ops.append((dst, a, b))
        return dst

    u = list(range(lg))
    r, x, rc, z, y_inv, neg_a, neg_b, allinv = range(lg, lg + 8)
    lo, hi = new(3 << lo_bits), new(3 << hi_bits)

    def hi_row(tb, j):
        """Table tb's row 2^j where bit j is a hi bit (its factor is made
        there), else None (a new slot)."""
        return hi + (tb << hi_bits) + (1 << (j - lo_bits)) \
            if j >= lo_bits else None

    # prefix and suffix products of the u (a term from one is its factor),
    # and prod(u) by a balanced tree, shorter than the suffix chain
    pres = [one] + u[:1]
    for k in range(2, lg):
        pres.append(mul(pres[-1], u[k - 1]))
    sufs = [None] * lg + [one]
    if lg:
        sufs[lg - 1] = u[lg - 1]
    for k in range(lg - 2, 0, -1):
        sufs[k] = mul(sufs[k + 1], u[k])
    level = list(u) or [one]
    while len(level) > 1:
        level = [mul(level[i], level[i + 1]) if i + 1 < len(level)
                 else level[i] for i in range(0, len(level), 2)]
    u_sq = [mul(u[k], u[k], hi_row(0, lg - 1 - k)) for k in range(lg)]
    u_inv_sq = []
    for k in range(lg):
        a = mul(allinv, pres[k]) if k else allinv
        v = mul(a, sufs[k + 1]) if k < lg - 1 else a
        u_inv_sq.append(mul(v, v))
    ypow2 = [y_inv][:lg]
    for _ in range(1, lg):
        ypow2.append(mul(ypow2[-1], ypow2[-1]))
    zpow = [one, z][:m]
    for j in range(2, m):
        zpow.append(mul(zpow[j // 2], zpow[j // 2]) if j % 2 == 0
                    else mul(zpow[j - 1], z))
    # the dynamic coefficients, plain: [r, rx, rcx, rcx^2, r u^2.., r u^-2..,
    # rczz z^j..]
    rcx = mul(rc, x)
    rczz = mul(mul(rc, z), z)
    dyn = [mul(r_in, one), mul(r_in, x), rcx, mul(rcx, x)] \
        + [mul(r_in, q) for q in u_sq] + [mul(r_in, q) for q in u_inv_sq] \
        + [rczz] + [mul(rczz, zp) for zp in zpow[1:]]
    # the tables, plain: row i = seed prod_{bit j of i} factor j, so that
    # g_i = -rz + row_1,i and h_i = rz + row_2,i + row_3,i.  Seeds -a t0
    # (t0 = r prod(u)^-1), -b t0r (t0r = r prod(u)) and rzz; factors
    # u_{lg-1-j}^2, u_{lg-1-j}^-2 y^-2^j, and y^-2^j times 2^(2^j) for the
    # bits of i % n or z^(2^(j - log2 n)) for those of i / n.  Row 2^j + k
    # = row k times factor j; a hi row of one bit is its factor.
    rz = mul(r_in, z)
    mul(neg_a, mul(r, allinv), lo)
    mul(neg_b, mul(r, level[0]), lo + (1 << lo_bits))
    mul(rz, z, lo + (2 << lo_bits))
    factors = (
        [u_sq[lg - 1 - j] for j in range(lg)],
        [mul(u_inv_sq[lg - 1 - j], ypow2[j], hi_row(1, j))
         for j in range(lg)],
        [mul(ypow2[j], pw2 + j if j < lg_n else zpow[1 << (j - lg_n)],
             hi_row(2, j)) for j in range(lg)])
    for tb, f in enumerate(factors):
        base = lo + (tb << lo_bits)
        for j in range(lo_bits):
            for k in range(1 << j):
                mul(base + k, f[j], base + (1 << j) + k)
        base = hi + (tb << hi_bits)
        for j in range(1, hi_bits):
            for k in range(1, 1 << j):
                mul(base + k, f[lo_bits + j], base + (1 << j) + k)
    header = [0, top[0], lo, hi, rz, lo_bits]
    return ops, header, dyn


def _list_schedule(ops, inputs: int):
    """Steps of at most 32 ops, none reading a slot that its own or a later
    step writes; the ops on the longest remaining chains go first."""
    made = {}                                  # slot -> op index
    for i, (dst, _, _) in enumerate(ops):
        made[dst] = i
    users = [[] for _ in ops]
    for i, (_, a, b) in enumerate(ops):
        for src in {a, b}:
            if src >= inputs:
                users[made[src]].append(i)
    height = [0] * len(ops)
    for i in range(len(ops) - 1, -1, -1):
        height[i] = 1 + max((height[j] for j in users[i]), default=0)
    step_of = {}
    left = set(range(len(ops)))
    steps = []
    while left:
        now = len(steps)
        ready = [i for i in left
                 if all(src < inputs or step_of.get(made[src], now) < now
                        for src in (ops[i][1], ops[i][2]))]
        ready.sort(key=lambda i: (-height[i], i))
        steps.append(ready[:32])
        for i in ready[:32]:
            step_of[i] = now
            left.discard(i)
    return steps


@lru_cache(maxsize=None)
def emit_schedule(n: int, m: int) -> torch.Tensor:
    """K2's schedule for shape (n, m), int32 (csrc/emit.cuh): a header
    [steps, slots a proof, lo, hi, rz, lo_bits], the dynamic coefficients'
    slots, then steps x 32 ops dst | a << 10 | b << 20 (-1: none)."""
    ops, header, dyn = _emit_products(n, m)
    steps = _list_schedule(ops, shape(n, m)[0] + 10 + n.bit_length() - 1)
    header[0] = len(steps)
    words = [-1] * (32 * len(steps))
    for k, step in enumerate(steps):
        for lane, i in enumerate(step):
            dst, a, b = ops[i]
            words[32 * k + lane] = dst | a << 10 | b << 20
    return torch.tensor(header + dyn + words, dtype=torch.int32)


@lru_cache(maxsize=None)
def _emit_inputs(n: int, m: int, device: str):
    """(2^(2^b) R mod l for b < log2(n), schedule, slots a proof) of K2 on
    `device`, made once."""
    sched = emit_schedule(n, m)
    pow2 = _pow2_mont(n)[[1 << b for b in range(n.bit_length() - 1)]]
    return pow2.contiguous().to(device), sched.to(device), int(sched[1])


def _bits_product(seed, factors, lg):
    """rows[i] = seed * prod_{bit j of i} factors[lg-1-j] (Montgomery), by
    lg doublings of the row axis (verify_stages._doubling_powers_from_usq)."""
    rows = seed[None]
    for j in range(lg):
        rows = torch.cat([rows, S.mont_mul_plain(rows, factors[lg - 1 - j])],
                         dim=0)
    return rows


def emit_plain(n: int, m: int, blk: torch.Tensor):
    """blk (P, lg + 8, 32) uint8 -> (digits (64, P * n_dyn) int8,
    partial (ceil(P / EMIT_TILE), 2, nm, 9) int32 canonical)."""
    nm = n * m
    lg, nblk, n_dyn = shape(n, m)
    P = blk.shape[0]
    T = -(-P // EMIT_TILE)
    dev = blk.device
    raw = torch.zeros((T * EMIT_TILE, nblk, 32), dtype=torch.uint8, device=dev)
    raw[:P] = blk
    v = S.to_mont_plain(S.from_bytes32(raw.reshape(-1, 32))).reshape(
        SC_LIMBS, T * EMIT_TILE, nblk)
    u = [v[:, :, k] for k in range(lg)]
    r, x, rc, z, y_inv, neg_a, neg_b, allinv = (v[:, :, lg + j]
                                                for j in range(8))
    one = S.const(S.ONE_M, dev).expand_as(r)
    mm = S.mont_mul_plain

    pres = [one]
    for k in range(1, lg):
        pres.append(mm(pres[-1], u[k - 1]))
    sufs = [None] * lg + [one]
    for k in range(lg - 1, -1, -1):
        sufs[k] = mm(sufs[k + 1], u[k])
    u_sq = [mm(uk, uk) for uk in u]
    u_inv_sq = []
    for k in range(lg):
        uinv = mm(mm(allinv, pres[k]), sufs[k + 1])
        u_inv_sq.append(mm(uinv, uinv))
    ypow2 = [y_inv]
    for _ in range(1, lg):
        ypow2.append(mm(ypow2[-1], ypow2[-1]))
    t0, t0r = mm(r, allinv), mm(r, sufs[0])
    rx, rcx = mm(r, x), mm(rc, x)
    rcxx = mm(rcx, x)
    rz = mm(r, z)
    rzz = mm(rz, z)
    rczz = mm(mm(rc, z), z)

    # dynamic coefficients, slot order [r, rx, rcx, rcxx, r u^2.., r u^-2.., V..]
    slots = [r, rx, rcx, rcxx] + [mm(r, s) for s in u_sq] \
        + [mm(r, s) for s in u_inv_sq]
    rzz_zj, zp = [], one
    for _ in range(m):
        slots.append(mm(rczz, zp))
        rzz_zj.append(mm(rzz, zp))
        zp = mm(zp, z)
    dyn = torch.stack(slots, dim=-1)[:, :P]                 # (9, P, n_dyn)
    digits = S.signed_digits(S.from_mont_plain(
        dyn.reshape(SC_LIMBS, P * n_dyn)))

    # static coefficients per (i, proof): (nm, 9, P') rows
    t = _bits_product(t0, u_sq, lg)
    t_rev = _bits_product(t0r, u_inv_sq, lg)
    yp = _bits_product(one, ypow2[::-1], lg)
    g = S.sadd_plain(S.sneg_plain(rz), mm(neg_a, t))
    pw = _pow2_mont(n).to(dev, torch.int64)[:, :, None]     # (n, 9, 1)
    term1 = torch.cat([mm(zj[None], pw) for zj in rzz_zj])  # (nm, 9, P')
    h = S.sadd_plain(rz, mm(yp, S.sadd_plain(term1, mm(neg_b, t_rev))))

    def tile_sums(rows):
        rows = rows.reshape(nm, SC_LIMBS, T, EMIT_TILE)
        acc = rows[..., 0]
        for q in range(1, EMIT_TILE):
            acc = S.sadd_plain(acc, rows[..., q])
        return S.from_mont_plain(acc).permute(2, 0, 1)      # (T, nm, 9)

    partial = torch.stack([tile_sums(g), tile_sums(h)], dim=1)
    return digits, partial.to(torch.int32).contiguous()


def emit(n: int, m: int, blk: torch.Tensor):
    """Kernel K2 on a CUDA tensor, the plain version on a CPU tensor."""
    lg, nblk, _ = shape(n, m)
    if blk.dim() != 3 or blk.shape[1:] != (nblk, 32) or blk.dtype != torch.uint8:
        raise ValueError(f"emit takes a (P, {nblk}, 32) uint8 tensor")
    if n * m != 1 << lg or lg > _LG_MAX or m > _M_MAX:
        raise ValueError("emit supports power-of-two n*m <= 1024, m <= 16")
    if blk.device.type == "cpu":
        return emit_plain(n, m, blk)
    _cuda.check(blk, torch.uint8)
    P = blk.shape[0]
    _, _, n_dyn = shape(n, m)
    digits = torch.empty((64, P * n_dyn), dtype=torch.int8, device=blk.device)
    partial = torch.empty((-(-P // EMIT_TILE), 2, n * m, SC_LIMBS),
                          dtype=torch.int32, device=blk.device)
    if P:
        pow2, sched, slots = _emit_inputs(n, m, str(blk.device))
        _cuda.launch("emit", "emit", "bp_emit", blk, pow2, sched, digits,
                     partial, P, n, m, slots)
    return digits, partial


def warps_per_sm(n: int = 64, m: int = 1) -> int:
    """Warps of K2 at shape (n, m) that one SM of the current CUDA device
    holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor with the
    kernel's shared memory, times the block's warps)."""
    out = (ctypes.c_int * 2)()
    f = _cuda._lib("emit").bp_emit_blocks_per_sm
    f.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
    f.restype = ctypes.c_int
    err = f(int(emit_schedule(n, m)[1]), out)
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return out[0] * (out[1] // 32)


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """(T, ..., 9) canonical scalars -> (..., 9) their sum mod l, by a
    halving tree over the leading axis (verify_pallas._lane_tree_sum)."""
    v = v.to(torch.int64).movedim(-1, -2)                   # limbs at -2
    while v.shape[0] > 1:
        h = v.shape[0] // 2
        lo = S.sadd(v[:h], v[h: 2 * h])
        v = torch.cat([lo, v[2 * h:]], dim=0) if v.shape[0] % 2 else lo
    return v[0].movedim(-2, -1)


# -- the fused tail of one sub-batch ----------------------------------------------

def fused_tail(n: int, m: int, blk: torch.Tensor, pair: torch.Tensor,
               static_niels: torch.Tensor, dyn_pts: torch.Tensor,
               dyn_valid: torch.Tensor) -> torch.Tensor:
    """Emit -> static g/h sums -> signed digits -> mega-MSM over the static
    generators and the dynamic points -> (1,) bool accept flag: the MSM is
    the identity AND every dynamic point decoded (verify_pallas.fused_tail).

    blk (P, lg + 8, 32) uint8 challenge blocks, pair (2, 32) uint8 host
    sums of the B_blinding / B scalars, static_niels (3, 10, 2 + 2nm),
    dyn_pts (4, 10, P * n_dyn) and dyn_valid (P * n_dyn,) from `decompress`
    of the proof-major dynamic point stream.  Runs on the inputs' device
    without synchronising."""
    dyn_digits, partial = emit(n, m, blk)
    gh = tree_sum(partial)                                   # (2, nm, 9)
    pair_sc = S.sreduce(S.from_bytes32(pair))                # (9, 2)
    static_sc = torch.cat([pair_sc, gh[0].T, gh[1].T], dim=-1)
    digits = torch.cat([S.signed_digits(static_sc), dyn_digits], dim=-1)
    # K3's binning makes the dynamic points' Niels rows
    _, flag = M.msm_niels(static_niels.contiguous(), digits.contiguous(),
                          dyn_pts.contiguous())
    return flag & dyn_valid.all()
