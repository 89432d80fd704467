"""Batched fixed-base MSM, the prover's point engine: kernels K6 (a one-hot
form, bucket accumulation; a direct form, signed multiples from a table),
K12 (the one-hot form's two-set twin) and K7 (bucket reduction, and the
direct form's chunk merge), csrc/fixed_msm.cu.

The JAX package's ops/fixed_msm.py.  out[q] = sum_j coef[j, q] Base_j for
Q output lanes over NB shared bases:

* tables T[j, w] = 2^(4w) Base_j, built once per base set in plain torch on
  the device (64 windows of 4 doublings, one batched inversion to Z = 1),
  stored as a canonical Niels stream (3, 10, NB * 64) in the order
  s = j * 64 + w, so window weights live in the tables and no doubling
  tail remains;
* digits: a signed base-16 digit in [-7, 8] per (stream row, lane), (S, Q)
  int8 (`ops/scalar.signed_digits` of the canonical coefficients);
* K6 `accumulate` (one-hot): every lane streams its S (table point,
  digit) rows in order and adds +-point into bucket |digit|, 8 buckets per
  lane.  The rows of one lane are split into `pick_splits(S, Q)`
  contiguous chunks, each with its own buckets, so Q * splits threads fill
  the card at any lane count (the TPU kernel ran one serial stream per
  lane);
* K6 `accumulate_direct` (public rows only): the stream's multiples table
  (`make_multiples`: k P_s for k = 1..8, canonical Niels, built once with
  the tables) gives +-|digit| P_s in one read, added into one accumulator
  per (lane, chunk); rows are read through a row map (`sel`), so an IPP
  round's rows of the full table need no copy; one point per chunk;
* K12 `accumulate2` (under `_ILP2`): K6 with two bucket sets per chunk,
  fed by alternate rows (two independent mixed-addition chains, one thread
  each), merged bucket by bucket at the end into K6's slab layout;
* K7 `reduce`: per lane, merge the chunks' buckets with complete additions
  (`red_groups` chunk groups, then a tree) and form sum_b b B_b by a
  suffix scan and a tree sum over the 8 buckets, 8 threads per group; on
  the direct form's slab, the merge alone.

The V/A/S and T rows carry the witness (values, bits, blindings, the
t-polynomial), so the one-hot K6 reads and writes ALL buckets at every row
and picks with a one-hot mask (fixed_msm._fixed_accum_kernel's select):
the memory pattern does not depend on a digit.  A zero digit selects no
bucket; its sum is computed and dropped (the TPU kernel's ninth bucket was
the sink).  The IPP rounds' L / R rows are public (the JAX package's host
route sends them to the vartime `rist_msm_rows`), so they alone pass
`consttime=False` and take the direct form, whose table read depends on
the digit and which skips zero digits.  Its points are the same group
elements as the one-hot form's in another projective representation.
The plain versions here repeat each kernel's arithmetic step for step, so
a kernel's output equals its plain version's limb for limb.

`msm_rows` / `msm_rows_compressed` take coefficient rows as bytes (the
host prover's form, fixed_msm.msm_rows): on tables on a card, digits by
K10 (`digit_stream`), then K6 and K7 (and K5); on host-only or CPU tables,
one C++ row MSM over the packed bases (`ensure_host_packed`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import tracing
from . import _cuda
from . import curve as C
from . import field as F
from . import fold as FO
from . import scalar as S
from .limbs import FE_LIMBS, fe_from_bytes, from_jax_lanes

L = FE_LIMBS
WINDOW_BITS = 4
NUM_WINDOWS = 64
NUM_BUCKETS = 8                 # digit magnitudes 1..8
# K6's one-hot form keeps its buckets in shared memory, 40 KB per block of
# 32 lanes: 5 blocks per SM on an H100 (228 KB of shared memory per SM; the
# runtime's cudaOccupancyMaxActiveBlocksPerMultiprocessor, `blocks_per_sm`,
# gives 5 there; chip_smoke.py logs it), so 132 * 5 * 32 threads fill the
# card in one wave
TARGET_THREADS = 21120
# K6's direct form keeps one point per thread in registers and no shared
# memory: blocks of DIRECT_THREADS lanes of one chunk, DIRECT_MIN_BLOCKS
# resident per SM by its __launch_bounds__ (csrc/fixed_msm.cu's defines of
# the same names): 8 warps, two on each scheduler, so 132 * 2 * 128
# threads are one balanced wave
DIRECT_THREADS = 128
DIRECT_MIN_BLOCKS = 2
TARGET_THREADS_DIRECT = 132 * DIRECT_MIN_BLOCKS * DIRECT_THREADS
MULT_WORDS = 32                 # a multiple's Niels point: 30 words, 2 pad
# K12 runs a lane's two bucket sets on two threads, 16 lanes a block of
# 32 at K6's 40 KB (5 blocks per SM resident), and aims at 4 blocks per SM,
# one warp on each of the SM's four schedulers: 2 * splits * Q = 132 * 4 *
# 32 threads.  At 256 lanes (split 33) that ran the m=16 S stream in 15.1
# ms on an H100, where 5 blocks per SM (split 41: one scheduler with two
# warps) took 17.6-17.8 (benches/fixed_msm_shapes.py)
TARGET_THREADS2 = 132 * 4 * 32 // 2
MIN_ROWS_PER_SPLIT = 32
# K7 sums each bucket's chunks in at most this many groups, one thread
# per (bucket, group)
MAX_RED_GROUPS = 4

# `accumulate` takes the two-set kernel K12 in place of K6 (the JAX
# package's flag of the same name, off there: measured even with the
# one-set kernel on its TPU, kept for other hardware)
_ILP2 = False


# -- tables ------------------------------------------------------------------------

def make_tables(points: torch.Tensor) -> torch.Tensor:
    """(4, 10, NB) int32 bases -> (3, 10, NB * 64) int32 canonical Niels
    stream (Y+X, Y-X, 2dT) of 2^(4w) Base_j at s = j * 64 + w
    (fixed_msm._make_tables)."""
    p = C.to_coords(points)
    rows = [torch.stack(p)]
    for _ in range(NUM_WINDOWS - 1):
        for _ in range(WINDOW_BITS):
            p = C.double(p)
        rows.append(torch.stack(p))
    pts = torch.stack(rows, dim=-1)                   # (4, 10, NB, 64)
    X, Y, Z, T = pts.reshape(4, L, -1).unbind(0)
    zinv = F.invert(Z)
    x, y = F.mul(X, zinv), F.mul(Y, zinv)
    t2d = F.mul(F.mul(x, y), F.const("d2", X.device))
    return torch.stack([F.canonicalize(F.add(y, x)),
                        F.canonicalize(F.sub(y, x)),
                        F.canonicalize(t2d)]).to(torch.int32)


def tables_from_jax(niels_np) -> torch.Tensor:
    """The JAX package's `_make_tables` output, (3, 20, S, 1) 13-bit limbs
    (numpy), -> the port's (3, 10, S) int32 canonical Niels stream."""
    return torch.as_tensor(from_jax_lanes(np.asarray(niels_np)[..., 0]))


class _HostBasis:
    """The bases as host points (`host_points`), for the C++ row MSM."""

    _host_packed = None

    @property
    def device(self) -> torch.device:
        """The tables' device; the CPU for host-only tables."""
        return torch.device("cpu") if self.niels is None else self.niels.device

    def ensure_host_packed(self) -> bytes:
        """The bases packed once in the C++ backend's extended-coordinate
        format (fixed_msm.FixedBaseTables.ensure_host_packed)."""
        if self._host_packed is None:
            from ..core.ristretto import pack_points
            self._host_packed = pack_points(self.host_points)
        return self._host_packed


def make_multiples(niels: torch.Tensor) -> torch.Tensor:
    """(3, 10, S) int32 canonical Niels stream -> (S, 8, 32) int32: row s
    holds k P_s for k = 1..8 as canonical Niels points (Y+X, Y-X, 2dT),
    each padded to 32 words, the table of K6's direct form.  Plain torch
    on the stream's device: P_s as (2 (Y+X - (Y-X)), 2 (Y+X + Y-X), 4,
    (Y+X - (Y-X)) (Y+X + Y-X)) = 4 (x, y, 1, xy), then 7 mixed additions
    of P_s, the 7 Z's inverted by one inversion a row (Montgomery's trick
    over the multiples), canonical Niels form."""
    S, dev = niels.shape[-1], niels.device
    n = niels.to(torch.int64)
    ypx, ymx, t2d = n[0], n[1], n[2]
    xx, yy = F.sub(ypx, ymx), F.add(ypx, ymx)          # 2x, 2y
    four = torch.zeros_like(xx)
    four[0] = 4
    p = (F.mul_small(xx, 2), F.mul_small(yy, 2), four, F.mul(xx, yy))
    pts = []
    for _ in range(NUM_BUCKETS - 1):                  # 2 P .. 8 P
        p = C.madd(p, (ypx, ymx, t2d))
        pts.append(p)
    zs = [q[2] for q in pts]
    prefix = [zs[0]]
    for z in zs[1:]:
        prefix.append(F.mul(prefix[-1], z))
    inv = F.invert(prefix[-1])
    zinv = [None] * len(zs)
    for k in range(len(zs) - 1, 0, -1):
        zinv[k] = F.mul(inv, prefix[k - 1])
        inv = F.mul(inv, zs[k])
    zinv[0] = inv
    out = torch.zeros((S, NUM_BUCKETS, MULT_WORDS), dtype=torch.int32,
                      device=dev)
    out[:, 0, :30] = niels.reshape(30, S).T
    d2 = F.const("d2", dev)
    for k, (q, zi) in enumerate(zip(pts, zinv), start=1):
        x, y = F.mul(q[0], zi), F.mul(q[1], zi)
        rows = torch.cat([F.canonicalize(F.add(y, x)),
                          F.canonicalize(F.sub(y, x)),
                          F.canonicalize(F.mul(F.mul(x, y), d2))])
        out[:, k, :30] = rows.T.to(torch.int32)
    return out


class TableRows(NamedTuple):
    """Rows `sel` ((S,) int64 on the tables' device; None: every row) of a
    FixedBaseTables' Niels stream `niels` (3, 10, T) and its multiples
    `mult` (T, 8, 32): what msm_digits_niels reads for public rows, the
    direct form through the row map, with no copy of the rows."""
    niels: torch.Tensor
    mult: torch.Tensor
    sel: Optional[torch.Tensor]

    def gathered(self) -> torch.Tensor:
        """The rows' Niels stream (3, 10, S), for the one-hot form."""
        return self.niels if self.sel is None \
            else self.niels.index_select(2, self.sel)


class FixedBaseTables(_HostBasis):
    """Window tables of a fixed base list, resident on `device`: the Niels
    stream `niels` and its multiples `mult` (K6's direct form); with
    device None, host tables only (`niels` and `mult` None: the rows go to
    the C++ row MSM)."""

    def __init__(self, points_host: Sequence, device):
        self.host_points = list(points_host)
        self.num_bases = len(self.host_points)
        self.niels = self.mult = None
        if device is not None:
            self.niels = make_tables(torch.as_tensor(
                C.points_to_lanes(self.host_points)).to(device))
            self.mult = make_multiples(self.niels)

    def table_rows(self, sel=None) -> TableRows:
        """Rows `sel` of the tables (None: every row), for public rows."""
        return TableRows(self.niels, self.mult, sel)


class StreamSubsetTables:
    """Arbitrary stream rows (sel[i] = j * 64 + w) of a FixedBaseTables,
    e.g. the range prover's A commitment, whose {0, +-1} coefficients on
    G_i / H_i touch only window 0 of those tables: their Niels rows copied
    (`niels`), and the row map on the device (`row_map`), through which
    the direct form reads the full tables' multiples."""

    def __init__(self, full: FixedBaseTables, sel):
        self._sel = np.asarray(sel, np.int64)
        self.full = full
        self.niels = self.row_map = None
        if full.niels is not None:
            self.row_map = torch.as_tensor(self._sel,
                                           device=full.niels.device)
            self.niels = full.niels[:, :, self.row_map].contiguous()

    def table_rows(self) -> TableRows:
        """This subset's rows of the full tables, for public rows."""
        return self.full.table_rows(self.row_map)


def base_rows(base_idx) -> np.ndarray:
    """Base indices -> their stream rows j * 64 + w, all 64 windows of
    each base in order (the row map of a base subset)."""
    base_idx = np.asarray(base_idx, np.int64)
    return (base_idx[:, None] * NUM_WINDOWS
            + np.arange(NUM_WINDOWS)[None, :]).reshape(-1)


class SubsetTables(StreamSubsetTables, _HostBasis):
    """All 64 windows of a base subset of a FixedBaseTables (stage 0's
    B / B~ and S bases)."""

    def __init__(self, full: FixedBaseTables, base_idx):
        self.host_points = [full.host_points[j] for j in base_idx]
        self.num_bases = len(base_idx)
        super().__init__(full, base_rows(base_idx))


# -- K6: bucket accumulation --------------------------------------------------------

def pick_splits(rows: int, lanes: int, target: int = TARGET_THREADS) -> int:
    """Chunks per lane's stream: target // lanes (the kernel's thread count
    that fills the card in one wave, at any lane count), each chunk at
    least MIN_ROWS_PER_SPLIT rows."""
    cap = max(1, rows // MIN_ROWS_PER_SPLIT)
    return max(1, min(cap, target // max(lanes, 1)))


def _split(niels, digits, target=TARGET_THREADS, quantum=1):
    """-> (niels, digits, splits): pick_splits for the stream, which is
    padded with Niels identities (1, 1, 0) and zero digits to a multiple of
    splits * quantum rows (fixed_msm.py:489-493; K12 takes quantum 2, an
    even row count per chunk)."""
    if niels.dim() != 3 or niels.shape[:2] != (3, L) \
            or digits.dim() != 2 or digits.shape[0] != niels.shape[-1]:
        raise ValueError("accumulate takes niels (3, 10, S), digits (S, Q)")
    S, Q = digits.shape
    splits = pick_splits(S, Q, target)
    pad = (-S) % (splits * quantum)
    if pad:
        ident = torch.zeros((3, L, pad), dtype=niels.dtype, device=niels.device)
        ident[:2, 0].fill_(1)
        niels = torch.cat([niels, ident], dim=-1)
        digits = torch.cat([digits, torch.zeros((pad, Q), dtype=digits.dtype,
                                                device=digits.device)])
    return niels.contiguous(), digits.contiguous(), splits


def _accumulate_plain(niels: torch.Tensor, digits: torch.Tensor,
                      splits: int) -> torch.Tensor:
    """accumulate_plain with the stream's split given (S % splits == 0)."""
    S, Q = digits.shape
    R = S // splits
    dev = niels.device
    pre = niels.to(torch.int64).reshape(3, L, splits, R).permute(3, 0, 2, 1)
    d = digits.to(torch.int64).reshape(splits, R, Q)
    ident = C.identity(1, dev).to(torch.int64)          # (4, 10, 1)
    buckets = ident[None, :, None].expand(NUM_BUCKETS, 4, splits, L, Q) \
        .contiguous()                                   # (8, 4, K, 10, Q)
    for r in range(R):
        dr = d[:, r]                                    # (K, Q)
        neg = (dr < 0)[:, None, :]
        mag = dr.abs()
        ypx, ymx, t2d = (pre[r, c][..., None] for c in range(3))   # (K, 10, 1)
        q = (torch.where(neg, ymx, ypx), torch.where(neg, ypx, ymx),
             torch.where(neg, F.neg(t2d), t2d))
        masks = [(mag == b + 1)[None, :, None, :] for b in range(NUM_BUCKETS)]
        cur = sum(torch.where(masks[b], buckets[b], 0)
                  for b in range(NUM_BUCKETS))
        new = torch.stack(C.madd(tuple(cur), q))
        for b in range(NUM_BUCKETS):
            buckets[b] = torch.where(masks[b], new, buckets[b])
    return buckets.permute(2, 0, 1, 3, 4).to(torch.int32).contiguous()


def accumulate_plain(niels: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """niels (3, 10, S) int32, digits (S, Q) int8 in [-7, 8] -> slab
    (splits, 8, 4, 10, Q) int32, splits = pick_splits(S, Q): bucket b of
    chunk c holds the sum of digit * point over the chunk's rows with
    |digit| = b + 1.  The plain version of K6's one-hot form."""
    return _accumulate_plain(*_split(niels, digits))


def accumulate(niels: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Kernel K6's one-hot form on CUDA tensors, the plain version on CPU
    tensors.  K12 (`accumulate2`) takes every row when _ILP2 is set."""
    if _ILP2:
        return accumulate2(niels, digits)
    if niels.device.type == "cpu":
        return accumulate_plain(niels, digits)
    niels, digits, splits = _split(niels, digits)
    _cuda.check(niels, torch.int32)
    _cuda.check(digits, torch.int8)
    S, Q = digits.shape
    slab = torch.empty((splits, NUM_BUCKETS, 4, L, Q), dtype=torch.int32,
                       device=niels.device)
    if Q:
        _cuda.launch("fixed_accumulate", "fixed_msm", "bp_fixed_accumulate",
                     niels, digits, slab, S, Q, splits)
    return slab


# -- K6's direct form: signed multiples into one accumulator ---------------------------

def _direct_split(mult, digits, sel):
    """-> (splits, rows per chunk) of K6's direct form: pick_splits at its
    own thread target; the last chunks may be short or empty."""
    if mult.dim() != 3 or mult.shape[1:] != (NUM_BUCKETS, MULT_WORDS) \
            or digits.dim() != 2 \
            or (sel is None and digits.shape[0] != mult.shape[0]) \
            or (sel is not None and sel.shape != digits.shape[:1]):
        raise ValueError("accumulate_direct takes mult (T, 8, 32), digits "
                         "(S, Q) and a row map sel (S,) (None: S = T)")
    S, Q = digits.shape
    splits = pick_splits(S, Q, TARGET_THREADS_DIRECT)
    return splits, -(-S // splits)


def _accumulate_direct_plain(mult, digits, sel, splits: int) -> torch.Tensor:
    """accumulate_direct_plain at a given split (chunks of ceil(S /
    splits) rows)."""
    S, Q = digits.shape
    R = -(-S // splits)
    pad = splits * R - S
    dev = mult.device
    d = torch.cat([digits.to(torch.int64),
                   torch.zeros((pad, Q), dtype=torch.int64, device=dev)]
                  ).reshape(splits, R, Q)
    rows = torch.arange(S, device=dev) if sel is None else sel.to(torch.int64)
    rows = torch.cat([rows, torch.zeros(pad, dtype=torch.int64, device=dev)]
                     ).reshape(splits, R)
    flat = mult.reshape(-1, MULT_WORDS).to(torch.int64)
    acc = tuple(c[None].expand(splits, L, Q)
                for c in C.to_coords(C.identity(1, dev)))
    for r in range(R):
        dr = d[:, r]                                    # (K, Q)
        k = dr.abs().clamp(min=1)
        w = flat[rows[:, r, None] * NUM_BUCKETS + k - 1].transpose(1, 2)
        ypx, ymx, t2d = w[:, :L], w[:, L: 2 * L], w[:, 2 * L: 3 * L]
        neg = (dr < 0)[:, None, :]
        new = C.madd(acc, (torch.where(neg, ymx, ypx),
                           torch.where(neg, ypx, ymx),
                           torch.where(neg, F.neg(t2d), t2d)))
        live = (dr != 0)[:, None, :]
        acc = tuple(torch.where(live, n, a) for n, a in zip(new, acc))
    return torch.stack(acc, dim=1)[:, None].to(torch.int32).contiguous()


def accumulate_direct_plain(mult: torch.Tensor, digits: torch.Tensor,
                            sel=None) -> torch.Tensor:
    """mult (T, 8, 32) int32 (make_multiples), digits (S, Q) int8 in [-7,
    8] over table rows sel ((S,) int64; None: rows 0..S-1) -> slab
    (splits, 1, 4, 10, Q) int32: chunk c of ceil(S / splits) digit rows,
    splits = pick_splits(S, Q, TARGET_THREADS_DIRECT), holds, from the
    identity in row order, each non-zero digit's multiple |d| of its row
    added by a mixed addition, negated for d < 0.  The plain version of
    K6's direct form."""
    splits, _ = _direct_split(mult, digits, sel)
    return _accumulate_direct_plain(mult, digits, sel, splits)


def accumulate_direct(mult: torch.Tensor, digits: torch.Tensor,
                      sel=None) -> torch.Tensor:
    """Kernel K6's direct form (public rows only: the IPP rounds' L / R)
    on CUDA tensors, the plain version on CPU tensors; with the recorder
    on, counts the rows x lanes as `fixed_direct_rows`."""
    splits, rows = _direct_split(mult, digits, sel)
    if tracing.ON:
        tracing.count("fixed_direct_rows", digits.numel())
    if mult.device.type == "cpu":
        return _accumulate_direct_plain(mult, digits, sel, splits)
    _cuda.check(mult, torch.int32)
    _cuda.check(digits, torch.int8)
    if sel is not None:
        _cuda.check(sel, torch.int64)
    S, Q = digits.shape
    slab = torch.empty((splits, 1, 4, L, Q), dtype=torch.int32,
                       device=mult.device)
    if Q:
        _cuda.launch("fixed_accumulate_vt", "fixed_msm",
                     "bp_fixed_accumulate_vt", mult, sel, digits, slab, S, Q,
                     splits, rows)
    return slab


def blocks_per_sm() -> Dict[str, int]:
    """Blocks that one SM of the current CUDA device holds at once, per
    kernel (cudaOccupancyMaxActiveBlocksPerMultiprocessor): K6 one-hot's
    blocks of 32 lanes, K6 direct's of DIRECT_THREADS, K12's, and K7's of
    128 threads."""
    out = (ctypes.c_int * 4)()
    f = _cuda._lib("fixed_msm").bp_fixed_blocks_per_sm
    f.argtypes, f.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    err = f(out)
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return dict(zip(("fixed_accumulate", "fixed_accumulate_vt",
                     "fixed_accumulate2", "fixed_reduce"), out))


# -- K12: two-set accumulation ----------------------------------------------------------

def accumulate2_plain(niels: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """The same slab as accumulate_plain up to the points' projective
    representation, splits = pick_splits(S, Q, TARGET_THREADS2): in each
    chunk (an even number of rows) rows 2t go to bucket set 0 and rows
    2t + 1 to set 1, each set accumulated as K6 does, then merged bucket by
    bucket with a complete addition (set 0 + set 1)."""
    return _accumulate2_plain(*_split(niels, digits, TARGET_THREADS2, 2))


def _accumulate2_plain(niels: torch.Tensor, digits: torch.Tensor,
                       splits: int) -> torch.Tensor:
    """accumulate2_plain with the stream's split given (S % (2 splits)
    == 0): chunk c's rows 2t (2t + 1) are rows c R / 2 + t of the even
    (odd) rows' stream split the same way."""
    sets = [_accumulate_plain(niels[..., h::2].contiguous(),
                              digits[h::2].contiguous(), splits)
            .to(torch.int64) for h in (0, 1)]
    merged = C.add(*(tuple(v[:, :, c] for c in range(4)) for v in sets))
    return torch.stack(merged, dim=2).to(torch.int32)


def accumulate2(niels: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Kernel K12 on CUDA tensors, the plain version on CPU tensors."""
    if niels.device.type == "cpu":
        return accumulate2_plain(niels, digits)
    niels, digits, splits = _split(niels, digits, TARGET_THREADS2, 2)
    _cuda.check(niels, torch.int32)
    _cuda.check(digits, torch.int8)
    S, Q = digits.shape
    slab = torch.empty((splits, NUM_BUCKETS, 4, L, Q), dtype=torch.int32,
                       device=niels.device)
    if Q:
        _cuda.launch("fixed_accumulate2", "fixed_msm", "bp_fixed_accumulate2",
                     niels, digits, slab, S, Q, splits)
    return slab


# -- K7: bucket reduction -------------------------------------------------------------

def _check_slab(slab):
    if slab.dim() != 5 or slab.shape[1] not in (1, NUM_BUCKETS) \
            or slab.shape[2:4] != (4, L):
        raise ValueError("reduce takes a (splits, 8 or 1, 4, 10, Q) slab")


def _add_prefix(p, q, cnt: int):
    """p with its first cnt entries (dim 0) replaced by p[:cnt] + q[:cnt]
    (complete addition, p first)."""
    s = C.add(tuple(a[:cnt] for a in p), tuple(b[:cnt] for b in q))
    return tuple(torch.cat([x, a[cnt:]]) for x, a in zip(s, p))


def red_groups(splits: int) -> int:
    """K7's chunk groups per bucket: 1 below 16 chunks, 2 below 32, else
    MAX_RED_GROUPS (4).  A small split keeps a warp on several lanes'
    work; a large one shortens each lane's serial merge."""
    g = 1
    while g < MAX_RED_GROUPS and 16 * g <= splits:
        g *= 2
    return g


def reduce_plain(slab: torch.Tensor) -> torch.Tensor:
    """(splits, 8, 4, 10, Q) -> (4, 10, Q) int32, K7's order: per lane and
    bucket, group g < G = red_groups(splits) sums chunks g, g + G, g + 2G,
    ... in order; the groups fold as g += g + h for h = G/2, ..., 1
    (partners past the last chunk skipped); then S_b += S_{b + d} for d =
    1, 2, 4 (a suffix scan, S_b = sum_{c >= b} B_c) and sum_b S_b =
    sum_b (b + 1) B_b by the tree b += b + h for h = 4, 2, 1.  A (splits,
    1, 4, 10, Q) slab (K6's direct form) is the merge alone."""
    _check_slab(slab)
    v = slab.to(torch.int64)
    K = v.shape[0]
    G = red_groups(K)
    live = min(K, G)
    acc = tuple(v[:live, :, c] for c in range(4))     # (live, 8, 10, Q) each
    for lo in range(G, K, G):
        acc = _add_prefix(acc, tuple(v[lo:, :, c] for c in range(4)),
                          min(G, K - lo))
    h = G // 2
    while h:
        if live - h > 0:
            acc = _add_prefix(acc, tuple(a[h:] for a in acc),
                              min(h, live - h))
        h //= 2
    s = tuple(a[0] for a in acc)                      # (NB, 10, Q) each
    nb = v.shape[1]
    d = 1
    while d < nb:
        s = _add_prefix(s, tuple(x[d:] for x in s), nb - d)
        d *= 2
    h = nb // 2
    while h:
        s = _add_prefix(s, tuple(x[h:] for x in s), h)
        h //= 2
    return torch.stack([x[0] for x in s]).to(torch.int32)


def reduce(slab: torch.Tensor) -> torch.Tensor:
    """Kernel K7 on a CUDA tensor (its chunk merge on a one-point slab),
    the plain version on a CPU tensor."""
    _check_slab(slab)
    if slab.device.type == "cpu":
        return reduce_plain(slab)
    _cuda.check(slab, torch.int32)
    K, Q = slab.shape[0], slab.shape[-1]
    out = torch.empty((4, L, Q), dtype=torch.int32, device=slab.device)
    if Q:
        name = "fixed_reduce" if slab.shape[1] == NUM_BUCKETS \
            else "fixed_merge"
        _cuda.launch(name, "fixed_msm", "bp_" + name, slab, out, Q, K,
                     red_groups(K))
    return out


# -- the MSM -------------------------------------------------------------------------

def msm_digits_niels(niels, digits: torch.Tensor,
                     consttime: bool = True) -> torch.Tensor:
    """A Niels stream (3, 10, S) int32 (a FixedBaseTables' or a subset's
    `.niels`) or TableRows (S rows of a table, `table_rows`), and signed
    digits (S, Q) int8 -> (4, 10, Q) int32 points, on the inputs' device:
    K6's one-hot form and K7.  `consttime=False` only for public rows (the
    JAX package's keyword of the same name), given as TableRows: K6's
    direct form over the table's multiples and K7's chunk merge.  K12
    takes every row under _ILP2."""
    if isinstance(niels, TableRows):
        if not (consttime or _ILP2):
            return reduce(accumulate_direct(niels.mult, digits, niels.sel))
        niels = niels.gathered()
    elif not (consttime or _ILP2):
        raise ValueError("the direct form reads a table's multiples: pass "
                         "TableRows (FixedBaseTables.table_rows)")
    return reduce(accumulate(niels, digits))


# -- coefficient rows: the host prover's MSMs ----------------------------------------

def _check_rows(tables, coef_bytes) -> None:
    if coef_bytes.ndim != 3 or coef_bytes.shape[1:] != (tables.num_bases, 32):
        raise ValueError(f"takes (Q, {tables.num_bases}, 32) coefficient "
                         f"bytes, got {tuple(coef_bytes.shape)}")


def digit_stream(coef_bytes: torch.Tensor) -> torch.Tensor:
    """(Q, NB, 32) uint8 canonical scalars -> (NB * 64, Q) int8 signed
    digit stream, row j * 64 + w (fixed_msm._device_digit_stream): kernel
    K10 on a CUDA tensor, its plain version on a CPU tensor."""
    q, nb, _ = coef_bytes.shape
    limbs = S.from_bytes32(coef_bytes.reshape(q * nb, 32))      # (9, Q NB)
    return FO.digits_lanes(limbs.reshape(-1, q, nb).permute(2, 0, 1)
                           .contiguous())


def _device_rows(tables, coef_bytes, consttime: bool = False) -> torch.Tensor:
    """msm_rows' card branch on the tables' device: digits by K10, then K6
    (one-hot when `consttime`, else direct) and K7 -> (4, 10, Q) int32; the
    plain versions on CPU tables."""
    _check_rows(tables, coef_bytes)
    coef = torch.as_tensor(coef_bytes).to(tables.niels.device)
    if consttime:
        return msm_digits_niels(tables.niels, digit_stream(coef))
    return msm_digits_niels(tables.table_rows(), digit_stream(coef),
                            consttime=False)


def _host_rows(tables, coef_bytes: np.ndarray, consttime: bool):
    """One C++ call over the packed basis (rist_msm_rows_ct when
    `consttime`, else rist_msm_rows) -> (Q, ctypes buffer of Q 128-byte
    extended points)."""
    from ..core import ristretto as R
    if R._NATIVE is None:
        raise RuntimeError("the host row MSM needs the native host library "
                           "(core/_native.py)")
    _check_rows(tables, coef_bytes)
    q = coef_bytes.shape[0]
    out = ctypes.create_string_buffer(128 * q)
    fn = R._NATIVE.rist_msm_rows_ct if consttime else R._NATIVE.rist_msm_rows
    fn(q, tables.num_bases, np.ascontiguousarray(coef_bytes).tobytes(),
       tables.ensure_host_packed(), out)
    return q, out


def msm_rows(tables, coef_bytes, consttime: bool = False) -> torch.Tensor:
    """(Q, NB, 32) canonical coefficient rows -> (4, 10, Q) int32 points,
    row q sum_j coef[q, j] Base_j (fixed_msm.msm_rows).  The tables' device
    picks the branch: on a card `_device_rows` (K10, K6, K7), else the C++
    row MSM (`consttime` picks its constant-time form there and K6's
    one-hot form on a card; the witness rows V / A / S and T_1 / T_2 pass
    True)."""
    if tables.device.type == "cuda":
        return _device_rows(tables, coef_bytes, consttime)
    q, out = _host_rows(tables, np.asarray(coef_bytes), consttime)
    ext = torch.frombuffer(bytearray(out.raw), dtype=torch.uint8)
    coords = ext.reshape(q, 4, 32).permute(1, 0, 2)
    return torch.stack([fe_from_bytes(c.contiguous()) for c in coords]) \
        .to(torch.int32)


def msm_rows_compressed(tables, coef_bytes, consttime: bool = False
                        ) -> np.ndarray:
    """(Q, NB, 32) coefficient rows -> (Q, 32) uint8 compressed points
    (fixed_msm.msm_rows_compressed): on a card msm_rows then K5, else one
    C++ row MSM and one rist_batch_compress."""
    if tables.device.type == "cuda":
        return C.compress(_device_rows(tables, coef_bytes, consttime)) \
            .cpu().numpy()
    from ..core import ristretto as R
    q, out = _host_rows(tables, np.asarray(coef_bytes), consttime)
    comp = ctypes.create_string_buffer(32 * q)
    R._NATIVE.rist_batch_compress(q, out, comp)
    return np.frombuffer(comp.raw, np.uint8).reshape(q, 32).copy()
