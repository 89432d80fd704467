"""Chained shared-operand field multiplication over 20 x 13-bit limbs:
kernels K15 (`fmul13_chain`, CUDA cores) and K16 (`fmul13_chain_mma`, int8
tensor cores), csrc/fmul13.cu, with their plain PyTorch versions.

The arithmetic is the JAX package's ops/pallas_math.py (L = 20 limbs of 13
bits, MASK, TOP = 2^260 mod p = 608, `carry`, `fmul`) as the MXU probe
(benches/_mxu_fmul_probe.py) uses it; the port keeps its own copy, with
the probe's limb codec (`to_limbs`) and banded matrix (`band_matrix`).
Limbs lie on axis -2, lanes on the last axis, all int32 with the JAX
form's wrap-around (only the low 32 bits of a product or sum are kept).

One chain step, for a lane's a and three operands b1, b2, b3 shared by
every lane: a <- carry(fmul(a, b1) + fmul(a, b2) + fmul(a, b3)).
* VPU form (`chain_vpu`): fmul by the schoolbook column sums
  c_k = sum_{i+j=k} a_i b_j, then the tail (fold the 19 high columns by
  608, three carries).
* MXU form (`chain_mxu`): the same c_k from one int8 product, the banded
  matrix M(b) (156, 40) times the lane's split A = [a & 127; a >> 7]
  (40, Q): c = P1 + 128 (P2 + P3) + 16384 P4 over its four 39-row blocks.
  No int32 sum overflows at the probe's bounds (limbs below 2^14 after
  every carry), so both forms give the same limbs exactly, not only the
  same values mod p.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import _cuda

P25519 = (1 << 255) - 19
LIMB_BITS = 13
L = 20
NCOL = 2 * L - 1               # column sums of a 20 x 20 product
MASK = (1 << LIMB_BITS) - 1
TOP = 608                      # 2^260 mod p = 19 * 2^5
MROWS = 4 * NCOL               # rows of a banded matrix
MCOLS = 2 * L                  # its columns: the 7-bit halves of a


# -- limb codec ---------------------------------------------------------------------

def to_limbs(v: int, n: int = L, bits: int = LIMB_BITS) -> np.ndarray:
    """An int -> its n limbs of `bits` bits, int64 (the probe's)."""
    out = np.zeros(n, np.int64)
    m = (1 << bits) - 1
    for k in range(n):
        out[k] = v & m
        v >>= bits
    return out


def ints_to_limbs(values: Sequence[int]) -> np.ndarray:
    """Ints -> (20, n) int32 limbs, one lane per value."""
    return np.stack([to_limbs(v) for v in values], axis=1).astype(np.int32)


def limbs_to_ints(arr) -> List[int]:
    """(20, n) limbs (any sign, any size) -> the ints they stand for."""
    arr = np.asarray(arr, np.int64)
    return [sum(int(v) << (LIMB_BITS * k) for k, v in enumerate(arr[:, q]))
            for q in range(arr.shape[1])]


def band_matrices(limbs: np.ndarray) -> np.ndarray:
    """(n, 20) canonical limbs of shared operands -> (n, 156, 40) int8
    banded matrices [[band(lo) | 0], [0 | band(lo)], [band(hi) | 0],
    [0 | band(hi)]], band(x)[k, i] = x[k - i], lo = b & 127, hi = b >> 7."""
    limbs = np.asarray(limbs, np.int64)
    k = np.arange(NCOL)[:, None]
    i = np.arange(L)[None, :]
    d = k - i
    inside = (d >= 0) & (d < L)
    idx = np.clip(d, 0, L - 1)

    def band(x):                                    # (n, 20) -> (n, 39, 20)
        return np.where(inside, x[:, idx], 0).astype(np.int8)

    lo, hi = band(limbs & 127), band(limbs >> 7)
    z = np.zeros_like(lo)
    return np.ascontiguousarray(np.concatenate(
        [np.concatenate([lo, z], axis=2), np.concatenate([z, lo], axis=2),
         np.concatenate([hi, z], axis=2), np.concatenate([z, hi], axis=2)],
        axis=1))


def band_matrix(b_int: int) -> np.ndarray:
    """(156, 40) int8 matrix of a shared operand b < p (the probe's)."""
    return band_matrices(to_limbs(b_int)[None])[0]


# -- the plain versions ----------------------------------------------------------------

def carry(c: torch.Tensor) -> torch.Tensor:
    """pallas_math.carry: c & MASK plus c >> 13 shifted up one limb, the
    top limb's carry times 608 into limb 0."""
    cr = c >> LIMB_BITS
    return (c & MASK) + torch.cat([TOP * cr[..., L - 1:, :],
                                   cr[..., :L - 1, :]], dim=-2)


def fold_tail(c: torch.Tensor) -> torch.Tensor:
    """(..., 39, Q) column sums -> (..., 20, Q) limbs: pallas_math.fmul's
    tail (the high columns folded by 608, then three carries)."""
    lo, hi = c[..., :L, :], c[..., L:, :]
    z = torch.zeros_like(hi[..., :1, :])
    lo = lo + TOP * torch.cat([hi & MASK, z], dim=-2)
    lo = lo + TOP * torch.cat([z, hi >> LIMB_BITS], dim=-2)
    return carry(carry(carry(lo)))


def columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook column sums of (..., 20, Q) limbs (broadcasting) ->
    (..., 39, Q) int32."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    c = torch.zeros(shape[:-2] + (NCOL, shape[-1]), dtype=torch.int32,
                    device=a.device)
    for i in range(L):
        c[..., i: i + L, :] += a[..., i: i + 1, :] * b
    return c


def fmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """pallas_math.fmul on (..., 20, Q) int32 limbs."""
    return fold_tail(columns(a, b))


def split(a: torch.Tensor) -> torch.Tensor:
    """(20, Q) limbs -> (40, Q) int8 [a & 127; a >> 7] (exact while every
    limb is below 2^14; a larger one wraps, as the probe's astype does)."""
    return torch.cat([a & 127, a >> 7], dim=-2).to(torch.int8)


def mxu_columns(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(20, Q) limbs and (..., 156, 40) int8 banded matrices -> (..., 39, Q)
    column sums from the int8 product: an int32 multiply-and-sum over the
    40 columns (torch.matmul has no integer kernel on the card)."""
    A = split(a).to(torch.int32)
    P = (m.to(torch.int32)[..., :, :, None] * A[..., None, :, :]).sum(
        dim=-2, dtype=torch.int32)                           # (..., 156, Q)
    n = NCOL
    return (P[..., :n, :] + 128 * (P[..., n: 2 * n, :] + P[..., 2 * n: 3 * n, :])
            + 16384 * P[..., 3 * n:, :])


def mxu_mul(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """One MXU-form product a * b for the banded matrix m = M(b) (the
    probe's `mxu_mul`): (20, Q) -> (20, Q)."""
    return fold_tail(mxu_columns(a, m))


def chain_vpu_plain(a: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """a (20, Q) int32, b3 (3, 20, T) int32 shared operands -> a after the
    T chained steps, VPU form (the probe's `vpu_kernel`)."""
    for t in range(b3.shape[-1]):
        y = fmul(a[None], b3[:, :, t: t + 1])                # (3, 20, Q)
        a = carry(y[0] + y[1] + y[2])
    return a


def chain_mxu_plain(a: torch.Tensor, m3: torch.Tensor) -> torch.Tensor:
    """a (20, Q) int32, m3 (3, T, 156, 40) int8 banded matrices -> a after
    the T chained steps, MXU form (the probe's `mxu_kernel`)."""
    for t in range(m3.shape[1]):
        y = fold_tail(mxu_columns(a, m3[:, t]))              # (3, 20, Q)
        a = carry(y[0] + y[1] + y[2])
    return a


# -- the kernels' wrappers ----------------------------------------------------------------

def _check_a(a: torch.Tensor) -> int:
    if a.dim() != 2 or a.shape[0] != L or a.dtype != torch.int32:
        raise ValueError("the chain takes a (20, Q) int32 tensor of limbs")
    return a.shape[1]


def chain_vpu(a: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """Kernel K15 (CUDA cores: a warp a lane, a thread a limb) on CUDA
    tensors, chain_vpu_plain on CPU tensors: a (20, Q) int32, b3 (3, 20,
    T) int32 -> (20, Q) int32."""
    q = _check_a(a)
    if b3.dim() != 3 or b3.shape[:2] != (3, L) or b3.dtype != torch.int32:
        raise ValueError("chain_vpu takes b3 (3, 20, T) int32")
    if a.device.type == "cpu":
        return chain_vpu_plain(a, b3)
    _cuda.check(a, torch.int32)
    _cuda.check(b3, torch.int32)
    out = torch.empty_like(a)
    if q:
        _cuda.launch("fmul13_chain", "fmul13", "bp_fmul13_chain", a, b3, out,
                     q, b3.shape[-1])
    return out


def chain_mxu(a: torch.Tensor, m3: torch.Tensor) -> torch.Tensor:
    """Kernel K16 (int8 tensor cores: the matrices in a ring of shared
    memory, product warps beside lane warps that run the tails, ten
    threads a lane) on CUDA tensors, chain_mxu_plain
    on CPU tensors: a (20, Q) int32, m3 (3, T, 156, 40) int8, 16-byte
    aligned -> (20, Q) int32, limb for limb chain_vpu's.  The kernel takes
    the zero halves of each matrix (columns 20-39 of P1 / P3 rows, 0-19 of
    P2 / P4 rows) as zero, as band_matrices makes them."""
    q = _check_a(a)
    if m3.dim() != 4 or m3.shape[0] != 3 or m3.shape[2:] != (MROWS, MCOLS) \
            or m3.dtype != torch.int8:
        raise ValueError("chain_mxu takes m3 (3, T, 156, 40) int8")
    if a.device.type == "cpu":
        return chain_mxu_plain(a, m3)
    _cuda.check(a, torch.int32)
    _cuda.check(m3, torch.int8)
    out = torch.empty_like(a)
    if q:
        _cuda.launch("fmul13_chain_mma", "fmul13", "bp_fmul13_chain_mma", a,
                     m3, out, q, m3.shape[1])
    return out


def residency() -> Dict[str, int]:
    """The kernels' shapes and the blocks one SM of the current CUDA device
    holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor, K16 with
    its dynamic shared memory): K15's blocks and threads, K16's blocks,
    threads, dynamic shared memory bytes, ring stages and lanes a block."""
    out = (ctypes.c_int * 7)()
    f = _cuda._lib("fmul13").bp_fmul13_residency
    f.argtypes, f.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    err = f(out)
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return dict(zip(("vpu_blocks_per_sm", "vpu_threads", "mma_blocks_per_sm",
                     "mma_threads", "mma_smem", "mma_stages", "mma_lanes"),
                    out))

