"""Limb layouts of the port and the byte <-> limb codecs.

Field elements (GF(2^255 - 19)): 10 signed limbs in radix 2^25.5 -- limb k
sits at bit FE_POS[k] = ceil(25.5 k) and is 26 bits wide for even k, 25
for odd k (the ref10 layout of curve25519).  A product of two limbs is at
most ~2^54 and a whole schoolbook column sum stays below 2^63, so the
plain PyTorch version multiplies in int64 and the CUDA kernels in 64-bit
IMAD.WIDE with int32 limbs, and both agree on every reduction step.
Tensors keep limbs on axis -2 and the batch on the last axis ((..., 10, N)),
the JAX package's lane-major layout.

Scalars mod l: 9 unsigned limbs of 29 bits (261 bits), limbs on axis -2,
kept canonical (< l) between operations; multiplication is Montgomery with
R = 2^261 (ops/scalar.py, csrc/sc25519.cuh).

The JAX package stores both as 20 x 13-bit int32 limbs; `from_jax_lanes`
converts its tensors (the BatchVerifier's generator table) to this layout.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import numpy as np
import torch

from ..core.field import P as _P

FE_LIMBS = 10
FE_POS = [(51 * k + 1) // 2 for k in range(FE_LIMBS)]          # ceil(25.5 k)
FE_WIDTH = [26 if k % 2 == 0 else 25 for k in range(FE_LIMBS)]

SC_LIMBS = 9
SC_BITS = 29
SC_MASK = (1 << SC_BITS) - 1
SC_POS = [SC_BITS * k for k in range(SC_LIMBS)]
SC_WIDTH = [SC_BITS] * (SC_LIMBS - 1) + [256 - SC_BITS * (SC_LIMBS - 1)]


def _gather_schedule(pos, width):
    """Per limb: the 5 source bytes and the shift (a limb of <= 29 bits at
    bit offset <= 7 spans at most 5 bytes)."""
    idx = np.array([[p // 8 + t for t in range(5)] for p in pos], np.int64)
    off = np.array([p % 8 for p in pos], np.int64)
    mask = np.array([(1 << w) - 1 for w in width], np.int64)
    return idx, off, mask


@lru_cache(maxsize=None)
def _gather_tensors(pos, width, device):
    """_gather_schedule and the byte shifts as tensors on `device`, made
    once (a host-to-device copy on the prover's path would wait for the
    card)."""
    idx, off, mask = _gather_schedule(pos, width)
    return (torch.as_tensor(idx.reshape(-1), device=device),
            torch.arange(0, 40, 8, device=device),
            torch.as_tensor(off, device=device),
            torch.as_tensor(mask, device=device))


def _bytes_to_limbs(raw: torch.Tensor, pos, width) -> torch.Tensor:
    """(N, 32) uint8 -> (K, N) int64 limbs (bits beyond the last limb drop)."""
    idx, shifts, off, mask = _gather_tensors(tuple(pos), tuple(width),
                                             raw.device)
    n = raw.shape[0]
    b = torch.zeros((n, 40), dtype=torch.int64, device=raw.device)
    b[:, :32] = raw.to(torch.int64)
    g = b[:, idx].reshape(n, len(pos), 5)
    val = (g << shifts).sum(-1)
    return ((val >> off) & mask).T.contiguous()


def _limbs_to_bytes(limbs: torch.Tensor, pos) -> torch.Tensor:
    """(K, N) exact non-negative limbs -> (N, 32) uint8.  Each byte spans
    at most two limbs (every limb is >= 8 bits wide)."""
    k_lo = [max(k for k in range(len(pos)) if pos[k] <= 8 * j) for j in range(32)]
    padded = torch.cat([limbs.to(torch.int64),
                        torch.zeros_like(limbs[:1])], dim=0)
    out = []
    for j in range(32):
        k = k_lo[j]
        v = padded[k] >> (8 * j - pos[k])
        if k + 1 < len(pos) and pos[k + 1] < 8 * j + 8:
            v = v | (padded[k + 1] << (pos[k + 1] - 8 * j))
        out.append(v & 255)
    return torch.stack(out, dim=1).to(torch.uint8)


def fe_from_bytes(raw: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 little-endian -> (10, N) int64 field limbs (the low 255
    bits; canonicity is checked separately by `canonical_mask`)."""
    return _bytes_to_limbs(raw, FE_POS, FE_WIDTH)


def fe_to_bytes(limbs: torch.Tensor) -> torch.Tensor:
    """(10, N) exact canonical limbs (ops/field.canonicalize) -> (N, 32)."""
    return _limbs_to_bytes(limbs, FE_POS)


def sc_from_bytes(raw: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 -> (9, N) int64 scalar limbs (value < 2^256)."""
    return _bytes_to_limbs(raw, SC_POS, SC_WIDTH)


def sc_to_bytes(limbs: torch.Tensor) -> torch.Tensor:
    """(9, N) exact scalar limbs (value < 2^256) -> (N, 32) uint8."""
    return _limbs_to_bytes(limbs, SC_POS)


def canonical_mask(raw: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 -> (N,) bool: a canonical ristretto encoding (field
    value < p = 2^255 - 19 and even; vec_curve.py:236-243)."""
    b = raw.to(torch.int32)
    top_clear = b[:, 31] < 128
    ge_p = ((b[:, 31] == 127) & (b[:, 0] >= 237)
            & torch.all(b[:, 1:31] == 255, dim=1))
    return top_clear & ~ge_p & ((b[:, 0] & 1) == 0)


# -- host conversions (numpy / Python ints; tests and set-up only) -----------

def ints_to_limbs(values: Sequence[int], pos, width) -> np.ndarray:
    """Python ints (< 2^(pos[-1] + width[-1])) -> (K, N) int64 limbs."""
    out = np.zeros((len(pos), len(values)), np.int64)
    for i, v in enumerate(values):
        v = int(v)
        for k, (p, w) in enumerate(zip(pos, width)):
            out[k, i] = (v >> p) & ((1 << w) - 1)
    return out


def limbs_to_ints(limbs, pos) -> List[int]:
    """(K, N) signed limbs -> Python ints (not reduced)."""
    arr = np.asarray(limbs, np.int64)
    return [sum(int(arr[k, i]) << p for k, p in enumerate(pos))
            for i in range(arr.shape[1])]


def fe_ints_to_limbs(values: Sequence[int]) -> np.ndarray:
    return ints_to_limbs([int(v) % _P for v in values], FE_POS, FE_WIDTH)


def fe_limbs_to_ints(limbs) -> List[int]:
    """(10, N) limbs -> canonical Python ints mod p."""
    return [v % _P for v in limbs_to_ints(limbs, FE_POS)]


def sc_ints_to_limbs(values: Sequence[int]) -> np.ndarray:
    return ints_to_limbs(values, SC_POS, [SC_BITS] * SC_LIMBS)


def sc_limbs_to_ints(limbs) -> List[int]:
    return limbs_to_ints(limbs, SC_POS)


def from_jax_lanes(arr) -> np.ndarray:
    """The JAX package's (..., 20, N) int32 13-bit limb tensor (numpy) ->
    the port's (..., 10, N) int32 field limbs of the same values mod p."""
    arr = np.asarray(arr, np.int64)
    lead, n = arr.shape[:-2], arr.shape[-1]
    flat = arr.reshape(-1, 20, n)
    out = np.zeros((flat.shape[0], FE_LIMBS, n), np.int64)
    for r in range(flat.shape[0]):
        vals = [sum(int(flat[r, k, i]) << (13 * k) for k in range(20))
                for i in range(n)]
        out[r] = fe_ints_to_limbs(vals)
    return out.reshape(lead + (FE_LIMBS, n)).astype(np.int32)
