"""The batch prover's mod-l vector kernels: K8 fold, K9 smul and K10
digits (csrc/fold.cu), each with its plain PyTorch version.

The JAX package's ops/fold_pallas.py (`fold_lanes`, `smul_lanes`,
`digits_lanes`) in the port's layout: vectors are (R, 9, P) int64
canonical scalars (ops/scalar.py), per-proof scalars (9, P).  K8 has two
wrappers on one kernel: `fold_pair`, an IPP round's fold of a and b under
the round's row maps (the JAX package's prover_stages.fold_dyn, one
launch), and `fold_lanes`, u x + v y of two vectors.  K9 too:
`smul_pair`, an IPP round's update of gw and hw in one launch, and
`smul_lanes`, one vector.  The wrappers take any row and column count
(the TPU kernels' 512-column tile and its `usable` gate were Mosaic
limits), check shapes, dtypes and contiguity on
either device, run the plain version for a CPU tensor and launch the
kernel for a CUDA tensor.  Outputs are canonical, so a kernel's result
equals its plain version's exactly.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import scalar as S
from .limbs import SC_LIMBS

L = SC_LIMBS


def _check(t: torch.Tensor, shape, what: str, dtype=torch.int64) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def _vectors(x: torch.Tensor, what: str):
    if x.dim() != 3 or x.shape[1] != L:
        raise ValueError(f"{what}: expected (R, {L}, P) limbs, got "
                         f"{tuple(x.shape)}")
    return x.shape[0], x.shape[2]


# -- K8: fold ----------------------------------------------------------------------

def fold_plain(x, y, u, v) -> torch.Tensor:
    return S.sadd_plain(S.smul_plain(x, u), S.smul_plain(y, v))


def fold_lanes(x: torch.Tensor, y: torch.Tensor, u: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """x, y (R, 9, P), u, v (9, P) per-proof scalars -> (R, 9, P)
    u x + v y mod l (kernel K8 with the identity map, one vector)."""
    R, P = _vectors(x, "fold_lanes")
    _check(x, (R, L, P), "fold_lanes x")
    _check(y, (R, L, P), "fold_lanes y")
    _check(u, (L, P), "fold_lanes u")
    _check(v, (L, P), "fold_lanes v")
    if x.device.type == "cpu":
        return fold_plain(x, y, u, v)
    for t in (x, y, u, v):
        _cuda.check(t, torch.int64)
    out = torch.empty_like(x)
    if x.numel():
        _cuda.launch("fold", "fold", "bp_fold", x, y, None, None, u, v, None,
                     None, out, None, R, P)
    return out


def fold_pair_plain(a, b, u, uinv, idx, mask):
    m = mask[:, None, None]
    na = fold_plain(a, a.index_select(0, idx), u, uinv)
    nb = fold_plain(b, b.index_select(0, idx), uinv, u)
    return torch.where(m, na, a), torch.where(m, nb, b)


def fold_pair(a: torch.Tensor, b: torch.Tensor, u: torch.Tensor,
              uinv: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor):
    """One IPP round's fold of both vectors, in one launch of kernel K8:
    a, b (R, 9, P), u, uinv (9, P) per-proof scalars, idx (R,) int64 rows
    in [0, R), mask (R,) bool -> (a', b') with a'[j] = u a[j] + u^-1
    a[idx[j]] and b'[j] = u^-1 b[j] + u b[idx[j]] where mask[j], else a[j]
    and b[j].  The maps are read from device memory, so every round of a
    prove launches K8 with the same arguments."""
    R, P = _vectors(a, "fold_pair")
    for t, what in ((a, "a"), (b, "b")):
        _check(t, (R, L, P), f"fold_pair {what}")
    for t, what in ((u, "u"), (uinv, "uinv")):
        _check(t, (L, P), f"fold_pair {what}")
    _check(idx, (R,), "fold_pair idx")
    _check(mask, (R,), "fold_pair mask", torch.bool)
    if a.device.type == "cpu":
        return fold_pair_plain(a, b, u, uinv, idx, mask)
    for t in (a, b, u, uinv, idx):
        _cuda.check(t, torch.int64)
    _cuda.check(mask, torch.bool)
    oa, ob = torch.empty_like(a), torch.empty_like(b)
    if a.numel():
        _cuda.launch("fold", "fold", "bp_fold", a, a, b, b, u, uinv, idx,
                     mask, oa, ob, R, P)
    return oa, ob


# -- K9: smul ----------------------------------------------------------------------

def smul_plain(x, mask, m1, m0) -> torch.Tensor:
    return S.smul_plain(x, torch.where(mask[:, None, None], m1, m0))


def smul_lanes(x: torch.Tensor, mask: torch.Tensor, m1: torch.Tensor,
               m0: torch.Tensor) -> torch.Tensor:
    """x (R, 9, P), mask (R,) bool, m1, m0 (9, P) per-proof scalars ->
    (R, 9, P): row r times m1 where mask[r], else times m0, mod l (kernel
    K9 with one vector)."""
    return _smul(x, None, mask, m1, m0, "smul_lanes")[0]


def smul_pair_plain(x, y, mask, m1, m0):
    return smul_plain(x, mask, m1, m0), smul_plain(y, mask, m0, m1)


def smul_pair(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
              m1: torch.Tensor, m0: torch.Tensor):
    """One IPP round's update of both generator weight vectors, in one
    launch of kernel K9: x, y (R, 9, P), mask (R,) bool, m1, m0 (9, P)
    per-proof scalars -> (x', y') with x'[r] = x[r] (mask[r] ? m1 : m0)
    and y'[r] = y[r] (mask[r] ? m0 : m1) mod l."""
    return _smul(x, y, mask, m1, m0, "smul_pair")


def _smul(x, y, mask, m1, m0, what: str):
    """K9 on x and, unless None, y -> (x', y' or None)."""
    R, P = _vectors(x, what)
    for t, name in ((x, "x"), (y, "y")):
        if t is not None:
            _check(t, (R, L, P), f"{what} {name}")
    for t, name in ((m1, "m1"), (m0, "m0")):
        _check(t, (L, P), f"{what} {name}")
    _check(mask, (R,), f"{what} mask", torch.bool)
    if x.device.type == "cpu":
        return (smul_plain(x, mask, m1, m0),
                None if y is None else smul_plain(y, mask, m0, m1))
    for t in (x, y, m1, m0):
        if t is not None:
            _cuda.check(t, torch.int64)
    _cuda.check(mask, torch.bool)
    ox = torch.empty_like(x)
    oy = None if y is None else torch.empty_like(y)
    if x.numel():
        _cuda.launch("smul", "fold", "bp_smul", x, y, mask, m1, m0, ox, oy,
                     R, P)
    return ox, oy


# -- K10: digits --------------------------------------------------------------------

def digits_plain(x: torch.Tensor) -> torch.Tensor:
    nb, _, q = x.shape
    d = S.signed_digits(S.reduce_top(x.permute(1, 0, 2).reshape(L, nb * q)))
    return d.reshape(64, nb, q).permute(1, 0, 2).reshape(nb * 64, q) \
        .contiguous()


def digits_lanes(x: torch.Tensor) -> torch.Tensor:
    """(nb, 9, Q) or (9, Q) exact limbs (value < 2^261; canonical in the
    port) -> (nb * 64, Q) int8 signed base-16 digits in [-7, 8] of the
    values mod l, row j * 64 + w (the fixed-base tables' stream order; the
    64 windows of one scalar for a (9, Q) input)."""
    if x.dim() == 2:
        x = x[None]
    nb, Q = _vectors(x, "digits_lanes")
    _check(x, (nb, L, Q), "digits_lanes x")
    if x.device.type == "cpu":
        return digits_plain(x)
    _cuda.check(x, torch.int64)
    out = torch.empty((nb * 64, Q), dtype=torch.int8, device=x.device)
    if x.numel():
        _cuda.launch("digits", "fold", "bp_digits", x, out, nb, Q)
    return out
