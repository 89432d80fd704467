"""Batched ristretto255 / edwards25519 point operations on limb tensors,
kernel K1 (batch point decompression) and kernel K5 (batch compression).

Points are (4, 10, N) int32 tensors: extended twisted Edwards coordinates
(X : Y : Z : T) on axis 0, field limbs (ops/limbs.py) on axis 1, the batch
on the last axis -- the JAX package's ops/vec_curve.py layout with the
port's limb radix.  Formulas are add-2008-hwcd-3 / madd-2008-hwcd-3 /
dbl-2008-hwcd for a = -1 as in the JAX package's ops/pallas_math.py, and
csrc/fe25519.cuh repeats them operation for operation, so a kernel's
output equals its plain version's limb for limb.

The coordinate functions (`add`, `madd`, `double`) work on 4-tuples of
int64 (..., 10, N) tensors; `decompress`, `from_uniform_bytes` (hash to the
group, plain PyTorch) and the lane conversions are the public entry
points.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core import field as host_field
from ..device import resolve_device
from . import _cuda
from . import field as F
from .limbs import FE_LIMBS, canonical_mask, fe_from_bytes, fe_ints_to_limbs, \
    fe_limbs_to_ints, fe_to_bytes

L = FE_LIMBS

Coords = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# -- point formulas on coordinate tuples (int64 limbs) ------------------------

def add(p: Coords, q: Coords) -> Coords:
    """Complete unified addition add-2008-hwcd-3 (pallas_math.ed_add)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = F.mul(F.sub(Y1, X1), F.sub(Y2, X2))
    B = F.mul(F.add(Y1, X1), F.add(Y2, X2))
    C = F.mul(F.mul(T1, F.const("d2", T1.device)), T2)
    D = F.mul_small(F.mul(Z1, Z2), 2)
    E, Fv, G, H = F.sub(B, A), F.sub(D, C), F.add(D, C), F.add(B, A)
    return F.mul(E, Fv), F.mul(G, H), F.mul(Fv, G), F.mul(E, H)


def madd(p: Coords, niels: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
         ) -> Coords:
    """Mixed addition of a Z = 1 point in Niels form (Y+X, Y-X, 2dT):
    7 multiplications (msm_pallas._accum_kernel_niels)."""
    X1, Y1, Z1, T1 = p
    ypx, ymx, t2d = niels
    A = F.mul(F.sub(Y1, X1), ymx)
    B = F.mul(F.add(Y1, X1), ypx)
    C = F.mul(T1, t2d)
    D = F.mul_small(Z1, 2)
    E, Fv, G, H = F.sub(B, A), F.sub(D, C), F.add(D, C), F.add(B, A)
    return F.mul(E, Fv), F.mul(G, H), F.mul(Fv, G), F.mul(E, H)


def double(p: Coords) -> Coords:
    """dbl-2008-hwcd for a = -1: 4M + 4S (pallas_math.ed_double)."""
    X1, Y1, Z1, _ = p
    A = F.square(X1)
    B = F.square(Y1)
    C = F.mul_small(F.square(Z1), 2)
    H = F.add(A, B)
    E = F.sub(H, F.square(F.add(X1, Y1)))
    G = F.sub(A, B)
    Fv = F.add(C, G)
    return F.mul(E, Fv), F.mul(G, H), F.mul(Fv, G), F.mul(E, H)


def is_identity(p: Coords) -> torch.Tensor:
    """Ristretto equality with the identity (0 : 1 : 1 : 0): X == 0 or
    Y == 0 (pallas_math.is_identity).  Decoded representatives may carry
    4-torsion, so this is NOT the Edwards identity test."""
    return F.eq_zero(p[0]) | F.eq_zero(p[1])


def identity(n: int, device) -> torch.Tensor:
    """(4, 10, n) int32 identity points."""
    pt = torch.zeros((4, L, n), dtype=torch.int32, device=device)
    pt[1, 0] = 1
    pt[2, 0] = 1
    return pt


def to_coords(pts: torch.Tensor) -> Coords:
    p = pts.to(torch.int64)
    return p[0], p[1], p[2], p[3]


def from_coords(c: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack(list(c)).to(torch.int32)


# -- K1: decompression ---------------------------------------------------------

def decode(s: torch.Tensor):
    """RFC 9496 DECODE of (10, N) int64 limbs -> (valid (N,) bool, coords);
    canonicity of the bytes is checked separately (pallas_math.decompress)."""
    ss = F.square(s)
    one = F.const("one", s.device).expand_as(ss)
    u1 = F.sub(one, ss)
    u2 = F.add(one, ss)
    u2_sqr = F.square(u2)
    v = F.sub(F.neg(F.mul(F.const("d", s.device), F.square(u1))), u2_sqr)
    was_square, invsqrt = F.sqrt_ratio_m1(one, F.mul(v, u2_sqr))
    den_x = F.mul(invsqrt, u2)
    den_y = F.mul(F.mul(invsqrt, den_x), v)
    x = F.ct_abs(F.mul(F.mul_small(s, 2), den_x))
    y = F.mul(u1, den_y)
    t = F.mul(x, y)
    valid = was_square & (F.is_negative(t) == 0) & ~F.eq_zero(y)
    return valid, (x, y, one, t)


def decompress_plain(raw: torch.Tensor):
    """(N, 32) uint8 encodings -> (valid (N,) bool, points (4, 10, N)
    int32).  Valid means canonical bytes AND a successful decode
    (vec_curve.decompress_device)."""
    valid, pt = decode(fe_from_bytes(raw))
    return valid & canonical_mask(raw), from_coords(pt)


def decompress_resident() -> int:
    """Points that K1 holds resident at once on the current CUDA device, a
    thread a point (csrc/decompress.cu): its SMs times the threads an SM
    that cudaOccupancyMaxActiveBlocksPerMultiprocessor allows."""
    out = ctypes.c_int()
    f = _cuda._lib("decompress").bp_decompress_threads_per_sm
    f.argtypes, f.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    err = f(ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count * out.value


def decompress_waves(n: int) -> int:
    """Waves of resident blocks that a K1 launch of n points takes on the
    current CUDA device."""
    return -(-n // decompress_resident())


def decompress(raw: torch.Tensor):
    """Kernel K1 (csrc/decompress.cu) on a CUDA tensor, the plain version
    on a CPU tensor: (N, 32) uint8 -> (valid (N,) bool, points
    (4, 10, N) int32)."""
    if raw.dim() != 2 or raw.shape[1] != 32 or raw.dtype != torch.uint8:
        raise ValueError("decompress takes an (N, 32) uint8 tensor")
    if raw.device.type == "cpu":
        return decompress_plain(raw)
    raw = _cuda.check(raw, torch.uint8)
    n = raw.shape[0]
    valid = torch.empty(n, dtype=torch.uint8, device=raw.device)
    pts = torch.empty((4, L, n), dtype=torch.int32, device=raw.device)
    if n:
        _cuda.launch("decompress", "decompress", "bp_decompress", raw, valid,
                     pts, n)
    return valid.bool(), pts


# -- K5: compression ----------------------------------------------------------------

def encode(p: Coords) -> torch.Tensor:
    """RFC 9496 ENCODE of int64 coordinates -> (10, N) canonical limbs of s
    (vec_curve.compress, pallas_math.compress)."""
    X, Y, Z, T = p
    dev = X.device
    u1 = F.mul(F.add(Z, Y), F.sub(Z, Y))
    u2 = F.mul(X, Y)
    one = F.const("one", dev).expand_as(u1)
    _, invsqrt = F.sqrt_ratio_m1(one, F.mul(u1, F.square(u2)))
    den1 = F.mul(invsqrt, u1)
    den2 = F.mul(invsqrt, u2)
    z_inv = F.mul(F.mul(den1, den2), T)
    ix0 = F.mul(X, F.const("sqrt_m1", dev))
    iy0 = F.mul(Y, F.const("sqrt_m1", dev))
    enchanted = F.mul(den1, F.const("invsqrt_a_minus_d", dev))
    rotate = F.is_negative(F.mul(T, z_inv)) != 0
    x = F.select(rotate, iy0, X)
    y = F.select(rotate, ix0, Y)
    den_inv = F.select(rotate, enchanted, den2)
    y = F.cond_neg(y, F.is_negative(F.mul(x, z_inv)) != 0)
    return F.canonicalize(F.ct_abs(F.mul(den_inv, F.sub(Z, y))))


def compress_plain(pts: torch.Tensor) -> torch.Tensor:
    """(4, 10, N) int32 points -> (N, 32) uint8 canonical encodings."""
    return fe_to_bytes(encode(to_coords(pts)))


# K5's lanes of a warp a point (its two forms of the field arithmetic):
# ten while a launch has at most COMPRESS_TEN_LANES_UP_TO points (3 a
# warp, ~3.9 warps an SM sub-partition at 6,144), one above.  On an H100
# (PERF.md §6) one lane took ~0.13 ms at every size to 12,288 points,
# one thread's chain of products with most of the card idle; ten lanes
# 0.068 ms at 512 points and 0.086 at 4,608, then their shuffles bound
# them (0.165 at 8,192); 2 and 5 lanes were never the fastest.
COMPRESS_LPS = (1, 10)
COMPRESS_TEN_LANES_UP_TO = 6144


def compress_lanes(n: int) -> int:
    """K5's lanes a point for a launch of n points."""
    return 10 if n <= COMPRESS_TEN_LANES_UP_TO else 1


def compress(pts: torch.Tensor) -> torch.Tensor:
    """Kernel K5 (csrc/compress.cu) on a CUDA tensor, the plain version on
    a CPU tensor: (4, 10, N) int32 points -> (N, 32) uint8 encodings."""
    if pts.dim() != 3 or pts.shape[:2] != (4, L) or pts.dtype != torch.int32:
        raise ValueError("compress takes a (4, 10, N) int32 tensor")
    if pts.device.type == "cpu":
        return compress_plain(pts)
    return _compress_kernel(pts, compress_lanes(pts.shape[-1]))


def _compress_kernel(pts: torch.Tensor, lp: int) -> torch.Tensor:
    """K5 at `lp` lanes a point (one of COMPRESS_LPS; the benches time
    both)."""
    pts = _cuda.check(pts, torch.int32)
    n = pts.shape[-1]
    out = torch.empty((n, 32), dtype=torch.uint8, device=pts.device)
    if n:
        _cuda.launch("compress", "compress", "bp_compress", pts, out, n, lp)
    return out


# -- hash to the group (RFC 9496 MAP) ----------------------------------------------

def elligator_map(t: torch.Tensor) -> Coords:
    """RFC 9496 MAP of (10, N) int64 limbs -> int64 coordinates, one half
    of from_uniform_bytes (vec_curve.elligator_map, step for step)."""
    dev = t.device
    one = F.const("one", dev).expand_as(t)
    d = F.const("d", dev)
    r = F.mul(F.mul(F.const("sqrt_m1", dev), t), t)
    u = F.mul(F.add(r, one), F.const("one_minus_d_sq", dev))
    v = F.mul(F.sub(F.neg(one), F.mul(r, d)), F.add(r, d))
    was_square, s = F.sqrt_ratio_m1(u, v)
    s_prime = F.neg(F.ct_abs(F.mul(s, t)))
    s = F.select(was_square, s, s_prime)
    c = F.select(was_square, F.neg(one), r)
    n = F.sub(F.mul(F.mul(c, F.sub(r, one)), F.const("d_minus_one_sq", dev)),
              v)
    w0 = F.mul(F.mul_small(s, 2), v)
    w1 = F.mul(n, F.const("sqrt_ad_minus_one", dev))
    w2 = F.sub(one, F.square(s))
    w3 = F.add(one, F.square(s))
    return F.mul(w0, w3), F.mul(w2, w1), F.mul(w1, w3), F.mul(w0, w2)


def from_uniform_bytes(raw, device="cuda") -> torch.Tensor:
    """(N, 64) uint8 (a tensor or a numpy array) -> (4, 10, N) int32 points
    MAP(lo) + MAP(hi) on `device` (vec_curve.from_uniform_bytes; dalek's
    RistrettoPoint::from_uniform_bytes).  Bit 255 of each 32-byte half is
    dropped.  Plain PyTorch on either device: the JAX package runs it in
    XLA, not in a Pallas kernel."""
    raw = torch.as_tensor(raw)
    if raw.dim() != 2 or raw.shape[1] != 64 or raw.dtype != torch.uint8:
        raise ValueError("from_uniform_bytes takes an (N, 64) uint8 array")
    raw = raw.to(resolve_device(device))
    lo, hi = (elligator_map(fe_from_bytes(raw[:, k: k + 32]))
              for k in (0, 32))
    return from_coords(add(lo, hi))


def to_niels(pts: torch.Tensor) -> torch.Tensor:
    """(4, 10, N) Z = 1 points -> (3, 10, N) int32 Niels form
    (Y+X, Y-X, 2dT) (msm_pallas.to_niels_lanes).  Plain torch on either
    device: it is XLA glue in the JAX package, not a Pallas kernel."""
    X, Y, _, T = to_coords(pts)
    return torch.stack([F.add(Y, X), F.sub(Y, X),
                        F.mul(T, F.const("d2", T.device))]).to(torch.int32)


# -- host conversions ------------------------------------------------------------

def points_to_lanes(points) -> np.ndarray:
    """Host RistrettoPoints -> (4, 10, N) int32 canonical limbs."""
    vals = [c for p in points for c in (p.X, p.Y, p.Z, p.T)]
    arr = fe_ints_to_limbs(vals).reshape(L, len(points), 4)
    return np.ascontiguousarray(arr.transpose(2, 0, 1)).astype(np.int32)


def lanes_to_points(arr) -> List:
    """(4, 10, N) limbs -> host RistrettoPoints."""
    from ..core.ristretto import RistrettoPoint
    arr = np.asarray(arr, np.int64)
    n = arr.shape[-1]
    coords = [fe_limbs_to_ints(arr[c]) for c in range(4)]
    return [RistrettoPoint(coords[0][i], coords[1][i], coords[2][i],
                           coords[3][i]) for i in range(n)]


def normalized(points) -> List:
    """The same host points with Z = 1 (a change of representation)."""
    P = host_field.P
    out = []
    for p in points:
        zi = pow(p.Z, P - 2, P)
        x, y = p.X * zi % P, p.Y * zi % P
        out.append(type(p)(x, y, 1, x * y % P))
    return out
