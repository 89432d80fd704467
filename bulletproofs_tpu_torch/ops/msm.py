"""Pippenger multi-scalar multiplication: kernels K3 (bucket accumulation
of Z = 1 points in Niels form) and K11 (bucket accumulation of points of
any Z), each a binning (msm_bin_niels / msm_bin: two launches, the lane
lists and rows, then the lanes ranked by length; K3's also makes the
Niels rows of Z = 1 extended points) then one thread per bucket, and K4
(bucket reduction, then the Horner window combine with the ristretto
is-identity flag), csrc/msm.cu.

The JAX package's ops/msm_pallas.py `_msm_pallas_niels` (`msm_niels`) and
`_msm_pallas` (`msm_lanes_flag`) in the port's layout: signed base-16
digits in [-8, 8] over 64 windows (ops/scalar.signed_digits or K10 make
them), 8 buckets per window, `lanes` independent accumulators per window
(`pick_lanes` of the point count).  Point k goes to lane k % lanes; a lane
adds its points in order of k.  Any point count is taken: the plain
versions pad to whole lane steps with identities and zero digits, the
kernels stop at N (the TPU's 512 x 8 padding quantum was a block shape).
Each kernel has its plain PyTorch version here, which a wrapper runs for
CPU tensors; the two agree limb for limb.

The two MSM entries over (N, 32) scalar bytes: `msm_lanes_flag` for
points of any Z (K10, K11, K4a, K4b) and `msm_lanes_niels_flag` for Z = 1
points (K10, K3, K4a, K4b); `normalize_z` takes points of any Z to Z = 1.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _cuda
from . import curve as C
from . import field as F
from . import fold as FO
from . import scalar as S
from .limbs import FE_LIMBS

L = FE_LIMBS
NUM_WINDOWS = 64
NUM_BUCKETS = 8
MAX_LANES = 512


def pick_lanes(n: int) -> int:
    """Accumulators per window: a power of two from 32 to 512, about n / 64
    points per lane (the JAX package used 512 at its verifier's sizes)."""
    lanes = 32
    while lanes < MAX_LANES and lanes * 64 < n:
        lanes *= 2
    return lanes


def _niels_identity(n: int, device) -> torch.Tensor:
    ident = torch.zeros((3, L, n), dtype=torch.int32, device=device)
    ident[0, 0] = 1
    ident[1, 0] = 1
    return ident


# -- K3 / K11: bucket accumulation ---------------------------------------------------

def _accumulate_plain(pts: torch.Tensor, digits: torch.Tensor, pad_pts,
                      add) -> torch.Tensor:
    """The bucket loop of both accumulations: pts (c, 10, N), padded with
    pad_pts(k) to whole lane steps; add(bucket coords, point coords (each
    (64, 10, lanes)), neg (64, 1, lanes)) -> the new bucket coords."""
    n = pts.shape[-1]
    lanes = pick_lanes(n)
    steps = -(-n // lanes)
    pad = steps * lanes - n
    dev = pts.device
    if pad:
        pts = torch.cat([pts, pad_pts(pad, dev)], dim=-1)
        digits = torch.cat([digits, torch.zeros((NUM_WINDOWS, pad),
                                                dtype=digits.dtype,
                                                device=dev)], dim=-1)
    pre = pts.to(torch.int64).reshape(pts.shape[0], L, steps, lanes)
    digs = digits.to(torch.int64).reshape(NUM_WINDOWS, steps, lanes)
    # slot 0 is a sink for digit 0; slots 1..8 are the buckets
    slab = C.identity(1, dev).to(torch.int64).reshape(1, 1, 4, L, 1).expand(
        NUM_WINDOWS, NUM_BUCKETS + 1, 4, L, lanes).contiguous()
    for s in range(steps):
        d = digs[:, s]                                       # (64, lanes)
        neg = (d < 0)[:, None, :]
        q = tuple(pre[c, :, s][None].expand(NUM_WINDOWS, L, lanes)
                  for c in range(pre.shape[0]))
        idx = d.abs()[:, None, None, None, :].expand(NUM_WINDOWS, 1, 4, L,
                                                      lanes)
        cur = slab.gather(1, idx)[:, 0]                      # (64, 4, L, lanes)
        new = torch.stack(add((cur[:, 0], cur[:, 1], cur[:, 2], cur[:, 3]),
                              q, neg), dim=1)
        slab.scatter_(1, idx, new[:, None])
    return slab[:, 1:].to(torch.int32).contiguous()


def _add_niels(cur, q, neg):
    ypx, ymx, t2d = q
    return C.madd(cur, (torch.where(neg, ymx, ypx), torch.where(neg, ypx, ymx),
                        torch.where(neg, -t2d, t2d)))


def _add_extended(cur, q, neg):
    X, Y, Z, T = q
    return C.add(cur, (torch.where(neg, F.neg(X), X), Y, Z,
                       torch.where(neg, F.neg(T), T)))


def accumulate_plain(niels: torch.Tensor,
                     digits: torch.Tensor) -> torch.Tensor:
    """niels (3, 10, N) int32, digits (64, N) int8 -> slab
    (64, 8, 4, 10, pick_lanes(N)) int32 of bucket sums (bucket b holds
    digit magnitude b + 1)."""
    return _accumulate_plain(niels, digits, _niels_identity, _add_niels)


def accumulate(niels: torch.Tensor, digits: torch.Tensor,
               points: torch.Tensor = None) -> torch.Tensor:
    """Kernel K3 on CUDA tensors (its binning, then msm_accumulate: one
    thread per (window, bucket, lane) adds its list of rows into a bucket
    in registers), the plain version on CPU tensors.  With `points`, Z = 1
    points (4, 10, N1) follow the Niels points and the binning puts them
    in Niels form (bin_niels): the sum of cat(niels, to_niels(points))."""
    if points is not None:
        n = _check_two(niels, points, digits)
        if niels.device.type == "cpu":
            return accumulate_plain(_niels_cat(niels, points), digits)
        binned = bin_niels(niels, points, digits)
    else:
        n = _check_points(niels, digits, (3,))
        if niels.device.type == "cpu":
            return accumulate_plain(niels, digits)
        binned = bin_points(niels, digits)
    return _accumulate_binned("msm_accumulate", "bp_msm_accumulate",
                              binned, n, niels.device)


def _accumulate_binned(kernel: str, fn: str, binned, n: int, device):
    lanes = binned[-1].shape[-1]
    slab = torch.empty((NUM_WINDOWS, NUM_BUCKETS, 4, L, lanes),
                       dtype=torch.int32, device=device)
    _cuda.launch(kernel, "msm", fn, *binned, slab, n, lanes)
    return slab


def accumulate_z_plain(points: torch.Tensor,
                       digits: torch.Tensor) -> torch.Tensor:
    """points (4, 10, N) int32 of any Z, digits (64, N) int8 -> slab
    (64, 8, 4, 10, pick_lanes(N)) int32 (accumulate_plain's, by the
    complete addition; a negative digit adds (-X : Y : Z : -T))."""
    return _accumulate_plain(points, digits, C.identity, _add_extended)


# words of a point-major row: a Niels point's 30 padded to 32 (one aligned
# 128-byte line), an extended point's 40
ROW_WORDS = {3: 32, 4: 4 * L}


def _check_points(points: torch.Tensor, digits: torch.Tensor,
                  coords=(3, 4)) -> int:
    n = points.shape[-1]
    if points.dim() != 3 or points.shape[0] not in coords \
            or points.shape[1] != L or digits.shape != (NUM_WINDOWS, n):
        raise ValueError(f"takes points ({' or '.join(map(str, coords))}, "
                         f"10, N) and digits (64, N)")
    return n


def bin_plain(digits: torch.Tensor, lanes: int) -> Tuple[torch.Tensor, ...]:
    """digits (64, N) int8 -> K3's and K11's per-lane bucket lists as bit
    masks over the lane's steps, nm = ceil(N / (32 lanes)) words each: (mask
    (64, 8, nm, lanes), sign (64, nm, lanes), cnt (64, 8, lanes), perm
    (64, 8, lanes)) int32.  Bit s of mask[w, b, m, j] is set when the digit
    of window w of point k = j + (32 m + s) lanes has magnitude b + 1, bit
    s of sign[w, m, j] when that digit is negative; cnt[w, b, j] counts
    bucket b's bits; perm[w, b] lists the lanes by cnt, largest first, ties
    by lane.  Walking a mask's bits in order lists the points of lane j and
    bucket b in ascending k."""
    n = digits.shape[-1]
    nm = -(-n // (32 * lanes))
    d = torch.cat([digits, torch.zeros((NUM_WINDOWS, nm * 32 * lanes - n),
                                       dtype=digits.dtype,
                                       device=digits.device)], dim=-1)
    d = d.to(torch.int64).reshape(NUM_WINDOWS, nm, 32, lanes)
    weight = (1 << torch.arange(32, device=d.device))[:, None]

    def words(bits):                       # (..., 32, lanes) -> int32 words
        v = (bits.to(torch.int64) * weight).sum(-2)
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)

    a = d.abs()
    hits = torch.stack([a == b + 1 for b in range(NUM_BUCKETS)], dim=1)
    cnt = hits.sum((2, 3)).to(torch.int32)
    perm = torch.sort(-cnt, dim=-1, stable=True).indices.to(torch.int32)
    return words(hits), words(d < 0), cnt, perm


def bin_points_plain(points: torch.Tensor, digits: torch.Tensor
                     ) -> Tuple[torch.Tensor, ...]:
    """points (4, 10, N) or Niels points (3, 10, N), digits (64, N) ->
    (rows (N, ROW_WORDS) int32, the points point-major, a Niels row's two
    pad words 0, and bin_plain(digits, pick_lanes(N)))."""
    n = _check_points(points, digits)
    c = points.shape[0]
    rows = torch.zeros((n, ROW_WORDS[c]), dtype=torch.int32,
                       device=points.device)
    rows[:, :c * L] = points.permute(2, 0, 1).reshape(n, c * L)
    return (rows,) + bin_plain(digits, pick_lanes(n))


def bin_points(points: torch.Tensor, digits: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
    """The binning of K3 (msm_bin_niels, for Niels points) or of K11
    (msm_bin) on CUDA tensors, bin_points_plain on CPU tensors."""
    n = _check_points(points, digits)
    if points.device.type == "cpu":
        return bin_points_plain(points, digits)
    if points.shape[0] == 3:
        return _bin("msm_bin_niels", points, None, digits)
    return _bin("msm_bin", None, points, digits)


def _niels_cat(niels: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    return torch.cat([niels, C.to_niels(points)], dim=-1)


def _check_two(niels, points, digits) -> int:
    n0 = _check_points(niels, digits[:, :niels.shape[-1]], (3,))
    n1 = _check_points(points, digits[:, n0:], (4,))
    if digits.shape[-1] != n0 + n1:
        raise ValueError("takes digits (64, N0 + N1) for Niels points "
                         "(3, 10, N0) and points (4, 10, N1)")
    return n0 + n1


def bin_niels_plain(niels: torch.Tensor, points: torch.Tensor,
                    digits: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """bin_points_plain(cat(niels, to_niels(points)), digits)."""
    _check_two(niels, points, digits)
    return bin_points_plain(_niels_cat(niels, points), digits)


def bin_niels(niels: torch.Tensor, points: torch.Tensor,
              digits: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K3's binning of Niels points (3, 10, N0) followed by Z = 1 points
    (4, 10, N1) (either may be empty), digits (64, N0 + N1): on CUDA
    tensors msm_bin_niels, which writes the points' Niels rows itself
    (Y+X, Y-X, 2dT: curve.to_niels' limbs); on CPU tensors
    bin_niels_plain."""
    if niels.device.type == "cpu":
        return bin_niels_plain(niels, points, digits)
    _check_two(niels, points, digits)
    return _bin("msm_bin_niels", niels, points, digits)


def _bin(kernel: str, pre, pts, digits) -> Tuple[torch.Tensor, ...]:
    """The two launches of a binning: the masks and the rows of `pre`
    (Niels points) and `pts` (extended points, in Niels form where `pre`
    is given), then the lanes' counts and ranks."""
    n = digits.shape[-1]
    lanes = pick_lanes(n)
    nm = -(-n // (32 * lanes))
    for t in (pre, pts):
        if t is not None:
            _cuda.check(t, torch.int32)
    _cuda.check(digits, torch.int8)
    dev = digits.device
    rows = torch.empty((n, ROW_WORDS[4 if pre is None else 3]),
                       dtype=torch.int32, device=dev)
    mask = torch.empty((NUM_WINDOWS, NUM_BUCKETS, nm, lanes),
                       dtype=torch.int32, device=dev)
    sign = torch.empty((NUM_WINDOWS, nm, lanes), dtype=torch.int32,
                       device=dev)
    cnt, perm = torch.empty((2, NUM_WINDOWS, NUM_BUCKETS, lanes),
                            dtype=torch.int32, device=dev)
    if n and pre is None:
        _cuda.launch(kernel, "msm", "bp_msm_bin", pts, digits, rows, mask,
                     sign, n, lanes)
    elif n:
        n0 = pre.shape[-1]
        _cuda.launch(kernel, "msm", "bp_msm_bin_niels", pre if n0 else None,
                     n0, pts if pts is not None and n > n0 else None, digits,
                     rows, mask, sign, n, lanes)
    _cuda.launch(kernel, "msm", "bp_msm_rank", mask, cnt, perm, n, lanes)
    return rows, mask, sign, cnt, perm


def accumulate_z(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Kernel K11 on CUDA tensors (msm_bin, then msm_accumulate_z: one
    thread per (window, bucket, lane) adds its list of bin_points rows into
    a bucket in registers), the plain version on CPU tensors."""
    n = _check_points(points, digits, (4,))
    if points.device.type == "cpu":
        return accumulate_z_plain(points, digits)
    return _accumulate_binned("msm_accumulate_z", "bp_msm_accumulate_z",
                              bin_points(points, digits), n, points.device)


def warps_per_sm() -> Dict[str, int]:
    """Warps of K3's, K11's and K4a's kernels that one SM of the current
    CUDA device holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    times the block's warps)."""
    out = (ctypes.c_int * 8)()
    f = _cuda._lib("msm").bp_msm_blocks_per_sm
    f.argtypes, f.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    err = f(out)
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    acc, binned = out[1] // 32, out[3] // 32
    return {"msm_accumulate_z": out[0] * acc, "msm_bin": out[2] * binned,
            "msm_accumulate": out[4] * acc, "msm_bin_niels": out[5] * binned,
            "msm_reduce": out[6] * (out[7] // 32)}


# -- K4: bucket reduction and Horner combine --------------------------------------

def reduce_plain(slab: torch.Tensor) -> torch.Tensor:
    """(64, 8, 4, 10, lanes) -> (64, 8, 4, 10): each bucket's lanes summed
    by a halving tree (lane j + lane j + half at every level)."""
    v = slab.to(torch.int64)
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        a, b = v[..., :h], v[..., h:]
        v = torch.stack(C.add((a[:, :, 0], a[:, :, 1], a[:, :, 2], a[:, :, 3]),
                              (b[:, :, 0], b[:, :, 1], b[:, :, 2], b[:, :, 3])),
                        dim=2)
    return v[..., 0].to(torch.int32).contiguous()


def reduce(slab: torch.Tensor) -> torch.Tensor:
    """Kernel K4a (msm_reduce) on CUDA tensors, the plain version on CPU."""
    lanes = slab.shape[-1]
    if slab.shape[:4] != (NUM_WINDOWS, NUM_BUCKETS, 4, L) or lanes < 2 \
            or lanes & (lanes - 1) or lanes > MAX_LANES:
        raise ValueError("reduce takes a (64, 8, 4, 10, lanes) slab")
    if slab.device.type == "cpu":
        return reduce_plain(slab)
    _cuda.check(slab, torch.int32)
    sums = torch.empty((NUM_WINDOWS, NUM_BUCKETS, 4, L), dtype=torch.int32,
                       device=slab.device)
    _cuda.launch("msm_reduce", "msm", "bp_msm_reduce", slab, sums, lanes)
    return sums


def horner_plain(sums: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(64, 8, 4, 10) bucket sums -> (point (4, 10) int32, flag (1,) bool):
    S_w = sum_b (b + 1) B_b by the double running sum, then
    sum_w 16^w S_w by Horner; the flag is ristretto equality with the
    identity.  K4b makes these operations in this order, so its limbs are
    these."""
    v = sums.to(torch.int64).permute(1, 2, 3, 0)           # (8, 4, 10, 64)
    running = tuple(v[NUM_BUCKETS - 1])                     # (10, 64) each
    total = running
    for b in range(NUM_BUCKETS - 2, -1, -1):
        running = C.add(running, tuple(v[b]))
        total = C.add(total, running)
    acc = tuple(c[:, 63:64] for c in total)                 # (10, 1) each
    for i in range(62, -1, -1):
        for _ in range(4):
            acc = C.double(acc)
        acc = C.add(acc, tuple(c[:, i: i + 1] for c in total))
    flag = C.is_identity(acc)
    return torch.stack([c[:, 0] for c in acc]).to(torch.int32), flag


def horner(sums: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K4b (msm_horner) on CUDA tensors, the plain version on CPU."""
    if sums.shape != (NUM_WINDOWS, NUM_BUCKETS, 4, L):
        raise ValueError("horner takes (64, 8, 4, 10) bucket sums")
    if sums.device.type == "cpu":
        return horner_plain(sums)
    _cuda.check(sums, torch.int32)
    out = torch.empty((4, L), dtype=torch.int32, device=sums.device)
    flag = torch.empty(1, dtype=torch.int32, device=sums.device)
    _cuda.launch("msm_horner", "msm", "bp_msm_horner", sums, out, flag)
    return out, flag.bool()


def msm_niels(niels: torch.Tensor, digits: torch.Tensor,
              points: torch.Tensor = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sum_k digits[:, k] . P_k for Niels points (3, 10, N) and signed
    digits (64, N) int8 -> (point (4, 10) int32, is-identity flag (1,)
    bool), on the device of the inputs.  With `points`, Z = 1 points (4,
    10, N1) follow the Niels points (K3's binning makes their Niels rows)
    and the digits are (64, N + N1)."""
    return horner(reduce(accumulate(niels, digits, points)))


def msm_lanes_flag(points: torch.Tensor, scalars: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sum_k s_k P_k for points (4, 10, N) int32 of any Z and scalars
    (N, 32) uint8 little-endian (any value < 2^256, taken mod l) -> (point
    (4, 10, 1) int32, is-identity flag (1,) bool), on the inputs' device
    (msm_pallas.msm_lanes_flag): digits by K10, then K11, K4a, K4b."""
    if scalars.dim() != 2 or scalars.shape != (points.shape[-1], 32):
        raise ValueError("msm_lanes_flag takes (N, 32) scalar bytes for "
                         "(4, 10, N) points")
    digits = FO.digits_lanes(S.from_bytes32(scalars))
    out, flag = horner(reduce(accumulate_z(points, digits)))
    return out[..., None], flag


def normalize_z(points: torch.Tensor) -> torch.Tensor:
    """(4, 10, N) int32 points of any Z -> the same points with Z = 1 and
    T = xy (msm_pallas.normalize_z), over field.invert.  Plain PyTorch on
    either device: XLA glue in the JAX package, not a Pallas kernel."""
    X, Y, Z, _ = C.to_coords(points)
    zi = F.invert(Z)
    x, y = F.mul(X, zi), F.mul(Y, zi)
    one = F.const("one", points.device).expand_as(x)
    return C.from_coords((x, y, one, F.mul(x, y)))


def msm_lanes_niels_flag(points: torch.Tensor, scalars: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """msm_lanes_flag for points (4, 10, N) int32 that already have Z = 1
    (decompressed points and the generator tables do; normalize_z makes
    others so) by the Niels mixed addition (msm_pallas.msm_lanes_niels_flag):
    digits by K10, then K3 (whose binning makes the Niels rows), K4a, K4b
    -> (point (4, 10, 1) int32, is-identity flag (1,) bool).  The JAX
    function takes device digits (64, N); this one takes (N, 32) uint8
    scalar bytes, as msm_lanes_flag does."""
    if scalars.dim() != 2 or scalars.shape != (points.shape[-1], 32):
        raise ValueError("msm_lanes_niels_flag takes (N, 32) scalar bytes "
                         "for (4, 10, N) points")
    digits = FO.digits_lanes(S.from_bytes32(scalars))
    empty = torch.empty((3, L, 0), dtype=torch.int32, device=points.device)
    out, flag = msm_niels(empty, digits, points)
    return out[..., None], flag


def msm_lanes(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """msm_lanes_flag's point alone, (4, 10, 1) int32."""
    return msm_lanes_flag(points, scalars)[0]


def bytes_tensor(blob: bytes, device) -> torch.Tensor:
    """Packed 32-byte values -> (N, 32) uint8 on `device` (one upload)."""
    raw = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    return raw.reshape(-1, 32).to(device)


def msm(scalars, points, device):
    """Host Scalars and RistrettoPoints -> host RistrettoPoint, by
    msm_lanes_flag on `device` (vec_msm.msm: the same signature order as
    core.ristretto.multiscalar_mul)."""
    from ..core.ristretto import RistrettoPoint
    from ..core.scalar import L as ELL, Scalar
    points = list(points)
    if not points:
        return RistrettoPoint.identity()
    pts = torch.as_tensor(C.points_to_lanes(points)).to(device)
    blob = b"".join(((s.v if isinstance(s, Scalar) else int(s)) % ELL)
                    .to_bytes(32, "little") for s in scalars)
    out = msm_lanes(pts, bytes_tensor(blob, device))
    return C.lanes_to_points(out.cpu().numpy())[0]


def msm_host_auto(scalars, points, device):
    """The MSM of the single-proof verifiers: the host C++ Pippenger below
    a size floor, msm on `device` from it (vec_msm.msm_host_auto).  The
    route depends on the size alone; `device` decides between the kernels
    and their plain versions.  settings.msm_device_floor (None: 2^18 with
    the C++ backend built, 32 without) sets the floor."""
    from ..config import settings
    from ..core._native import LIB
    from ..core.ristretto import multiscalar_mul
    points = list(points)
    floor = settings.msm_device_floor
    if floor is None:
        floor = (1 << 18) if LIB is not None else 32
    if len(points) >= floor:
        return msm(scalars, points, device)
    return multiscalar_mul(scalars, points)
