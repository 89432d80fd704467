"""MSM sharded over a mesh of devices (the JAX package's
parallel/sharded_msm.py).

The points are split along the point axis into one contiguous shard per
device; each device runs the whole Pippenger MSM on its shard
(ops/msm.msm_lanes: kernels K10, K11 with its binning launch, K4a, K4b, or
their plain versions on the CPU); the per-device partial points (group
elements, not summable limb-wise) are gathered to the first device and
folded there in device order by complete Edwards additions.  That is one
(4, 10, 1) point moved per device, the JAX package's all-gather.

One process drives every device of the mesh (a single controller, like a
JAX mesh): every shard is queued, each on its own device's current stream,
before any partial is gathered, so the cards run at the same time, and
nothing here waits for a card.  A mesh may name one device more than once
(virtual shards: the shards then run one after another on that device),
and `make_mesh(n, device="cpu")` gives a mesh of n CPU entries, the
counterpart of the JAX package's virtual CPU devices.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.scalar import L as ELL, Scalar
from ..device import resolve_device
from ..ops import curve as C
from ..ops import msm as M


class Mesh:
    """Devices along one named axis (the JAX package's one-axis
    jax.sharding.Mesh): `devices` (a tuple of torch.device), `axis` and
    `size`."""

    def __init__(self, devices: Sequence, axis: str = "points"):
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis!r})")


def make_mesh(n_devices: Optional[int] = None, axis: str = "points",
              device="cuda") -> Mesh:
    """The first `n_devices` visible cards (all of them by default) as a
    mesh; raises when fewer are present.  device="cpu" gives n_devices
    (default 1) entries of the CPU, a virtual mesh."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh([dev] * (1 if n_devices is None else n_devices), axis)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh: {n} cards asked for, {count} present")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def _on(dev: torch.device):
    """`dev` as the current CUDA device inside the block (nothing on the
    CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _scalar_bytes(scalars, n: int) -> np.ndarray:
    """Ints or Scalars, or (N, 32 | 33) uint8 little-endian rows (the 33rd
    byte, the JAX package's digit carry, is zero) -> (N, 32) uint8."""
    if isinstance(scalars, np.ndarray):
        if scalars.dtype != np.uint8 or scalars.ndim != 2 \
                or scalars.shape[1] not in (32, 33):
            raise ValueError("scalar rows must be (N, 32 | 33) uint8")
        sb = scalars[:, :32]
    else:
        sb = np.frombuffer(b"".join(
            ((s.v if isinstance(s, Scalar) else int(s)) % ELL)
            .to_bytes(32, "little") for s in scalars),
            np.uint8).reshape(-1, 32)
    if sb.shape[0] != n:
        raise ValueError(f"{sb.shape[0]} scalars for {n} points")
    return sb


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A tensor onto `dev` without waiting for a card: a host source goes
    through pinned memory."""
    if t.device == dev:
        return t
    if t.device.type == "cpu" and dev.type == "cuda":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def sharded_msm_lanes(points: torch.Tensor, scalars, mesh: Mesh
                      ) -> torch.Tensor:
    """sum_k s_k P_k over `mesh`: points (4, 10, N) int32 of any Z on any
    device, scalars a list of ints (or Scalars) or (N, 32 | 33) uint8
    numpy rows -> (4, 10, 1) int32 on mesh.devices[0].

    N is padded to size * shard with identity points and zero scalars
    (their digits are 0: they touch no bucket); shard i (points
    [i * shard, (i + 1) * shard)) goes to devices[i] and runs msm_lanes
    there under that device; the partials are gathered to devices[0] and
    folded in device order."""
    if points.dim() != 3 or points.shape[:2] != (4, C.L):
        raise ValueError("sharded_msm_lanes takes (4, 10, N) points")
    n = points.shape[-1]
    sb = _scalar_bytes(scalars, n)
    shard = max(1, -(-n // mesh.size))
    pad = mesh.size * shard - n
    if pad:
        points = torch.cat([points, C.identity(pad, points.device)], dim=-1)
        sb = np.concatenate([sb, np.zeros((pad, 32), np.uint8)])
    sc = torch.from_numpy(np.array(sb))
    partials = []
    for i, dev in enumerate(mesh.devices):
        lo, hi = i * shard, (i + 1) * shard
        with _on(dev):
            partials.append(M.msm_lanes(
                _to(points[..., lo:hi].contiguous(), dev),
                _to(sc[lo:hi], dev)))
    home = mesh.devices[0]
    acc = C.to_coords(partials[0])
    with _on(home):
        for part in partials[1:]:
            acc = C.add(acc, C.to_coords(_to(part, home)))
    return C.from_coords(acc)
