"""Batched Keccak-f[1600]: P independent sponge states on the last axis,
kernel K13 (csrc/keccak.cu) and its plain PyTorch version.

The JAX package's ops/keccak_device.py.  The permutation is the one under
the Merlin / STROBE-128 transcript (utils/strobe.py, utils/keccak.py); the
batch prover runs one transcript per proof, so the byte-oriented sponge is
lane-parallel: the device transcript (ops/transcript_device.py) keeps the
(200, P) uint8 states on the card and permutes them all at once.

* `f1600_words_plain` is the JAX package's `f1600_words`: (50, ...) words
  of 32 bits (held in int64), lane i = words (2i low, 2i + 1 high), little
  endian.  It is vectorised over the 25 lanes (about 30 tensor ops a round)
  rather than written lane by lane.
* `f1600_state_bytes` is the kernel's wrapper on the (200, P) uint8 states,
  with the device transcript's pending pad XORed in first when given: K13
  for a CUDA tensor, the plain version for a CPU tensor.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import _cuda

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets for lane (x, y), lane index x + 5y
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_M32 = 0xFFFFFFFF


@lru_cache(maxsize=None)
def _tables(device: torch.device):
    """Per-lane rotation (25, 1), the pi gather (lane d <- lane src[d]) and
    the round constants' (low, high) words, on `device`."""
    rot = [0] * 25
    src = [0] * 25
    for x in range(5):
        for y in range(5):
            rot[x + 5 * y] = _ROT[x][y]
            src[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
    return (t(rot)[:, None], t(src), t([c & _M32 for c in _RC]),
            t([c >> 32 for c in _RC]))


def _rotl(lo, hi, r):
    """64-bit rotate left of (lo, hi) word pairs by r in [0, 64): a per-lane
    (25, 1) tensor or an int."""
    if isinstance(r, int):
        if r >= 32:
            lo, hi = hi, lo
    else:
        lo, hi = torch.where(r >= 32, hi, lo), torch.where(r >= 32, lo, hi)
    s = r % 32
    return (((lo << s) | (hi >> (32 - s))) & _M32,
            ((hi << s) | (lo >> (32 - s))) & _M32)


def f1600_words_plain(words: torch.Tensor) -> torch.Tensor:
    """(50, ...) int64 words (values < 2^32) -> the permuted words."""
    shape = words.shape
    w = words.reshape(25, 2, -1)
    lo, hi = w[:, 0], w[:, 1]                            # (25, P), lane x + 5y
    rot, src, rc_lo, rc_hi = _tables(words.device)
    for rnd in range(24):
        # theta: c[x] = xor over y; a[x, y] ^= c[x - 1] ^ rotl(c[x + 1], 1)
        c_lo = lo.reshape(5, 5, -1)
        c_hi = hi.reshape(5, 5, -1)
        c_lo = c_lo[0] ^ c_lo[1] ^ c_lo[2] ^ c_lo[3] ^ c_lo[4]
        c_hi = c_hi[0] ^ c_hi[1] ^ c_hi[2] ^ c_hi[3] ^ c_hi[4]
        r_lo, r_hi = _rotl(c_lo.roll(-1, 0), c_hi.roll(-1, 0), 1)
        d_lo = c_lo.roll(1, 0) ^ r_lo
        d_hi = c_hi.roll(1, 0) ^ r_hi
        lo = (lo.reshape(5, 5, -1) ^ d_lo).reshape(25, -1)
        hi = (hi.reshape(5, 5, -1) ^ d_hi).reshape(25, -1)
        # rho and pi
        lo, hi = _rotl(lo, hi, rot)
        b_lo = lo[src].reshape(5, 5, -1)
        b_hi = hi[src].reshape(5, 5, -1)
        # chi, on rows of fixed y
        lo = (b_lo ^ (~b_lo.roll(-1, 1) & b_lo.roll(-2, 1))).reshape(25, -1)
        hi = (b_hi ^ (~b_hi.roll(-1, 1) & b_hi.roll(-2, 1))).reshape(25, -1)
        # iota
        lo = torch.cat([lo[:1] ^ rc_lo[rnd], lo[1:]])
        hi = torch.cat([hi[:1] ^ rc_hi[rnd], hi[1:]])
    return torch.stack([lo, hi], dim=1).reshape(shape)


def bytes_to_words(st: torch.Tensor) -> torch.Tensor:
    """(200, ...) uint8 little-endian state -> (50, ...) int64 words."""
    b = st.to(torch.int64).reshape((50, 4) + st.shape[1:])
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """(50, ...) int64 words -> (200, ...) uint8 little-endian."""
    parts = torch.stack([(w >> (8 * k)) & 255 for k in range(4)], dim=1)
    return parts.reshape((200,) + w.shape[1:]).to(torch.uint8)


def f1600_state_bytes_plain(st: torch.Tensor,
                            pad: torch.Tensor = None) -> torch.Tensor:
    if pad is not None:
        st = st ^ pad
    return words_to_bytes(f1600_words_plain(bytes_to_words(st)))


def f1600_state_bytes(st: torch.Tensor, pad: torch.Tensor = None
                      ) -> torch.Tensor:
    """(200, P) uint8 states, and optionally a (200, 1) uint8 pad XORed
    into every state first -> (200, P) uint8 permuted states, a new
    tensor: kernel K13 (one launch, the pad included) on a CUDA tensor,
    the plain version on a CPU tensor."""
    if st.dim() != 2 or st.shape[0] != 200 or st.dtype != torch.uint8:
        raise ValueError("f1600_state_bytes takes a (200, P) uint8 tensor")
    if pad is not None and (tuple(pad.shape) != (200, 1)
                            or pad.dtype != torch.uint8):
        raise ValueError("f1600_state_bytes takes a (200, 1) uint8 pad")
    if st.device.type == "cpu":
        return f1600_state_bytes_plain(st, pad)
    st = _cuda.check(st, torch.uint8)
    if pad is not None:
        _cuda.check(pad, torch.uint8)
    out = torch.empty_like(st)
    if st.shape[1]:
        _cuda.launch("keccak_f1600", "keccak", "bp_keccak_f1600", st, pad,
                     out, st.shape[1])
    return out
