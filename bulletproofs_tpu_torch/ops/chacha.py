"""ChaCha20 (RFC 8439) keystream on the device, for the batch prover's
blinding draws (the JAX package's ops/chacha.py).

The prover needs 4 + 2N secret scalars per proof (the a/s blindings, the
t-polynomial blindings and the s_L / s_R vectors).  The host draws one
256-bit key per half-batch from the caller's rng; the device expands it,
one 64-byte keystream block (counter = draw index, nonce 0) per scalar,
reduced mod l (`ops/scalar.from_wide_bytes`).  Same key, same blocks and
same reduction as the JAX package, so the same rng bytes give the same
scalars.

Plain PyTorch: the JAX package runs this as XLA vector code, not as a
Pallas kernel.  The 32-bit words live in int64 tensors and every add and
rotate is masked back to 32 bits, because torch's uint32 lacks shifts.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scalar as S

_MASK = 0xFFFFFFFF
_SIGMA = [int(w) for w in np.frombuffer(b"expand 32-byte k", dtype="<u4")]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def _quarter(x, a, b, c, d):
    x[a] = (x[a] + x[b]) & _MASK
    x[d] = _rotl(x[d] ^ x[a], 16)
    x[c] = (x[c] + x[d]) & _MASK
    x[b] = _rotl(x[b] ^ x[c], 12)
    x[a] = (x[a] + x[b]) & _MASK
    x[d] = _rotl(x[d] ^ x[a], 8)
    x[c] = (x[c] + x[d]) & _MASK
    x[b] = _rotl(x[b] ^ x[c], 7)


def keystream_blocks(key: bytes, n: int, device) -> torch.Tensor:
    """32-byte key -> (n, 64) uint8 keystream blocks with nonce 0 and block
    counters 0 .. n - 1 (chacha._keystream_blocks)."""
    if len(key) != 32:
        raise ValueError("ChaCha20 takes a 32-byte key")
    if n > 1 << 32:
        raise ValueError("at most 2^32 blocks per key")
    words = [int(w) for w in np.frombuffer(key, dtype="<u4")]
    ctr = torch.arange(n, dtype=torch.int64, device=device)
    init = ([torch.full_like(ctr, w) for w in _SIGMA + words] + [ctr]
            + [torch.zeros_like(ctr)] * 3)
    x = list(init)
    for _ in range(10):                              # 20 rounds
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    out = (torch.stack(x) + torch.stack(init)) & _MASK          # (16, n)
    # little-endian words: byte 4w + k of a block is byte k of word w
    by = torch.stack([(out >> (8 * k)) & 255 for k in range(4)], dim=1)
    return by.reshape(64, n).T.to(torch.uint8).contiguous()


def random_scalars(key: bytes, n: int, device) -> torch.Tensor:
    """32-byte key -> (9, n) canonical scalars mod l, each reduced from one
    512-bit keystream block (chacha.random_scalars)."""
    return S.from_wide_bytes(keystream_blocks(key, n, device))
