"""ChaCha20 (RFC 8439) keystream on the device, for the batch prover's
blinding draws (the JAX package's ops/chacha.py).

The prover needs 4 + 2N secret scalars per proof (the a/s blindings, the
t-polynomial blindings and the s_L / s_R vectors).  The host draws one
256-bit key per half-batch from the caller's rng; the device expands it,
one 64-byte keystream block (counter = draw index, nonce 0) per scalar,
reduced mod l (`ops/scalar.from_wide_bytes`).  Same key, same blocks and
same reduction as the JAX package, so the same rng bytes give the same
scalars.

`random_scalars` is kernel K20 (csrc/scalar.cu chacha_scalars: a thread
a draw makes its block from the key, passed as launch arguments, and
reduces it mod l) on a CUDA device, `random_scalars_plain` on the CPU:
`keystream_blocks` in plain PyTorch, then `scalar.from_wide_bytes_plain`.
The JAX package runs this as XLA vector code, not as a Pallas kernel.
In the plain version the 32-bit words live in int64 tensors and every
add and rotate is masked back to 32 bits, because torch's uint32 lacks
shifts.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
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


def _key_words(key: bytes, n: int):
    """The key's 8 little-endian words, after checking the key and the
    block count."""
    if len(key) != 32:
        raise ValueError("ChaCha20 takes a 32-byte key")
    if n > 1 << 32:
        raise ValueError("at most 2^32 blocks per key")
    return [int(w) for w in np.frombuffer(key, dtype="<u4")]


def keystream_blocks(key: bytes, n: int, device) -> torch.Tensor:
    """32-byte key -> (n, 64) uint8 keystream blocks with nonce 0 and block
    counters 0 .. n - 1 (chacha._keystream_blocks)."""
    words = _key_words(key, n)
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


def random_scalars_plain(key: bytes, n: int, device) -> torch.Tensor:
    return S.from_wide_bytes_plain(keystream_blocks(key, n, device))


def random_scalars(key: bytes, n: int, device) -> torch.Tensor:
    """32-byte key -> (9, n) canonical scalars mod l, each reduced from one
    512-bit keystream block (chacha.random_scalars): kernel K20 on a CUDA
    device, one launch."""
    device = torch.device(device)
    if device.type == "cpu":
        return random_scalars_plain(key, n, device)
    words = _key_words(key, n)
    out = torch.empty((S.L, n), dtype=torch.int64, device=device)
    if n:
        _cuda.launch("chacha_scalars", "scalar", "bp_chacha_scalars", None,
                     0, 0, *words, out, n)
    return out
