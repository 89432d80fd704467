"""The port's ChaCha20 blinding draws (bulletproofs_tpu_torch.ops.chacha)
and the wide reduction mod l (ops.scalar.from_wide_bytes), on the CPU,
against RFC 8439, the JAX package's device ChaCha and Python integers.

All comparisons are exact (bytes and canonical scalars); inputs are
seeded numpy draws."""

import ctypes

import numpy as np
import pytest
import torch

import jax
from bulletproofs_tpu.ops import chacha as JCH

from bulletproofs_tpu_torch.core._native import LIB
from bulletproofs_tpu_torch.core.scalar import L as ELL
from bulletproofs_tpu_torch.ops import chacha as CH
from bulletproofs_tpu_torch.ops import scalar as S
from bulletproofs_tpu_torch.ops.limbs import sc_limbs_to_ints, sc_to_bytes


def test_rfc8439_block_vector():
    """RFC 8439 appendix A.1, test vectors #1 and #2: key and nonce all
    zero, block counters 0 and 1."""
    blocks = CH.keystream_blocks(bytes(32), 2, "cpu").numpy()
    assert blocks[0].tobytes().hex() == (
        "76b8e0ada0f13d90405d6ae55386bd28bdd219b8a08ded1aa836efcc8b770dc7"
        "da41597c5157488d7724e03fb8d84a376a43b8f41518a11cc387b669b2ee6586")
    assert blocks[1].tobytes().hex() == (
        "9f07e7be5551387a98ba977c732d080dcb0f29a048e3656912c6533e32ee7aed"
        "29b721769ce64e43d57133b074d839d531ed1f28510afb45ace10a1f4b794d6f")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_scalars_match_jax(seed):
    """1000 draws from one key: the keystream bytes and the reduced
    scalars equal the JAX package's (the JAX scalars are lazy limbs, < 2^256,
    compared mod l)."""
    key = np.random.default_rng(seed).integers(0, 256, 32, np.uint8).tobytes()
    n = 1000
    assert np.array_equal(CH.keystream_blocks(key, n, "cpu").numpy(),
                          np.asarray(JCH.random_wide(key, n)))
    got = sc_limbs_to_ints(CH.random_scalars(key, n, "cpu").numpy())
    jl = np.asarray(jax.device_get(JCH.random_scalars(key, n)), np.int64)
    want = [sum(int(jl[k, i]) << (13 * k) for k in range(jl.shape[0])) % ELL
            for i in range(n)]
    assert got == want
    assert max(got) < ELL


def test_from_wide_bytes_matches_ints_and_host():
    """Against Python `int % l` and the host library's rp_reduce_wide."""
    raw = np.random.default_rng(7).integers(0, 256, (200, 64), np.uint8)
    raw[0] = 255
    raw[1] = 0
    got = sc_limbs_to_ints(S.from_wide_bytes(torch.as_tensor(raw)).numpy())
    assert got == [int.from_bytes(r.tobytes(), "little") % ELL for r in raw]
    out = ctypes.create_string_buffer(32 * len(raw))
    assert LIB.rp_reduce_wide(len(raw), raw.tobytes(), out) == 0
    assert got == [int.from_bytes(out.raw[32 * i: 32 * i + 32], "little")
                   for i in range(len(raw))]


def test_canonical_bytes_and_sequences():
    """power_sequence, tree_sum and the wire bytes (sc_to_bytes) against
    Python ints."""
    g = np.random.default_rng(8)
    ys = [int.from_bytes(g.integers(0, 256, 32, np.uint8).tobytes(),
                         "little") % ELL for _ in range(5)]
    y = S.sreduce(S.from_bytes32(torch.as_tensor(np.frombuffer(
        b"".join(v.to_bytes(32, "little") for v in ys), np.uint8
    ).reshape(5, 32).copy())))
    seq = S.power_sequence(y, 13)
    assert seq.shape == (13, 9, 5)
    for k in range(13):
        assert sc_limbs_to_ints(seq[k].numpy()) == [pow(v, k, ELL) for v in ys]
    assert sc_limbs_to_ints(S.tree_sum(seq).numpy()) == [
        sum(pow(v, k, ELL) for k in range(13)) % ELL for v in ys]
    assert [bytes(r) for r in sc_to_bytes(y).numpy()] == [
        v.to_bytes(32, "little") for v in ys]


def test_key_length_checked():
    with pytest.raises(ValueError):
        CH.keystream_blocks(bytes(31), 1, "cpu")
