"""Keccak-f[1600] of the PyTorch port (ops/keccak_device.py, the plain
version of kernel K13) against the JAX package's ops/keccak_device
f1600_words and the port's host permutation utils/keccak.f1600_state, on
seeded random states, with and without the device transcript's pad; and
the byte <-> word codecs.  Exact (bitwise)."""

import numpy as np
import pytest
import torch

from bulletproofs_tpu.ops import keccak_device as JK

from bulletproofs_tpu_torch.ops import keccak_device as K
from bulletproofs_tpu_torch.utils.keccak import f1600_state


def _states(p, seed):
    st = np.random.default_rng(seed).integers(0, 256, (200, p)).astype(np.uint8)
    st[:, 0] = 0                                  # the all-zero state too
    return st


@pytest.mark.parametrize("p, seed", [(1, 91), (7, 92), (64, 93)])
def test_plain_words_match_jax(p, seed):
    st = _states(p, seed)
    words = np.asarray(JK.bytes_to_words(st))
    want = np.asarray(JK.f1600_words(words)).astype(np.int64)
    got = K.f1600_words_plain(torch.as_tensor(words.astype(np.int64)))
    assert np.array_equal(got.numpy(), want)


def test_state_bytes_match_host_permutation():
    st = _states(9, 94)
    got = K.f1600_state_bytes(torch.as_tensor(st)).numpy()
    for p in range(st.shape[1]):
        assert got[:, p].tobytes() == f1600_state(st[:, p].tobytes())


def test_repeated_permutation_matches_host():
    """24 rounds applied three times over (a sponge's chain of calls)."""
    st = torch.as_tensor(_states(3, 95))
    host = [st[:, p].numpy().tobytes() for p in range(3)]
    for _ in range(3):
        st = K.f1600_state_bytes(st)
        host = [f1600_state(h) for h in host]
    assert [st[:, p].numpy().tobytes() for p in range(3)] == host


def test_bytes_words_round_trip_and_jax_layout():
    st = _states(5, 96)
    words = K.bytes_to_words(torch.as_tensor(st))
    assert words.shape == (50, 5) and words.dtype == torch.int64
    assert np.array_equal(words.numpy(),
                          np.asarray(JK.bytes_to_words(st)).astype(np.int64))
    assert np.array_equal(K.words_to_bytes(words).numpy(), st)


def _pad(seed):
    """A transcript's pending pad: constant bytes at a few positions and
    the permutation's padding (0x04 after the data, 0x80 at 167)."""
    pad = np.zeros((200, 1), np.uint8)
    r = np.random.default_rng(seed)
    pos = int(r.integers(0, 165))
    pad[:pos, 0] = r.integers(0, 256, pos)
    pad[pos + 1, 0] ^= 0x04
    pad[167, 0] ^= 0x80
    return pad


@pytest.mark.parametrize("p, seed", [(1, 81), (7, 82), (33, 83)])
def test_padded_permutation_matches_jax_and_host(p, seed):
    """f1600_state_bytes(st, pad) = the JAX package's f1600_words of
    st ^ pad (the XOR its DeviceStrobe makes before each permutation) and
    the host permutation of each padded state."""
    st, pad = _states(p, seed), _pad(seed)
    got = K.f1600_state_bytes(torch.as_tensor(st), torch.as_tensor(pad))
    words = np.asarray(JK.bytes_to_words(st ^ pad))
    want = np.asarray(JK.words_to_bytes(JK.f1600_words(words)))
    assert np.array_equal(got.numpy(), want)
    for q in range(p):
        assert got[:, q].numpy().tobytes() == f1600_state(
            (st[:, q] ^ pad[:, 0]).tobytes())
    assert np.array_equal(got.numpy(), K.f1600_state_bytes_plain(
        torch.as_tensor(st ^ pad)).numpy())


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        K.f1600_state_bytes(torch.zeros((199, 3), dtype=torch.uint8))
    with pytest.raises(ValueError):
        K.f1600_state_bytes(torch.zeros((200, 3), dtype=torch.int64))
    st = torch.zeros((200, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        K.f1600_state_bytes(st, torch.zeros((200,), dtype=torch.uint8))
    with pytest.raises(ValueError):
        K.f1600_state_bytes(st, torch.zeros((200, 1), dtype=torch.int32))
