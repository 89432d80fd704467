"""Keccak-f[1600] permutation (pure Python) with an optional C++ fast path.

This is the permutation underlying the STROBE-128 sponge used by the Merlin
transcript (reference: the `merlin` crate's internal `keccak::f1600`, see
dalek-bulletproofs/Cargo.toml:31).  It is host-side, sequential, byte-oriented
work -- exactly the kind of thing that stays off the TPU (SURVEY.md §7).

The pure-Python implementation is validated against `hashlib.sha3_256` /
`hashlib.shake_256` by re-building those functions from this permutation
(tests/test_keccak.py).  When the native extension (native/keccak.cpp) has
been built, `f1600` transparently dispatches to it.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

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

# Rotation offsets r[x][y] for lane A[x, y] (lane index = x + 5y).
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rol(v: int, n: int) -> int:
    n &= 63
    if n == 0:
        return v
    return ((v << n) | (v >> (64 - n))) & _MASK


def f1600_py(lanes: list) -> list:
    """Apply Keccak-f[1600] to 25 little-endian 64-bit lanes.

    `lanes[x + 5*y]` is lane A[x, y]. Returns a new list.
    """
    a = list(lanes)
    for rnd in range(24):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi: B[y, (2x+3y) % 5] = rol(A[x, y], r[x][y])
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y] & _MASK)
        # iota
        a[0] ^= _RC[rnd]
    return a


def _state_to_lanes(state: bytes) -> list:
    return [int.from_bytes(state[8 * i: 8 * i + 8], "little") for i in range(25)]


def _lanes_to_state(lanes: list) -> bytes:
    return b"".join(l.to_bytes(8, "little") for l in lanes)


# ---------------------------------------------------------------------------
# Native fast path (ctypes binding to native/keccak.cpp, built by
# native/build.sh / setup at import time if the shared object exists).
# ---------------------------------------------------------------------------
_native = None


def _try_load_native():
    global _native
    if _native is not None:
        return _native
    import ctypes
    from ..core import _native as _core_native  # builds the port's .so if absent
    lib = _core_native.LIB
    if lib is not None:
        lib.keccak_f1600.argtypes = [ctypes.c_char_p]
        lib.keccak_f1600.restype = None
        _native = lib
    else:
        _native = False
    return _native


def f1600_state(state: bytes) -> bytes:
    """Apply Keccak-f[1600] to a 200-byte state (little-endian lanes)."""
    assert len(state) == 200
    lib = _try_load_native()
    if lib:
        import ctypes
        buf = ctypes.create_string_buffer(state, 200)
        lib.keccak_f1600(buf)
        return buf.raw[:200]
    return _lanes_to_state(f1600_py(_state_to_lanes(state)))


class Sponge:
    """Keccak sponge (used for test validation against hashlib only)."""

    def __init__(self, rate_bytes: int, pad_byte: int):
        self.rate = rate_bytes
        self.pad = pad_byte
        self.state = bytearray(200)
        self.buf = bytearray()

    def absorb(self, data: bytes) -> None:
        self.buf += data

    def squeeze(self, n: int) -> bytes:
        buf = self.buf
        # pad10*1 with domain bits
        padded = bytes(buf) + bytes([self.pad]) + b"\x00" * ((-len(buf) - 1) % self.rate)
        padded = padded[:-1] + bytes([padded[-1] | 0x80])
        state = bytes(200)
        for off in range(0, len(padded), self.rate):
            block = padded[off: off + self.rate]
            state = bytes(s ^ b for s, b in zip(state, block + bytes(200 - self.rate)))
            state = f1600_state(state)
        out = b""
        while len(out) < n:
            out += state[: self.rate]
            if len(out) < n:
                state = f1600_state(state)
        return out[:n]
