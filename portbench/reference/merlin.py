"""Merlin transcripts (merlin 2.0: STROBE-128 over Keccak-f[1600]) in
plain Python, and the range proof's transcript protocol, as the
`merlin` and `bulletproofs` crates define them.  The state is kept as the
program keeps it: 200 bytes of sponge, then pos, pos_begin and cur_flags.
"""

from __future__ import annotations

import struct

_M64 = (1 << 64) - 1
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
# rho offsets and pi targets per lane x + 5 y: lane (x, y) moves to
# (y, 2x + 3y) rotated left by its offset
_RHO = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
        41, 45, 15, 21, 8, 18, 2, 61, 56, 14]
_PI = [(x + 5 * y, y + 5 * ((2 * x + 3 * y) % 5))
       for y in range(5) for x in range(5)]


def _round_source() -> str:
    """One Keccak round as straight-line code over locals a0..a24 (theta,
    rho and pi, chi), generated once: a loop over lanes in Python costs
    five times as much."""
    lines = []
    for x in range(5):
        lines.append(f"c{x} = a{x} ^ a{x + 5} ^ a{x + 10} ^ a{x + 15} ^ a{x + 20}")
    for x in range(5):
        c1 = f"c{(x + 1) % 5}"
        lines.append(f"d{x} = c{(x - 1) % 5} ^ ((({c1} << 1) | ({c1} >> 63)) & M)")
    for i in range(25):
        lines.append(f"a{i} ^= d{i % 5}")
    for src, dst in _PI:
        r = _RHO[src]
        lines.append(f"b{dst} = ((a{src} << {r}) | (a{src} >> {64 - r})) & M"
                     if r else f"b{dst} = a{src}")
    for i in range(25):
        row = i - i % 5
        lines.append(f"a{i} = b{i} ^ (~b{row + (i + 1) % 5} & "
                     f"b{row + (i + 2) % 5})")
    lines.append("a0 ^= rc")
    return "\n".join("        " + s for s in lines)


_NAMES = ", ".join(f"a{i}" for i in range(25))
_SOURCE = (f"def keccak_f1600(state):\n"
           f"    {_NAMES} = unpack('<25Q', state)\n"
           f"    for rc in RC:\n{_round_source()}\n"
           f"    return pack('<25Q', {_NAMES})\n")
_NS = {"unpack": struct.unpack, "pack": struct.pack, "RC": _RC, "M": _M64}
exec(compile(_SOURCE, "<keccak_f1600>", "exec"), _NS)
keccak_f1600 = _NS["keccak_f1600"]


_R = 166
_I, _A, _C, _T, _M, _K = 1, 2, 4, 8, 16, 32


class Strobe128:
    """The subset of STROBE-128 that Merlin uses (merlin's strobe.rs)."""

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        self.st = bytearray(keccak_f1600(bytes(st)))
        self.pos = self.pos_begin = self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self):
        self.st[self.pos] ^= self.pos_begin
        self.st[self.pos + 1] ^= 0x04
        self.st[_R + 1] ^= 0x80
        self.st = bytearray(keccak_f1600(bytes(self.st)))
        self.pos = self.pos_begin = 0

    def _absorb(self, data: bytes):
        for byte in data:
            self.st[self.pos] ^= byte
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.st[self.pos]
            self.st[self.pos] = 0
            self.pos += 1
            if self.pos == _R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            if self.cur_flags != flags:
                raise ValueError("continued a STROBE operation with "
                                 "other flags")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & (_C | _K) and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(_M | _A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_I | _A | _C, more)
        return self._squeeze(n)

    def state(self) -> bytes:
        return bytes(self.st) + bytes([self.pos, self.pos_begin,
                                       self.cur_flags])


class Transcript:
    """A Merlin transcript with the range proof's protocol methods
    (bulletproofs' transcript.rs).  `challenge_len` is 64 in the protocol;
    the control of `check.py` draws 32."""

    def __init__(self, label: bytes, challenge_len: int = 64):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.challenge_len = challenge_len
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int):
        self.append_message(label, struct.pack("<Q", x))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", n), True)
        return self.strobe.prf(n, False)

    def challenge_scalar(self, label: bytes, ell: int) -> int:
        raw = self.challenge_bytes(label, self.challenge_len)
        return int.from_bytes(raw, "little") % ell

    def state(self) -> bytes:
        return self.strobe.state()
