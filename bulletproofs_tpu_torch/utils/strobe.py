"""STROBE-128 duplex construction, as used by the Merlin transcript.

Semantics match the `merlin` crate's internal mini-STROBE
(merlin v2 `src/strobe.rs`; the reference pulls it in at
dalek-bulletproofs/Cargo.toml:31).  Only the operations Merlin needs are
implemented: meta-AD, AD, PRF, KEY, plus deep-cloning (the reference's
MPC dealer clones the transcript for self-verification,
dalek-bulletproofs/src/range_proof/dealer.rs:69).
"""

from __future__ import annotations

from .keccak import f1600_state

STROBE_R = 166  # security 128: R = 200 - 128/4 - 2

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class PyStrobe128:
    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes = None, _clone: "PyStrobe128" = None):
        if _clone is not None:
            self.state = bytearray(_clone.state)
            self.pos = _clone.pos
            self.pos_begin = _clone.pos_begin
            self.cur_flags = _clone.cur_flags
            return
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        self.state = bytearray(f1600_state(bytes(st)))
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def clone(self) -> "PyStrobe128":
        return PyStrobe128(_clone=self)

    # -- internals ----------------------------------------------------------
    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        self.state = bytearray(f1600_state(bytes(self.state)))
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if self.cur_flags != flags:
                raise ValueError("STROBE op continuation changed flags")
            return
        if flags & FLAG_T:
            raise NotImplementedError("STROBE transport ops unsupported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (FLAG_C | FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # -- public ops ---------------------------------------------------------
    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)


# ---------------------------------------------------------------------------
# Native backend (native/transcript.cpp via ctypes): same semantics, C speed.
# Transcript replay is per-proof work in batched verification, so this is a
# host-path hot spot (SURVEY.md §2b: merlin is "host-side ... bit-exact").
# ---------------------------------------------------------------------------

def _load_native():
    import ctypes
    from ..core import _native as _core_native  # builds the port's .so if absent
    lib = _core_native.LIB
    if lib is None:
        return None
    for name in ("strobe_init", "strobe_meta_ad", "strobe_ad", "strobe_prf",
                 "strobe_key"):
        getattr(lib, name).restype = None
    lib.strobe_append_many.restype = None
    lib.strobe_append_many.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64]
    return lib


_NATIVE = _load_native()


class CStrobe128:
    """ctypes binding to the C++ STROBE-128 (state blob: 200B + 3 counters)."""

    __slots__ = ("buf",)
    _SIZE = 208  # sizeof(Strobe) with alignment padding
    _INIT_CACHE: dict = {}   # protocol label -> post-init state blob (the
    # init Keccak-f is identical for every transcript with the same
    # protocol label; batched verification creates thousands)

    def __init__(self, protocol_label: bytes = None, _clone: "CStrobe128" = None):
        import ctypes
        if _clone is not None:
            self.buf = ctypes.create_string_buffer(_clone.buf.raw, self._SIZE)
            return
        cached = self._INIT_CACHE.get(protocol_label)
        if cached is None:
            self.buf = ctypes.create_string_buffer(self._SIZE)
            _NATIVE.strobe_init(self.buf, protocol_label, len(protocol_label))
            self._INIT_CACHE[protocol_label] = self.buf.raw
        else:
            self.buf = ctypes.create_string_buffer(cached, self._SIZE)

    def clone(self) -> "CStrobe128":
        return CStrobe128(_clone=self)

    def meta_ad(self, data: bytes, more: bool) -> None:
        _NATIVE.strobe_meta_ad(self.buf, bytes(data), len(data), int(more))

    def ad(self, data: bytes, more: bool) -> None:
        _NATIVE.strobe_ad(self.buf, bytes(data), len(data), int(more))

    def prf(self, n: int, more: bool) -> bytes:
        import ctypes
        out = ctypes.create_string_buffer(n)
        _NATIVE.strobe_prf(self.buf, out, n, int(more))
        return out.raw[:n]

    def key(self, data: bytes, more: bool) -> None:
        _NATIVE.strobe_key(self.buf, bytes(data), len(data), int(more))

    def append_many(self, label: bytes, msgs: bytes, msg_len: int,
                    count: int) -> None:
        """`count` Merlin-framed messages of msg_len bytes (one C call;
        byte-identical to count append_message calls)."""
        _NATIVE.strobe_append_many(self.buf, bytes(label), len(label),
                                   bytes(msgs), msg_len, count)


Strobe128 = CStrobe128 if _NATIVE is not None else PyStrobe128
