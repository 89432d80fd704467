"""Merlin / STROBE-128 transcripts on the prover's device, one per proof
(the JAX package's ops/transcript_device.py).

The batch prover runs P transcripts whose data differ by proof but whose
schedule (labels, lengths, order of operations) is the same and known in
advance.  STROBE's position, frame start and flags depend only on that
schedule, so they are Python ints here; the 200-byte duplex states ride
the device as a (200, P) uint8 tensor, and the permutation is kernel K13
(ops/keccak_device.f1600_state_bytes).  Semantics are byte for byte those
of utils/strobe.PyStrobe128 and the merlin crate (domain separators of
reference src/transcript.rs:44-94).

Constant bytes (labels, lengths, frame bytes, the permutation's padding)
are the same for every transcript.  They are XORed into a host-side
200-byte pad and applied just before the next per-transcript operation
(one XOR of a device constant) or inside the next permutation (kernel K13
takes the pad: one launch); each distinct pad is uploaded once per device
and cached, so a prove makes no host-to-device copy (a pageable copy
would wait for the card to drain).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import scalar as S
from .keccak_device import f1600_state_bytes

STROBE_R = 166

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5

_PADS = {}


def _pad_tensor(pad: bytes, device) -> torch.Tensor:
    """(200, 1) uint8 device copy of a 200-byte pad, cached."""
    key = (pad, str(device))
    t = _PADS.get(key)
    if t is None:
        t = _PADS[key] = torch.as_tensor(
            np.frombuffer(pad, np.uint8).reshape(200, 1).copy(), device=device)
    return t


def _u32le(x: int) -> bytes:
    return struct.pack("<I", x)


def _u64le(x: int) -> bytes:
    return struct.pack("<Q", x)


class DeviceStrobe:
    """STROBE-128 over a (200, P) uint8 state with static counters.

    Mirrors utils/strobe.PyStrobe128 operation for operation; `pos`,
    `pos_begin` and `cur_flags` are Python ints, so transcripts can only be
    driven together while their counters agree (the prover enters here
    after the challenge z, where every transcript sits at the same
    counters).  The state passed in is copied, never written."""

    __slots__ = ("_st", "pos", "pos_begin", "cur_flags", "_pad")

    def __init__(self, state: torch.Tensor, pos: int, pos_begin: int,
                 cur_flags: int):
        if state.dim() != 2 or state.shape[0] != 200 \
                or state.dtype != torch.uint8:
            raise ValueError("DeviceStrobe takes a (200, P) uint8 state")
        self._st = state.clone()
        self.pos = int(pos)
        self.pos_begin = int(pos_begin)
        self.cur_flags = int(cur_flags)
        self._pad = bytearray(200)

    # -- internals -------------------------------------------------------------
    def _flush(self) -> None:
        """Apply the pending constant bytes to every transcript."""
        if any(self._pad):
            self._st ^= _pad_tensor(bytes(self._pad), self._st.device)
            self._pad = bytearray(200)

    def _run_f(self) -> None:
        """Pad and permute: the pending pad goes into the permutation's
        one launch (kernel K13 XORs it in before round 0)."""
        self._pad[self.pos] ^= self.pos_begin
        self._pad[self.pos + 1] ^= 0x04
        self._pad[STROBE_R + 1] ^= 0x80
        pad = _pad_tensor(bytes(self._pad), self._st.device)
        self._pad = bytearray(200)
        self._st = f1600_state_bytes(self._st, pad)
        self.pos = 0
        self.pos_begin = 0

    def _absorb_const(self, data: bytes) -> None:
        for byte in data:
            self._pad[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _absorb_rows(self, rows: torch.Tensor, overwrite: bool) -> None:
        """XOR (or overwrite) per-transcript data, rows (k, P) uint8."""
        self._flush()
        k, i = rows.shape[0], 0
        while i < k:
            take = min(k - i, STROBE_R - self.pos)
            dst = self._st[self.pos: self.pos + take]
            if overwrite:
                dst.copy_(rows[i: i + take])
            else:
                dst ^= rows[i: i + take]
            self.pos += take
            i += take
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> torch.Tensor:
        """-> (n, P) uint8 PRF output (the squeezed bytes zeroed in the
        state)."""
        self._flush()
        out, got = [], 0
        while got < n:
            take = min(n - got, STROBE_R - self.pos)
            dst = self._st[self.pos: self.pos + take]
            out.append(dst.clone())
            dst.zero_()
            self.pos += take
            got += take
            if self.pos == STROBE_R:
                self._run_f()
        return out[0] if len(out) == 1 else torch.cat(out)

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
        self._absorb_const(bytes([old_begin, flags]))
        if flags & (FLAG_C | FLAG_K) and self.pos != 0:
            self._run_f()

    # -- STROBE ops --------------------------------------------------------------
    def meta_ad_const(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb_const(data)

    def ad_const(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb_const(data)

    def ad_rows(self, rows: torch.Tensor, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb_rows(rows, overwrite=False)

    def prf(self, n: int, more: bool) -> torch.Tensor:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key_rows(self, rows: torch.Tensor, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._absorb_rows(rows, overwrite=True)

    # -- Merlin framing ---------------------------------------------------------
    def append_const(self, label: bytes, message: bytes) -> None:
        self.meta_ad_const(label, False)
        self.meta_ad_const(_u32le(len(message)), True)
        self.ad_const(message, False)

    def append_rows(self, label: bytes, rows: torch.Tensor) -> None:
        """Per-transcript message: rows (k, P) uint8."""
        self.meta_ad_const(label, False)
        self.meta_ad_const(_u32le(rows.shape[0]), True)
        self.ad_rows(rows, False)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_const(label, _u64le(x))

    def challenge_bytes(self, label: bytes, n: int) -> torch.Tensor:
        """-> (n, P) uint8."""
        self.meta_ad_const(label, False)
        self.meta_ad_const(_u32le(n), True)
        return self.prf(n, False)

    def challenge_scalar(self, label: bytes) -> torch.Tensor:
        """-> (9, P) canonical scalars (Transcript.challenge_scalar:
        64 bytes reduced mod l)."""
        return S.from_wide_bytes(self.challenge_bytes(label, 64).T)

    # -- protocol domain separators (reference src/transcript.rs:44-65) --------
    def rangeproof_domain_sep(self, n: int, m: int) -> None:
        self.append_const(b"dom-sep", b"rangeproof v1")
        self.append_u64(b"n", n)
        self.append_u64(b"m", m)

    def innerproduct_domain_sep(self, n: int) -> None:
        self.append_const(b"dom-sep", b"ipp v1")
        self.append_u64(b"n", n)

    def state(self) -> torch.Tensor:
        """The (200, P) states with every pending constant applied."""
        self._flush()
        return self._st

    def counters(self):
        return self.pos, self.pos_begin, self.cur_flags
