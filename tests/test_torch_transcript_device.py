"""The PyTorch port's device transcripts (ops/transcript_device.DeviceStrobe:
STROBE-128 / Merlin over a (200, P) state, kernel K13's plain version on
the CPU) against the JAX package's DeviceStrobe and the port's host
PyStrobe128, on the schedules of tests/test_transcript_device.py: per-lane
data, the rate boundary, a key overwrite and the whole range-proof
schedule.  Exact bytes and counters; seeded data."""

import numpy as np
import pytest
import torch

from bulletproofs_tpu.ops.transcript_device import DeviceStrobe as JStrobe

from bulletproofs_tpu_torch.ops import scalar as S
from bulletproofs_tpu_torch.ops import transcript_device as TD
from bulletproofs_tpu_torch.ops.limbs import sc_limbs_to_ints
from bulletproofs_tpu_torch.ops.transcript_device import DeviceStrobe
from bulletproofs_tpu_torch.transcript import Transcript
from bulletproofs_tpu_torch.utils.strobe import PyStrobe128


def _fresh(lanes):
    """Host oracles, the port's and JAX's device strobes, all at the state
    of a new Merlin transcript."""
    hosts = [PyStrobe128(b"Merlin v1.0") for _ in range(lanes)]
    st = np.stack([np.frombuffer(bytes(h.state), np.uint8) for h in hosts],
                  axis=1)
    c = (hosts[0].pos, hosts[0].pos_begin, hosts[0].cur_flags)
    return hosts, DeviceStrobe(torch.as_tensor(st), *c), JStrobe(st, *c)


def _check(hosts, dev, jdev):
    st = dev.state().numpy()
    assert np.array_equal(st, np.asarray(jdev.st))
    for p, h in enumerate(hosts):
        assert st[:, p].tobytes() == bytes(h.state), f"lane {p}"
        assert dev.counters() == jdev.counters() == (
            h.pos, h.pos_begin, h.cur_flags)


def _rows(msgs):
    return np.stack([np.frombuffer(m, np.uint8) for m in msgs], axis=1)


def test_per_lane_data_and_challenges():
    hosts, dev, jdev = _fresh(4)
    rng = np.random.default_rng(5)
    msgs = [rng.bytes(32) for _ in range(4)]
    for h, m in zip(hosts, msgs):
        h.meta_ad(b"V", False)
        h.meta_ad(np.uint32(32).tobytes(), True)
        h.ad(m, False)
    dev.append_rows(b"V", torch.as_tensor(_rows(msgs)))
    jdev.append_rows(b"V", _rows(msgs))
    _check(hosts, dev, jdev)
    want = []
    for h in hosts:
        h.meta_ad(b"u", False)
        h.meta_ad(np.uint32(64).tobytes(), True)
        want.append(h.prf(64, False))
    got = dev.challenge_bytes(b"u", 64).numpy()
    assert np.array_equal(got, np.asarray(jdev.challenge_bytes(b"u", 64)))
    assert [got[:, p].tobytes() for p in range(4)] == want
    _check(hosts, dev, jdev)


def test_rate_boundary_crossing():
    """Labelled messages whose absorbs straddle the 166-byte rate, then a
    200-byte squeeze across it."""
    hosts, dev, jdev = _fresh(2)
    rng = np.random.default_rng(9)
    for i in range(12):
        msgs = [rng.bytes(40) for _ in hosts]
        for h, m in zip(hosts, msgs):
            h.meta_ad(b"blob %d" % i, False)
            h.meta_ad(np.uint32(40).tobytes(), True)
            h.ad(m, False)
        dev.append_rows(b"blob %d" % i, torch.as_tensor(_rows(msgs)))
        jdev.append_rows(b"blob %d" % i, _rows(msgs))
        _check(hosts, dev, jdev)
    want = []
    for h in hosts:
        h.meta_ad(b"wide", False)
        h.meta_ad(np.uint32(200).tobytes(), True)
        want.append(h.prf(200, False))
    got = dev.challenge_bytes(b"wide", 200).numpy()
    assert [got[:, p].tobytes() for p in range(2)] == want
    jdev.challenge_bytes(b"wide", 200)
    _check(hosts, dev, jdev)


def test_key_overwrite():
    hosts, dev, jdev = _fresh(2)
    rng = np.random.default_rng(2)
    keys = [rng.bytes(32) for _ in hosts]
    for h, k in zip(hosts, keys):
        h.key(k, False)
    dev.key_rows(torch.as_tensor(_rows(keys)), False)
    jdev.key_rows(_rows(keys), False)
    _check(hosts, dev, jdev)


def test_permutation_takes_the_pad_in_one_call(monkeypatch):
    """A permutation is one f1600_state_bytes call with the pending pad (one
    K13 launch on the card) and no separate XOR of the state: a label and
    a challenge across the rate, against the host and JAX strobes."""
    hosts, dev, jdev = _fresh(3)
    pads = []
    real = TD.f1600_state_bytes

    def f1600(st, pad=None):
        pads.append(pad)
        return real(st, pad)

    def no_flush(self):
        raise AssertionError("the pad was XORed in a launch of its own")

    monkeypatch.setattr(TD, "f1600_state_bytes", f1600)
    for h in hosts:
        h.meta_ad(b"a label of the schedule", False)
        h.meta_ad(np.uint32(170).tobytes(), True)
    for d in (dev, jdev):
        d.meta_ad_const(b"a label of the schedule", False)
        d.meta_ad_const(np.uint32(170).tobytes(), True)
    monkeypatch.setattr(DeviceStrobe, "_flush", no_flush)
    dev._begin_op(TD.FLAG_I | TD.FLAG_A | TD.FLAG_C, False)   # a PRF begins
    monkeypatch.undo()
    assert len(pads) == 1 and pads[0] is not None
    want = [h.prf(170, False) for h in hosts]
    got = dev._squeeze(170).numpy()
    assert [got[:, p].tobytes() for p in range(3)] == want
    assert np.array_equal(got, np.asarray(jdev.prf(170, False)))
    _check(hosts, dev, jdev)


def test_input_state_is_not_written():
    st = torch.zeros((200, 2), dtype=torch.uint8)
    dev = DeviceStrobe(st, 0, 0, 0)
    dev.append_const(b"label", b"message")
    dev.challenge_bytes(b"c", 64)
    assert not st.any()


def test_full_rangeproof_schedule():
    """The prover's whole schedule (dom-sep, V / A / S, y, z, T_1 / T_2, x,
    t_x .. e_blinding, w, the IPP domain separator, three L / R / u
    rounds) against host Transcripts, with every challenge also reduced to
    a scalar; the round counters repeat, so one round body serves all."""
    lanes, n = 3, 8
    rng = np.random.default_rng(42)
    hosts = [Transcript(_strobe=PyStrobe128(b"Merlin v1.0"))
             for _ in range(lanes)]
    for h in hosts:
        h.append_message(b"dom-sep", b"bp label")
    st = np.stack([np.frombuffer(bytes(h.strobe.state), np.uint8)
                   for h in hosts], axis=1)
    c = (hosts[0].strobe.pos, hosts[0].strobe.pos_begin,
         hosts[0].strobe.cur_flags)
    dev, jdev = DeviceStrobe(torch.as_tensor(st), *c), JStrobe(st, *c)

    def absorb(label):
        msgs = [rng.bytes(32) for _ in range(lanes)]
        dev.append_rows(label, torch.as_tensor(_rows(msgs)))
        jdev.append_rows(label, _rows(msgs))
        for h, m in zip(hosts, msgs):
            h.append_message(label, m)

    def challenge(label):
        got = dev.challenge_bytes(label, 64).numpy()
        jdev.challenge_bytes(label, 64)
        for p, h in enumerate(hosts):
            assert got[:, p].tobytes() == h.clone().challenge_bytes(label, 64)
        want = [h.challenge_scalar(label).v for h in hosts]
        return got, want

    dev.rangeproof_domain_sep(n, 1)
    jdev.rangeproof_domain_sep(n, 1)
    for h in hosts:
        h.rangeproof_domain_sep(n, 1)
    for label in (b"V", b"A", b"S"):
        absorb(label)
    for label in (b"y", b"z"):
        got, want = challenge(label)
        assert sc_limbs_to_ints(S.from_wide_bytes(
            torch.as_tensor(got.T.copy())).numpy()) == want
    for label in (b"T_1", b"T_2"):
        absorb(label)
    challenge(b"x")
    for label in (b"t_x", b"t_x_blinding", b"e_blinding"):
        absorb(label)
    challenge(b"w")
    dev.innerproduct_domain_sep(n)
    jdev.innerproduct_domain_sep(n)
    for h in hosts:
        h.innerproduct_domain_sep(n)
    counters = []
    for _ in range(3):
        absorb(b"L")
        absorb(b"R")
        hosts_before = [h.clone() for h in hosts]
        u = dev.challenge_scalar(b"u")
        jdev.challenge_bytes(b"u", 64)
        assert sc_limbs_to_ints(u.numpy()) == [
            h.challenge_scalar(b"u").v for h in hosts_before]
        for h in hosts:
            h.challenge_bytes(b"u", 64)
        counters.append(dev.counters())
    assert len(set(counters)) == 1
    st_now = dev.state().numpy()
    assert np.array_equal(st_now, np.asarray(jdev.st))
    for p, h in enumerate(hosts):
        assert st_now[:, p].tobytes() == bytes(h.strobe.state)
