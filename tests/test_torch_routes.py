"""The port's host and Python routes against the JAX package's:

* BatchProver(prefer_host=True): the C++ stage engine for m = 1 (its row
  MSMs by fixed_msm.msm_rows_compressed over host tables), prove_multiple
  per proof for m > 1; proofs, commitments and transcripts byte for byte
  the JAX BatchProver's off the TPU with the same rng;
* BatchVerifier(prefer_host=True) (all C++) and BatchVerifier(use_native=
  False) (the Python replay, then K1 and the MSM's plain versions): the
  verdicts and post-verify transcripts of the JAX package's
  BatchVerifier(prefer_host=True) on valid, flipped-byte and
  swapped-commitment batches; prefer_host=None keeps the device routes;
* RangeProof.verify_multiple through host_verify_one;
* msm_rows_compressed on the CPU (the C++ rows) against the JAX
  package's and against the card branch's plain versions (`_device_rows`:
  K10, K6, K7, then K5);
* `_cuda.launch` under its tensors' device, a check that runs without a
  card on a stand-in library."""

import random

import numpy as np
import pytest
import torch

import bulletproofs_tpu as J
from bulletproofs_tpu.ops import fixed_msm as JFM
from bulletproofs_tpu.parallel import BatchVerifier as JBatchVerifier
from bulletproofs_tpu.proofs.batch_prover import BatchProver as JBatchProver

import bulletproofs_tpu_torch as T
from bulletproofs_tpu_torch.core.scalar import L as ELL
from bulletproofs_tpu_torch.ops import _cuda
from bulletproofs_tpu_torch.ops import curve as C
from bulletproofs_tpu_torch.ops import fixed_msm as FM
from bulletproofs_tpu_torch.parallel import BatchVerifier
from bulletproofs_tpu_torch.parallel import batch_verify as BVm

N_BITS, COUNT = 8, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions here are long chains of small ops, which one
    intra-op thread runs fastest (several test workers share the cores);
    the setting is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Rng:
    def __init__(self, seed):
        self.r = random.Random(seed)

    def randbytes(self, n):
        return self.r.randbytes(n)


def _prove(pkg, prover, m, seed):
    """COUNT proofs of m seeded values -> (wires, commitment lists, labels,
    transcript bytes after)."""
    g = np.random.default_rng(seed)
    values = [[int(v) for v in g.integers(0, 1 << N_BITS, m)]
              for _ in range(COUNT)]
    values[0][0], values[-1][-1] = 0, (1 << N_BITS) - 1
    blinds = [[pkg.Scalar(int.from_bytes(g.bytes(32), "little") % ELL)
               for _ in range(m)] for _ in range(COUNT)]
    labels = [b"torch routes %d" % i for i in range(COUNT)]
    if m == 1:
        values, blinds = [v[0] for v in values], [b[0] for b in blinds]
    ts = [pkg.Transcript(l) for l in labels]
    proofs, vcs = prover.prove_batch(values, blinds, ts, rng=Rng(seed))
    vcss = [[v] for v in vcs] if m == 1 else vcs
    return ([p.to_bytes() for p in proofs], vcss, labels,
            [t.strobe.buf.raw for t in ts])


@pytest.fixture(scope="module", params=[1, 2], ids=["m1", "m2"])
def made(request):
    """The port's host prover and the JAX package's BatchProver (off the
    TPU: its host route) on the same inputs, and the port's proofs'
    flipped-byte and swapped-commitment variants."""
    m = request.param
    port = _prove(T, T.BatchProver(T.BulletproofGens(N_BITS, m),
                                   T.PedersenGens(), N_BITS, m, device="cpu",
                                   prefer_host=True), m, 40 + m)
    jax = _prove(J, JBatchProver(J.BulletproofGens(N_BITS, m),
                                 J.PedersenGens(), N_BITS, m), m, 40 + m)
    wires, vcss, labels, _ = port
    flipped = bytearray(wires[-1])
    flipped[128] ^= 1                               # low byte of t_x
    swapped = ([vcss[-1], vcss[-2]] if m == 1
               else [vcss[-1][1], vcss[-1][0]] + vcss[-1][2:])
    cases = {"valid": (wires, vcss),
             "flipped": (wires[:-1] + [bytes(flipped)], vcss),
             "swapped": (wires, vcss[:-2] + swapped if m == 1
                         else vcss[:-1] + [swapped])}
    return m, port, jax, labels, cases


def _verdict(pkg, bv, wires, vcss, labels, seed):
    """-> (accepted, transcript bytes after the call)."""
    ts = [pkg.Transcript(l) for l in labels]
    try:
        bv.verify_batch([pkg.RangeProof.from_bytes(w) for w in wires], vcss,
                        ts, rng=Rng(seed))
        ok = True
    except pkg.ProofError:
        ok = False
    return ok, [t.strobe.buf.raw for t in ts]


def test_host_prover_equals_jax(made):
    """Proofs, commitments and transcripts byte for byte."""
    _, port, jax, _, _ = made
    assert port == jax


def test_host_prover_draws_the_jax_route_s_rng(monkeypatch):
    """m = 1: count (2 + 2n) 64 bytes, then count 128; the C++ rows take
    the constant-time form for V / A / S and T_1 / T_2 only."""
    draws, rows = [], []

    class Counting(Rng):
        def randbytes(self, n):
            draws.append(n)
            return super().randbytes(n)

    real = FM.msm_rows_compressed

    def spy(tables, coef, consttime=False):
        rows.append((coef.shape, consttime))
        return real(tables, coef, consttime)

    monkeypatch.setattr(FM, "msm_rows_compressed", spy)
    prover = T.BatchProver(T.BulletproofGens(N_BITS, 1), T.PedersenGens(),
                           N_BITS, device="cpu", prefer_host=True)
    assert prover.tables.niels is None and not hasattr(prover, "a_tables")
    prover.prove_batch([1, 2], [T.Scalar(3), T.Scalar(4)],
                       [T.Transcript(b"a"), T.Transcript(b"b")],
                       rng=Counting(0))
    assert draws == [2 * (2 + 2 * N_BITS) * 64, 2 * 128]
    nb = 2 * N_BITS + 2
    assert rows == [((6, nb, 32), True), ((4, 2, 32), True)] \
        + [((4, nb, 32), False)] * 3


def test_host_prover_proofs_pass_the_default_verifier(made, monkeypatch):
    """The port's BatchVerifier(device="cpu") with prefer_host left None
    accepts them on a device route (the plain versions): neither the C++
    nor the Python route runs."""
    m, (wires, vcss, labels, _), _, _, _ = made

    def forbidden(*a):
        raise AssertionError("took a host route")

    monkeypatch.setattr(BatchVerifier, "_verify_host", forbidden)
    monkeypatch.setattr(BatchVerifier, "_verify_python", forbidden)
    bv = BatchVerifier(T.BulletproofGens(N_BITS, m), T.PedersenGens(),
                       n=N_BITS, m=m, device="cpu")
    assert _verdict(T, bv, wires, vcss, labels, 5)[0]


@pytest.mark.parametrize("case", ["valid", "flipped", "swapped"])
@pytest.mark.parametrize("route", ["prefer_host", "python"])
def test_verifier_routes_match_jax(made, route, case, monkeypatch):
    m, _, _, labels, cases = made
    wires, vcss = cases[case]
    taken = []
    name = "_verify_host" if route == "prefer_host" else "_verify_python"
    real = getattr(BatchVerifier, name)
    monkeypatch.setattr(BatchVerifier, name,
                        lambda self, *a: taken.append(1) or real(self, *a))
    kw = {"prefer_host": True} if route == "prefer_host" \
        else {"use_native": False}
    bv = BatchVerifier(T.BulletproofGens(N_BITS, m), T.PedersenGens(),
                       n=N_BITS, m=m, device="cpu", **kw)
    got = _verdict(T, bv, wires, vcss, labels, 6)
    jbv = JBatchVerifier(J.BulletproofGens(N_BITS, m), J.PedersenGens(),
                         n=N_BITS, m=m, prefer_host=True)
    assert got == _verdict(J, jbv, wires, vcss, labels, 6)
    assert got[0] == (case == "valid") and taken == [1]


@pytest.mark.parametrize("case", ["valid", "flipped"])
def test_verify_multiple_takes_host_verify_one(made, case, monkeypatch):
    """The JAX package's verdict and transcript after each proof; with an
    injected msm the Python replay runs instead."""
    m, _, _, labels, cases = made
    wires, vcss = cases[case]
    calls = []
    real = BVm.host_verify_one
    monkeypatch.setattr(BVm, "host_verify_one",
                        lambda *a: calls.append(1) or real(*a))
    for pkg in (T, J):
        bp, pc = pkg.BulletproofGens(N_BITS, m), pkg.PedersenGens()
        out = []
        for w, v, l in zip(wires, vcss, labels):
            t = pkg.Transcript(l)
            try:
                pkg.RangeProof.from_bytes(w).verify_multiple(
                    bp, pc, t, v, N_BITS, rng=Rng(9))
                out.append(True)
            except pkg.ProofError:
                out.append(False)
            out.append(t.strobe.buf.raw)
        if pkg is T:
            got = out
    assert got == out and calls == [1] * COUNT
    assert got[-2] == (case == "valid")
    from bulletproofs_tpu_torch.core.ristretto import multiscalar_mul
    t = T.Transcript(labels[0])
    T.RangeProof.from_bytes(wires[0]).verify_multiple(
        T.BulletproofGens(N_BITS, m), T.PedersenGens(), t, vcss[0], N_BITS,
        msm=multiscalar_mul)
    assert calls == [1] * COUNT and t.strobe.buf.raw == got[1]


@pytest.fixture(scope="module")
def row_tables():
    """The n = 8 bases [B, B~, G.., H..] as the port's host-only and CPU
    tables and the JAX package's tables, and seeded coefficient rows with
    0, 1 and l - 1 among them."""
    bp, pc = T.BulletproofGens(N_BITS, 1), T.PedersenGens()
    bases = [pc.B, pc.B_blinding] + bp.G(N_BITS, 1) + bp.H(N_BITS, 1)
    jbp, jpc = J.BulletproofGens(N_BITS, 1), J.PedersenGens()
    jbases = [jpc.B, jpc.B_blinding] + jbp.G(N_BITS, 1) + jbp.H(N_BITS, 1)
    g = np.random.default_rng(3)
    vals = [int.from_bytes(g.bytes(32), "little") % ELL
            for _ in range(4 * len(bases))]
    vals[:3] = [0, 1, ELL - 1]
    coef = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                         np.uint8).reshape(4, len(bases), 32).copy()
    return (FM.FixedBaseTables(bases, None), FM.FixedBaseTables(bases, "cpu"),
            JFM.FixedBaseTables(jbases), coef)


@pytest.mark.parametrize("consttime", [True, False])
def test_msm_rows_compressed_matches_jax_and_the_card_branch(row_tables,
                                                             consttime):
    host, cpu, jax, coef = row_tables
    got = FM.msm_rows_compressed(host, coef, consttime=consttime)
    assert got.shape == (4, 32) and got.dtype == np.uint8
    assert np.array_equal(got, JFM.msm_rows_compressed(jax, coef,
                                                       consttime=consttime))
    # CPU tables take the C++ rows too; `_device_rows` runs the card
    # branch's plain versions on them
    assert np.array_equal(got, FM.msm_rows_compressed(cpu, coef, consttime))
    pts = FM._device_rows(cpu, coef, consttime)
    assert pts.shape == (4, 10, 4)
    assert np.array_equal(got, C.compress(pts).numpy())
    assert np.array_equal(got, C.compress(FM.msm_rows(host, coef)).numpy())


def test_digit_stream_is_the_rows_signed_digits(row_tables):
    """(Q, NB, 32) bytes -> (NB 64, Q): row j 64 + w is window w of base
    j's coefficient, sum_w d 16^w = the coefficient."""
    _, _, _, coef = row_tables
    dig = FM.digit_stream(torch.as_tensor(coef)).to(torch.int64).numpy()
    q, nb, _ = coef.shape
    for i in range(q):
        for j in range(nb):
            want = int.from_bytes(coef[i, j].tobytes(), "little")
            got = sum(int(d) << (4 * w)
                      for w, d in enumerate(dig[j * 64: (j + 1) * 64, i]))
            assert got == want


def test_launch_runs_under_its_tensors_device(monkeypatch):
    """A launch makes its tensors' device current and passes that device's
    stream (a stand-in library and stand-in CUDA calls record them); mixed
    devices are refused before anything is built."""
    seen = []

    class Stream:
        cuda_stream = 1234

    class Device:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            seen.append(("enter", self.dev))

        def __exit__(self, *exc):
            seen.append(("exit", self.dev))

    class Lib:
        @staticmethod
        def bp_fake(*args):
            seen.append(("call", args[-1].value))
            return 0

    monkeypatch.setattr(_cuda, "_lib", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: seen.append(("stream", dev))
                        or Stream)
    dev = torch.device("meta")
    before = _cuda.LAUNCHES["digits"]
    _cuda.launch("digits", "fold", "bp_fake", torch.empty(3, device=dev),
                 None, 7)
    assert seen == [("enter", dev), ("stream", dev), ("call", 1234),
                    ("exit", dev)]
    assert _cuda.LAUNCHES["digits"] == before + 1
    with pytest.raises(ValueError):
        _cuda.launch("digits", "fold", "bp_fake", torch.empty(3, device=dev),
                     torch.empty(3))
    assert _cuda.LAUNCHES["digits"] == before + 1
    _cuda.LAUNCHES["digits"] = before


def test_routes_need_no_card_but_the_default_does():
    """The C++ route and host_verify_one run with device="cpu" verifiers;
    the default device still raises without a card (no silent CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        BatchVerifier(T.BulletproofGens(N_BITS, 1), T.PedersenGens(),
                      n=N_BITS, prefer_host=True)
    with pytest.raises(RuntimeError):
        T.BatchProver(T.BulletproofGens(N_BITS, 1), T.PedersenGens(), N_BITS,
                      prefer_host=True)


def test_new_routes_import_neither_jax_nor_the_jax_package():
    """In a fresh interpreter: the host prover, the C++ and Python verifier
    routes, verify_multiple's host route, the row MSMs and a sharded MSM
    over a CPU mesh; neither jax nor bulletproofs_tpu gets imported."""
    import subprocess
    import sys
    code = """
import random, sys
import numpy as np, torch
torch.set_num_threads(1)
import bulletproofs_tpu_torch as T
from bulletproofs_tpu_torch.ops import curve as C, fixed_msm as FM
from bulletproofs_tpu_torch.parallel import (BatchVerifier, make_mesh,
                                             sharded_msm_lanes)
class R:
    def __init__(s, seed): s.r = random.Random(seed)
    def randbytes(s, n): return s.r.randbytes(n)
bp, pc = T.BulletproofGens(8, 1), T.PedersenGens()
ps, vs = T.BatchProver(bp, pc, 8, device="cpu", prefer_host=True).prove_batch(
    [3, 4], [T.Scalar(5), T.Scalar(6)], [T.Transcript(b"i"), T.Transcript(b"j")],
    rng=R(1))
for kw in ({"prefer_host": True}, {"use_native": False}):
    BatchVerifier(bp, pc, n=8, device="cpu", **kw).verify_batch(
        ps, [[v] for v in vs], [T.Transcript(b"i"), T.Transcript(b"j")],
        rng=R(2))
ps[0].verify_single(bp, pc, T.Transcript(b"i"), vs[0], 8)
coef = np.zeros((1, 2, 32), np.uint8); coef[0, 0, 0] = 1
FM.msm_rows_compressed(FM.FixedBaseTables([pc.B, pc.B_blinding], None), coef)
sharded_msm_lanes(C.identity(3, "cpu"), [1, 2, 3], make_mesh(2, device="cpu"))
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "bulletproofs_tpu"
       or m.startswith("bulletproofs_tpu.")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
