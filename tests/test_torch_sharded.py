"""The MSM sharded over a mesh (bulletproofs_tpu_torch.parallel.sharded_msm)
on virtual CPU meshes, where every shard runs the plain PyTorch versions
of K10, K11, K4a and K4b, against the JAX package's host MSM (the oracle
of tests/test_sharded.py); `make_mesh`; and BatchVerifier(mesh=) on its
chunked route with every chunk's MSM and the final one sharded over four
entries (and the Python replay over the mesh), against the JAX package's
BatchVerifier(prefer_host=True) on the same proofs and rng bytes:
accept / reject and the transcript bytes after the replay.

Small shapes: each sharded MSM runs one plain MSM a shard (~1 s each on
the CPU)."""

import random

import numpy as np
import pytest
import torch

import bulletproofs_tpu as J
from bulletproofs_tpu.core.ristretto import RistrettoPoint as JPoint
from bulletproofs_tpu.core.ristretto import multiscalar_mul as j_msm
from bulletproofs_tpu.parallel import BatchVerifier as JBatchVerifier

import bulletproofs_tpu_torch as T
from bulletproofs_tpu_torch.config import settings as TSET
from bulletproofs_tpu_torch.core.ristretto import RISTRETTO_BASEPOINT
from bulletproofs_tpu_torch.core.scalar import L as ELL, Scalar
from bulletproofs_tpu_torch.ops import curve as C
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.parallel import (BatchVerifier, Mesh, make_mesh,
                                             sharded_msm_lanes)
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


def _compressed(out) -> bytes:
    """A (4, 10, 1) result -> its 32-byte encoding."""
    return C.compress(out).numpy().tobytes()


def _points(n, seed):
    """n seeded points (odd multiples of the basepoint) and n scalars."""
    g = np.random.default_rng(seed)
    pts = [RISTRETTO_BASEPOINT.scalar_mul(
        Scalar(int.from_bytes(g.bytes(16), "little") | 1)) for _ in range(n)]
    scalars = [int.from_bytes(g.bytes(32), "little") % ELL for _ in range(n)]
    return pts, scalars


@pytest.mark.parametrize("n_pts, shards", [(32, 8), (19, 8), (3, 8)])
def test_sharded_msm_equals_the_host_msm(n_pts, shards):
    """N = 32 and 19 over 8 shards (19: the non-power-of-two regression of
    test_sharded.py), and 3 over 8, where five shards hold padding alone."""
    pts, scalars = _points(n_pts, n_pts)
    out = sharded_msm_lanes(torch.as_tensor(C.points_to_lanes(pts)), scalars,
                            make_mesh(shards, device="cpu"))
    assert out.shape == (4, 10, 1) and out.device.type == "cpu"
    want = j_msm([J.Scalar(s) for s in scalars],
                 [JPoint(p.X, p.Y, p.Z, p.T) for p in pts])
    assert _compressed(out) == want.compress()


def test_sharded_msm_with_more_points_a_shard_than_a_lane_step():
    """4,133 points over 4 shards, 1,034 a shard (33 steps of its 32
    lanes; the JAX test's 'more points than one shard holds' size): points
    from a table of basepoint multiples, so the oracle is one scalar
    multiplication; scalars as (N, 33) rows, the JAX package's form."""
    n = 4 * 1024 + 37
    g = np.random.default_rng(11)
    table, acc = [], RISTRETTO_BASEPOINT
    for _ in range(16):
        table.append(acc)
        acc = acc + RISTRETTO_BASEPOINT
    idx = g.integers(0, 16, n)
    pts = torch.as_tensor(C.points_to_lanes(table))[..., torch.as_tensor(idx)]
    scalars = [int.from_bytes(g.bytes(32), "little") % ELL for _ in range(n)]
    rows = np.zeros((n, 33), np.uint8)
    rows[:, :32] = np.frombuffer(b"".join(s.to_bytes(32, "little")
                                          for s in scalars),
                                 np.uint8).reshape(n, 32)
    out = sharded_msm_lanes(pts.contiguous(), rows, make_mesh(4, device="cpu"))
    k = sum((int(i) + 1) * s for i, s in zip(idx, scalars)) % ELL
    assert _compressed(out) == RISTRETTO_BASEPOINT.scalar_mul(
        Scalar(k)).compress()


def test_sharded_msm_equals_the_unsharded_msm():
    """Compared as compressed bytes (the limbs of the two differ)."""
    pts, scalars = _points(19, 5)
    lanes = torch.as_tensor(C.points_to_lanes(pts))
    sharded = sharded_msm_lanes(lanes, scalars, make_mesh(2, device="cpu"))
    sb = torch.as_tensor(np.frombuffer(b"".join(
        s.to_bytes(32, "little") for s in scalars), np.uint8)
        .reshape(-1, 32).copy())
    assert _compressed(sharded) == _compressed(M.msm_lanes(lanes, sb))


def test_make_mesh_takes_every_card_and_never_fewer(monkeypatch):
    """On n cards make_mesh() is cuda:0 .. cuda:n-1, make_mesh(k) the
    first k, and asking for more than n raises (no shorter mesh); on the
    CPU a mesh of n entries, and without a card the default raises."""
    cpu = make_mesh(4, device="cpu")
    assert cpu.size == 4 and cpu.axis == "points" \
        and cpu.devices == (torch.device("cpu"),) * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().devices == (torch.device("cuda", 0),
                                   torch.device("cuda", 1))
    assert make_mesh(1).devices == (torch.device("cuda", 0),)
    for k in (3, 0):
        with pytest.raises(ValueError):
            make_mesh(k)
    with pytest.raises(ValueError):
        Mesh([])


# -- the mesh verifier -------------------------------------------------------------

@pytest.fixture(scope="module", params=[1, 2], ids=["m1", "m2"])
def made(request):
    """COUNT n = 8 proofs of m values from the port's host prover, as
    wires, their commitments and a flipped-byte and a swapped-commitments
    variant."""
    m = request.param
    bp, pc = T.BulletproofGens(N_BITS, m), T.PedersenGens()
    prover = T.BatchProver(bp, pc, N_BITS, m, device="cpu", prefer_host=True)
    g = np.random.default_rng(m)
    values = [[int(v) for v in g.integers(0, 1 << N_BITS, m)]
              for _ in range(COUNT)]
    blinds = [[Scalar(int.from_bytes(g.bytes(32), "little") % ELL)
               for _ in range(m)] for _ in range(COUNT)]
    labels = [b"torch mesh %d" % i for i in range(COUNT)]
    if m == 1:
        values, blinds = [v[0] for v in values], [b[0] for b in blinds]
    proofs, vcs = prover.prove_batch(values, blinds,
                                     [T.Transcript(l) for l in labels],
                                     rng=Rng(m))
    vcss = [[v] for v in vcs] if m == 1 else vcs
    wires = [p.to_bytes() for p in proofs]
    flipped = bytearray(wires[-1])
    flipped[128] ^= 1                               # low byte of t_x
    swapped = ([vcss[-1], vcss[-2]] if m == 1
               else [vcss[-1][1], vcss[-1][0]] + vcss[-1][2:])
    cases = {"valid": (wires, vcss),
             "flipped": (wires[:-1] + [bytes(flipped)], vcss),
             "swapped": (wires, vcss[:-2] + swapped if m == 1
                         else vcss[:-1] + [swapped])}
    return m, labels, cases


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


@pytest.mark.parametrize("case", ["valid", "flipped", "swapped"])
def test_mesh_verifier_matches_jax(made, case, monkeypatch):
    """BatchVerifier over a 4-entry CPU mesh takes the chunked route, every
    MSM sharded: the JAX host route's verdict and transcripts.  The valid
    batch runs as two chunks (settings.verify_chunk_pts lowered), the
    tampered ones as one (the plain MSMs cost ~1 s a shard)."""
    m, labels, cases = made
    wires, vcss = cases[case]
    n_dyn = 4 + 2 * (N_BITS * m).bit_length() - 2 + m
    per_chunk = 2 if case == "valid" else COUNT
    monkeypatch.setattr(TSET, "verify_chunk_pts", per_chunk * n_dyn)
    calls = []
    real = BVm.sharded_msm_lanes
    monkeypatch.setattr(BVm, "sharded_msm_lanes",
                        lambda *a: calls.append(a[0].shape[-1]) or real(*a))
    # with a mesh the verifier's device is the mesh's first, whatever
    # `device` says (here a card that is not there)
    bv = BatchVerifier(T.BulletproofGens(N_BITS, m), T.PedersenGens(),
                       n=N_BITS, m=m, mesh=make_mesh(4, device="cpu"),
                       device="cuda")
    assert bv.device == torch.device("cpu") and bv.sharded
    got = _verdict(T, bv, wires, vcss, labels, 7)
    jbv = JBatchVerifier(J.BulletproofGens(N_BITS, m), J.PedersenGens(),
                         n=N_BITS, m=m, prefer_host=True)
    assert got == _verdict(J, jbv, wires, vcss, labels, 7)
    assert got[0] == (case == "valid")
    # the chunks' MSMs, then the final one over the static points and the
    # chunks' partials
    chunks = [min(per_chunk, COUNT - lo) * n_dyn
              for lo in range(0, COUNT, per_chunk)]
    assert calls == chunks + [2 + 2 * N_BITS * m + len(chunks)]


def test_python_replay_over_the_mesh_matches_jax(made):
    """use_native=False over a 4-entry mesh: its one MSM sharded; the JAX
    host route's verdict and transcripts (valid and flipped)."""
    m, labels, cases = made
    bv = BatchVerifier(T.BulletproofGens(N_BITS, m), T.PedersenGens(),
                       n=N_BITS, m=m, mesh=make_mesh(4, device="cpu"),
                       use_native=False)
    jbv = JBatchVerifier(J.BulletproofGens(N_BITS, m), J.PedersenGens(),
                         n=N_BITS, m=m, prefer_host=True)
    for case in ("valid", "flipped"):
        wires, vcss = cases[case]
        got = _verdict(T, bv, wires, vcss, labels, 8)
        assert got == _verdict(J, jbv, wires, vcss, labels, 8)
        assert got[0] == (case == "valid")
