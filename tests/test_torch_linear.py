"""The PyTorch port's linear proof against the JAX package's
proofs/linear.py.

Compared exactly: proof bytes from LinearProof.create with the same values
and rng (n = 8); batch verification verdicts and the items' transcript
bytes after it, on the host route (C++ replay and C++ MSM) and the device
route (use_device=True on device="cpu": the plain PyTorch versions of K1,
K10, K11, K4a and K4b), against the JAX package's host route; and the
error each route raises for a non-power-of-two n."""

import random

import pytest
import torch

import bulletproofs_tpu as J
from bulletproofs_tpu.core.ristretto import multiscalar_mul as j_msm
from bulletproofs_tpu.errors import ProofError as JProofError
from bulletproofs_tpu.proofs.linear import LinearProof as JLinearProof
from bulletproofs_tpu.utils.util import inner_product as j_inner

import bulletproofs_tpu_torch as T
from bulletproofs_tpu_torch.core.ristretto import multiscalar_mul as t_msm
from bulletproofs_tpu_torch.proofs import linear as TL
from bulletproofs_tpu_torch.utils.util import inner_product as t_inner

N = 8


class Rng:
    def __init__(self, seed):
        self.r = random.Random(seed)

    def randbytes(self, n):
        return self.r.randbytes(n)


def _create(pkg, msm, inner, Proof, n, seed, label):
    """(proof, C, b values) from one package, all values from Rng(seed)."""
    G = pkg.BulletproofGens(n, 1).share(0).G(n)
    pc = pkg.PedersenGens()
    F, B = pc.B, pc.B_blinding
    rng = Rng(seed)
    a = [pkg.Scalar.random(rng) for _ in range(n)]
    b = [pkg.Scalar.random(rng) for _ in range(n)]
    r = pkg.Scalar.random(rng)
    C = msm(a + [r, inner(a, b)], G + [B, F]).compress()
    proof = Proof.create(pkg.Transcript(label), rng, C, r, list(a), list(b),
                         list(G), F, B)
    return proof, C, b


def port_create(n, seed, label=b"port linear"):
    return _create(T, t_msm, t_inner, T.LinearProof, n, seed, label)


def jax_create(n, seed, label=b"port linear"):
    return _create(J, j_msm, j_inner, JLinearProof, n, seed, label)


@pytest.fixture(scope="module")
def made():
    """4 proofs at n = 8, each with its label."""
    out = []
    for i in range(4):
        label = b"port linear %d" % i
        out.append(port_create(N, 30 + i, label) + (label,))
    return out


def test_proofs_byte_identical_to_jax():
    for seed in (1, 2):
        tp, tC, tb = port_create(N, seed)
        jp, jC, jb = jax_create(N, seed)
        assert tC == jC and [s.v for s in tb] == [s.v for s in jb]
        assert tp.to_bytes() == jp.to_bytes()


def _port_batch(items, **kw):
    """-> (accepted, transcript bytes after) for the port's batch_verify."""
    G = T.BulletproofGens(N, 1).share(0).G(N)
    pc = T.PedersenGens()
    ts = [T.Transcript(l) for _, _, _, l in items]
    try:
        T.LinearProof.batch_verify(
            [(p, t, C, list(b)) for (p, C, b, _), t in zip(items, ts)],
            G, pc.B, pc.B_blinding, rng=Rng(40), device="cpu", **kw)
        ok = True
    except T.ProofError:
        ok = False
    return ok, [t.strobe.buf.raw for t in ts]


def _jax_batch(items):
    G = J.BulletproofGens(N, 1).share(0).G(N)
    pc = J.PedersenGens()
    ts = [J.Transcript(l) for _, _, _, l in items]
    try:
        JLinearProof.batch_verify(
            [(JLinearProof.from_bytes(p.to_bytes()), t, C,
              [J.Scalar(s.v) for s in b])
             for (p, C, b, _), t in zip(items, ts)],
            G, pc.B, pc.B_blinding, rng=Rng(40), device=False)
        ok = True
    except JProofError:
        ok = False
    return ok, [t.strobe.buf.raw for t in ts]


def _tampered(made, what):
    p0, C0, b0, l0 = made[0]
    bad = T.LinearProof.from_bytes(p0.to_bytes())
    if what == "scalar":
        bad.a = bad.a + T.Scalar.one()
    else:                                    # an undecodable S
        bad.S = b"\xff" * 32
    return [(bad, C0, b0, l0)] + made[1:]


@pytest.mark.parametrize("use_device", [False, True])
def test_batch_verify_agrees_with_jax(made, use_device, monkeypatch):
    calls = []
    real = TL._device_linear_check
    monkeypatch.setattr(TL, "_device_linear_check",
                        lambda *a: calls.append(a[-1]) or real(*a))
    for items, want in ((made, True), (_tampered(made, "scalar"), False),
                        (_tampered(made, "point"), False)):
        got = _port_batch(items, use_device=use_device)
        assert got == _jax_batch(items)
        assert got[0] is want
    # the undecodable S stops the host route at its C++ decompression
    # before any MSM; the device route runs K1's validity flags
    assert calls == ([torch.device("cpu")] * 3 if use_device else [])


def test_python_route_agrees_with_native(made):
    """An injected msm disables the C++ replay (the Python replay, the
    semantic oracle); the verdicts and transcripts are the same."""
    assert _port_batch(made, msm=t_msm) == _port_batch(made)
    bad = _tampered(made, "scalar")
    assert _port_batch(bad, msm=t_msm) == _port_batch(bad) \
        == (False, _port_batch(bad)[1])


def test_error_for_non_power_of_two_n():
    """n = 6: the native route raises invalid_generators_length
    (linear.py:374-375), the Python route verification() (the replay's
    n != 2^lg_n check), in both packages."""
    n = 6
    tG = T.BulletproofGens(N, 1).share(0).G(N)
    jG = J.BulletproofGens(N, 1).share(0).G(N)
    tpc, jpc = T.PedersenGens(), J.PedersenGens()
    tp, tC, _ = port_create(4, 50)
    jp = JLinearProof.from_bytes(tp.to_bytes())
    tb = [T.Scalar(i + 1) for i in range(n)]
    jb = [J.Scalar(i + 1) for i in range(n)]
    kinds = []
    for msm in (None, t_msm):
        with pytest.raises(T.ProofError) as e:
            T.LinearProof.batch_verify([(tp, T.Transcript(b"n6"), tC, tb)],
                                       tG, tpc.B, tpc.B_blinding, rng=Rng(51),
                                       msm=msm, device="cpu")
        kinds.append(e.value.kind)
    jkinds = []
    for msm in (None, j_msm):
        with pytest.raises(JProofError) as e:
            JLinearProof.batch_verify([(jp, J.Transcript(b"n6"), tC, jb)],
                                      jG, jpc.B, jpc.B_blinding, rng=Rng(51),
                                      msm=msm)
        jkinds.append(e.value.kind)
    assert kinds == jkinds == [T.ProofError.INVALID_GENERATORS_LENGTH,
                               T.ProofError.VERIFICATION]


def test_single_verify_matches_jax():
    tp, tC, tb = port_create(N, 60)
    G = T.BulletproofGens(N, 1).share(0).G(N)
    pc = T.PedersenGens()
    t = T.Transcript(b"port linear")
    tp.verify(t, tC, G, pc.B, pc.B_blinding, list(tb), device="cpu")
    jG = J.BulletproofGens(N, 1).share(0).G(N)
    jpc = J.PedersenGens()
    jt = J.Transcript(b"port linear")
    JLinearProof.from_bytes(tp.to_bytes()).verify(
        jt, tC, jG, jpc.B, jpc.B_blinding, [J.Scalar(s.v) for s in tb])
    assert t.strobe.buf.raw == jt.strobe.buf.raw
    bad = list(tb)
    bad[3] = bad[3] + T.Scalar.one()
    with pytest.raises(T.ProofError):
        tp.verify(T.Transcript(b"port linear"), tC, G, pc.B, pc.B_blinding,
                  bad, device="cpu")


def test_default_device_is_cuda(made):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    G = T.BulletproofGens(N, 1).share(0).G(N)
    pc = T.PedersenGens()
    p, C, b, l = made[0]
    with pytest.raises(RuntimeError):
        T.LinearProof.batch_verify([(p, T.Transcript(l), C, list(b))], G,
                                   pc.B, pc.B_blinding, rng=Rng(61))


def test_msm_host_auto_takes_the_device_msm_from_its_floor(monkeypatch):
    """ops/msm.msm (msm_lanes_flag on device="cpu") equals the host MSM,
    and LinearProof.verify takes it once settings.msm_device_floor is at
    or below its n."""
    from bulletproofs_tpu_torch.config import settings
    from bulletproofs_tpu_torch.ops import msm as M
    G = T.BulletproofGens(N, 1).share(0).G(N)
    sc = [T.Scalar.random(Rng(70)) for _ in range(N)] + [0, 5]
    pts = G + [G[0], G[1]]
    assert M.msm(sc, pts, "cpu").compress() == t_msm(sc, pts).compress()
    assert M.msm([], [], "cpu").is_identity()
    calls = []
    real = M.msm
    monkeypatch.setattr(M, "msm", lambda *a: calls.append(len(a[1])) or
                        real(*a))
    monkeypatch.setattr(settings, "msm_device_floor", N)
    tp, tC, tb = port_create(N, 71)
    pc = T.PedersenGens()
    tp.verify(T.Transcript(b"port linear"), tC, G, pc.B, pc.B_blinding,
              list(tb), device="cpu")
    assert calls == [N]
