"""The PyTorch port's batched range-proof verification as a whole
(BatchVerifier(device="cpu"): plain PyTorch versions of every kernel)
against the JAX package's all-C++ route, BatchVerifier(prefer_host=True),
on the same proofs, transcripts and weights.

Compared exactly: accept / reject, and the transcript bytes after the
replay (both verifiers advance the caller's transcripts)."""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import bulletproofs_tpu as J
from bulletproofs_tpu.parallel import BatchVerifier as JBatchVerifier

import bulletproofs_tpu_torch as T
from bulletproofs_tpu_torch.ops.limbs import from_jax_lanes
from bulletproofs_tpu_torch.parallel.batch_verify import BatchVerifier

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

T_BP, T_PC = T.BulletproofGens(64, 8), T.PedersenGens()
J_BP, J_PC = J.BulletproofGens(64, 8), J.PedersenGens()


class Rng:
    def __init__(self, seed):
        self.r = random.Random(seed)

    def randbytes(self, n):
        return self.r.randbytes(n)


def _make(k, n, m, seed):
    """k proofs made by the port's host prover -> (wire bytes, commitments,
    labels)."""
    rng = Rng(seed)
    wires, vcss, labels = [], [], []
    for i in range(k):
        label = b"torch batch %d" % i
        proof, vcs = T.RangeProof.prove_multiple(
            T_BP, T_PC, T.Transcript(label),
            [rng.r.randrange(1 << n) for _ in range(m)],
            [T.Scalar.random(rng) for _ in range(m)], n, rng=rng)
        wires.append(proof.to_bytes())
        vcss.append(list(vcs))
        labels.append(label)
    return wires, vcss, labels


def _both(n, m, wires, vcss, labels, seed=7):
    """Run both verifiers; -> (port accepted, jax accepted, port transcript
    bytes, jax transcript bytes)."""
    out = []
    for pkg, bv in ((T, BatchVerifier(T_BP, T_PC, n=n, m=m, device="cpu")),
                    (J, JBatchVerifier(J_BP, J_PC, n=n, m=m,
                                       prefer_host=True))):
        ts = [pkg.Transcript(l) for l in labels]
        proofs = [pkg.RangeProof.from_bytes(w) for w in wires]
        try:
            bv.verify_batch(proofs, vcss, ts, rng=Rng(seed))
            ok = True
        except pkg.ProofError:
            ok = False
        out.append((ok, [t.challenge_bytes(b"after", 32) for t in ts]))
    (tok, tts), (jok, jts) = out
    return tok, jok, tts, jts


@pytest.fixture(scope="module")
def proofs64():
    return _make(3, 64, 1, 51)


def test_valid_batch_accepted_and_transcripts_match(proofs64):
    tok, jok, tts, jts = _both(64, 1, *proofs64)
    assert tok and jok
    assert tts == jts


def test_tampered_t_x_rejected(proofs64):
    wires, vcss, labels = proofs64
    bad = T.RangeProof.from_bytes(wires[1])
    bad.t_x = bad.t_x + T.Scalar.one()
    tok, jok, tts, jts = _both(64, 1, [wires[0], bad.to_bytes(), wires[2]],
                               vcss, labels)
    assert not tok and not jok
    assert tts == jts


def test_wrong_transcript_label_rejected(proofs64):
    wires, vcss, labels = proofs64
    tok, jok, tts, jts = _both(64, 1, wires, vcss,
                               [labels[0], b"not the label", labels[2]])
    assert not tok and not jok
    assert tts == jts


def test_empty_batch_raises():
    bv = BatchVerifier(T_BP, T_PC, n=8, m=1, device="cpu")
    with pytest.raises(ValueError):
        bv.verify_batch([], [], [])


def test_aggregated_m2_n8():
    wires, vcss, labels = _make(2, 8, 2, 52)
    tok, jok, tts, jts = _both(8, 2, wires, vcss, labels)
    assert tok and jok
    assert tts == jts
    # a commitment swapped between the two parties is rejected by both
    swapped = [vcss[0][::-1], vcss[1]]
    tok, jok, _, _ = _both(8, 2, wires, swapped, labels)
    assert not tok and not jok


def test_sub_batches_and_golden_vector(monkeypatch):
    """The Rust crate's golden n=64, m=1 proof, alongside the port's own
    proofs, split into sub-batches of two (three sub-batches)."""
    from bulletproofs_tpu_torch.config import settings
    monkeypatch.setattr(settings, "fused_verify_chunk", 2)
    with open(os.path.join(HERE, "golden_vectors.json")) as fh:
        data = json.load(fh)
    wires, vcss, labels = _make(4, 64, 1, 53)
    wires.append(bytes.fromhex(data["proofs"][3][0]))
    vcss.append([bytes.fromhex(data["value_commitments"][0])])
    labels.append(data["transcript_label"].encode())
    bv = BatchVerifier(T_BP, T_PC, n=64, m=1, device="cpu")
    assert bv.sub_batch == 2
    ts = [T.Transcript(l) for l in labels]
    bv.verify_batch([T.RangeProof.from_bytes(w) for w in wires], vcss, ts,
                    rng=Rng(9))
    jts = [J.Transcript(l) for l in labels]
    JBatchVerifier(J_BP, J_PC, n=64, m=1, prefer_host=True).verify_batch(
        [J.RangeProof.from_bytes(w) for w in wires], vcss, jts, rng=Rng(9))
    assert [t.challenge_bytes(b"x", 32) for t in ts] == \
        [t.challenge_bytes(b"x", 32) for t in jts]


def test_static_generators_match_jax_weights():
    """The JAX verifier's generator tensor, converted by from_jax_lanes,
    equals the port's own static table limb for limb."""
    jbv = JBatchVerifier(J_BP, J_PC, n=64, m=1, prefer_host=True)
    tbv = BatchVerifier(T_BP, T_PC, n=64, m=1, device="cpu")
    assert np.array_equal(from_jax_lanes(np.asarray(jbv._static_dev)),
                          tbv.static_lanes)
    assert tbv.static_lanes.shape == (4, 10, 130)


def test_default_device_is_cuda():
    """With no card, the default device raises instead of falling back."""
    if torch.cuda.is_available():
        bv = BatchVerifier(T_BP, T_PC, n=8, m=1)
        assert bv.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            BatchVerifier(T_BP, T_PC, n=8, m=1)


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter: import the port, make 3 proofs and verify
    them on the CPU, prove 2 with the batch prover's device-transcript
    route, then 3 aggregated m = 2 proofs on that route, verified on the
    chunked route over two chunks; verify an R1CS shuffle on the device
    route, batch-verify two linear proofs on theirs, run the MXU probe's
    chains and hash 4 rows to the group for both MSM routes (plain
    versions); neither jax nor bulletproofs_tpu gets imported."""
    code = """
import random, sys
import bulletproofs_tpu_torch as T
from bulletproofs_tpu_torch.parallel.batch_verify import BatchVerifier
class R:
    def __init__(s, seed): s.r = random.Random(seed)
    def randbytes(s, n): return s.r.randbytes(n)
rng = R(5)
bp, pc = T.BulletproofGens(8, 1), T.PedersenGens()
ps, vs, ts = [], [], []
for i in range(3):
    p, v = T.RangeProof.prove_single(bp, pc, T.Transcript(b"iso"), i,
                                     T.Scalar.random(rng), 8, rng=rng)
    ps.append(p); vs.append([v]); ts.append(T.Transcript(b"iso"))
BatchVerifier(bp, pc, n=8, m=1, device="cpu").verify_batch(ps, vs, ts, rng=rng)
# the batch prover on its device-transcript route (the default), m = 1
p1 = T.BatchProver(bp, pc, 8, device="cpu")
assert p1.fused
ps, vs = p1.prove_batch([9, 250], [T.Scalar(3), T.Scalar(4)],
                        [T.Transcript(b"iso1"), T.Transcript(b"iso1")], rng=rng)
ps[1].verify_single(bp, pc, T.Transcript(b"iso1"), vs[1], 8)
# the aggregated prover (m = 2, device-transcript route) and the chunked
# verifier route
from bulletproofs_tpu_torch.config import settings
bp2 = T.BulletproofGens(8, 2)
ts = [T.Transcript(b"iso2 %d" % i) for i in range(3)]
p2 = T.BatchProver(bp2, pc, 8, m=2, device="cpu")
ps, vs = p2.prove_batch(
    [[1, 2], [3, 4], [255, 0]],
    [[T.Scalar(5), T.Scalar(6)] for _ in range(3)], ts, rng=rng)
settings.fused_verify_max_nm, settings.verify_chunk_pts = 8, 28
BatchVerifier(bp2, pc, n=8, m=2, device="cpu").verify_batch(
    ps, vs, [T.Transcript(b"iso2 %d" % i) for i in range(3)], rng=rng)
# R1CS: a k = 5 shuffle (8 multipliers) on the device mega-MSM route
from bulletproofs_tpu_torch.benches import shuffle as SH
from bulletproofs_tpu_torch.proofs.r1cs import verifier as VM
VM._NATIVE_MIN_N = settings.r1cs_device_msm_floor = 8
bpr = T.BulletproofGens(16, 1)
ins, outs, proof = SH.prove_shuffle(pc, bpr, b"iso r1cs",
                                    *SH.shuffle_values(5, 1), rng)
SH.shuffle_verifier(b"iso r1cs", ins, outs).verify(proof, pc, bpr, rng=rng,
                                                   device="cpu")
# linear proofs: a batch of two on the device route
from bulletproofs_tpu_torch.core.ristretto import multiscalar_mul
from bulletproofs_tpu_torch.utils.util import inner_product
G = T.BulletproofGens(4, 1).share(0).G(4)
items = []
for i in range(2):
    a = [T.Scalar.random(rng) for _ in range(4)]
    b = [T.Scalar.random(rng) for _ in range(4)]
    r = T.Scalar.random(rng)
    C = multiscalar_mul(a + [r, inner_product(a, b)],
                        G + [pc.B_blinding, pc.B]).compress()
    items.append((T.LinearProof.create(T.Transcript(b"iso lin"), rng, C, r,
                                       a, b, list(G), pc.B, pc.B_blinding),
                  C, b))
T.LinearProof.batch_verify([(p, T.Transcript(b"iso lin"), C, b)
                            for p, C, b in items], G, pc.B, pc.B_blinding,
                           rng=rng, use_device=True, device="cpu")
# the MXU probe's chains
from bulletproofs_tpu_torch.benches import mxu_fmul_probe as PR
res = PR.run("cpu", lanes=4, steps=2, reps=1, log=lambda *a: None)
assert res["oracle_ok"] and bool((res["vpu_out"] == res["mxu_out"]).all())
# the K4b bench's helpers
from bulletproofs_tpu_torch.benches import horner as HB
assert HB.latency_floor_ms(1980) > 0
# the K11 bench's inputs and the binning's plain version
from bulletproofs_tpu_torch.benches import accumulate_z as AZB
from bulletproofs_tpu_torch.ops import msm as MSM
pts, dig = AZB.edge_inputs("fewer points than lanes", 1, "cpu")
assert MSM.bin_points(pts, dig)[1].shape == (64, 8, 1, 32)
# the north-star MSM entry: hash to the group, normalize_z, both routes
import numpy as np, torch
from bulletproofs_tpu_torch.ops import curve as CV
pts = CV.from_uniform_bytes(np.arange(256, dtype=np.uint8).reshape(4, 64),
                            device="cpu")
sc = MSM.bytes_tensor(bytes(range(1, 129)), "cpu")
assert torch.equal(
    CV.compress_plain(MSM.msm_lanes_niels_flag(MSM.normalize_z(pts), sc)[0]),
    CV.compress_plain(MSM.msm_lanes_flag(pts, sc)[0]))
# the K1 / K14 bench's helpers and the chunked-verify bench
from bulletproofs_tpu_torch.benches import field_kernels as FKB
from bulletproofs_tpu_torch.benches import chunked_verify as CVB
assert FKB.sinv_latency_floor_ms(1980) > 0 and CVB.Rng(1).randbytes(4)
bad = [k for k in sys.modules
       if k == "jax" or k.startswith("jax.") or k == "bulletproofs_tpu"
       or k.startswith("bulletproofs_tpu.")]
assert not bad, bad
print("isolated")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout


def test_recorded_verify_calls_keep_verdicts_and_transcripts():
    """benches/verify_calls.record_verify_calls wraps the fused route's
    stages and records each call without changing what the call does: the
    transcripts after a recorded call equal an unrecorded call's, every
    stage is timed (one replay a sub-batch, three uploads a sub-batch),
    and the verifier and the ops modules are restored afterwards."""
    from bulletproofs_tpu_torch.benches import verify_calls as VC
    from bulletproofs_tpu_torch.ops import curve as C
    from bulletproofs_tpu_torch.ops import verify as V
    wires, vcss, labels = _make(3, 8, 1, 40)
    proofs = [T.RangeProof.from_bytes(w) for w in wires]
    bp = T.BulletproofGens(8, 1)
    bv = BatchVerifier(bp, T_PC, n=8, m=1, device="cpu")
    after = []

    def call(r):
        ts = [T.Transcript(l) for l in labels]
        bv.verify_batch(proofs, vcss, ts, rng=Rng(41))
        after.append([t.strobe.buf.raw for t in ts])

    decompress, fused_tail = C.decompress, V.fused_tail
    recs = VC.record_verify_calls(bv, call, 1, lambda *a: None, cuda=False)
    call(None)
    assert after[0] == after[1]
    (rec,) = recs
    st = rec["stages"]
    assert len(st["replay"]) == 1 and len(st["_upload"]) == 3
    assert set(st) == {"_serialize", "replay", "_upload", "K1 launch",
                       "fused_tail launches", "flag sync",
                       "outside verify_batch"}
    assert rec["wall_ms"] >= sum(sum(v) for k, v in st.items()
                                 if k in ("_serialize", "replay"))
    assert "replay" not in bv.__dict__ and "verify_batch" not in bv.__dict__
    assert C.decompress is decompress and V.fused_tail is fused_tail
