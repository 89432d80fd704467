"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same CUDA tensors (exact: integer arithmetic, tolerance 0),
and the batch verifier on the card.  Marked `gpu`; each test skips when no
CUDA device is present.  Run on a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_gpu.py -m gpu
"""

import random

import numpy as np
import pytest
import torch

from bulletproofs_tpu_torch import (BulletproofGens, PedersenGens, ProofError,
                                    RangeProof, Scalar, Transcript)
from bulletproofs_tpu_torch.core.ristretto import RISTRETTO_BASEPOINT
from bulletproofs_tpu_torch.benches import accumulate_z as AZ
from bulletproofs_tpu_torch.benches import compress as CB
from bulletproofs_tpu_torch.benches import horner as HB
from bulletproofs_tpu_torch.core.scalar import L as ELL
from bulletproofs_tpu_torch.ops import _cuda
from bulletproofs_tpu_torch.ops import curve as C
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops import scalar as S
from bulletproofs_tpu_torch.ops import verify as V
from bulletproofs_tpu_torch.ops.limbs import sc_ints_to_limbs
from bulletproofs_tpu_torch.parallel.batch_verify import BatchVerifier

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


class Rng:
    def __init__(self, seed):
        self.r = random.Random(seed)

    def randbytes(self, n):
        return self.r.randbytes(n)


def _encodings(k, seed):
    r = random.Random(seed)
    enc = [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
           .compress() for _ in range(k // 2)]
    enc += [r.randbytes(32) for _ in range(k - len(enc))]
    return torch.as_tensor(np.frombuffer(b"".join(enc), np.uint8)
                           .reshape(k, 32).copy())


def test_decompress_kernel_matches_plain(cuda):
    raw = _encodings(1000, 61).to(cuda)
    before = _cuda.LAUNCHES["decompress"]
    valid, pts = C.decompress(raw)
    pvalid, ppts = C.decompress_plain(raw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["decompress"] == before + 1
    assert torch.equal(valid, pvalid) and torch.equal(pts, ppts)
    assert bool(valid[:500].all())


def test_emit_kernel_matches_plain(cuda):
    n, m, P = 64, 1, 37
    _, nblk, _ = V.shape(n, m)
    r = random.Random(62)
    blk = torch.as_tensor(np.frombuffer(
        b"".join(r.randrange(ELL).to_bytes(32, "little")
                 for _ in range(P * nblk)), np.uint8
    ).reshape(P, nblk, 32).copy()).to(cuda)
    got = V.emit(n, m, blk)
    want = V.emit_plain(n, m, blk)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,m,P", [(64, 1, 2048), (64, 1, 2047), (8, 2, 13),
                                   (64, 16, 5)])
def test_emit_kernel_at_path_shapes(cuda, n, m, P):
    """K2 against emit_plain, digits and partials exact, at a verifier
    sub-batch (2048 m=1 proofs), one proof short of it, a short tile at
    nm = 16 and the fused m=16 cross-check's nm = 1024; a 2048-proof
    sub-batch is one wave of the card's resident blocks."""
    _, nblk, _ = V.shape(n, m)
    r = random.Random(65 + P)
    blk = torch.as_tensor(np.frombuffer(
        b"".join(r.randrange(ELL).to_bytes(32, "little")
                 for _ in range(P * nblk)), np.uint8
    ).reshape(P, nblk, 32).copy()).to(cuda)
    before = _cuda.LAUNCHES["emit"]
    got = V.emit(n, m, blk)
    want = V.emit_plain(n, m, blk)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["emit"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = -(-2048 // V.EMIT_TILE)
    assert V.warps_per_sm() // (V.EMIT_TILE) * sms >= tiles


@pytest.mark.parametrize("lanes", [1 << k for k in range(1, 10)])
def test_reduce_kernel_at_every_lane_count(cuda, lanes):
    """K4a against reduce_plain limb for limb on a seeded slab of
    benches.accumulate_z.make_points at every lane count the wrapper
    takes; the 512 buckets are one wave of the card's resident blocks."""
    pts = AZ.make_points(64 * 8 * lanes, 70 + lanes, cuda)
    slab = pts.reshape(4, 10, 64, 8, lanes).permute(2, 3, 0, 1, 4) \
        .contiguous()
    before = _cuda.LAUNCHES["msm_reduce"]
    got = M.reduce(slab)
    want = M.reduce_plain(slab)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["msm_reduce"] == before + 1
    assert torch.equal(got, want)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert M.warps_per_sm()["msm_reduce"] // 2 * sms >= 64 * 8


def test_msm_kernels_match_plain(cuda):
    k = 700
    raw = _encodings(2 * k, 63)[:k].to(cuda)
    _, pts = C.decompress(raw)
    r = random.Random(64)
    digits = S.signed_digits(torch.as_tensor(
        sc_ints_to_limbs([r.randrange(ELL) for _ in range(k)])).to(cuda))
    niels = C.to_niels(pts).contiguous()
    slab = M.accumulate(niels, digits)
    assert torch.equal(slab, M.accumulate_plain(niels, digits))
    sums = M.reduce(slab)
    assert torch.equal(sums, M.reduce_plain(slab))
    out, flag = M.horner(sums)
    pout, pflag = M.horner_plain(sums)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and torch.equal(flag, pflag)


@pytest.mark.parametrize("case", HB.CASES + tuple(f"slab {i}"
                                                 for i in range(5)))
def test_horner_kernel_matches_plain_on_edge_sums(cuda, case):
    """K4b, one launch, against horner_plain limb for limb on bucket sums
    that stress the chain (benches.horner.edge_sums: every bucket the
    identity, the top window the identity, window 0 alone, projective and
    4-torsion representatives) and on five seeded slabs."""
    if case.startswith("slab"):
        sums = HB.slab_sums(2048, 90 + int(case[5:]), cuda)
    else:
        sums = HB.edge_sums(case, HB.slab_sums(2048, 89, cuda).cpu(),
                            91).to(cuda)
    before = _cuda.LAUNCHES["msm_horner"]
    out, flag = M.horner(sums)
    pout, pflag = M.horner_plain(sums.cpu())
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["msm_horner"] == before + 1
    assert torch.equal(out.cpu(), pout) and torch.equal(flag.cpu(), pflag)
    assert bool(flag[0]) == (case == "identity")


def test_wrappers_refuse_wrong_dtypes_on_cuda(cuda):
    with pytest.raises(TypeError):
        M.accumulate(torch.zeros((3, 10, 64), dtype=torch.int64, device=cuda),
                     torch.zeros((64, 64), dtype=torch.int8, device=cuda))


def test_verify_batch_on_card(cuda, monkeypatch):
    from bulletproofs_tpu_torch.config import settings
    monkeypatch.setattr(settings, "fused_verify_chunk", 2)
    bp, pc = BulletproofGens(8, 1), PedersenGens()
    rng = Rng(65)
    proofs, vcs = [], []
    for i in range(5):
        p, v = RangeProof.prove_single(bp, pc, Transcript(b"gpu"), i,
                                       Scalar.random(rng), 8, rng=rng)
        proofs.append(p)
        vcs.append([v])
    bv = BatchVerifier(bp, pc, n=8, m=1, device=cuda)
    real_to_niels = C.to_niels

    def to_niels(pts):              # the fused tail's binning makes them
        assert pts.device.type == "cpu", "to_niels on the card"
        return real_to_niels(pts)
    monkeypatch.setattr(C, "to_niels", to_niels)
    bv.verify_batch(proofs, vcs, [Transcript(b"gpu") for _ in proofs],
                    rng=rng)
    with pytest.raises(ProofError):
        bv.verify_batch(proofs, vcs[::-1], [Transcript(b"gpu")
                                            for _ in proofs], rng=rng)


def test_compress_kernel_matches_plain(cuda):
    r = random.Random(66)
    pts = [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(ELL)))
           for _ in range(300)]
    lanes = torch.as_tensor(C.points_to_lanes(pts)).to(cuda)
    # other projective representatives, as the MSMs leave them
    lanes = torch.cat([lanes, C.from_coords(C.double(C.to_coords(lanes)))], -1)
    before = _cuda.LAUNCHES["compress"]
    got = C.compress(lanes)
    want = C.compress_plain(lanes)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["compress"] == before + 1
    assert torch.equal(got, want)
    assert [bytes(b) for b in got[:300].cpu().numpy()] == [p.compress()
                                                            for p in pts]


def test_fixed_msm_kernels_match_plain(cuda):
    from bulletproofs_tpu_torch.ops import fixed_msm as FM
    r = random.Random(67)
    bases = [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
             for _ in range(5)]
    tables = FM.FixedBaseTables(bases, cuda)
    g = np.random.default_rng(68)
    digits = torch.as_tensor(g.integers(-7, 9, (5 * 64, 300)).astype(np.int8)
                             ).to(cuda)
    assert FM.pick_splits(5 * 64, 300) > 1
    slab = FM.accumulate(tables.niels, digits)
    assert torch.equal(slab, FM.accumulate_plain(tables.niels, digits))
    out = FM.reduce(slab)
    torch.cuda.synchronize()
    assert torch.equal(out, FM.reduce_plain(slab))


def test_fixed_msm_direct_form_matches_one_hot(cuda):
    """K6's direct form (public rows) equals its plain version limb for
    limb at a split above 16 (1280 rows of a row map over 45 lanes, not a
    multiple of 32, zero digits included), and K7's outputs of both forms
    give the same compressed points; K7's chunk merge equals reduce_plain
    on 40, 20 and 5 of those chunks (4, 2 and 1 groups)."""
    from bulletproofs_tpu_torch.ops import fixed_msm as FM
    r = random.Random(86)
    bases = [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
             for _ in range(20)]
    tables = FM.FixedBaseTables(bases, cuda)
    sel = torch.as_tensor(np.random.default_rng(85).permutation(20 * 64)
                          ).to(cuda)
    d = np.random.default_rng(87).integers(-7, 9, (20 * 64, 45))
    d[:, 3] = 0
    d[100:400] = 0
    digits = torch.as_tensor(d.astype(np.int8)).to(cuda)
    assert FM.pick_splits(20 * 64, 45, FM.TARGET_THREADS_DIRECT) == 40
    before = dict(_cuda.LAUNCHES)
    vt = FM.accumulate_direct(tables.mult, digits, sel)
    ct = FM.accumulate(tables.niels.index_select(2, sel), digits)
    plain = FM.accumulate_direct_plain(tables.mult, digits, sel)
    torch.cuda.synchronize()
    assert vt.shape == (40, 1, 4, 10, 45)
    assert torch.equal(vt, plain)
    assert _cuda.LAUNCHES["fixed_accumulate_vt"] == \
        before["fixed_accumulate_vt"] + 1
    assert _cuda.LAUNCHES["fixed_accumulate"] == before["fixed_accumulate"] + 1
    assert torch.equal(C.compress(FM.reduce(vt)), C.compress(FM.reduce(ct)))
    for k in (40, 20, 5):                 # K7 with 4, 2 and 1 chunk groups
        part = vt[:k].contiguous()
        out = FM.reduce(part)
        torch.cuda.synchronize()
        assert torch.equal(out, FM.reduce_plain(part))


@pytest.mark.parametrize("rows, lanes", [(65600, 512), (32832, 1024)])
def test_fixed_msm_direct_form_at_the_cells_shapes(cuda, rows, lanes):
    """K6's direct form at the IPP L / R shapes of the benchmark's cells
    (m = 16: (N + 1) 64 = 65,600 rows x 512 proofs; m = 8: 32,832 x
    1,024), through a row map of that length into a table of 64 bases:
    the slab equals the plain version's limb for limb, and K7's chunk
    merge equals reduce_plain; one wave at the split target."""
    from bulletproofs_tpu_torch.ops import fixed_msm as FM
    r = random.Random(rows)
    bases = [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
             for _ in range(64)]
    tables = FM.FixedBaseTables(bases, cuda)
    g = np.random.default_rng(lanes)
    sel = torch.as_tensor(g.integers(0, 64 * 64, rows)).to(cuda)
    digits = torch.as_tensor(g.integers(-7, 9, (rows, lanes)).astype(
        np.int8)).to(cuda)
    slab = FM.accumulate_direct(tables.mult, digits, sel)
    splits = slab.shape[0]
    assert splits * lanes == FM.TARGET_THREADS_DIRECT
    assert torch.equal(slab, FM.accumulate_direct_plain(tables.mult, digits,
                                                        sel))
    out = FM.reduce(slab)
    torch.cuda.synchronize()
    assert torch.equal(out, FM.reduce_plain(slab))


def test_fixed_direct_residency_meets_its_split_target(cuda):
    """The direct form keeps no shared memory: registers alone give it
    DIRECT_MIN_BLOCKS (2) resident blocks of DIRECT_THREADS (128) per SM,
    8 warps, the count its split target assumes."""
    from bulletproofs_tpu_torch.ops import fixed_msm as FM
    per_sm = FM.blocks_per_sm()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert per_sm["fixed_accumulate_vt"] >= FM.DIRECT_MIN_BLOCKS
    assert FM.DIRECT_MIN_BLOCKS * FM.DIRECT_THREADS // 32 >= 8
    assert FM.TARGET_THREADS_DIRECT == \
        sms * FM.DIRECT_MIN_BLOCKS * FM.DIRECT_THREADS


def test_prove_bytes_equal_the_one_hot_forms(cuda):
    """One m = 2 prove on the card, its IPP rows through K6's direct form,
    against the same prove with those rows sent to the one-hot form over
    the gathered Niels rows (the parent design's points, limb for limb):
    the same proofs, commitments and transcripts, byte for byte."""
    from bulletproofs_tpu_torch import BatchProver
    from bulletproofs_tpu_torch.ops import fixed_msm as FM
    bp, pc = BulletproofGens(8, 2), PedersenGens()
    prover = BatchProver(bp, pc, 8, 2, device=cuda)
    values = [[5, 250], [1, 2], [255, 0]]
    blinds = [[Scalar(3 + i), Scalar(9 + i)] for i in range(3)]

    def prove():
        ts = [Transcript(b"gpu one-hot %d" % i) for i in range(3)]
        ps, vs = prover.prove_batch(values, blinds, ts, rng=Rng(89))
        torch.cuda.synchronize()
        return ([p.to_bytes() for p in ps], vs,
                [t.strobe.buf.raw for t in ts])

    direct = prove()
    real = FM.msm_digits_niels
    FM.msm_digits_niels = lambda niels, digits, consttime=True: real(
        niels, digits, True)
    try:
        one_hot = prove()
    finally:
        FM.msm_digits_niels = real
    assert direct == one_hot


def test_prove_routes_public_rows_to_the_direct_form(cuda):
    """One half of a device-transcript prove at n = 8, m = 1 launches K6's
    one-hot form 4 times (V, A, S, T), its direct form 2 log2(8) = 6 times
    (each IPP round's L and R) and K7 once per K6 launch: its 8-bucket
    form after the one-hot form, its chunk merge after the direct form."""
    from bulletproofs_tpu_torch import BatchProver
    bp, pc = BulletproofGens(8, 1), PedersenGens()
    prover = BatchProver(bp, pc, 8, device=cuda)
    labels = [b"gpu routes %d" % i for i in range(5)]
    _cuda.reset_counts()
    proofs, vcs = prover.prove_batch(
        [1, 2, 3, 4, 255], [Scalar(11 + i) for i in range(5)],
        [Transcript(l) for l in labels], rng=Rng(88))
    torch.cuda.synchronize()
    got = {k: _cuda.LAUNCHES[k] for k in
           ("fixed_accumulate", "fixed_accumulate_vt", "fixed_reduce",
            "fixed_merge")}
    assert got == {"fixed_accumulate": 4, "fixed_accumulate_vt": 6,
                   "fixed_reduce": 4, "fixed_merge": 6}
    proofs[4].verify_single(bp, pc, Transcript(labels[4]), vcs[4], 8)


def test_prove_batch_on_card(cuda):
    from bulletproofs_tpu_torch import BatchProver
    bp, pc = BulletproofGens(64, 1), PedersenGens()
    rng = Rng(69)
    labels = [b"gpu prove %d" % i for i in range(16)]
    values = [rng.r.randrange(1 << 64) for _ in labels]
    proofs, vcs = BatchProver(bp, pc, 64, device=cuda).prove_batch(
        values, [Scalar.random(rng) for _ in labels],
        [Transcript(l) for l in labels], rng=rng)
    BatchVerifier(bp, pc, n=64, m=1, device=cuda).verify_batch(
        proofs, [[v] for v in vcs], [Transcript(l) for l in labels], rng=rng)
    proofs[3].verify_single(bp, pc, Transcript(labels[3]), vcs[3], 64)


def _device_kernels(prof):
    """Names of the kernels (and copies) a torch.profiler run saw on the
    card, in order, without their argument lists."""
    return [e.name.split("(")[0] for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _sc_vectors(rows, cols, seed, top=ELL):
    r = random.Random(seed)
    vals = [r.randrange(top) for _ in range(rows * cols)]
    return torch.as_tensor(sc_ints_to_limbs(vals)).reshape(
        9, rows, cols).permute(1, 0, 2).contiguous()


def test_fold_kernels_match_plain(cuda):
    from bulletproofs_tpu_torch.ops import fold as FO
    R, P = 37, 100                                # ragged: any shape runs
    x, y = _sc_vectors(R, P, 70).to(cuda), _sc_vectors(R, P, 71).to(cuda)
    u, v = _sc_vectors(1, P, 72)[0].to(cuda), _sc_vectors(1, P, 73)[0].to(cuda)
    mask = torch.arange(R, device=cuda) % 3 == 0
    before = dict(_cuda.LAUNCHES)
    got = (FO.fold_lanes(x, y, u, v), FO.smul_lanes(x, mask, u, v))
    want = (FO.fold_plain(x, y, u, v), FO.smul_plain(x, mask, u, v))
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["fold"] == before["fold"] + 1
    assert _cuda.LAUNCHES["smul"] == before["smul"] + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("N, P", [(64, 4096), (1024, 256), (16, 37)])
def test_fold_pair_at_every_round(cuda, N, P):
    """K8's one launch a round against fold_pair_plain (torch.equal) at the
    m=1 and m=16 provers' round-1 shapes and a ragged one, under every
    round's device maps (dyn_round_xs) and the last fold's; one K8 launch
    a call, no other kernel."""
    from bulletproofs_tpu_torch.ops import fold as FO
    from bulletproofs_tpu_torch.ops import prover_stages as PS
    from torch.profiler import ProfilerActivity, profile
    a, b = _sc_vectors(N, P, 76).to(cuda), _sc_vectors(N, P, 77).to(cuda)
    u, v = _sc_vectors(1, P, 78)[0].to(cuda), _sc_vectors(1, P, 79)[0].to(cuda)
    xs = PS.dyn_round_xs(N, cuda)
    maps = [(xs["idx_fold"][k], xs["mask_fold"][k])
            for k in range(xs["k"].shape[0])] + [PS._fold_maps(N, 1, cuda)]
    for idx, mask in maps:
        before = _cuda.LAUNCHES["fold"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = FO.fold_pair(a, b, u, v, idx, mask)
            torch.cuda.synchronize()
        assert _cuda.LAUNCHES["fold"] == before + 1
        kernels = _device_kernels(prof)
        if kernels:                       # where the profiler sees the card
            assert kernels == ["fold_kernel"], kernels
        want = FO.fold_pair_plain(a, b, u, v, idx, mask)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_prove_launches_k8_once_a_round(cuda):
    """A device-transcript prove at n = 8, m = 1 (one half) folds a and b in
    one K8 launch a round: log2(8) = 3 (rounds 1, 2 and the last fold)."""
    from bulletproofs_tpu_torch import BatchProver
    bp, pc = BulletproofGens(8, 1), PedersenGens()
    _cuda.reset_counts()
    BatchProver(bp, pc, 8, device=cuda).prove_batch(
        [5, 6, 7], [Scalar(21 + i) for i in range(3)],
        [Transcript(b"k8 %d" % i) for i in range(3)], rng=Rng(89))
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["fold"] == 3


@pytest.mark.parametrize("N, P", [(64, 4096), (1024, 256), (13, 37)])
def test_smul_pair_matches_plain(cuda, N, P):
    """K9's one launch for gw and hw against smul_pair_plain (torch.equal)
    at the m=1 and m=16 provers' round-1 shapes and a ragged one, under a
    mask that is neither all set nor all clear; one K9 launch, no other
    kernel."""
    from bulletproofs_tpu_torch.ops import fold as FO
    from torch.profiler import ProfilerActivity, profile
    x, y = _sc_vectors(N, P, 90).to(cuda), _sc_vectors(N, P, 91).to(cuda)
    m1, m0 = (_sc_vectors(1, P, 92)[0].to(cuda),
              _sc_vectors(1, P, 93)[0].to(cuda))
    mask = torch.arange(N, device=cuda) % 4 < 2
    before = _cuda.LAUNCHES["smul"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = FO.smul_pair(x, y, mask, m1, m0)
        torch.cuda.synchronize()
    assert _cuda.LAUNCHES["smul"] == before + 1
    kernels = _device_kernels(prof)
    if kernels:                           # where the profiler sees the card
        assert kernels == ["smul_kernel"], kernels
    want = FO.smul_pair_plain(x, y, mask, m1, m0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_prove_launches_k9_once_a_round(cuda):
    """A device-transcript prove at n = 8, m = 1 (one half) updates gw and
    hw in one K9 launch a round: rounds 1 and 2 (the last fold updates
    neither); the per-stage route's round_fold updates them in its last
    fold too: 3."""
    from bulletproofs_tpu_torch import BatchProver
    bp, pc = BulletproofGens(8, 1), PedersenGens()
    prover = BatchProver(bp, pc, 8, device=cuda)
    for fused, want in ((True, 2), (False, 3)):
        prover.fused = fused
        _cuda.reset_counts()
        prover.prove_batch(
            [5, 6, 7], [Scalar(21 + i) for i in range(3)],
            [Transcript(b"k9 %d" % i) for i in range(3)], rng=Rng(94))
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["smul"] == want, fused


def test_digits_kernel_matches_plain(cuda):
    """Canonical coefficients and values up to 2^261 (the guard's
    reduction), as the fixed-base stream (nb * 64, Q)."""
    from bulletproofs_tpu_torch.ops import fold as FO
    for x in (_sc_vectors(5, 300, 74), _sc_vectors(3, 70, 75, 1 << 261)):
        x = x.to(cuda)
        got = FO.digits_lanes(x)
        want = FO.digits_plain(x)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_accumulate_z_and_msm_lanes_match_plain(cuda):
    k = 700
    raw = _encodings(2 * k, 76)[:k].to(cuda)
    _, pts = C.decompress(raw)
    pts = C.from_coords(C.double(C.to_coords(pts)))           # Z != 1
    r = random.Random(77)
    vals = [r.randrange(1 << 256) for _ in range(k)]
    sc = torch.as_tensor(np.frombuffer(b"".join(
        v.to_bytes(32, "little") for v in vals), np.uint8).reshape(k, 32)
        .copy()).to(cuda)
    digits = S.signed_digits(S.reduce_top(S.from_bytes32(sc)))
    slab = M.accumulate_z(pts, digits)
    assert torch.equal(slab, M.accumulate_z_plain(pts, digits))
    out, flag = M.msm_lanes_flag(pts, sc)
    torch.cuda.synchronize()
    host = C.lanes_to_points(pts.cpu().numpy())
    from bulletproofs_tpu_torch.core.ristretto import multiscalar_mul
    ref = multiscalar_mul([Scalar(v % ELL) for v in vals], host)
    assert C.lanes_to_points(out.cpu().numpy())[0].compress() \
        == ref.compress()
    assert not bool(flag[0])


@pytest.mark.parametrize("case", [c for c, _ in AZ.CASES] + [196653])
def test_bin_kernel_matches_plain(cuda, case):
    """msm_bin, two launches (the lists and rows, then the ranks), against
    bin_points_plain on the CPU: its five outputs rows (the points
    point-major), mask (each bucket's bit mask of lane steps), sign, cnt
    (each list's length) and perm (each bucket's lanes ranked by length),
    on the edge cases and at the R1CS k = 2^15 mega-MSM's 196,653 points."""
    if case == 196653:
        pts, dig = AZ.make_points(case, 7, cuda), AZ.make_digits(case, 8, cuda)
    else:
        pts, dig = AZ.edge_inputs(case, 7, cuda)
    before = _cuda.LAUNCHES["msm_bin"]
    got = M.bin_points(pts, dig)
    want = M.bin_points_plain(pts.cpu(), dig.cpu())
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["msm_bin"] == before + 2
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", [c for c, _ in AZ.CASES])
def test_accumulate_z_kernel_matches_plain_on_edge_cases(cuda, case):
    """K11 (msm_bin then msm_accumulate_z) against accumulate_z_plain limb
    for limb on the edge cases: every digit 0 (every bucket the identity),
    every digit +-8, fewer points than lanes, a ragged lane step, every
    digit negative."""
    pts, dig = AZ.edge_inputs(case, 7, cuda)
    before = (_cuda.LAUNCHES["msm_bin"], _cuda.LAUNCHES["msm_accumulate_z"])
    slab = M.accumulate_z(pts, dig)
    want = M.accumulate_z_plain(pts.cpu(), dig.cpu())
    torch.cuda.synchronize()
    assert (_cuda.LAUNCHES["msm_bin"], _cuda.LAUNCHES["msm_accumulate_z"]) \
        == (before[0] + 2, before[1] + 1)
    assert torch.equal(slab.cpu(), want)


def _two_sources(case, cuda):
    """(Niels points, Z = 1 points, digits): a case's points split into a
    Niels prefix (the first third) and Z = 1 extended points after it, or
    130 static-like Niels points before 196,523 Z = 1 points (196,653)."""
    if case == 196653:
        pre = AZ.make_niels(130, 9, cuda)
        pts = M.normalize_z(AZ.make_points(case - 130, 10, cuda))
        return pre, pts, AZ.make_digits(case, 11, cuda)
    ext, dig = AZ.edge_inputs(case, 7, cuda)
    ext = M.normalize_z(ext)
    k = ext.shape[-1] // 3
    return C.to_niels(ext[:, :, :k]).contiguous(), \
        ext[:, :, k:].contiguous(), dig


@pytest.mark.parametrize("form", ["niels", "two sources"])
@pytest.mark.parametrize("case", [c for c, _ in AZ.CASES] + [196653])
def test_bin_niels_kernel_matches_plain(cuda, case, form):
    """msm_bin_niels (K3's binning), two launches, against its plain
    version on the CPU: the Niels rows padded to 32 words, mask, sign, cnt
    and perm; for Niels points alone (bin_points) and for a Niels prefix
    followed by Z = 1 extended points whose Niels rows the kernel makes
    (bin_niels), on the edge cases and at 196,653 points."""
    if form == "niels":
        if case == 196653:
            pts, dig = AZ.make_niels(case, 9, cuda), AZ.make_digits(case, 11,
                                                                     cuda)
        else:
            pts, dig = AZ.edge_inputs(case, 7, cuda, niels=True)
        run = lambda: M.bin_points(pts, dig)                  # noqa: E731
        plain = lambda: M.bin_points_plain(pts.cpu(), dig.cpu())  # noqa: E731
    else:
        pre, pts, dig = _two_sources(case, cuda)
        run = lambda: M.bin_niels(pre, pts, dig)              # noqa: E731
        plain = lambda: M.bin_niels(pre.cpu(), pts.cpu(),     # noqa: E731
                                    dig.cpu())
    before = _cuda.LAUNCHES["msm_bin_niels"]
    got = run()
    want = plain()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["msm_bin_niels"] == before + 2
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", [c for c, _ in AZ.CASES])
def test_accumulate_kernel_matches_plain_on_edge_cases(cuda, case):
    """K3 (msm_bin_niels then msm_accumulate) against accumulate_plain limb
    for limb on the edge cases: every digit 0, every digit +-8, fewer
    points than lanes, a ragged lane step, every digit negative."""
    pts, dig = AZ.edge_inputs(case, 7, cuda, niels=True)
    keys = ("msm_bin_niels", "msm_accumulate")
    before = [_cuda.LAUNCHES[k] for k in keys]
    slab = M.accumulate(pts, dig)
    want = M.accumulate_plain(pts.cpu(), dig.cpu())
    torch.cuda.synchronize()
    assert [_cuda.LAUNCHES[k] for k in keys] == [before[0] + 2, before[1] + 1]
    assert torch.equal(slab.cpu(), want)


def test_accumulate_kernel_at_a_verify_sub_batch(cuda):
    """K3 and its binning at a 2048-proof sub-batch's 34,946 points (512
    lanes): 130 static Niels points and 34,816 Z = 1 decoded-like points
    that the binning puts in Niels form, against their plain versions on
    the card."""
    pre = AZ.make_niels(130, 93, cuda)
    pts = M.normalize_z(AZ.make_points(34816, 95, cuda))
    dig = AZ.make_digits(34946, 94, cuda)
    binned = M.bin_niels(pre, pts, dig)
    assert binned[-1].shape[-1] == 512
    whole = torch.cat([pre, C.to_niels(pts)], dim=-1)
    assert all(torch.equal(a, b) for a, b in
               zip(binned, M.bin_points_plain(whole, dig)))
    slab = M.accumulate(pre, dig, pts)
    want = M.accumulate_plain(whole, dig)
    torch.cuda.synchronize()
    assert torch.equal(slab, want)


@pytest.mark.parametrize("n", [1, 31, 512, 4608, 8192, 12288])
def test_compress_kernel_at_the_prover_sizes(cuda, n):
    """K5 against compress_plain byte for byte at the prover's sizes and
    at 1 and 31 points, at the lanes per point compress_lanes picks and at
    every other: the identity (32 zero bytes) and the base point plus
    4-torsion (the base point's bytes) come first."""
    pts = CB.make_points(n, 95, cuda)
    want = C.compress_plain(pts)
    before = _cuda.LAUNCHES["compress"]
    got = C.compress(pts)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["compress"] == before + 1
    assert torch.equal(got, want)
    assert not bool(got[0].any())
    if n > 1:
        assert bytes(got[1].cpu().numpy()) == RISTRETTO_BASEPOINT.compress()
    for lp in C.COMPRESS_LPS:
        assert torch.equal(C._compress_kernel(pts, lp), want), lp


def test_aggregated_prove_and_chunked_verify_on_card(cuda, monkeypatch):
    from bulletproofs_tpu_torch import BatchProver
    from bulletproofs_tpu_torch.config import settings
    bp, pc = BulletproofGens(8, 2), PedersenGens()
    labels = [b"gpu agg %d" % i for i in range(5)]
    values = [[i, 255 - i] for i in range(5)]
    blinds = [[Scalar(7 + i), Scalar(9 + i)] for i in range(5)]
    out = []
    for device in (cuda, "cpu"):
        ts = [Transcript(l) for l in labels]
        ps, vs = BatchProver(bp, pc, 8, m=2, device=device).prove_batch(
            values, blinds, ts, rng=Rng(78))
        out.append(([p.to_bytes() for p in ps], vs, [t.strobe.buf.raw
                                                     for t in ts]))
    assert out[0] == out[1]
    monkeypatch.setattr(settings, "fused_verify_max_nm", 8)
    monkeypatch.setattr(settings, "verify_chunk_pts", 28)
    bv = BatchVerifier(bp, pc, n=8, m=2, device=cuda)
    before = _cuda.LAUNCHES["msm_accumulate_z"]
    proofs = [RangeProof.from_bytes(b) for b in out[0][0]]
    bv.verify_batch(proofs, out[0][1], [Transcript(l) for l in labels],
                    rng=Rng(79))
    assert _cuda.LAUNCHES["msm_accumulate_z"] == before + 4  # 3 chunks + final
    with pytest.raises(ProofError):
        bv.verify_batch(proofs, [out[0][1][0][::-1]] + out[0][1][1:],
                        [Transcript(l) for l in labels], rng=Rng(80))


def test_fixed_accumulate2_matches_plain(cuda):
    """K12 against its plain version; reduced and compressed, its points
    equal K6's."""
    from bulletproofs_tpu_torch.ops import fixed_msm as FM
    r = random.Random(81)
    bases = [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
             for _ in range(5)]
    tables = FM.FixedBaseTables(bases, cuda)
    niels = tables.niels[:, :, :5 * 64 - 3].contiguous()       # padded
    digits = torch.as_tensor(np.random.default_rng(82).integers(
        -7, 9, (5 * 64 - 3, 300)).astype(np.int8)).to(cuda)
    before = _cuda.LAUNCHES["fixed_accumulate2"]
    slab = FM.accumulate2(niels, digits)
    assert torch.equal(slab, FM.accumulate2_plain(niels, digits))
    got = C.compress(FM.reduce(slab))
    want = C.compress(FM.reduce(FM.accumulate(niels, digits)))
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["fixed_accumulate2"] == before + 1
    assert torch.equal(got, want)


def _k12_stream(cuda, rows, lanes, seed):
    """A Niels stream of `rows` rows (five bases' tables, repeated) and
    seeded digits (rows, lanes) on the card."""
    from bulletproofs_tpu_torch.ops import fixed_msm as FM
    r = random.Random(seed)
    bases = [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
             for _ in range(5)]
    niels = FM.FixedBaseTables(bases, cuda).niels
    niels = niels.repeat(1, 1, -(-rows // niels.shape[-1]))[:, :, :rows]
    digits = torch.as_tensor(np.random.default_rng(seed).integers(
        -7, 9, (rows, lanes)).astype(np.int8)).to(cuda)
    return niels.contiguous(), digits


@pytest.mark.parametrize("splits, lanes", [(7, 37), (3, 16), (1, 5)])
def test_fixed_accumulate2_two_rows_a_chunk(cuda, splits, lanes):
    """K12 launched directly with 2 rows a chunk (each of a lane's two
    threads adds one row), lanes not a multiple of 16: its slab equals
    the plain version's at that split limb for limb."""
    from bulletproofs_tpu_torch.ops import fixed_msm as FM
    niels, digits = _k12_stream(cuda, 2 * splits, lanes, 95 + splits)
    slab = torch.empty((splits, 8, 4, 10, lanes), dtype=torch.int32,
                       device=cuda)
    _cuda.launch("fixed_accumulate2", "fixed_msm", "bp_fixed_accumulate2",
                 niels, digits, slab, 2 * splits, lanes, splits)
    assert torch.equal(slab, FM._accumulate2_plain(niels, digits, splits))


def test_fixed_accumulate2_at_the_m16_s_stream(cuda):
    """K12 at the m=16 prover's S stream shape (131,136 rows x 256
    lanes, its split of 33 chunks): equal to its plain version, and its
    points, reduced and compressed, to K6's."""
    from bulletproofs_tpu_torch.ops import fixed_msm as FM
    niels, digits = _k12_stream(cuda, 131136, 256, 96)
    slab = FM.accumulate2(niels, digits)
    assert slab.shape[0] == 33
    assert torch.equal(slab, FM.accumulate2_plain(niels, digits))
    assert torch.equal(C.compress(FM.reduce(slab)),
                       C.compress(FM.reduce(FM.accumulate(niels, digits))))


def test_fixed_accumulate2_residency_equals_k6s(cuda):
    """One bucket set a thread keeps K12 at K6's 40 KB of static shared
    memory a block, so the runtime gives it as many blocks per SM."""
    from bulletproofs_tpu_torch.ops import fixed_msm as FM
    FM.accumulate2(*_k12_stream(cuda, 64, 16, 97))       # built and loaded
    per_sm = FM.blocks_per_sm()
    assert per_sm["fixed_accumulate2"] == per_sm["fixed_accumulate"] >= 5


def test_keccak_kernel_matches_plain(cuda):
    from bulletproofs_tpu_torch.ops import keccak_device as K
    from bulletproofs_tpu_torch.utils.keccak import f1600_state
    st = torch.as_tensor(np.random.default_rng(83).integers(
        0, 256, (200, 1000)).astype(np.uint8)).to(cuda)
    got = K.f1600_state_bytes(st)
    want = K.f1600_state_bytes_plain(st)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    host = st[:, 7].cpu().numpy().tobytes()
    assert got[:, 7].cpu().numpy().tobytes() == f1600_state(host)


@pytest.mark.parametrize("P", [1, 31, 256, 4096, 4097])
def test_keccak_kernel_with_and_without_a_pad(cuda, P):
    """K13 at one state, a ragged block, the m=16 and m=1 provers' state
    counts and one past the last full block, with the transcript's pad
    XORed in and without: against the plain version and the host
    permutation of a few states (the first, the last), one launch each."""
    from bulletproofs_tpu_torch.ops import keccak_device as K
    from bulletproofs_tpu_torch.utils.keccak import f1600_state
    r = np.random.default_rng(90 + P)
    st = torch.as_tensor(r.integers(0, 256, (200, P)).astype(np.uint8)).to(cuda)
    pad = torch.as_tensor(r.integers(0, 256, (200, 1)).astype(np.uint8)).to(cuda)
    for pd in (None, pad):
        before = _cuda.LAUNCHES["keccak_f1600"]
        got = K.f1600_state_bytes(st, pd)
        want = K.f1600_state_bytes_plain(st, pd)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["keccak_f1600"] == before + 1
        assert torch.equal(got, want)
        padded = st if pd is None else st ^ pd
        for p in {0, P // 2, P - 1}:
            assert got[:, p].cpu().numpy().tobytes() == f1600_state(
                padded[:, p].cpu().numpy().tobytes())


def test_transcript_permutation_is_one_launch(cuda):
    """DeviceStrobe._run_f with a pending pad: one kernel on the card, K13
    (the pad XORed inside it), no XOR launch of its own; bytes as the CPU
    strobe's."""
    from torch.profiler import ProfilerActivity, profile
    from bulletproofs_tpu_torch.ops.transcript_device import DeviceStrobe
    st = np.random.default_rng(91).integers(0, 256, (200, 64)).astype(np.uint8)

    def strobe(device):
        ts = DeviceStrobe(torch.as_tensor(st).to(device), 0, 0, 0)
        ts.meta_ad_const(b"one launch", False)
        return ts

    strobe(cuda)._run_f()                 # uploads and caches this pad
    ts, host = strobe(cuda), strobe("cpu")
    torch.cuda.synchronize()
    before = _cuda.LAUNCHES["keccak_f1600"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ts._run_f()
        torch.cuda.synchronize()
    host._run_f()
    assert _cuda.LAUNCHES["keccak_f1600"] == before + 1
    kernels = _device_kernels(prof)
    if kernels:                           # where the profiler sees the card
        assert kernels == ["keccak_f1600_kernel"], kernels
    assert torch.equal(ts.state().cpu(), host.state())


@pytest.mark.parametrize("P", [256, 1000, 4096])
def test_sinv_kernel_matches_plain(cuda, P):
    """K14 (safegcd) against the Fermat ladder of sinv_plain and pow, at the
    m=16 and m=1 provers' challenge counts, edge values first."""
    from bulletproofs_tpu_torch.ops.limbs import sc_limbs_to_ints
    r = random.Random(84)
    edge = [0, 1, 2, ELL - 1, ELL - 2, 1 << 252, (1 << 252) - 1] \
        + [1 << k for k in range(0, 253, 12)] \
        + [(1 << k) - 1 for k in range(2, 253, 12)]
    vals = edge + [r.randrange(ELL) for _ in range(P - len(edge))]
    x = torch.as_tensor(sc_ints_to_limbs(vals)).to(cuda)
    before = _cuda.LAUNCHES["sinv"]
    got = S.sinv(x)
    want = S.sinv_plain(x)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["sinv"] == before + 1
    assert torch.equal(got, want)
    k = len(edge) + 20
    assert sc_limbs_to_ints(got[:, :k].cpu().numpy()) == [
        pow(v, -1, ELL) if v else 0 for v in vals[:k]]


@pytest.mark.parametrize("n", [33792, 34816, 45056])
def test_decompress_kernel_at_path_sizes(cuda, n):
    """K1 at one wave of eight warps an SM (33,792), an m=1 verifier
    sub-batch (34,816) and the linear batch (45,056), with non-canonical,
    negative and random encodings among valid ones: equal to the plain
    version, one launch, one wave of resident blocks."""
    from bulletproofs_tpu_torch.benches import field_kernels as FK
    raw = FK.encodings(n, 65)
    before = _cuda.LAUNCHES["decompress"]
    valid, pts = C.decompress(raw)
    pvalid, ppts = C.decompress_plain(raw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["decompress"] == before + 1
    assert torch.equal(valid, pvalid) and torch.equal(pts, ppts)
    assert not bool(valid[0]) and not bool(valid[1])
    assert bool(valid[66:].all())
    assert C.decompress_waves(n) == 1


@pytest.mark.parametrize("m", [1, 2])
def test_fused_route_equals_per_stage_on_card(cuda, m):
    """n = 8: the device-transcript route's proofs, commitments and
    transcripts on the card equal the per-stage route's and the CPU's."""
    from bulletproofs_tpu_torch import BatchProver
    bp, pc = BulletproofGens(8, m), PedersenGens()
    labels = [b"gpu fused %d" % i for i in range(5)]
    values = [[i, 255 - i][:m] for i in range(5)]
    blinds = [[Scalar(7 + i), Scalar(9 + i)][:m] for i in range(5)]
    if m == 1:
        values, blinds = [v[0] for v in values], [b[0] for b in blinds]
    out = []
    for device, fused in ((cuda, True), (cuda, False), ("cpu", True)):
        prover = BatchProver(bp, pc, 8, m=m, device=device)
        prover.fused = fused
        ts = [Transcript(l) for l in labels]
        before = dict(_cuda.LAUNCHES)
        ps, vs = prover.prove_batch(values, blinds, ts, rng=Rng(85))
        if device is cuda:
            launched = _cuda.LAUNCHES["keccak_f1600"] - before["keccak_f1600"]
            assert (launched > 0) == fused
        out.append(([p.to_bytes() for p in ps], vs,
                    [t.strobe.buf.raw for t in ts]))
    assert out[0] == out[1] == out[2]


def _chain_inputs(q, t, seed):
    from bulletproofs_tpu_torch.ops import fmul13 as F
    g = np.random.RandomState(seed)
    vals = [int.from_bytes(g.bytes(31), "little") % F.P25519
            for _ in range(q + 3 * t)]
    a = torch.as_tensor(F.ints_to_limbs(vals[:q]))
    bl = np.stack([F.to_limbs(v) for v in vals[q:]])            # (3 t, 20)
    b3 = torch.as_tensor(bl.reshape(3, t, 20).transpose(0, 2, 1)
                         .astype(np.int32).copy())
    m3 = torch.as_tensor(F.band_matrices(bl).reshape(3, t, 156, 40))
    return a, b3, m3


def test_fmul13_kernels_match_plain(cuda):
    """K15 and K16 against their plain versions on the card and against
    each other, limb for limb, each call one launch of each: Q = 1, 64, 70
    and 520 (ragged last blocks: K15 takes 4 lanes a block, K16 8) at T =
    16, and Q = 70 at T = 1 and 13 (K16's ring of 4 stages: T below, not a
    multiple of and a multiple of its stages)."""
    from bulletproofs_tpu_torch.ops import fmul13 as F
    for q, t in ((1, 16), (64, 16), (70, 16), (520, 16), (70, 1), (70, 13)):
        a, b3, m3 = (x.to(cuda) for x in _chain_inputs(q, t, 86 + q + t))
        before = dict(_cuda.LAUNCHES)
        v = F.chain_vpu(a, b3)
        m = F.chain_mxu(a, m3)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["fmul13_chain"] == before["fmul13_chain"] + 1
        assert _cuda.LAUNCHES["fmul13_chain_mma"] == \
            before["fmul13_chain_mma"] + 1
        pv = F.chain_vpu_plain(a, b3)
        pm = F.chain_mxu_plain(a, m3)
        assert torch.equal(v, pv) and torch.equal(m, pm), (q, t)
        assert torch.equal(v, m), (q, t)


def test_fmul13_residency_is_the_designs(cuda):
    """K16's dynamic shared memory is its ring of 4 stages (18,720 bytes
    and a zero row each), a step's column sums and the lanes' split, and
    that memory alone sets its blocks per SM (2 of 8 lanes: 3 lane warps,
    15 product warps, a pair each, and the copying warp), by the card's
    occupancy query;
    K15 runs blocks of 4 lane warps, 4 of them an SM (its registers)."""
    from bulletproofs_tpu_torch.ops import fmul13 as F
    a, b3, m3 = (x.to(cuda) for x in _chain_inputs(8, 2, 85))
    F.chain_mxu(a, m3)                                    # built and loaded
    r = F.residency()
    assert (r["mma_stages"], r["mma_lanes"], r["mma_threads"]) == (4, 8, 608)
    # the ring (a stage: 3 matrices and a 32-byte zero row), the column
    # sums (40 words a lane and operand), the split (80 bytes a lane), an
    # mbarrier a stage
    assert r["mma_smem"] == 4 * (3 * 156 * 40 + 32) + 8 * (3 * 40 * 4 + 80) \
        + 4 * 8 == 79520
    assert r["mma_blocks_per_sm"] == 233472 // (r["mma_smem"] + 1024) == 2
    assert (r["vpu_threads"], r["vpu_blocks_per_sm"]) == (128, 4)


def test_r1cs_device_route_on_card(cuda, monkeypatch):
    """The R1CS verifier's device mega-MSM at k = 9 on the card accepts,
    a tampered proof is rejected, and the launches of K1, K10, K11, K4a
    and K4b show the route."""
    from bulletproofs_tpu_torch import R1CSError
    from bulletproofs_tpu_torch.config import settings
    from bulletproofs_tpu_torch.proofs.r1cs import verifier as VM
    from bulletproofs_tpu_torch.benches import shuffle as SH
    monkeypatch.setattr(VM, "_NATIVE_MIN_N", 8)
    monkeypatch.setattr(settings, "r1cs_device_msm_floor", 8)
    pc, bp = PedersenGens(), BulletproofGens(128, 1)
    for tamper, want in ((False, None), (True, R1CSError)):
        ins, outs, proof = SH.prove_shuffle(pc, bp, b"gpu shuffle",
                                            *SH.shuffle_values(9, 87, tamper),
                                            Rng(88))
        v = SH.shuffle_verifier(b"gpu shuffle", ins, outs)
        _cuda.reset_counts()
        if want is None:
            v.verify(proof, pc, bp, rng=Rng(89), device=cuda)
        else:
            with pytest.raises(want):
                v.verify(proof, pc, bp, rng=Rng(89), device=cuda)
        for k in ("decompress", "digits", "msm_accumulate_z", "msm_reduce",
                  "msm_horner"):
            assert _cuda.LAUNCHES[k] == 1, k


@pytest.mark.parametrize("mesh_of", ["every card", "virtual 4 on card 0"])
def test_sharded_msm_on_card(cuda, mesh_of):
    """sharded_msm_lanes over every card present and over four virtual
    shards of card 0: equal to the unsharded msm_lanes (compressed bytes);
    every shard's kernels launch, one K11 a shard."""
    from bulletproofs_tpu_torch.parallel import (Mesh, make_mesh,
                                                 sharded_msm_lanes)
    mesh = make_mesh() if mesh_of == "every card" \
        else Mesh([torch.device("cuda", 0)] * 4)
    r = random.Random(91)
    pts = torch.as_tensor(C.points_to_lanes(
        [RISTRETTO_BASEPOINT.scalar_mul(Scalar(r.randrange(1, ELL)))
         for _ in range(37)])).to(torch.device("cuda", 0))
    sb = np.frombuffer(r.randbytes(37 * 32), np.uint8).reshape(37, 32)
    before = _cuda.LAUNCHES["msm_accumulate_z"]
    out = sharded_msm_lanes(pts, sb, mesh)
    want = M.msm_lanes(pts, torch.from_numpy(sb.copy()).to(pts.device))
    assert out.device == mesh.devices[0]
    assert torch.equal(C.compress(out), C.compress(want))
    assert _cuda.LAUNCHES["msm_accumulate_z"] == before + mesh.size + 1


@pytest.mark.parametrize("consttime", [True, False])
def test_msm_rows_compressed_on_card_equals_the_cpp_rows(cuda, consttime):
    """The card branch (K10, K6 one-hot or direct, K7, K5) against the C++
    row MSM on seeded n = 8 coefficient rows."""
    from bulletproofs_tpu_torch.ops import fixed_msm as FM
    bp, pc = BulletproofGens(8, 1), PedersenGens()
    bases = [pc.B, pc.B_blinding] + bp.G(8, 1) + bp.H(8, 1)
    g = np.random.default_rng(92)
    coef = np.frombuffer(b"".join(
        (int.from_bytes(g.bytes(32), "little") % ELL).to_bytes(32, "little")
        for _ in range(5 * len(bases))), np.uint8).reshape(5, len(bases), 32)
    kernel = "fixed_accumulate" if consttime else "fixed_accumulate_vt"
    before = _cuda.LAUNCHES[kernel]
    got = FM.msm_rows_compressed(FM.FixedBaseTables(bases, cuda), coef,
                                 consttime=consttime)
    assert _cuda.LAUNCHES[kernel] == before + 1
    assert np.array_equal(got, FM.msm_rows_compressed(
        FM.FixedBaseTables(bases, None), coef, consttime=consttime))


def _uniform_rows(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 64),
                                                dtype=np.uint8)


def test_from_uniform_bytes_on_card_equals_cpu(cuda):
    """Hash to the group (plain PyTorch on both devices) and normalize_z:
    the card's limbs equal the CPU's."""
    raw = _uniform_rows(1000, 93)
    raw[0] = 0
    raw[1] = 0xFF
    got = C.from_uniform_bytes(raw)
    assert got.device.type == "cuda"
    want = C.from_uniform_bytes(raw, device="cpu")
    assert torch.equal(got.cpu(), want)
    assert torch.equal(M.normalize_z(got).cpu(), M.normalize_z(want))


@pytest.mark.parametrize("route, kernels", [
    ("msm_lanes_flag", ("digits", "msm_bin", "msm_accumulate_z",
                        "msm_reduce", "msm_horner")),
    ("msm_lanes_niels_flag", ("digits", "msm_bin_niels", "msm_accumulate",
                              "msm_reduce", "msm_horner"))])
def test_msm_routes_at_2_12_on_card(cuda, route, kernels, monkeypatch):
    """Each MSM route over 2^12 hashed points (normalize_z'd for the Niels
    route) on the card: one launch of each of its kernels (two of the
    binning's), no plain curve.to_niels on the card (the Niels bin makes
    the rows), the limbs and flag of its plain version (the same route on
    CPU tensors), and the other route's point."""
    real_to_niels = C.to_niels

    def to_niels(pts):
        assert pts.device.type == "cpu", "to_niels on the card"
        return real_to_niels(pts)
    monkeypatch.setattr(C, "to_niels", to_niels)
    n = 1 << 12
    pts = C.from_uniform_bytes(_uniform_rows(n, 94))
    sb = np.random.default_rng(95).integers(0, 256, (n, 32), dtype=np.uint8)
    sb[:, 31] &= 15
    sc = torch.from_numpy(sb).to(cuda)
    other = "msm_lanes_niels_flag" if route == "msm_lanes_flag" \
        else "msm_lanes_flag"
    ins = {"msm_lanes_flag": pts, "msm_lanes_niels_flag": M.normalize_z(pts)}
    before = {k: _cuda.LAUNCHES[k] for k in _cuda.LAUNCHES}
    out, flag = getattr(M, route)(ins[route], sc)
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in _cuda.LAUNCHES.items()
                if v != before.get(k, 0)}
    assert launched == {k: 2 if k.startswith("msm_bin") else 1
                        for k in kernels}
    want, wflag = getattr(M, route)(ins[route].cpu(), sc.cpu())
    assert torch.equal(out.cpu(), want) and torch.equal(flag.cpu(), wflag)
    alt, _ = getattr(M, other)(ins[other], sc)
    assert torch.equal(C.compress(out), C.compress(alt))
    assert not bool(flag[0])


# -- K17-K20: the prover's mod-l vector kernels ---------------------------------------

_EDGE = [0, 1, 2, ELL - 1, ELL - 2, (1 << 252) - 1, 1 << 252, (ELL - 1) // 2]


def _fast_sc(shape, seed):
    """Canonical (.., 9, P) int64 scalars: seeded limbs below 2^252, with
    _EDGE's values in the first columns of the first row."""
    g = np.random.default_rng(seed)
    *lead, _, p = shape
    x = g.integers(0, 1 << 29, (*lead, 9, p), dtype=np.int64)
    x[..., 8, :] &= (1 << 20) - 1
    k = min(len(_EDGE), p)
    if x.size:
        x.reshape(-1, 9, p)[0, :, :k] = sc_ints_to_limbs(_EDGE[:k])
    return torch.from_numpy(x)


def _sc_launched(fn, kernel):
    """fn() on the card -> (its output, the launches of `kernel` it made,
    the launches of the port's other kernels)."""
    before = dict(_cuda.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
             if v != before[k]}
    return out, moved.pop(kernel, 0), moved


def _sc_layouts(cuda):
    """(name, a, b) operand pairs as the prover and verifier pass them."""
    vec = _fast_sc((256, 9, 4096), 96).to(cuda)         # m = 1 round emit
    per = _fast_sc((9, 4096), 97).to(cuda)
    yzi = _fast_sc((9, 3 * 37), 98).to(cuda)
    part = _fast_sc((6, 2, 9, 21), 99).to(cuda).transpose(-1, -2) \
        .contiguous().transpose(-1, -2)
    return [
        ("round emit, m = 1", vec, _fast_sc((256, 9, 4096), 100).to(cuda)),
        ("m = 16 rows", _fast_sc((4096, 9, 256), 101).to(cuda),
         _fast_sc((4096, 9, 256), 102).to(cuda)),
        ("(9, 1) constant", per, S.const(ELL - 1, cuda)),
        ("expanded one, strided slice",
         S.const(1, cuda).expand(9, 37)[None], yzi[:, :37]),
        ("(n, 9, P) against (9, P)", vec, per),
        ("transposed rows", _fast_sc((9, 37), 103).T.contiguous().T.to(cuda),
         yzi[:, 37:74]),
        ("four-dimensional halves", part[:3], part[3:]),
        ("empty rows", vec[:0], per),
        ("empty columns", vec[:, :, :0], per[:, :0]),
    ]


@pytest.mark.parametrize("case", range(9))
def test_sc_mul_kernel_matches_plain(cuda, case):
    """K17, both modes, against mont_mul_plain / smul_plain (torch.equal)
    on each layout: one launch (none for an empty output), no other
    kernel of the port, a contiguous output of the broadcast shape."""
    name, a, b = _sc_layouts(cuda)[case]
    for mode, fn, plain in ((0, S.mont_mul, S.mont_mul_plain),
                            (1, S.smul, S.smul_plain)):
        got, n, other = _sc_launched(lambda: fn(a, b), "sc_mul")
        want = plain(a, b)
        assert (n, other) == (int(want.numel() > 0), {}), (name, mode)
        assert got.is_contiguous() and torch.equal(got, want), (name, mode)


@pytest.mark.parametrize("case", range(9))
def test_sc_add_kernel_matches_plain(cuda, case):
    """K18, a + b and -a, against sadd_plain / sneg_plain on each layout."""
    name, a, b = _sc_layouts(cuda)[case]
    for fn, plain in ((lambda: S.sadd(a, b), lambda: S.sadd_plain(a, b)),
                      (lambda: S.sneg(b), lambda: S.sneg_plain(b))):
        got, n, other = _sc_launched(fn, "sc_add")
        want = plain()
        assert (n, other) == (int(want.numel() > 0), {}), name
        assert torch.equal(got, want), name


@pytest.mark.parametrize("n, P, launches", [
    (1, 37, 1), (7, 37, 1), (64, 8192, 1), (63, 8192, 1), (16, 256, 1),
    (64, 4096, 1), (1024, 512, 2), (1024, 256, 2), (1023, 256, 2),
    (5, 0, 0)])
def test_sc_tree_sum_kernel_matches_plain(cuda, n, P, launches):
    """K19 against tree_sum_plain at the provers' sums (64 x 8192 the m = 1
    round's cross terms, 1024 x 512 the m = 16 one's, 64 x 4096 and 1024 x
    256 stage 1's, 16 x 256 the t-blinding's), odd n, a column slice and
    no columns: one launch where its 32-column blocks fill half the card
    or the rows are few, two (row slices, then their sums) at m = 16's
    stage 1 sums and cross terms, none without columns."""
    v = _fast_sc((n, 9, 2 * P), 104 + n).to(cuda)
    for what, x in (("contiguous", v[:, :, :P].contiguous()),
                    ("column slice", v[:, :, P:])):
        got, k, other = _sc_launched(lambda: S.tree_sum(x), "sc_tree_sum")
        assert (k, other) == (launches, {}), what
        assert torch.equal(got, S.tree_sum_plain(x)), what


@pytest.mark.parametrize("N, P", [(64, 4096), (1024, 256), (13, 37)])
def test_sc_tree_sum_prefix_kernel_matches_plain(cuda, N, P):
    """K19's prefix form at every IPP round's h (N / 2 .. 1, and 0) over
    two row blocks of one product tensor, as round_emit_dyn passes them,
    against the masked composition tree_sum_prefix_plain: the same
    launches every round (two at the provers' shapes)."""
    prod = _fast_sc((2 * N, 9, P), 108 + N).to(cuda)
    x, y = prod[:N], prod[N:]
    want_k = 1 if S.tree_slices(N, 2 * P) == 1 else 2
    for h in [N // 2 >> k for k in range(N.bit_length() - 1)] + [0]:
        hd = torch.tensor(h, device=cuda)
        got, k, other = _sc_launched(lambda: S.tree_sum_prefix(x, y, hd),
                                     "sc_tree_sum")
        assert (k, other) == (want_k, {}), h
        assert torch.equal(got, S.tree_sum_prefix_plain(x, y, hd)), h


@pytest.mark.parametrize("n", [0, 1, 1000, 4096 * 132])
def test_chacha_scalars_kernel_matches_plain(cuda, n):
    """K20 from a key against random_scalars_plain at the m = 1 prover's
    draws of one half (4096 x 132) and small counts: one launch."""
    from bulletproofs_tpu_torch.ops import chacha as CH
    key = np.random.default_rng(105).integers(0, 256, 32, np.uint8).tobytes()
    got, k, other = _sc_launched(lambda: CH.random_scalars(key, n, cuda),
                                 "chacha_scalars")
    assert (k, other) == (int(n > 0), {})
    assert torch.equal(got, CH.random_scalars_plain(key, n, cuda))


@pytest.mark.parametrize("P", [0, 37, 4096])
def test_wide_reduction_kernel_matches_plain(cuda, P):
    """K20's wide form on the device transcript's layout (a (64, P) block
    transposed) and on contiguous rows, edge halves first."""
    g = np.random.default_rng(106)
    raw = g.integers(0, 256, (64, P), dtype=np.uint8)
    for j, (lo, hi) in enumerate([(0, 0), (255, 255), (0, 255), (255, 0)]):
        if j < P:
            raw[:32, j], raw[32:, j] = lo, hi
    block = torch.from_numpy(raw).to(cuda)
    for what, rows in (("transposed", block.T), ("rows", block.T.contiguous())):
        got, k, other = _sc_launched(lambda: S.from_wide_bytes(rows),
                                     "chacha_scalars")
        assert (k, other) == (int(P > 0), {}), what
        assert torch.equal(got, S.from_wide_bytes_plain(rows)), what


def test_prove_launches_the_mod_l_kernels(cuda):
    """A device-transcript prove at n = 8 (one half) launches K17-K19 and
    K20 once for its blinds and once a challenge (x, w and three u), and
    its proofs equal the CPU route's."""
    from bulletproofs_tpu_torch import BatchProver
    bp, pc = BulletproofGens(8, 1), PedersenGens()
    outs = []
    for device in (cuda, "cpu"):
        _cuda.reset_counts()
        ps, _ = BatchProver(bp, pc, 8, device=device).prove_batch(
            [5, 6, 7], [Scalar(31 + i) for i in range(3)],
            [Transcript(b"mod l %d" % i) for i in range(3)], rng=Rng(107))
        outs.append([p.to_bytes() for p in ps])
        if device == cuda:
            torch.cuda.synchronize()
            launches = dict(_cuda.LAUNCHES)
    assert outs[0] == outs[1]
    assert launches["chacha_scalars"] == 1 + 2 + 3
    assert launches["sc_mul"] and launches["sc_add"] \
        and launches["sc_tree_sum"]
