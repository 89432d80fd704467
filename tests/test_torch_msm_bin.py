"""The binning launch of kernels K3 and K11 (`msm.bin_points`, whose CUDA
kernels `msm_bin_niels` and `msm_bin` sort each (window, lane)'s points
into per-bucket lists) and the order K3 and K11 add in, through the plain
versions on the CPU, for both point forms (Niels rows of Z = 1 points, as
K3 takes them, and extended points of any Z, as K11 takes them), on the
edge cases of `benches.accumulate_z.CASES` (random digits, every digit 0,
every digit +-8, fewer points than lanes, a ragged last lane step, every
digit negative):

* `bin_plain`'s bit masks list, per (window w, bucket b, lane j), the
  points k = j (mod lanes) with |d[w, k]| = b + 1 in ascending k, their
  signs and their count, and its permutation orders each bucket's lanes
  by that count, largest first; `bin_points_plain`'s rows are the points
  point-major (a Niels row padded with two zero words);
* adding each list's points in order from the identity, as a K3 or K11
  thread does (a mixed addition of the Niels row, Y+X and Y-X swapped and
  2dT negated for a negative digit; or a complete addition, X and T
  negated), gives `accumulate_plain`'s or `accumulate_z_plain`'s slab
  limb for limb;
* that slab's MSM (K4a and K4b's plain versions) equals the JAX package's
  host MSM of the points with the digits' scalars sum_w d[w, k] 16^w, by
  compressed bytes (ristretto equality);
* K3's two-source binning (`msm.bin_niels`: Niels points, then Z = 1
  extended points whose Niels rows it makes, either part empty) equals
  the JAX package's `to_niels_lanes` of the extended points followed by
  the binning of the whole, and so do K3 and its MSM over the two
  sources."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bulletproofs_tpu.ops import limbs as JL
from bulletproofs_tpu.ops import msm_pallas as MP
from bulletproofs_tpu.ops import vec_curve as JC

from bulletproofs_tpu.core.ristretto import RistrettoPoint as HostPoint
from bulletproofs_tpu.core.ristretto import multiscalar_mul as host_msm
from bulletproofs_tpu.core.field import P as FIELD_P
from bulletproofs_tpu.core.scalar import L as ELL

from bulletproofs_tpu_torch.benches import accumulate_z as AZ
from bulletproofs_tpu_torch.ops import curve as C
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops.limbs import fe_limbs_to_ints

CASES = [c for c, _ in AZ.CASES]
# (case, form): the extended form keeps the case's name as its id
FORMED = pytest.mark.parametrize(
    "case,form", [(c, "extended") for c in CASES]
    + [(c, "niels") for c in CASES],
    ids=CASES + [f"niels {c}" for c in CASES])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's many small tensor operations on one thread: beside
    the other test workers, torch's thread pool made them ~10x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _inputs(case, form):
    return AZ.edge_inputs(case, 7, "cpu", niels=form == "niels")


def _lists(mask, sign, lanes):
    """The bin masks as K11 walks them: (k (64, 8, S, lanes), neg (64, 8,
    S, lanes)), each (w, b, j)'s listed points first, in the order of their
    bits, S = 32 x the words per lane."""
    nm = mask.shape[2]
    shift = torch.arange(32)[:, None]
    bits = (mask.to(torch.int64)[:, :, :, None] >> shift) & 1
    bits = bits.reshape(64, 8, nm * 32, lanes).bool()
    neg = ((sign.to(torch.int64)[:, :, None] >> shift) & 1).bool()
    neg = neg.reshape(64, 1, nm * 32, lanes).expand(64, 8, nm * 32, lanes)
    s = torch.arange(nm * 32)[:, None]
    order = torch.sort(torch.where(bits, s, s + nm * 32), dim=2).indices
    return order * lanes + torch.arange(lanes), neg.gather(2, order)


def _binned_slab(rows, mask, sign, cnt):
    """K3's and K11's order: thread (w, b, j) starts from the identity and
    adds the points of its list, lane j's points with |digit| = b + 1 by
    ascending k: a Niels row (32 words) by the mixed addition, Y+X and Y-X
    swapped and 2dT negated for a negative digit; an extended row (40
    words) by the complete addition, X and T negated."""
    lanes = cnt.shape[-1]
    ks, negs = _lists(mask, sign, lanes)
    niels = rows.shape[1] == 32
    pts = rows[:, :30 if niels else 40].to(torch.int64).T.reshape(
        3 if niels else 4, 10, -1)
    acc = C.to_coords(C.identity(cnt.numel(), "cpu"))
    for i in range(int(cnt.max())):
        live = (cnt > i).reshape(-1)
        k = torch.where(live, ks[:, :, i].reshape(-1), 0)
        neg = negs[:, :, i].reshape(-1)
        q = pts[:, :, k]
        if niels:
            new = C.madd(acc, (torch.where(neg, q[1], q[0]),
                               torch.where(neg, q[0], q[1]),
                               torch.where(neg, -q[2], q[2])))
        else:
            new = C.add(acc, (torch.where(neg, -q[0], q[0]), q[1], q[2],
                              torch.where(neg, -q[3], q[3])))
        acc = tuple(torch.where(live, a, b) for a, b in zip(new, acc))
    slab = torch.stack(acc).reshape(4, 10, M.NUM_WINDOWS, M.NUM_BUCKETS,
                                    lanes)
    return slab.permute(2, 3, 0, 1, 4).to(torch.int32).contiguous()


@FORMED
def test_bin_plain_lists(case, form):
    pts, dig = _inputs(case, form)
    n = dig.shape[-1]
    lanes = M.pick_lanes(n)
    rows, mask, sign, cnt, perm = M.bin_points_plain(pts, dig)
    c = pts.shape[0]
    assert rows.shape == (n, 32 if c == 3 else 40)
    assert torch.equal(rows[:, :10 * c], pts.permute(2, 0, 1).reshape(n, -1))
    assert not rows[:, 10 * c:].any()
    nm = -(-(-(-n // lanes)) // 32)
    assert mask.shape == (64, 8, nm, lanes) and sign.shape == (64, nm, lanes)
    assert cnt.shape == (64, 8, lanes)
    assert perm.shape == cnt.shape
    assert {t.dtype for t in (mask, sign, cnt, perm)} == {torch.int32}
    ks, negs = _lists(mask, sign, lanes)
    d = dig.numpy().astype(int)
    for w in range(64):
        for b in range(8):
            for j in range(lanes):
                want = [k for k in range(j, n, lanes) if abs(d[w, k]) == b + 1]
                c = int(cnt[w, b, j])
                assert ks[w, b, :c, j].tolist() == want
                assert negs[w, b, :c, j].tolist() == [d[w, k] < 0
                                                      for k in want]
            order = sorted(range(lanes), key=lambda x: (-int(cnt[w, b, x]), x))
            assert perm[w, b].tolist() == order


@FORMED
def test_binned_order_gives_the_plain_slab(case, form):
    pts, dig = _inputs(case, form)
    slab = _binned_slab(*M.bin_points(pts, dig)[:4])
    plain = M.accumulate_plain if form == "niels" else M.accumulate_z_plain
    assert torch.equal(slab, plain(pts, dig))


def _host_points(pts):
    """Host points of (4, 10, n) extended or (3, 10, n) Niels limbs (Z = 1:
    X = (Y+X - (Y-X)) / 2, Y = (Y+X + Y-X) / 2)."""
    coords = [fe_limbs_to_ints(pts[c].numpy()) for c in range(pts.shape[0])]
    if pts.shape[0] == 4:
        return [HostPoint(*(coords[c][i] for c in range(4)))
                for i in range(pts.shape[-1])]
    half = pow(2, FIELD_P - 2, FIELD_P)
    out = []
    for ypx, ymx in zip(coords[0], coords[1]):
        x, y = (ypx - ymx) * half % FIELD_P, (ypx + ymx) * half % FIELD_P
        out.append(HostPoint(x, y, 1, x * y % FIELD_P))
    return out


@FORMED
def test_binned_msm_matches_jax_host_msm(case, form):
    pts, dig = _inputs(case, form)
    slab = _binned_slab(*M.bin_points(pts, dig)[:4])
    out, flag = M.horner_plain(M.reduce_plain(slab))
    got = C.lanes_to_points(out.numpy()[:, :, None])[0]
    host = _host_points(pts)
    weights = 16 ** np.arange(64, dtype=object)
    scalars = [int((dig[:, k].numpy().astype(object) * weights).sum()) % ELL
               for k in range(pts.shape[-1])]
    want = host_msm(scalars, host)
    assert got.compress() == want.compress()
    assert bool(flag[0]) == want.is_identity() == (case == "all zero")


# (Niels points, Z = 1 points after them): a verify sub-batch's layout
# (static generators, then decoded points), the MSM entry's (no Niels
# prefix), Niels points alone, and fewer points than lanes
SPLITS = [(130, 170), (0, 300), (300, 0), (0, 5), (5, 0)]


@functools.lru_cache(maxsize=None)
def _two_sources(n0, n1):
    niels = (AZ.make_niels(n0, 11, "cpu") if n0
             else torch.empty((3, 10, 0), dtype=torch.int32))
    pts = (M.normalize_z(AZ.make_points(n1, 12, "cpu")) if n1
           else torch.empty((4, 10, 0), dtype=torch.int32))
    return niels, pts, AZ.make_digits(n0 + n1, 13, "cpu")


def _jax_niels(pts):
    """The JAX package's to_niels_lanes of the same points, as field
    elements mod p: [Y+X, Y-X, 2dT] lists (its limbs are 20 of 13 bits)."""
    if not pts.shape[-1]:
        return [[], [], []]
    lanes = JC.points_to_lanes(_host_points(pts))
    out = np.asarray(MP.to_niels_lanes(jnp.asarray(lanes)))
    return [[v % FIELD_P for v in JL.limbs_to_ints(out[c].T)]
            for c in range(3)]


@pytest.mark.parametrize("n0,n1", SPLITS)
def test_bin_niels_matches_jax_to_niels_then_binning(n0, n1):
    """Rows, lists and ranks of bin_niels equal bin_points_plain's of the
    whole in Niels form (limb for limb: the port's to_niels), and the
    converted points' rows are the JAX package's to_niels_lanes values."""
    niels, pts, dig = _two_sources(n0, n1)
    whole = torch.cat([niels, C.to_niels(pts)], dim=-1)
    got = M.bin_niels(niels, pts, dig)
    want = M.bin_points_plain(whole, dig)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    rows = got[0][n0:, :30].T.reshape(3, 10, n1)
    assert [[v % FIELD_P for v in fe_limbs_to_ints(rows[c].numpy())]
            for c in range(3)] == _jax_niels(pts)
    slab = M.accumulate(niels, dig, pts)
    assert torch.equal(slab, M.accumulate_plain(whole, dig))
    out, flag = M.msm_niels(niels, dig, pts)
    want_out, want_flag = M.horner_plain(M.reduce_plain(slab))
    assert torch.equal(out, want_out) and torch.equal(flag, want_flag)


def test_bin_niels_rejects_mismatched_digits():
    niels, pts, dig = _two_sources(5, 0)
    with pytest.raises(ValueError):
        M.bin_niels(niels, pts, dig[:, :4])
    with pytest.raises(ValueError):
        M.accumulate(niels, torch.cat([dig, dig], -1), pts)
