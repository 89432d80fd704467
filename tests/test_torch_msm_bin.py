"""Kernel K11's binning launch (`msm.bin_points`, whose CUDA kernel
`msm_bin` sorts each (window, lane)'s points into per-bucket lists) and
the order K11 adds in, through the plain versions on the CPU, on the edge
cases of `benches.accumulate_z.CASES` (random digits, every digit 0, every
digit +-8, fewer points than lanes, a ragged last lane step, every digit
negative):

* `bin_plain`'s bit masks list, per (window w, bucket b, lane j), the
  points k = j (mod lanes) with |d[w, k]| = b + 1 in ascending k, their
  signs and their count, and its permutation orders each bucket's lanes
  by that count, largest first;
* adding each list's points in order from the identity, as a K11 thread
  does, gives `accumulate_z_plain`'s slab limb for limb;
* that slab's MSM (K4a and K4b's plain versions) equals the JAX package's
  host MSM of the points with the digits' scalars sum_w d[w, k] 16^w, by
  compressed bytes (ristretto equality)."""

import functools

import numpy as np
import pytest
import torch

from bulletproofs_tpu.core.ristretto import RistrettoPoint as HostPoint
from bulletproofs_tpu.core.ristretto import multiscalar_mul as host_msm
from bulletproofs_tpu.core.scalar import L as ELL

from bulletproofs_tpu_torch.benches import accumulate_z as AZ
from bulletproofs_tpu_torch.ops import curve as C
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops.limbs import fe_limbs_to_ints

CASES = [c for c, _ in AZ.CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's many small tensor operations on one thread: beside
    the other test workers, torch's thread pool made them ~10x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _inputs(case):
    return AZ.edge_inputs(case, 7, "cpu")


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
    """K11's order: thread (w, b, j) starts from the identity and adds the
    points of its list, lane j's points with |digit| = b + 1 by ascending
    k, X and T negated for a negative digit."""
    lanes = cnt.shape[-1]
    ks, negs = _lists(mask, sign, lanes)
    pts = rows.to(torch.int64).T.reshape(4, 10, -1)
    acc = C.to_coords(C.identity(cnt.numel(), "cpu"))
    for i in range(int(cnt.max())):
        live = (cnt > i).reshape(-1)
        k = torch.where(live, ks[:, :, i].reshape(-1), 0)
        neg = negs[:, :, i].reshape(-1)
        q = pts[:, :, k]
        q = (torch.where(neg, -q[0], q[0]), q[1], q[2],
             torch.where(neg, -q[3], q[3]))
        new = C.add(acc, q)
        acc = tuple(torch.where(live, a, b) for a, b in zip(new, acc))
    slab = torch.stack(acc).reshape(4, 10, M.NUM_WINDOWS, M.NUM_BUCKETS,
                                    lanes)
    return slab.permute(2, 3, 0, 1, 4).to(torch.int32).contiguous()


@pytest.mark.parametrize("case", CASES)
def test_bin_plain_lists(case):
    _, dig = _inputs(case)
    n = dig.shape[-1]
    lanes = M.pick_lanes(n)
    mask, sign, cnt, perm = M.bin_plain(dig, lanes)
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


@pytest.mark.parametrize("case", CASES)
def test_binned_order_gives_the_plain_slab(case):
    pts, dig = _inputs(case)
    rows, mask, sign, cnt, _ = M.bin_points(pts, dig)
    assert torch.equal(rows, pts.permute(2, 0, 1).reshape(-1, 40))
    slab = _binned_slab(rows, mask, sign, cnt)
    assert torch.equal(slab, M.accumulate_z_plain(pts, dig))


@pytest.mark.parametrize("case", CASES)
def test_binned_msm_matches_jax_host_msm(case):
    pts, dig = _inputs(case)
    slab = _binned_slab(*M.bin_points(pts, dig)[:4])
    out, flag = M.horner_plain(M.reduce_plain(slab))
    got = C.lanes_to_points(out.numpy()[:, :, None])[0]
    coords = [fe_limbs_to_ints(pts[c].numpy()) for c in range(4)]
    host = [HostPoint(*(coords[c][i] for c in range(4)))
            for i in range(pts.shape[-1])]
    weights = 16 ** np.arange(64, dtype=object)
    scalars = [int((dig[:, k].numpy().astype(object) * weights).sum()) % ELL
               for k in range(pts.shape[-1])]
    want = host_msm(scalars, host)
    assert got.compress() == want.compress()
    assert bool(flag[0]) == want.is_identity() == (case == "all zero")
