"""Kernel K4b's plain version (`msm.horner_plain`, which the CUDA kernel
repeats limb for limb) on bucket sums that stress the Horner chain: every
bucket the identity, the top window the identity (the chain starts from
it), only window 0 non-identity, buckets scaled projectively and carrying
4-torsion, and real slabs.  Each is held to the JAX package's host MSM of
the 512 bucket points with scalars (b + 1) 16^w: the point by its
compressed bytes (ristretto equality), the flag by that point being the
identity."""

import pytest

from bulletproofs_tpu.core.ristretto import RistrettoPoint as HostPoint
from bulletproofs_tpu.core.ristretto import multiscalar_mul as host_msm
from bulletproofs_tpu.core.scalar import L as ELL

from bulletproofs_tpu_torch.benches import horner as HB
from bulletproofs_tpu_torch.ops import curve as C
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops.limbs import fe_limbs_to_ints


@pytest.fixture(scope="module")
def base_sums():
    return HB.slab_sums(64, 5, "cpu")


def _host_result(sums):
    """sum over windows w and buckets b of (b + 1) 16^w B_wb, by the JAX
    package's host MSM."""
    lanes = sums.reshape(M.NUM_WINDOWS * M.NUM_BUCKETS, 4, 10).permute(1, 2, 0)
    coords = [fe_limbs_to_ints(lanes[c].numpy()) for c in range(4)]
    points = [HostPoint(*(coords[c][i] for c in range(4)))
              for i in range(len(coords[0]))]
    scalars = [(b + 1) * 16 ** w % ELL for w in range(M.NUM_WINDOWS)
               for b in range(M.NUM_BUCKETS)]
    return host_msm(scalars, points)


@pytest.mark.parametrize("case", HB.CASES + ("slab", "slab of 40 points"))
def test_horner_plain_against_host_msm(base_sums, case):
    if case == "slab":
        sums = base_sums
    elif case == "slab of 40 points":
        sums = HB.slab_sums(40, 6, "cpu")
    else:
        sums = HB.edge_sums(case, base_sums, 3)
    out, flag = M.horner_plain(sums)
    got = C.lanes_to_points(out.numpy()[:, :, None])[0]
    want = _host_result(sums)
    assert got.compress() == want.compress()
    assert bool(flag[0]) == want.is_identity()
    assert bool(flag[0]) == (case == "identity")


def test_edge_sums_are_ristretto_equal_representatives(base_sums):
    """The projective / 4-torsion case changes every bucket's limbs but
    no bucket's ristretto point."""
    sums = HB.edge_sums("projective and 4-torsion", base_sums, 3)
    a, b = (C.lanes_to_points(x.reshape(512, 4, 10).permute(1, 2, 0).numpy())
            for x in (base_sums, sums))
    assert all(p.compress() == q.compress() for p, q in zip(a, b))
    assert not bool((sums == base_sums).all(-1).all(-1).any())
