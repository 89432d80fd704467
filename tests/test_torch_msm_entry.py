"""The north-star MSM entry through the plain PyTorch versions on the CPU:
hash to the group (ops/curve.from_uniform_bytes, RFC 9496 MAP(lo) +
MAP(hi)), ops/msm.normalize_z, and both MSM routes, msm_lanes_flag (points
of any Z: K10, K11, K4a, K4b) and msm_lanes_niels_flag (Z = 1 points:
K10, K3, K4a, K4b), against the JAX package's vec_curve.from_uniform_bytes,
msm_pallas.normalize_z and host multiscalar_mul.

Compared exactly (tolerance 0): encodings byte for byte, canonical
coordinates as integers, MSM results by their compressed bytes (ristretto
equality) and flags as booleans."""

import random

import numpy as np
import pytest
import torch

import jax
from bulletproofs_tpu.core.ristretto import multiscalar_mul as jax_msm
from bulletproofs_tpu.core.scalar import Scalar as JaxScalar
from bulletproofs_tpu.ops import msm_pallas as MP
from bulletproofs_tpu.ops import vec_curve as JC
from bulletproofs_tpu.ops import vec_field as VF

from bulletproofs_tpu_torch.core import field as HF
from bulletproofs_tpu_torch.core.ristretto import RistrettoPoint
from bulletproofs_tpu_torch.core.scalar import L as ELL
from bulletproofs_tpu_torch.ops import curve as C
from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops.limbs import fe_limbs_to_ints

N_SEEDED = 256


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions here are long chains of small ops, which one
    intra-op thread runs fastest (several test workers share the cores);
    the setting is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _edge_rows():
    """All zeros, all 0xff, bit 255 set in the low half only and in the
    high half only."""
    rows = np.zeros((4, 64), np.uint8)
    rows[1] = 0xFF
    r = np.random.default_rng(82)
    rows[2:] = r.integers(0, 256, (2, 64), dtype=np.uint8)
    rows[2:, 31] &= 0x7F
    rows[2:, 63] &= 0x7F
    rows[2, 31] |= 0x80
    rows[3, 63] |= 0x80
    return rows


@pytest.fixture(scope="module")
def jax_side():
    """N_SEEDED seeded rows and the edge rows, mapped by the JAX package's
    from_uniform_bytes; its normalize_z of the same points; both as host
    point lists.  The two run op by op with the field product jitted (their
    jit wrappers swapped for the functions they wrap while the fixture
    runs): the same integer operations as the whole-program jit, in about
    a third of the time its tracing and compiling take."""
    raw = np.concatenate([
        np.random.default_rng(81).integers(0, 256, (N_SEEDED, 64),
                                           dtype=np.uint8), _edge_rows()])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(VF, "mul", jax.jit(VF.mul))
        mp.setattr(JC, "_from_uniform_jit", JC._from_uniform_jit.__wrapped__)
        pts = JC.from_uniform_bytes(raw)
        norm = MP.normalize_z.__wrapped__(pts)
    return {"raw": raw,
            "points": JC.lanes_to_points(np.asarray(pts)),
            "normalized": JC.lanes_to_points(np.asarray(norm))}


def _was_square(half: bytes) -> bool:
    """The MAP's was_square branch for one 32-byte half (host integers)."""
    t = HF.fe_from_bytes(half)
    r = HF.SQRT_M1 * t * t % HF.P
    u = (r + 1) * HF.ONE_MINUS_D_SQ % HF.P
    v = (-1 - r * HF.D) * (r + HF.D) % HF.P
    return HF.sqrt_ratio_m1(u, v)[0]


def _port_points(raw):
    return C.from_uniform_bytes(torch.as_tensor(raw), device="cpu")


def test_map_constants_are_the_host_constants():
    for name, want in (("one_minus_d_sq", HF.ONE_MINUS_D_SQ),
                       ("d_minus_one_sq", HF.D_MINUS_ONE_SQ),
                       ("sqrt_ad_minus_one", HF.SQRT_AD_MINUS_ONE)):
        col = F.const(name, "cpu")
        assert fe_limbs_to_ints(col.numpy())[0] == want


def test_from_uniform_bytes_equals_jax_and_the_host(jax_side):
    raw = jax_side["raw"]
    halves = [bytes(row[k: k + 32]) for row in raw for k in (0, 32)]
    branches = {_was_square(h) for h in halves}
    assert branches == {True, False}          # each branch of the MAP taken
    enc = C.compress_plain(_port_points(raw)).numpy()
    for i, row in enumerate(raw):
        want = jax_side["points"][i].compress()
        assert bytes(enc[i]) == want, f"row {i}"
        assert RistrettoPoint.from_uniform_bytes(bytes(row)).compress() \
            == want, f"row {i}"


@pytest.mark.parametrize("half", [0, 1])
def test_bit_255_of_each_half_is_dropped(jax_side, half):
    raw = jax_side["raw"][N_SEEDED + 2 + half: N_SEEDED + 3 + half].copy()
    cleared = raw.copy()
    cleared[0, 32 * half + 31] &= 0x7F
    assert raw[0, 32 * half + 31] & 0x80
    assert torch.equal(_port_points(raw), _port_points(cleared))


def test_from_uniform_bytes_takes_a_tensor_or_an_array(jax_side):
    raw = jax_side["raw"][:3]
    assert torch.equal(_port_points(raw),
                       C.from_uniform_bytes(raw, device="cpu"))
    with pytest.raises(ValueError):
        C.from_uniform_bytes(raw[:, :32], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            C.from_uniform_bytes(raw)                 # the default: the card


def test_normalize_z_equals_jax(jax_side):
    pts = _port_points(jax_side["raw"])
    assert not bool((F.canonicalize(pts[2].to(torch.int64))[0] == 1).all())
    norm = M.normalize_z(pts)
    coords = [fe_limbs_to_ints(F.canonicalize(norm[c].to(torch.int64))
                               .numpy()) for c in range(4)]
    for i, want in enumerate(jax_side["normalized"]):
        assert coords[2][i] == 1 and want.Z % HF.P == 1
        assert coords[0][i] == want.X % HF.P, f"x of point {i}"
        assert coords[1][i] == want.Y % HF.P, f"y of point {i}"
        assert coords[3][i] == want.X * want.Y % HF.P, f"t of point {i}"


def _scalar_bytes(vals):
    return torch.as_tensor(np.frombuffer(
        b"".join(v.to_bytes(32, "little") for v in vals), np.uint8)
        .reshape(len(vals), 32).copy())


def _msm_cases(jax_side):
    """(name, port points, JAX host points, scalars): N_SEEDED seeded
    points with a zero scalar and l - 1 among random ones; and half of
    them twice, the second time with the negated scalars (the identity)."""
    r = random.Random(83)
    raw = jax_side["raw"][:N_SEEDED]
    vals = [r.randrange(ELL) for _ in range(N_SEEDED)]
    vals[3], vals[7] = 0, ELL - 1
    h = N_SEEDED // 2
    twice = np.concatenate([raw[:h], raw[:h]])
    neg = vals[:h] + [(ELL - v) % ELL for v in vals[:h]]
    return [("random", _port_points(raw), jax_side["points"][:N_SEEDED],
             vals),
            ("identity", _port_points(twice), jax_side["points"][:h] * 2,
             neg)]


def test_both_msm_routes_equal_jax_host_msm(jax_side):
    for name, pts, host, vals in _msm_cases(jax_side):
        sc = _scalar_bytes(vals)
        want = jax_msm([JaxScalar(v) for v in vals], host).compress()
        general = M.msm_lanes_flag(pts, sc)
        niels = M.msm_lanes_niels_flag(M.normalize_z(pts), sc)
        for route, (out, flag) in (("general", general), ("niels", niels)):
            assert out.shape == (4, 10, 1) and flag.shape == (1,)
            got = bytes(C.compress_plain(out).numpy()[0])
            assert got == want, f"{route} route, {name}"
            assert bool(flag[0]) == (want == bytes(32)), f"{route}, {name}"
        assert bool(niels[1][0]) == (name == "identity")


def test_niels_route_refuses_mismatched_scalars(jax_side):
    pts = _port_points(jax_side["raw"][:4])
    with pytest.raises(ValueError):
        M.msm_lanes_niels_flag(pts, _scalar_bytes([1, 2, 3]))
