"""Kernels K15 / K16 (the chained shared-operand field multiplication of the
MXU probe) of the PyTorch port, through their plain PyTorch versions on the
CPU, against the JAX package: a jax.lax.fori_loop of pallas_math's fmul /
carry, the probe's `vpu_kernel` body rebuilt as a Pallas kernel in
interpret mode, and the probe's `mxu_mul` form rebuilt with jnp.

Q = 16 lanes, T = 8 steps, operands drawn by numpy RandomState.  Every
comparison is exact, limb for limb (integer arithmetic: tolerance 0); the
Python-int oracle is compared mod p."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from bulletproofs_tpu.ops import pallas_math as PM

from bulletproofs_tpu_torch.benches import mxu_fmul_probe as PROBE
from bulletproofs_tpu_torch.ops import fmul13 as F

HERE = os.path.dirname(os.path.abspath(__file__))
Q, T = 16, 8


@pytest.fixture(scope="module")
def inputs():
    return PROBE.make_inputs(Q, T, seed=91)


@pytest.fixture(scope="module")
def jax_probe():
    """benches/_mxu_fmul_probe.py, loaded by path (numpy at module level
    only; its kernels are closures inside main())."""
    path = os.path.join(os.path.dirname(HERE), "benches", "_mxu_fmul_probe.py")
    spec = importlib.util.spec_from_file_location("_mxu_fmul_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_step(a, b1, b2, b3):
    y1 = PM.fmul(a, jnp.broadcast_to(b1, a.shape))
    y2 = PM.fmul(a, jnp.broadcast_to(b2, a.shape))
    y3 = PM.fmul(a, jnp.broadcast_to(b3, a.shape))
    return PM.carry(y1 + y2 + y3)


def _b3_probe_layout(inp):
    """(3, 20, T) -> the probe's (3, 20, T, 1) int32."""
    return jnp.asarray(inp["b3"].numpy()[..., None])


def test_plain_vpu_chain_matches_jax_fori_loop(inputs):
    b3 = _b3_probe_layout(inputs)

    def step(k, a):
        return _jax_step(a, b3[0, :, k, :], b3[1, :, k, :], b3[2, :, k, :])

    want = np.asarray(jax.lax.fori_loop(0, T, step,
                                        jnp.asarray(inputs["a"].numpy())))
    got = F.chain_vpu_plain(inputs["a"], inputs["b3"])
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_plain_vpu_chain_matches_pallas_vpu_kernel_interpret(inputs):
    """The probe's vpu_kernel body (benches/_mxu_fmul_probe.py:135-145)
    as a pallas_call in interpret mode."""

    def vpu_kernel(consts_ref, b3_ref, a_ref, out_ref):
        PM.bind_consts(consts_ref)
        a = a_ref[0]

        def step(k, a):
            return _jax_step(a, b3_ref[0, :, k, :], b3_ref[1, :, k, :],
                             b3_ref[2, :, k, :])

        out_ref[0] = jax.lax.fori_loop(0, T, step, a)

    vpu = pl.pallas_call(
        vpu_kernel, out_shape=jax.ShapeDtypeStruct((1, F.L, Q), jnp.int32),
        interpret=True)
    want = np.asarray(vpu(jnp.asarray(PM.CONSTS), _b3_probe_layout(inputs),
                          jnp.asarray(inputs["a"].numpy())[None]))[0]
    assert np.array_equal(F.chain_vpu_plain(inputs["a"], inputs["b3"]).numpy(),
                          want)


def _jax_mxu_mul(a, Mmat):
    """The probe's mxu_mul (benches/_mxu_fmul_probe.py:93-117) in jnp."""
    L, MASK, LIMB = F.L, F.MASK, F.LIMB_BITS
    alo = (a & 127).astype(jnp.int8)
    ahi = (a >> 7).astype(jnp.int8)
    A = jnp.concatenate([alo, ahi], axis=0)
    Pm = jax.lax.dot_general(Mmat, A, (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32)
    n = 2 * L - 1
    c = (Pm[:n] + 128 * (Pm[n: 2 * n] + Pm[2 * n: 3 * n])
         + 16384 * Pm[3 * n: 4 * n])
    lo, hi = c[:L], c[L:]
    z1 = jnp.zeros_like(hi[:1])
    lo = lo + 608 * jnp.concatenate([hi & MASK, z1], axis=0)
    lo = lo + 608 * jnp.concatenate([z1, hi >> LIMB], axis=0)
    return PM.carry(PM.carry(PM.carry(lo)))


def test_plain_mxu_chain_matches_jax_mxu_form(inputs):
    m3 = jnp.asarray(inputs["m3"].numpy())
    a = jnp.asarray(inputs["a"].numpy())
    # one product, as the probe's oracle check
    one = np.asarray(_jax_mxu_mul(a, jnp.asarray(inputs["M"].numpy())))
    assert np.array_equal(F.mxu_mul(inputs["a"], inputs["M"]).numpy(), one)
    for t in range(T):
        a = PM.carry(_jax_mxu_mul(a, m3[0, t]) + _jax_mxu_mul(a, m3[1, t])
                     + _jax_mxu_mul(a, m3[2, t]))
    got = F.chain_mxu_plain(inputs["a"], inputs["m3"])
    assert np.array_equal(got.numpy(), np.asarray(a))


def test_vpu_and_mxu_chains_agree_limb_for_limb(inputs):
    assert torch.equal(F.chain_vpu(inputs["a"], inputs["b3"]),
                       F.chain_mxu(inputs["a"], inputs["m3"]))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_band_matrix_matches_probe(jax_probe, seed):
    g = np.random.RandomState(seed)
    vals = [0, 1, F.P25519 - 1] + [int.from_bytes(g.bytes(32), "little")
                                    % F.P25519 for _ in range(5)]
    for v in vals:
        want = jax_probe.band_matrix(v)
        got = F.band_matrix(v)
        assert got.dtype == np.int8 and np.array_equal(got, want)
        assert np.array_equal(F.to_limbs(v), jax_probe.to_limbs(v))


def test_limbs_stay_below_2_14_at_every_step(inputs):
    """The int8 split [a & 127; a >> 7] is exact only while every limb is
    below 2^14: the chain keeps them there (after carry: limbs 1-19 at most
    2^13 + 4, limb 0 a few multiples of 608 more)."""
    a = inputs["a"]
    worst = int(a.max())
    for t in range(T):
        a = F.chain_vpu_plain(a, inputs["b3"][:, :, t: t + 1])
        assert int(a.min()) >= 0
        worst = max(worst, int(a.max()))
        assert int(a[1:].max()) <= (1 << 13) + 4
    assert worst < 1 << 14


def test_chain_matches_python_int_oracle(inputs):
    got = F.limbs_to_ints(F.chain_vpu_plain(inputs["a"], inputs["b3"]).numpy())
    want = PROBE.chain_oracle(inputs["a_int"], inputs["b_steps"], T)
    assert [g % F.P25519 for g in got] == want


def test_probe_run_on_cpu(inputs):
    res = PROBE.run("cpu", inputs=inputs, reps=1, log=lambda *a: None)
    assert res["oracle_ok"] and res["lanes"] == Q and res["steps"] == T
    assert torch.equal(res["vpu_out"], res["mxu_out"])
    assert res["vpu_ms"] > 0 and res["mxu_ms"] > 0


def test_probe_inputs_follow_the_jax_probe(jax_probe):
    """The port's inputs draw the probe's RandomState(5) sequence: a, one
    b, then the step operands (benches/_mxu_fmul_probe.py:83-89, 177-185)."""
    inp = PROBE.make_inputs(8, 4, seed=5)
    rng = np.random.RandomState(5)
    p = F.P25519
    a_int = [int.from_bytes(rng.bytes(31), "little") % p for _ in range(8)]
    b_int = int.from_bytes(rng.bytes(31), "little") % p
    steps = [int.from_bytes(rng.bytes(31), "little") % p for _ in range(12)]
    assert inp["a_int"] == a_int and inp["b_int"] == b_int
    assert inp["b_steps"] == steps
    # the kernels' wrappers take contiguous tensors only
    assert all(inp[k].is_contiguous() for k in ("a", "b3", "m3"))
    for j in range(3):
        for t in range(4):
            v = steps[j * 4 + t]
            assert np.array_equal(inp["b3"][j, :, t].numpy(),
                                  jax_probe.to_limbs(v))
            assert np.array_equal(inp["m3"][j, t].numpy(),
                                  jax_probe.band_matrix(v))


def test_wrappers_refuse_wrong_shapes():
    a = torch.zeros((20, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        F.chain_vpu(a, torch.zeros((3, 19, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        F.chain_mxu(a, torch.zeros((3, 2, 156, 40), dtype=torch.int32))
    with pytest.raises(ValueError):
        F.chain_vpu(a.to(torch.int64), torch.zeros((3, 20, 2),
                                                   dtype=torch.int32))


def test_probe_default_device_is_cuda():
    """With no card, the probe's default device raises (no fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        PROBE.run(lanes=4, steps=1, log=lambda *a: None)
