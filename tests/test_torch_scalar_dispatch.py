"""The dispatch of ops/scalar.py's and ops/chacha.py's wrappers (kernels
K17-K20 on the card), on the CPU: every plain version (the oracles that
chip_smoke.py and the GPU tests hold the kernels K2, K8, K9, K14 and
K17-K20 to) runs with each dispatching wrapper and the launcher patched
to raise, so none of them can reach a kernel on the card; and the row
strides that K17 / K18 receive describe each operand as broadcast, for
the layouts the prover and verifier pass (a (9, 1) constant, an
expanded vector, column slices, transposes, (n, 9, P) against (9, P),
four-dimensional views)."""

import numpy as np
import pytest
import torch

from bulletproofs_tpu_torch.core.scalar import L as ELL
from bulletproofs_tpu_torch.ops import _cuda
from bulletproofs_tpu_torch.ops import chacha as CH
from bulletproofs_tpu_torch.ops import fold as FO
from bulletproofs_tpu_torch.ops import scalar as S
from bulletproofs_tpu_torch.ops import verify as V
from bulletproofs_tpu_torch.ops.limbs import sc_ints_to_limbs, \
    sc_limbs_to_ints

DISPATCHING = ("mont_mul", "smul", "to_mont", "from_mont", "sreduce",
               "sadd", "sneg", "tree_sum", "from_wide_bytes", "sinv",
               "power_sequence")


def _sc(shape, seed):
    """Canonical scalars of shape (..., 9, P) from a seeded draw."""
    *lead, _, p = shape
    k = int(np.prod(lead, dtype=np.int64)) * p
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % ELL for _ in range(k)]
    limbs = torch.as_tensor(sc_ints_to_limbs(vals))          # (9, k)
    return limbs.reshape(9, *lead, p).movedim(0, -2).contiguous()


def _oracles():
    """Every plain version of a kernel that builds on ops/scalar.py, on
    small seeded inputs -> their outputs."""
    n, m, P = 8, 1, 5
    _, nblk, _ = V.shape(n, m)
    rng = np.random.default_rng(3)
    blk = torch.as_tensor(np.frombuffer(b"".join(
        (int.from_bytes(rng.bytes(32), "little") % ELL).to_bytes(32, "little")
        for _ in range(P * nblk)), np.uint8).reshape(P, nblk, 32).copy())
    a, b = _sc((6, 9, P), 4), _sc((6, 9, P), 5)
    u, v = _sc((9, P), 6), _sc((9, P), 7)
    idx = torch.tensor([3, 4, 5, 0, 0, 0])
    mask = torch.tensor([True, True, True, False, False, False])
    raw = torch.as_tensor(rng.integers(0, 256, (7, 64), np.uint8))
    return {
        "emit_plain": V.emit_plain(n, m, blk),
        "fold_plain": FO.fold_plain(a, b, u, v),
        "fold_pair_plain": FO.fold_pair_plain(a, b, u, v, idx, mask),
        "smul_pair_plain": FO.smul_pair_plain(a, b, mask, u, v),
        "digits_plain": FO.digits_plain(a),
        "sinv_plain": S.sinv_plain(u),
        "mont_mul_plain": S.mont_mul_plain(a, u),
        "smul_plain": S.smul_plain(a, S.const(5, "cpu")),
        "to_mont_plain": S.to_mont_plain(u),
        "from_mont_plain": S.from_mont_plain(u),
        "sreduce_plain": S.sreduce_plain(u),
        "sadd_plain": S.sadd_plain(a, v),
        "sneg_plain": S.sneg_plain(a),
        "tree_sum_plain": S.tree_sum_plain(a),
        "from_wide_bytes_plain": S.from_wide_bytes_plain(raw),
        "random_scalars_plain": CH.random_scalars_plain(bytes(range(32)), 9,
                                                        "cpu"),
    }


def test_plain_versions_reach_no_kernel(monkeypatch):
    """With every dispatching wrapper of ops/scalar.py, chacha.
    random_scalars and the launcher raising, each plain version still runs
    and gives what it gave before."""
    before = _oracles()

    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"a plain version called {name}")
        return f

    for name in DISPATCHING:
        monkeypatch.setattr(S, name, refuse(f"scalar.{name}"))
    monkeypatch.setattr(CH, "random_scalars", refuse("chacha.random_scalars"))
    monkeypatch.setattr(_cuda, "launch", refuse("_cuda.launch"))
    after = _oracles()
    assert before.keys() == after.keys()
    for name, want in before.items():
        got = after[name]
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        assert all(torch.equal(x, y) for x, y in pairs), name


def test_wrappers_on_cpu_tensors_equal_the_plain_versions():
    """On CPU tensors each wrapper is its plain version, with the same
    broadcasting: (n, 9, P) against (9, P) and a (9, 1) constant."""
    a, u = _sc((5, 9, 4), 8), _sc((9, 4), 9)
    c = S.const(ELL - 3, "cpu")
    assert torch.equal(S.smul(a, u), S.smul_plain(a, u))
    assert torch.equal(S.mont_mul(u, a), S.mont_mul_plain(u, a))
    assert torch.equal(S.sadd(a, c), S.sadd_plain(a, c))
    assert torch.equal(S.sneg(a), S.sneg_plain(a))
    assert torch.equal(S.tree_sum(a), S.tree_sum_plain(a))
    want = [sum(sc_limbs_to_ints(a[i].numpy())[p] for i in range(5)) % ELL
            for p in range(4)]
    assert sc_limbs_to_ints(S.tree_sum(a).numpy()) == want
    with pytest.raises(ValueError):
        S.tree_sum(a[:0])


def _layouts():
    """(name, operands) as callers pass them to K17 / K18."""
    y3 = _sc((9, 12), 10)
    vec = _sc((6, 9, 4), 11)
    # (5, 2, 9, 7) laid out as (5, 2, 7, 9): verify.tree_sum's operands
    part = _sc((5, 2, 9, 7), 12).transpose(-1, -2).contiguous() \
        .transpose(-1, -2)
    per = _sc((3, 9, 4), 13)
    return [
        ("vector against a (9, 1) constant", (vec, S.const(7, "cpu"))),
        ("expanded one against a column slice",
         (S.const(1, "cpu").expand(9, 4)[None], y3[:, :4])),
        ("column slices of one tensor", (y3[:, 4:8], y3[:, 8:])),
        ("a transposed block", (_sc((9, 4), 14).T.contiguous().T,
                                y3[:, :4])),
        ("(n, 9, P) against (9, P)", (vec, y3[:, :4])),
        ("halves of a four-dimensional view", (part[:2], part[2:4])),
        ("per-party scalars over n rows",
         (per[:, None].expand(3, 2, 9, 4), vec.reshape(3, 2, 9, 4))),
    ]


@pytest.mark.parametrize("case", range(7))
def test_row_strides_describe_each_operand(case):
    """For each layout the two row groups and every operand's strides,
    read back by as_strided, give the operand as broadcast, and no
    operand is copied."""
    name, ops = _layouts()[case]
    shape = torch.broadcast_shapes(*(t.shape for t in ops))
    views = [t.expand(shape) for t in ops]
    (r0, r1), rows = S._row_groups(shape, views)
    assert r0 * r1 * 9 * shape[-1] == int(np.prod(shape)), name
    for t, v, (s0, s1) in zip(ops, views, rows):
        got = torch.as_strided(t, (r0, r1, 9, shape[-1]),
                               (s0, s1, v.stride(-2), v.stride(-1)),
                               t.storage_offset())
        assert torch.equal(got.reshape(shape), v), name


def test_three_unmergeable_row_dimensions_are_refused():
    """Leading dimensions in reverse order of their strides cannot merge:
    three row groups, which K17 / K18 do not take."""
    x = _sc((2, 2, 3, 9, 4), 15).permute(2, 1, 0, 3, 4)
    with pytest.raises(ValueError):
        S._row_groups(x.shape, [x])
