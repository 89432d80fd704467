"""The fixed-base work count of `portbench/work.py` against the
arithmetic `chip_smoke.py`'s fixed_shape_checks derives (non-zero digits
of the stream times the multiply-adds of one mixed addition) and the
program's own digit recoding."""

import random

import pytest
import torch
from conftest import REPO  # noqa: F401  (puts the repo on sys.path)

from portbench import work

L = 2 ** 252 + 27742317777372353535851937790883648493


def _madd():
    """chip_smoke.py's multiply-adds of one mixed addition."""
    import chip_smoke
    from bulletproofs_tpu_torch.ops import curve as C
    return chip_smoke.field_mads(lambda: C.madd(
        C.to_coords(C.identity(1, "cpu")),
        tuple(torch.zeros((10, 1), dtype=torch.int64) for _ in range(3))))


def test_mixed_addition_cost_is_chip_smokes():
    assert work.MADD_MADS == _madd()


def test_uniform_digits_count_equals_chip_smokes():
    """A stream whose digits take every value of [-7, 8] equally often:
    chip_smoke's count (non-zero digits x madd) equals the model's 15 in
    16 non-zero digits of a full window."""
    rows, lanes = 3 * 64, 32
    dig = (torch.arange(rows * lanes) % 16 - 7).reshape(rows, lanes)
    dig = dig[torch.randperm(rows)].to(torch.int8)
    chip_smoke_mads = int((dig != 0).sum()) * _madd()
    mads, nbytes = work.stream_work(rows, lanes, rows * 15 / 16)
    assert mads == chip_smoke_mads
    assert nbytes == rows * 120 + rows * lanes + lanes * 160


def _digits(values):
    from bulletproofs_tpu_torch.ops import fold as FO
    from bulletproofs_tpu_torch.ops import scalar as S
    raw = torch.tensor([list(v.to_bytes(32, "little")) for v in values],
                       dtype=torch.uint8)
    return FO.digits_lanes(S.from_bytes32(raw).contiguous())     # (64, Q)


@pytest.mark.parametrize("draw,expected", [
    (lambda r: r.randrange(L), work.UNIFORM),
    (lambda r: r.randrange(1 << 64), work.VALUE64),
])
def test_expected_nonzero_digits_match_the_programs_recoding(draw, expected):
    """The program's signed digits of uniform values: non-zero a value
    within 5 standard deviations of the model's expectation."""
    r = random.Random(11)
    q = 4096
    dig = _digits([draw(r) for _ in range(q)])
    got = int((dig != 0).sum()) / q
    sd = (64 * 0.25 / q) ** 0.5
    assert abs(got - expected) < 5 * sd


def test_prove_streams_at_the_cells_shapes():
    """The streams are the program's: S over 2N + 1 bases, L / R over
    N + 1, 2 log2 N of them, the rows chip_smoke.py names (m=16 S 131,136
    rows, IPP L 65,600)."""
    s16 = {w: (r, q) for w, r, q, _ in work.prove_streams(64, 16, 256)}
    assert s16["S"] == (131_136, 256) and s16["LR"] == (65_600, 256)
    assert sum(1 for w, *_ in work.prove_streams(64, 16, 256) if w == "LR") == 20
    assert sum(1 for w, *_ in work.prove_streams(64, 8, 512) if w == "LR") == 18
    peak = work.peak_imads_per_s(1980)
    assert peak == pytest.approx(1.673e13, rel=1e-3)
    assert 0.02 < work.prove_bound_s(64, 16, 256, peak) < 0.04
