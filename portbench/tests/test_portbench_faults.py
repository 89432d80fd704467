"""The comparison that decides `correct`, on the tiny cell through the
port's CPU route: a sound run is correct, and each fault the prove cell
can have, planted under the timed path, makes it not correct.  The
control (the reference with 32-byte challenges in the program's place)
fails every exact comparison."""

import gc

import pytest
from conftest import TINY_CFG, TINY_TRAFFIC, run_tiny


@pytest.mark.parametrize("m", [2, 1])
def test_sound_run_is_correct(tiny, m):
    if m != TINY_CFG["m"]:
        import json
        from portbench import run as RUN
        with open(f"{RUN.ROOT}/portbench/configs/tiny.json", "w") as fh:
            json.dump(dict(TINY_CFG, m=m), fh)
    res = run_tiny(tiny)
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert gc.get_freeze_count() == 0    # the set-up heap is thawed again
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"prove_outputs_per_s", "prove_call_p90_ms",
                                   "setup_s"} - ({"prove_call_p90_ms"}
                                                 if res["attempted"] < 2 else set())


def _state_unchanged(monkeypatch):
    """The call leaves every transcript as it found it."""
    from bulletproofs_tpu_torch.proofs.batch_prover import BatchProver
    real = BatchProver.prove_batch

    def fault(self, values, blindings, transcripts, rng=None):
        snaps = [t.strobe.buf.raw for t in transcripts]
        out = real(self, values, blindings, transcripts, rng=rng)
        for t, s in zip(transcripts, snaps):
            t.strobe.buf.raw = s
        return out
    monkeypatch.setattr(BatchProver, "prove_batch", fault)


def _half_batch(monkeypatch):
    """Only the first half of the statements is proved; its proofs stand
    in for the rest."""
    from bulletproofs_tpu_torch.proofs.batch_prover import BatchProver
    real = BatchProver.prove_batch

    def fault(self, values, blindings, transcripts, rng=None):
        h = max(1, len(values) // 2)
        proofs, vcs = real(self, values[:h], blindings[:h], transcripts[:h],
                           rng=rng)
        k = len(values)
        return [proofs[i % h] for i in range(k)], [vcs[i % h] for i in range(k)]
    monkeypatch.setattr(BatchProver, "prove_batch", fault)


def _point_altered(monkeypatch):
    """The fixed-base MSM's points land in the wrong lanes where they are
    produced: every commitment and IPP point goes to another proof."""
    import torch
    from bulletproofs_tpu_torch.ops import fixed_msm
    real = fixed_msm.msm_digits_niels

    def fault(niels, digits, consttime=True):
        return torch.roll(real(niels, digits, consttime), 1, dims=-1)
    monkeypatch.setattr(fixed_msm, "msm_digits_niels", fault)


def _lane_altered(monkeypatch):
    """One lane of the IPP rows' fixed-base MSM (K6 direct) takes another
    lane's point where it is produced, and the program goes on with it:
    its transcripts and scalars agree with the wrong point."""
    from bulletproofs_tpu_torch.ops import fixed_msm
    real = fixed_msm.msm_digits_niels

    def fault(niels, digits, consttime=True):
        out = real(niels, digits, consttime)
        if not consttime and out.shape[-1] > 1:
            out = out.clone()
            out[..., -1] = out[..., 0]
        return out
    monkeypatch.setattr(fixed_msm, "msm_digits_niels", fault)


def _scalar_altered(monkeypatch):
    """The last proof of a call leaves the prover with another t_x."""
    from bulletproofs_tpu_torch.core.scalar import Scalar
    from bulletproofs_tpu_torch.proofs.batch_prover import BatchProver
    real = BatchProver._assemble

    def fault(self, *a):
        proofs, vcs = real(self, *a)
        proofs[-1].t_x = Scalar(proofs[-1].t_x.v + 1)
        return proofs, vcs
    monkeypatch.setattr(BatchProver, "_assemble", fault)


@pytest.mark.parametrize("plant,number", [
    (_state_unchanged, "replay_mismatches"),
    (_half_batch, "replay_mismatches"),
    (_point_altered, "exact_mismatches"),
    (_point_altered, "point_mismatches"),
    (_lane_altered, "point_mismatches"),
    (_scalar_altered, "replay_mismatches"),
])
def test_fault_makes_the_run_not_correct(tiny, monkeypatch, plant, number):
    plant(monkeypatch)
    res = run_tiny(tiny)
    assert not res["correct"]
    assert res["check"][number]["value"] > res["check"][number]["limit"]


def test_control_fails_the_exact_comparison():
    """The control: the reference with 32-byte challenges put in the
    program's place for the proofs that the exact comparison reads."""
    from portbench import control
    got = control.control_reading(TINY_CFG, TINY_TRAFFIC, seed=3, workers=1)
    assert got["numbers"]["exact_mismatches"] == got["checked"] > 0
