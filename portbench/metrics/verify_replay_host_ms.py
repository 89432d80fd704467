"""Host milliseconds a call inside BatchVerifier.replay: the C++
transcript replay (native/verify_prep.cpp
rangeproof_verify_replay_batch_c), one call a sub-batch, with the
transcripts' states gathered and written back."""

UNIT = "ms"
LAYER = "C++ transcript replay (BatchVerifier.replay, native/verify_prep.cpp)"
MOVES = "verify_outputs_per_s"


def read(run):
    spans = run.spans
    if spans is None or not run.latencies_s or not spans.calls["replay"]:
        return None
    return spans.seconds["replay"] / len(run.latencies_s) * 1e3
