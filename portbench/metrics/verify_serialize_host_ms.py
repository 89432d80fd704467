"""Host milliseconds a call inside the verifier's proof codec and
staging: BatchVerifier._serialize (proof objects to wire bytes and the
dynamic points' rows) and BatchVerifier._upload (pinned copies to the
card)."""

UNIT = "ms"
LAYER = "proof codec and staging (_serialize, _upload)"
MOVES = "verify_outputs_per_s"


def read(run):
    spans = run.spans
    if spans is None or not run.latencies_s or not spans.calls["serialize"]:
        return None
    return (spans.seconds["serialize"] + spans.seconds["upload"]) \
        / len(run.latencies_s) * 1e3
