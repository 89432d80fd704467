"""Host milliseconds a call inside the prove entry's codecs:
BatchProver._statements (the statements to device rows) and
BatchProver._assemble (the fetched bytes to proof objects)."""

UNIT = "ms"
LAYER = "prove entry (proofs/batch_prover.py)"
MOVES = "prove_outputs_per_s"


def read(run):
    spans = run.spans
    if spans is None or not run.latencies_s or not spans.calls["statements"]:
        return None
    return (spans.seconds["statements"] + spans.seconds["assemble"]) \
        / len(run.latencies_s) * 1e3
