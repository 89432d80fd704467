"""Host milliseconds a call inside the C++ Fiat-Shamir transcript calls
(core/_native.py rp_ts_yz, and rp_ts_x / rp_ts_w / rp_ts_round where a
route makes them)."""

UNIT = "ms"
LAYER = "host Fiat-Shamir (core/_native.py)"
MOVES = "prove_outputs_per_s"


def read(run):
    spans = run.spans
    if spans is None or not run.latencies_s or not spans.calls["host_fs"]:
        return None
    return spans.seconds["host_fs"] / len(run.latencies_s) * 1e3
