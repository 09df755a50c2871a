"""The fused attention's share of the card's busy time (train cells): 100 x
the device seconds of the attention's kernels (matched by name,
``arith/segformer.py``) over the traced window's busy seconds; none where
the trace holds no such kernel."""

from portbench.metrics.arith import segformer


def read(run: dict):
    trace, counters = run.get("trace"), run.get("counters") or {}
    if not trace or counters.get("kind") != "train" or not trace.get("busy_s"):
        return None
    secs = segformer.attention_seconds(trace["kernels"])
    return 100.0 * secs / trace["busy_s"] if secs > 0 else None
