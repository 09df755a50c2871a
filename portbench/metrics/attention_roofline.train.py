"""SegFormer's attention against the card's bf16 peak (train cells): the
analytic FLOPs of the window's attention calls (the program's counter
``ops.nn.attention.calls``, forward and backward,
``arith/segformer.py``) over the peak (``arith/peaks.py``), as a share of
the device seconds of the fused attention's kernels, matched by name; none
where the run counted no calls or the trace holds no such kernel."""

from portbench.metrics.arith import peaks, segformer


def read(run: dict):
    trace, counters = run.get("trace"), run.get("counters") or {}
    peak = peaks.bf16_flops(run.get("device_name") or "")
    calls = counters.get("attention_calls")
    if not trace or counters.get("kind") != "train" or not peak or not calls:
        return None
    secs = segformer.attention_seconds(trace["kernels"])
    if secs <= 0:
        return None
    return 100.0 * segformer.attention_flops(calls, train=True) / peak / secs
