"""What the readers share: the device's idle share, the step's share of
the card's bf16 peak, and the hand kernels' share of their bounds, each in
percent of a traced window, or None where the run holds nothing to read."""

from __future__ import annotations

from portbench.metrics.arith import kernels, peaks


def idle(run: dict, kind: str):
    trace, counters = run.get("trace"), run.get("counters") or {}
    if not trace or counters.get("kind") != kind or not trace.get("device_events"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def mfu(run: dict, kind: str):
    trace, counters = run.get("trace"), run.get("counters") or {}
    peak = peaks.bf16_flops(run.get("device_name") or "")
    if not trace or counters.get("kind") != kind or not peak or not counters.get("flops"):
        return None
    return 100.0 * counters["flops"] / (trace["window_s"] * counters["chips"] * peak)


def roofline(run: dict, kind: str):
    trace, counters = run.get("trace"), run.get("counters") or {}
    bandwidth = peaks.hbm_bytes(run.get("device_name") or "")
    if not trace or counters.get("kind") != kind or not bandwidth:
        return None
    per_step = kernels.step_bytes(counters["config"], counters["batch"], counters["image_hw"],
                                  kind, counters.get("widths"))
    share = kernels.roofline(trace["kernels"], per_step, bandwidth)
    return None if share is None else 100.0 * share
