"""The nearest-rank 95th percentile of the client-side latency of every
request due in the window (serve cells), timed as ``request_p50_ms`` is:
from when the open-loop schedule made the request due until its response
body was read."""

from portbench.traffic.schedule import percentile


def read(run: dict):
    counters = run.get("counters") or {}
    latency = counters.get("latency_s") or []
    if counters.get("kind") != "serve" or not latency:
        return None
    return 1e3 * percentile(latency, 0.95)
