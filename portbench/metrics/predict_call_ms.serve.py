"""The mean wall time of the service's calls to the model's public
``predict`` in the window, timed by the benchmark around that method."""


def read(run: dict):
    counters = run.get("counters") or {}
    calls = counters.get("predict_call_s") or []
    if counters.get("kind") != "serve" or not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
