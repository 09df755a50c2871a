"""The share of the padded device batches that clients asked for: the
service's ``requests`` over ``dispatches`` x ``max_batch``, both counted
over the window."""


def read(run: dict):
    counters = run.get("counters") or {}
    if counters.get("kind") != "serve" or not counters.get("dispatches"):
        return None
    return 100.0 * counters["requests"] / (counters["dispatches"] * counters["max_batch"])
