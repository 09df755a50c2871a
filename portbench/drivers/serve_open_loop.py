"""Serving under open-loop load: ``InferenceService`` (micro-batched)
behind ``make_server`` on a localhost port the system picks, and a load
generator in a child process (``traffic/loadgen.py``) that sends
``POST /predict`` with PNG bodies on a seeded Poisson schedule.

Set-up starts the child first (it encodes the pool of seeded scenes while
the model is made), builds the model and the service, predicts one scene in
process (the capture of the padded batch), sends a burst over HTTP and then
``warm_seconds`` of open-loop traffic at the cell's rate on a schedule of
its own, so that the window finds the service as it runs under that load
(its threads, pinned host buffers and sockets grown to what the rate
needs).
The window is the schedule: ``rate_per_s * --seconds`` requests due at
seeded times, each timed from when it was due until its response has been
read; a request that fails counts as having waited until the generator gave
up. ``request_p50_ms`` is the nearest-rank median over every request; the
latencies go to the counters too, where ``request_p95_ms.serve`` reads
their 95th percentile. After the window the service stops, the program is
dropped, and the plain reference computes the fp32 logits of a seeded
sample of the requests' scenes; the check reads by how much the served ids'
logits lie below the reference's best (``reference/compare.answer_gaps``).
"""

from __future__ import annotations

import base64
import io
import threading
import time

import numpy as np
import torch
from PIL import Image

from .. import harness, system, tracing, weights
from ..reference import compare, fcn
from ..traffic import loadgen, scenes, schedule

GRACE_S = 60.0


class Service:
    """The model behind the HTTP server, on a thread of this process."""

    def __init__(self, model, traffic: dict):
        from fcn8s_tensorflow_tpu_torch.engine.serving import InferenceService, make_server

        self.model = model
        self.service = InferenceService(model, batch_window_ms=traffic["batch_window_ms"],
                                        max_batch=traffic["max_batch"])
        self.server = make_server(self.service, port=0)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.calls: list[float] = []

    def counters(self) -> tuple[int, int]:
        return self.service.requests, self.service.dispatches

    def time_predict(self) -> None:
        """Record the wall time of each call of the model's public
        ``predict`` (and a span of it in a trace) from now on."""
        inner = self.model.predict

        def timed(*args, **kwargs):
            t = time.perf_counter()
            with torch.profiler.record_function("portbench.predict"):
                out = inner(*args, **kwargs)
            self.calls.append(time.perf_counter() - t)
            return out

        self.model.predict = timed

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()
        self.service.close()


def warm(service: Service, gen: loadgen.LoadGen, seed: int, hw, traffic: dict,
         rate: float) -> None:
    """The capture of the padded batch in process, a burst over HTTP, then
    ``warm_seconds`` of open-loop load at ``rate``."""
    image, _ = scenes.batch(seed, scenes.SERVE_STREAM, 0, 1, hw[0], hw[1])
    buf = io.BytesIO()
    Image.fromarray(image[0]).save(buf, format="PNG")
    service.service.predict_png(buf.getvalue())
    answer = gen.warm(service.port, traffic["warm_requests"], traffic["max_batch"])
    if answer["errors"]:
        raise RuntimeError(f"warm-up: {answer['errors']} of {answer['warmed']} requests failed")
    due = schedule.arrivals(seed, rate, traffic["warm_seconds"], stream=3)
    records = gen.go(due, schedule.picks(seed, len(due), traffic["pool"]), [], GRACE_S)["records"]
    failed = latencies(records)[1]
    if failed:
        raise RuntimeError(f"warm-up: {failed} of {len(records)} requests failed")


def latencies(records: list) -> tuple[list[float], int]:
    """Every request's latency (a failure's: until the generator gave up)
    and the number that failed."""
    return [r[2] for r in records], sum(1 for r in records if r[3] != 200)


def check_gaps(cfg: dict, seed: int, device, width, hw, picks, keep: list, bodies: dict):
    """The answer gaps of the kept requests against the reference's fp32
    logits of their scenes; a kept request without an answer is wrong."""
    if any(str(i) not in bodies for i in keep):
        return {"mean_gap": float("inf")}
    tree = weights.make_tree(cfg, seed, device, width)

    def pairs():
        for i in keep:
            ids = np.asarray(Image.open(io.BytesIO(base64.b64decode(bodies[str(i)]))))
            image, _ = scenes.batch(seed, scenes.SERVE_STREAM, int(picks[i]), 1, hw[0], hw[1])
            yield fcn.logits(tree, image[0], cfg), ids

    with fcn.exact_fp32():
        out = compare.answer_gaps(pairs())
    del tree
    return out


def run(ctx: harness.Context) -> harness.Result:
    cfg, traffic, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    hw = ctx.mix("image_hw")
    due = schedule.arrivals(ctx.seed, ctx.mix("rate_per_s"), ctx.seconds)
    picks = schedule.picks(ctx.seed, len(due), traffic["pool"])
    keep = schedule.keep(ctx.seed, len(due), traffic["sample"])
    gen = loadgen.LoadGen(ctx.seed, traffic["pool"], hw, harness.root())
    try:
        system.reset_peak(device)
        model = system.model(cfg, ctx.seed, device, ctx.width)
        service = Service(model, traffic)
        try:
            warm(service, gen, ctx.seed, hw, traffic, ctx.mix("rate_per_s"))
            system.sync(device)
            if ctx.trace:
                service.time_predict()
            before = service.counters()
            with tracing.traced(ctx.trace) as trace:
                start = time.perf_counter()
                with tracing.window():
                    answer = gen.go(due, picks, keep, GRACE_S)
                end = time.perf_counter()
            after = service.counters()
        finally:
            service.close()
    finally:
        gen.close()
    peak = system.peak_bytes(device)
    calls = list(service.calls)
    del model, service
    system.free(device)

    lat, failed = latencies(answer["records"])
    found = check_gaps(cfg, ctx.seed, device, ctx.width, hw, picks, keep, answer["bodies"])
    return harness.Result(
        setup_s=start - ctx.t0, attempted=len(lat), failed=failed,
        end_to_end={"request_p50_ms": 1e3 * schedule.percentile(lat, 0.50),
                    "setup_s": start - ctx.t0},
        counters={"requests": after[0] - before[0], "dispatches": after[1] - before[1],
                  "max_batch": traffic["max_batch"], "predict_call_s": calls,
                  "latency_s": lat, "kind": "serve"},
        checks=harness.checks(found, ctx.cell.limits),
        memory_peak_bytes=peak, device_count=1, trace=trace.summary,
        notes={"gaps": found})
