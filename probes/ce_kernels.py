#!/usr/bin/env python3
"""Time the CE kernels (K1, K3, the CE grad) of the port at the train shape
on one CUDA card, for the port tree at TREE (default: this checkout).

    python3 probes/ce_kernels.py [TREE] [--sweep]

TREE may be an unpacked older commit of the port, e.g.
``git archive <commit> fcn8s_tensorflow_tpu_torch | tar -x -C build/parent``,
so two versions are compared on one card in one call (run them in turns:
old, new, new, old). Inputs: P = 8 x 1024 x 512 rows of 20 bf16 classes
(``randn * 3``), uint8 labels, seed 10. Times are per call: the median over
10 repetitions of the mean of 20 back-to-back calls between CUDA events, and
(``*_graph_ms``) the same calls replayed from a CUDA graph, which leaves out
the host entirely. ``--sweep`` (this tree only) also times the three kernels
over grids of 528/792/1056 blocks and tiles of 10/20/40 KB of logits. Prints
one JSON object per line.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

TREE = os.path.abspath(next((a for a in sys.argv[1:] if not a.startswith("--")),
                            os.path.join(os.path.dirname(__file__), "..")))
sys.path.insert(0, TREE)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from fcn8s_tensorflow_tpu_torch.kernels import build  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import kernels as K  # noqa: E402


def events_ms(fn, reps: int = 10, n: int = 20, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def graph_ms(fn, reps: int = 10, n: int = 20) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe times the card")
    t0 = time.perf_counter()
    build.library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(10)
    p, c, pps = 8 * 1024 * 512, 20, 1024 * 512
    logits = (torch.randn((p, c), generator=g, device=dev) * 3).to(torch.bfloat16)
    labels = torch.randint(0, c, (p,), generator=g, device=dev, dtype=torch.uint8)
    mask = torch.ones(8, device=dev)
    w = torch.rand(p, generator=g, device=dev)
    grad_out = torch.tensor(1.0 / p, device=dev)
    want = K.ce_sum_per_sample_plain(logits, labels, mask, pps)
    d_want = K.ce_grad_plain(logits, labels, mask, grad_out, pps)

    def agrees() -> bool:
        got = K.ce_sum_per_sample(logits, labels, mask, pps)
        d = K.ce_grad(logits, labels, mask, grad_out, pps)
        return (abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
                and float((d.float() - d_want.float()).abs().max()) < 1e-8)

    calls = {"k1": lambda: K.ce_sum_per_sample(logits, labels, mask, pps),
             "k3": lambda: K.ce_sum_weighted(logits, labels, w),
             "grad": lambda: K.ce_grad(logits, labels, mask, grad_out, pps),
             "grad_per_pixel": lambda: K.ce_grad(logits, labels, w, grad_out, None)}
    out = {"tree": TREE, "device": torch.cuda.get_device_name(0),
           "build_s": time.perf_counter() - t0, "agrees": agrees()}
    for name, fn in calls.items():
        out[name + "_ms"] = events_ms(fn)
        out[name + "_graph_ms"] = graph_ms(fn)
    lib_labels = labels.long()
    out["f_cross_entropy_ms"] = events_ms(lambda: F.cross_entropy(logits, lib_labels,
                                                                  reduction="sum"))
    print(json.dumps(out))
    if "--sweep" in sys.argv:
        for blocks in (528, 792, 1056):
            for tile in (10240, 20480, 40960):
                K._CE_MAX_BLOCKS, K._CE_TILE_BYTES = blocks, tile
                row = {"blocks": blocks, "tile_bytes": tile, "agrees": agrees()}
                for name in ("k1", "k3", "grad"):
                    row[name + "_graph_ms"] = graph_ms(calls[name])
                print(json.dumps(row))


if __name__ == "__main__":
    main()
