#!/usr/bin/env python3
"""Time KB (the conv1_2-core calibration kernel) and K5 (the confusion
matrix) of the port on one CUDA card, for the port tree at TREE (default:
this checkout).

    python3 probes/kb_k5.py [TREE]

TREE may be an unpacked older commit of the port, e.g.
``git archive <commit> fcn8s_tensorflow_tpu_torch | tar -x -C build/parent``,
so two versions are compared on one card in one call (run them in turns:
old, new, new, old). Inputs:

* KB: the calibration script's data (x 8192 x 512 x 64 bf16,
  ``default_rng(0)``), checked against the twin within one bf16 step; beside
  it cuDNN's conv1_2 forward + ReLU on the script's (8, 1024, 512, 64) input;
* K5 at the serving shape, P = 8 x 512 x 1024 ids, int32 predictions, uint8
  labels, C = 20, sample 3 masked out: (a) ``random``, uniform ids with every
  997th label 255 (what ``chip_smoke.py`` times); (b) ``coherent``, eval-like
  ids made on the card from seed 1: labels in 32x32 blocks of random classes
  over each 512x1024 frame, predictions equal to them but on ~10% of pixels.
  Both are checked exactly against the twin.

Times are per call: ``*_ms`` the median over 10 repetitions of the mean of 20
back-to-back calls between CUDA events (which includes the host's launch
work where that is slower than the kernel), ``*_graph_ms`` the same 20 calls
replayed from a CUDA graph, which leaves the host out (KB and cuDNN: 10
calls, 5 repetitions). K5's accumulator is
zeroed before each replay. ``fill_graph_ms`` is the same graph timing of a
(20, 20) int32 ``zero_()``: what a kernel node that does almost nothing
costs, the floor under K5's time; ``pred_sum_graph_ms`` that of
``pred.sum()`` over K5's int32 predictions, one library kernel that streams
most of K5's bytes. Prints one JSON object.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

TREE = os.path.abspath(next((a for a in sys.argv[1:] if not a.startswith("--")),
                            os.path.join(os.path.dirname(__file__), "..")))
sys.path.insert(0, TREE)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from fcn8s_tensorflow_tpu_torch.kernels import build  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import conv1_core as KB  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import kernels as K  # noqa: E402


def events_ms(fn, reps: int = 10, n: int = 20, warmup: int = 3) -> float:
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


def graph_ms(fn, reps: int = 10, n: int = 20, reset=None) -> float:
    """``fn`` captured n times in a CUDA graph; the median over ``reps``
    replays of the replay's time / n. ``reset`` runs before each replay,
    outside the timed events."""
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
        if reset is not None:
            reset()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def k5_inputs(dev, batch: int = 8, h: int = 512, w: int = 1024, c: int = 20) -> dict:
    """The two K5 inputs of the module docstring, and the mask."""
    g = torch.Generator(device=dev).manual_seed(1)
    p = batch * h * w
    labels = torch.randint(0, c, (p,), generator=g, device=dev, dtype=torch.uint8)
    labels[::997] = 255
    pred = torch.randint(0, c, (p,), generator=g, device=dev, dtype=torch.int32)
    blocks = torch.randint(0, c, (batch, h // 32, w // 32), generator=g, device=dev)
    gt = blocks.repeat_interleave(32, 1).repeat_interleave(32, 2).reshape(-1).to(torch.uint8)
    flip = torch.rand((p,), generator=g, device=dev) < 0.1
    noise = torch.randint(0, c, (p,), generator=g, device=dev)
    coherent_pred = torch.where(flip, noise, gt.long()).to(torch.int32)
    mask = torch.ones(batch, device=dev)
    mask[3] = 0.0
    return {"random": (pred, labels), "coherent": (coherent_pred, gt), "mask": mask,
            "pps": h * w, "c": c}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe times the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    build.library()
    dev = torch.device("cuda", 0)
    out = {"tree": TREE, "card": smi, "build_s": time.perf_counter() - t0}

    ids = k5_inputs(dev)
    mask, pps, c = ids["mask"], ids["pps"], ids["c"]
    acc = torch.zeros((c, c), dtype=torch.int32, device=dev)
    for name in ("random", "coherent"):
        pred, gt = ids[name]
        got = K.confusion_matrix_accumulate(torch.zeros_like(acc), pred, gt, mask, pps)
        want = K.confusion_matrix_accumulate_plain(torch.zeros_like(acc), pred, gt, mask, pps)
        out[f"k5_{name}_exact"] = bool(torch.equal(got, want))
        fn = (lambda p=pred, q=gt: K.confusion_matrix_accumulate(acc, p, q, mask, pps))
        out[f"k5_{name}_ms"] = events_ms(fn)
        out[f"k5_{name}_graph_ms"] = graph_ms(fn, reset=acc.zero_)
    # the floor of any µs-scale kernel replayed from a graph: a (C, C) fill;
    # and what one PyTorch reduction takes to stream the 16.8 MB of int32
    # predictions, most of K5's bytes
    out["fill_graph_ms"] = graph_ms(acc.zero_)
    pred = ids["random"][0]
    out["pred_sum_graph_ms"] = graph_ms(lambda: pred.sum())
    del ids

    inputs = KB.calibration_inputs(dev)
    out.update({f"kb_{k}": v for k, v in KB.check_against_twin(inputs).items()})
    x, w128, w64 = inputs["xmain"], inputs["w128"], inputs["w64"]
    xc, k = inputs["conv_x"], inputs["conv_w"]
    out["kb_ms"] = events_ms(lambda: KB.conv1_core(x, w128, w64), reps=5, n=10)
    out["kb_graph_ms"] = graph_ms(lambda: KB.conv1_core(x, w128, w64), reps=5, n=10)
    out["cudnn_graph_ms"] = graph_ms(lambda: torch.relu_(F.conv2d(xc, k, padding=1)), reps=5, n=10)
    out["kb_tflops"] = KB.kb_flops(*x.shape[:2]) / out["kb_graph_ms"] / 1e9
    out["cudnn_tflops"] = KB.conv_flops() / out["cudnn_graph_ms"] / 1e9
    print(json.dumps(out))


if __name__ == "__main__":
    main()
