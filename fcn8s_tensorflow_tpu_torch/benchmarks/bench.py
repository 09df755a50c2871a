"""Benchmark: Cityscapes-resolution FCN-8s train + infer throughput on one
CUDA card. Port of the repository's ``bench.py``.

    python -m fcn8s_tensorflow_tpu_torch.benchmarks.bench [--device cuda]

Prints exactly ONE JSON line on stdout:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": null, ...extras}
All progress chatter goes to stderr.

Headline metric: train images/sec/card at 1024x512, 20 Cityscapes trainId
classes, full-width FCN-8s (VGG-16 encoder), bf16, TF1 Adam, lr 1e-4,
keep_prob 0.5, 3 warm-up and 10 timed steps of
``parallel.steps.compile_train_step`` (the step captured in a CUDA graph,
one replay a step), where the JAX script times its compiled step. Then the
batch-1 predict p50 (uint8 ids D2H) and its breakdown, and the batched,
int8 (calibrated static scales, ``ops/quantize.py``) and overlay rows at
batch 8, each pipelined two in flight, their reps interleaved round-robin,
every predict through ``compile_predict_step``.

``vs_baseline`` and ``infer_vs_baseline`` are null: the JAX script's
TF-on-CPU constants were measured on another machine's CPU, and the card's
host has no TensorFlow to measure them again. ``mfu`` divides the analytic
step FLOPs (``utils.summary.model_summary_rows``: fwd + dgrad + wgrad = 3x
forward MACs, 2 FLOPs a MAC) by the card's dense bf16 peak, looked up by
``torch.cuda.get_device_name``; an unknown card (or the CPU) gives null.

Without a card, ``--device cuda`` prints the null line naming
``--device cpu`` and exits 1; ``--device cpu`` runs the same script on the
host (a correctness run, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from ..examples import add_device_argument
from . import device_name, first_element, fresh_state, log, sync, to_device
from .overlay_bench import overlay_lut

H, W = 1024, 512
TRAIN_BATCH = 8
NUM_CLASSES = 20
WARMUP = 3
ITERS = 10
INFER_BATCH = 8
INFER_REPS = 3  # interleaved reps of every serving row

METRIC = "fcn8s_train_images_per_sec_per_chip_1024x512"
DEVICE_INIT_TIMEOUT_S = 600.0
RUN_TIMEOUT_S = 2700.0  # whole-run ceiling; a healthy run on the card takes under a minute
BASELINE_NOTE = ("none: the JAX script's TF-CPU baseline (tools/tf_cpu_baseline.py) was "
                 "measured on another machine's CPU, and this host has no TensorFlow to "
                 "measure it again")

# dense bf16 tensor-core peak, TFLOP/s, by substring of the device name; the
# PCIe part before the bare "H100", which would otherwise shadow it
_PEAK_BF16_TFLOPS = (
    ("H100 PCIe", 756.0),
    ("H100", 989.4),
)


def _fail_json_and_exit(err: str) -> None:
    """The mandatory JSON line with value null and the error, then a hard
    exit with code 1 (a hung thread may be in native code)."""
    print(json.dumps({"metric": METRIC, "value": None, "unit": "images/sec/chip",
                      "vs_baseline": None, "error": err}))
    sys.stdout.flush()
    os._exit(1)


def _arm_run_watchdog() -> threading.Timer:
    """Emit the null line and exit 1 if ``main`` has not finished in
    ``RUN_TIMEOUT_S``."""
    t = threading.Timer(RUN_TIMEOUT_S, lambda: _fail_json_and_exit(
        f"bench run exceeded {RUN_TIMEOUT_S:.0f}s"))
    t.daemon = True
    t.start()
    return t


def _device_or_die(device: str) -> torch.device:
    """The run's device. ``cuda`` is probed in a thread with a tighter
    watchdog than the whole run's; without a card the null line names
    ``--device cpu``. The CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    box = {}

    def probe():
        try:
            if not torch.cuda.is_available():
                box["error"] = (f"no CUDA device for --device {device}: pass --device cpu to "
                                "run on the host")
                return
            box["name"] = torch.cuda.get_device_name(dev)
        except Exception as exc:  # noqa: BLE001 — reported in the null line
            box["error"] = f"{type(exc).__name__}: {exc}"

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(DEVICE_INIT_TIMEOUT_S)
    if "name" in box:
        log(f"device: {box['name']} (count {torch.cuda.device_count()})")
        return dev
    _fail_json_and_exit(box.get(
        "error", f"CUDA device init unresponsive after {DEVICE_INIT_TIMEOUT_S:.0f}s"))


def peak_bf16_tflops(name: str):
    """The dense bf16 peak of the device named ``name``, or None."""
    return next((v for k, v in _PEAK_BF16_TFLOPS if k in name), None)


def step_tflops(params: dict, hw, batch: int) -> float:
    """Analytic FLOPs of one train step at ``batch`` x ``hw`` in TFLOP: 3 x
    forward MACs x 2."""
    from ..utils.summary import model_summary_rows

    fwd_macs = sum(r["macs"] for r in model_summary_rows(params, input_hw=hw, batch=batch))
    return 3 * 2 * fwd_macs / 1e12


def _fetch_later(out: torch.Tensor):
    """Start ``out``'s D2H now (into pinned memory, behind the work that
    makes it); ``_wait`` takes it."""
    if out.device.type != "cuda":
        return out, None
    host = out.to("cpu", non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _wait(pending) -> np.ndarray:
    host, done = pending
    if done is not None:
        done.synchronize()
    return host.numpy()


def _median_time(fn, iters: int = ITERS) -> float:
    ts = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = _device_or_die(args.device)

    from .. import bridge
    from ..ops.quantize import collect_activation_absmax, quantize_fcn8s_params
    from ..parallel.steps import compile_predict_step, compile_train_step, make_optimizer

    n_chips = 1
    kind = device_name(dev)
    rng = np.random.default_rng(0)
    optimizer = make_optimizer()
    state = fresh_state(NUM_CLASSES, dev, optimizer)

    # ---- train throughput @ 1024x512 ----
    im, lb, mk = to_device(
        dev,
        rng.integers(0, 255, (TRAIN_BATCH, H, W, 3), np.uint8),
        rng.integers(0, NUM_CLASSES, (TRAIN_BATCH, H, W), np.uint8),
        np.ones((TRAIN_BATCH,), np.float32))

    train = compile_train_step(None, optimizer, NUM_CLASSES, device=dev)

    def step():
        return train(state, im, lb, mk, 1, 1e-4, 0.0, 0.5)[1]

    for _ in range(WARMUP):
        loss = step()
    loss.item()  # hard sync
    t0 = time.perf_counter()
    for _ in range(ITERS):
        loss = step()
    loss.item()
    train_dt = (time.perf_counter() - t0) / ITERS
    train_imgs_per_sec = TRAIN_BATCH / train_dt
    log(f"train: {train_dt * 1e3:.1f} ms/step -> {train_imgs_per_sec:.1f} img/s")

    # ---- measured MFU ----
    tflops = step_tflops(state.params, (H, W), TRAIN_BATCH)
    peak = peak_bf16_tflops(kind)
    mfu = (tflops / (train_dt * n_chips)) / peak if peak else None
    log(f"mfu: {tflops:.2f} TFLOP/step analytic, device '{kind}' peak {peak} TFLOPS -> "
        f"{'%.3f' % mfu if mfu else 'n/a'}")
    mfu_extras = {"train_step_analytic_tflops": round(tflops, 2),
                  "peak_bf16_tflops_per_chip": peak,
                  "mfu": round(mfu, 3) if mfu is not None else None}

    with torch.no_grad():
        run = bridge.cast_params(state.params, torch.bfloat16)
    del im, lb, mk

    pred_ids = compile_predict_step(None, argmax=True, id_dtype=torch.uint8, device=dev)

    # ---- inference throughput + p50 latency (batch 1, uint8 ids D2H) ----
    with torch.inference_mode():
        one = to_device(dev, rng.integers(0, 255, (n_chips, H, W, 3), np.uint8))[0]
        for _ in range(WARMUP):
            pred_ids(run, one).cpu()
        latencies = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            pred_ids(run, one).cpu().numpy()  # hard sync incl. D2H of the id map
            latencies.append(time.perf_counter() - t0)
        p50 = float(np.median(latencies))
        infer_imgs_per_sec = one.shape[0] / p50
        log(f"infer: p50 {p50 * 1e3:.1f} ms -> {infer_imgs_per_sec:.1f} img/s")

        # ---- batch-1 latency decomposition ----
        # p50 = dispatch + compute + D2H of the id map (the input is
        # device-resident; H2D is reported apart). Raw medians, and
        # estimates net of the scalar-sync floor.
        tiny = torch.zeros((), device=dev)
        rt_ms = _median_time(lambda: (tiny + 0).item()) * 1e3
        resident_out = pred_ids(run, one)
        payload_bytes = int(resident_out.numel() * resident_out.element_size())
        d2h_raw_ms = _median_time(lambda: resident_out.cpu()) * 1e3
        compute_raw_ms = _median_time(lambda: first_element(pred_ids(run, one))) * 1e3
        host_img = one.cpu()
        h2d_raw_ms = _median_time(lambda: first_element(host_img.to(dev))) * 1e3
        compute_est = max(compute_raw_ms - rt_ms, 0.0)
        d2h_est = max(d2h_raw_ms - rt_ms, 0.0)
        d2h_bandwidth = payload_bytes / 1e6 / max(d2h_est / 1e3, 1e-9)
        total_ms = p50 * 1e3
        batch1_breakdown = {
            "total_p50_ms": round(total_ms, 1),
            "scalar_sync_floor_ms": round(rt_ms, 1),
            "compute_sync_ms": round(compute_raw_ms, 1),
            "resident_output_d2h_ms": round(d2h_raw_ms, 1),
            "h2d_input_sync_ms_not_in_p50": round(h2d_raw_ms, 1),
            "compute_ms_est": round(compute_est, 1),
            "d2h_payload_ms_est": round(d2h_est, 1),
            "payload_bytes": payload_bytes,
            "d2h_bandwidth_MB_per_s": round(d2h_bandwidth, 1),
            "unattributed_transport_ms": round(
                max(total_ms - rt_ms - compute_est - d2h_est, 0.0), 1),
        }
        log(f"batch-1 breakdown: sync floor {rt_ms:.1f} ms, compute est {compute_est:.1f} ms, "
            f"D2H est {d2h_est:.1f} ms ({payload_bytes / 1e6:.2f} MB @ {d2h_bandwidth:.1f} "
            f"MB/s), H2D (not in p50) {h2d_raw_ms:.1f} ms")
        del resident_out, host_img

        # ---- batched pipelined inference (the serving path) ----
        # two in flight: batch i+1 is dispatched before batch i's output
        # (copied to pinned memory behind its own work) is waited for
        b8 = to_device(dev, rng.integers(0, 255, (INFER_BATCH, H, W, 3), np.uint8))[0]

        def setup_row(fn, params_):
            """Warm a row outside every timed window; its compute-only time:
            the output stays on the card, synced by a 1-element D2H."""
            for _ in range(WARMUP):
                first_element(fn(params_, b8))
            return _median_time(lambda: first_element(fn(params_, b8))) * 1e3

        def pipelined_once(fn, params_):
            """One timed pipelined loop -> img/s."""
            t0 = time.perf_counter()
            pending = deque()
            for _ in range(ITERS):
                pending.append(_fetch_later(fn(params_, b8)))
                if len(pending) >= 2:
                    _wait(pending.popleft())
            while pending:
                _wait(pending.popleft())
            return INFER_BATCH / ((time.perf_counter() - t0) / ITERS)

        def row_stats(tag, rates, compute_sync_ms):
            med = float(np.median(rates))
            stats = {
                "images_per_sec_per_chip": round(med / n_chips, 2),
                "images_per_sec_per_chip_min": round(min(rates) / n_chips, 2),
                "images_per_sec_per_chip_max": round(max(rates) / n_chips, 2),
                "spread_pct": round(100.0 * (max(rates) - min(rates)) / med, 1),
                "reps": len(rates),
                "compute_sync_ms": round(compute_sync_ms, 1),
                "interleaved_reps": True,
            }
            log(f"infer {tag}: median {INFER_BATCH / med * 1e3:.1f} ms/batch{INFER_BATCH} -> "
                f"{med:.1f} img/s (min {min(rates):.1f}, max {max(rates):.1f}, spread "
                f"{stats['spread_pct']:.0f}%), compute-sync {compute_sync_ms:.1f} ms")
            return stats

        absmax = collect_activation_absmax(run, b8)
        qparams = quantize_fcn8s_params(state.params, absmax)  # calibrated static scales
        sync(dev)
        lut = overlay_lut(NUM_CLASSES)
        rows = {
            "batched": (pred_ids, run),
            "int8": (compile_predict_step(None, argmax=True, id_dtype=torch.uint8, quantized=True,
                                          device=dev), qparams),
            "overlay": (compile_predict_step(None, argmax=True, overlay_lut=lut, device=dev), run),
        }
        rows = {tag: (fn, pr, setup_row(fn, pr), []) for tag, (fn, pr) in rows.items()}
        # every rep of every row in turn, so the rows share the card's state
        for _ in range(INFER_REPS):
            for fn, pr, _cs, rates in rows.values():
                rates.append(pipelined_once(fn, pr))
        stats = {tag: row_stats(tag, rates, cs) for tag, (_f, _p, cs, rates) in rows.items()}

    result = {
        "metric": METRIC,
        "value": round(train_imgs_per_sec / n_chips, 2),
        "unit": "images/sec/chip",
        "vs_baseline": None,
        "extras": {
            "train_batch": TRAIN_BATCH,
            "train_ms_per_step": round(train_dt * 1e3, 1),
            **mfu_extras,
            "infer_images_per_sec_per_chip": round(infer_imgs_per_sec / n_chips, 2),
            "infer_p50_latency_ms_batch1": round(p50 * 1e3, 1),
            "infer_batch1_latency_spread": {
                "min_ms": round(float(np.min(latencies)) * 1e3, 1),
                "max_ms": round(float(np.max(latencies)) * 1e3, 1),
                "iters": ITERS,
            },
            "infer_batch1_breakdown": batch1_breakdown,
            "infer_batched_images_per_sec_per_chip": stats["batched"]["images_per_sec_per_chip"],
            "infer_batched_batch": INFER_BATCH,
            "infer_batched_stats": stats["batched"],
            "infer_overlay_images_per_sec_per_chip": stats["overlay"]["images_per_sec_per_chip"],
            "infer_overlay_stats": stats["overlay"],
            "infer_int8_images_per_sec_per_chip": stats["int8"]["images_per_sec_per_chip"],
            "infer_int8_stats": stats["int8"],
            "infer_vs_baseline": None,
            "n_chips": n_chips,
            "resolution": f"{H}x{W}",
            "baseline": BASELINE_NOTE,
            "device": kind,
        },
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    _watchdog = _arm_run_watchdog()
    main()
    _watchdog.cancel()
