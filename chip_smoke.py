#!/usr/bin/env python3
"""Drive the PyTorch port's serving and eval path once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: require CUDA; print the device name and nvidia-smi's name and
   power limit;
2. build the CUDA kernels from ``fcn8s_tensorflow_tpu_torch/csrc`` (nvcc,
   sm_90a) and print the build time;
3. each kernel against its plain PyTorch twin on the card at the main
   path's shapes (batch 8 x 512x1024, 20 classes, bf16), with median times
   from CUDA events;
4. the card against the CPU: a narrow fp32 model (TF32 off) gives the same
   logits, loss and ids on both;
5. serving at full VGG-16 width: ``FCN8s`` -> ``InferenceService`` ->
   ``make_server`` on a thread, answering /predict, /overlay, /healthz,
   /stats, concurrent and undecodable requests;
6. ``FCN8s.evaluate`` at full width over three synthetic batches;
7. times: predict latency at batch 1 and 8, the forward and the eval step.

Kernel launch counts are zeroed just before phase 5 and read after phase 6;
every kernel of the path must have launched. The line before the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import math
import statistics
import subprocess
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
from PIL import Image

from fcn8s_tensorflow_tpu_torch import bridge
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s
from fcn8s_tensorflow_tpu_torch.engine.serving import InferenceService, make_server
from fcn8s_tensorflow_tpu_torch.kernels import build
from fcn8s_tensorflow_tpu_torch.labels import TRAINIDS_TO_RGBA_DICT
from fcn8s_tensorflow_tpu_torch.models.fcn8s import apply_fcn8s
from fcn8s_tensorflow_tpu_torch.ops import kernels as K
from fcn8s_tensorflow_tpu_torch.ops.metrics import empty_metrics_state
from fcn8s_tensorflow_tpu_torch.ops.nn import max_pool_2x2
from fcn8s_tensorflow_tpu_torch.ops.pool import maxpool2x2_nhwc
from fcn8s_tensorflow_tpu_torch.parallel.steps import eval_step

BATCH, H, W, C = 8, 512, 1024, 20
POOL_INPUTS = [(64, H, W), (128, H // 2, W // 2), (256, H // 4, W // 4),
               (512, H // 8, W // 8), (512, H // 16, W // 16)]  # (C, H, W) per VGG block
WRAPPERS = {"maxpool2x2_nhwc": maxpool2x2_nhwc, "ce_sum_per_sample": K.ce_sum_per_sample,
            "confusion_matrix_accumulate": K.confusion_matrix_accumulate}
SOURCES = {
    "maxpool2x2_nhwc": ("fcn8s_tensorflow_tpu_torch/csrc/maxpool2x2.cu",
                        "fcn8s_tensorflow_tpu/ops/pallas_pool.py:96"),
    "ce_sum_per_sample": ("fcn8s_tensorflow_tpu_torch/csrc/ce_sum.cu",
                          "fcn8s_tensorflow_tpu/ops/pallas_kernels.py:211"),
    "confusion_matrix_accumulate": ("fcn8s_tensorflow_tpu_torch/csrc/confmat.cu",
                                    "fcn8s_tensorflow_tpu/ops/pallas_kernels.py:69"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median wall-clock milliseconds of ``fn``, synchronised on both sides."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
def phase_card() -> str:
    check(torch.cuda.is_available(), "no CUDA device: this script runs only on the card")
    print(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    return smi


def phase_build() -> None:
    fresh = not build.library_path().exists()
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({'nvcc' if fresh else 'reused'}) "
          f"-> {build.library_path().name}")


def phase_kernels(dev) -> dict:
    """Each kernel against its twin at the main path's shapes; returns
    {name: {max_abs_err, ms, plain_ms, ...}}. K4f's times are sums over the
    five pool shapes (``shapes``: 5), one launch each; K1's error is that of
    one scalar sum, given also relative to it (``rel_err``)."""
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # K4f: all five VGG pool inputs, bit-exact
    ms = plain_ms = err = 0.0
    for c, h, w in POOL_INPUTS:
        x = torch.randn((BATCH, c, h, w), generator=g, device=dev, dtype=torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        y, ref = maxpool2x2_nhwc(x), max_pool_2x2(x)
        check(y.is_contiguous(memory_format=torch.channels_last), "K4f output not channels_last")
        err = max(err, float((y.float() - ref.float()).abs().max()))
        check(torch.equal(y, ref), f"K4f differs from its twin at {tuple(x.shape)}")
        k_ms, p_ms = cuda_ms(lambda: maxpool2x2_nhwc(x)), cuda_ms(lambda: max_pool_2x2(x))
        print(f"K4f maxpool2x2_nhwc {tuple(x.shape)} bf16: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bit-exact")
        ms, plain_ms = ms + k_ms, plain_ms + p_ms
        del x, y, ref
    xf = torch.randn((2, 64, 32, 64), generator=g, device=dev).contiguous(
        memory_format=torch.channels_last)
    xf[0, 5, 2, 3] = float("nan")
    yf, reff = maxpool2x2_nhwc(xf), max_pool_2x2(xf)
    check(bool(torch.isnan(yf[0, 5, 1, 1])), "K4f drops NaN")
    check(torch.equal(torch.nan_to_num(yf), torch.nan_to_num(reff)), "K4f fp32 differs")
    out["maxpool2x2_nhwc"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "shapes": len(POOL_INPUTS)}

    # K1: bf16 logits, uint8 labels (a few out of range), one masked sample
    p = BATCH * H * W
    logits = (torch.randn((p, C), generator=g, device=dev) * 3).to(torch.bfloat16)
    labels = torch.randint(0, C, (p,), generator=g, device=dev, dtype=torch.uint8)
    labels[::997] = 255
    mask = torch.ones(BATCH, device=dev)
    mask[3] = 0.0
    s_k = K.ce_sum_per_sample(logits, labels, mask, H * W)
    s_again = K.ce_sum_per_sample(logits, labels, mask, H * W)
    s_t = K.ce_sum_per_sample_plain(logits, labels, mask, H * W)
    err = abs(float(s_k) - float(s_t))
    check(err <= 1e-5 * abs(float(s_t)), f"K1 {float(s_k)} vs twin {float(s_t)}")
    check(torch.equal(s_k, s_again), "K1 is not run-to-run identical")
    s_i32 = K.ce_sum_per_sample(logits, labels.to(torch.int32), mask, H * W)
    check(abs(float(s_i32) - float(s_t)) <= 1e-5 * abs(float(s_t)), "K1 with int32 labels")
    k_ms = cuda_ms(lambda: K.ce_sum_per_sample(logits, labels, mask, H * W))
    p_ms = cuda_ms(lambda: K.ce_sum_per_sample_plain(logits, labels, mask, H * W))
    print(f"K1 ce_sum_per_sample ({p}, {C}) bf16 + uint8: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, |diff| {err:.6g} of {float(s_t):.9g} (rtol 1e-5)")
    out["ce_sum_per_sample"] = {"max_abs_err": err, "rel_err": err / abs(float(s_t)),
                                "ms": k_ms, "plain_ms": p_ms}

    # K5: int32 predictions, uint8 GT (a few out of range), one masked sample
    pred = torch.randint(0, C, (p,), generator=g, device=dev, dtype=torch.int32)
    conf_k = K.confusion_matrix_accumulate(
        torch.zeros((C, C), dtype=torch.int32, device=dev), pred, labels, mask, H * W)
    conf_t = K.confusion_matrix_accumulate_plain(
        torch.zeros((C, C), dtype=torch.int32, device=dev), pred, labels, mask, H * W)
    err = int((conf_k - conf_t).abs().max())
    check(err == 0, f"K5 differs from its twin by up to {err}")
    acc = torch.zeros((C, C), dtype=torch.int32, device=dev)
    k_ms = cuda_ms(lambda: K.confusion_matrix_accumulate(acc, pred, labels, mask, H * W))
    p_ms = cuda_ms(lambda: K.confusion_matrix_accumulate_plain(acc, pred, labels, mask, H * W))
    print(f"K5 confusion_matrix_accumulate ({p},) int32 + uint8, C={C}: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, exact")
    out["confusion_matrix_accumulate"] = {"max_abs_err": float(err), "ms": k_ms, "plain_ms": p_ms}
    return out


def phase_card_vs_cpu(dev) -> None:
    """A narrow fp32 model on the card and on the CPU: logits within the
    CPU tests' tolerance (atol 1e-4 * max|logits|, rtol 1e-4), the eval loss
    within rtol 1e-4, argmax ids equal on >= 99.9% of pixels."""
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(width_mult=1 / 32, fc_channels=32, compute_dtype=torch.float32)
    cpu = FCN8s(num_classes=C, seed=1, **kw)
    gpu = FCN8s.from_params(bridge.to_numpy(cpu.params), device=dev, **kw)
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (2, 128, 256, 3), dtype=np.uint8)
    labels = rng.integers(0, C, (2, 128, 256), dtype=np.uint8)
    with torch.inference_mode():
        ref = apply_fcn8s(cpu._run_params, torch.from_numpy(images), compute_dtype=torch.float32)
        got = apply_fcn8s(gpu._run_params, torch.from_numpy(images).to(dev),
                          compute_dtype=torch.float32).cpu()
        scale = float(ref.abs().max())
        torch.testing.assert_close(got, ref, atol=1e-4 * scale, rtol=1e-4)
        losses = []
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            state = eval_step(model._run_params, empty_metrics_state(C, device=d), torch.from_numpy(images).to(d),
                              torch.from_numpy(labels).to(d), torch.ones(2, device=d),
                              num_classes=C, compute_dtype=torch.float32)
            losses.append(float(state["loss_sum"]))
        check(math.isclose(losses[0], losses[1], rel_tol=1e-4), f"eval loss {losses}")
    agree = float((cpu.predict(images) == gpu.predict(images)).mean())
    check(agree >= 0.999, f"argmax ids agree on only {agree:.5f} of pixels")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"card vs CPU (fp32, TF32 off, 2x128x256): max|diff| "
          f"{float((got - ref).abs().max()):.3g} of max|logits| {scale:.4g}; eval loss "
          f"{losses[1]:.7f} vs {losses[0]:.7f}; ids agree {agree:.6f}")


def _png(array: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="PNG")
    return buf.getvalue()


def _decode(body: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(body)))


def _post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def phase_serving(model: FCN8s) -> None:
    service = InferenceService(model, color_map=TRAINIDS_TO_RGBA_DICT, batch_window_ms=20,
                               max_batch=8)
    srv = make_server(service, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % srv.server_address[1]
    rng = np.random.default_rng(2)
    pool0 = maxpool2x2_nhwc.launches
    try:
        for _ in range(3):
            status, body = _post(base + "/predict", _png(rng.integers(0, 256, (H, W, 3), np.uint8)))
            ids = _decode(body)
            check(status == 200 and ids.shape == (H, W) and ids.dtype == np.uint8
                  and int(ids.max()) < C, f"/predict gave {status}, {ids.shape}")
        status, body = _post(base + "/predict", _png(rng.integers(0, 256, (500, 1000, 3), np.uint8)))
        check(status == 200 and _decode(body).shape == (500, 1000), "/predict at 500x1000")
        status, body = _post(base + "/overlay", _png(rng.integers(0, 256, (H, W, 3), np.uint8)))
        check(status == 200 and _decode(body).shape == (H, W, 3), "/overlay")
        bodies = [_png(rng.integers(0, 256, (H, W, 3), np.uint8)) for _ in range(8)]
        results = [None] * 8

        def worker(i):
            results[i] = _post(base + "/predict", bodies[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        for status, body in results:
            ids = _decode(body)
            check(status == 200 and ids.shape == (H, W) and int(ids.max()) < C,
                  "concurrent /predict")
        status, body = _post(base + "/predict", b"this is not an image")
        check(status == 400 and "error" in json.loads(body), f"undecodable body gave {status}")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and health["model_config"]["num_classes"] == C, "/healthz")
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        service.close()
        thread.join(timeout=60)
    pool_launches = maxpool2x2_nhwc.launches - pool0
    check(stats["requests"] == 13 and stats["errors"] == 1, f"stats {stats}")
    check(stats["dispatches"] < stats["requests"], f"no micro-batching: {stats}")
    check(pool_launches == 5 * stats["dispatches"],
          f"K4f launched {pool_launches} times for {stats['dispatches']} dispatches")
    print(f"serving: {stats['requests']} requests in {stats['dispatches']} dispatches, "
          f"p50 {stats['p50_ms']:.1f} ms, p95 {stats['p95_ms']:.1f} ms; K4f launches "
          f"{pool_launches} = 5 x dispatches")


def phase_evaluate(model: FCN8s) -> None:
    sizes = (8, 8, 5)

    def batches():
        rng = np.random.default_rng(3)
        for n in sizes:
            yield (rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8),
                   rng.integers(0, C, (n, H, W), dtype=np.uint8))

    k1, k5 = K.ce_sum_per_sample.launches, K.confusion_matrix_accumulate.launches
    values = model.evaluate(batches(), len(sizes))
    k1 = K.ce_sum_per_sample.launches - k1
    k5 = K.confusion_matrix_accumulate.launches - k5
    total = int(model.metrics_state["conf_matrix"].sum())
    check(all(math.isfinite(v) for v in values.values()), f"evaluate gave {values}")
    check(k1 == 3 and k5 == 3, f"evaluate launched K1 {k1} and K5 {k5} times, not 3 each")
    check(total == sum(sizes) * H * W, f"confusion matrix holds {total} pixels")
    print(f"evaluate: {values}; K1 {k1}, K5 {k5} launches; matrix sums to {total} "
          f"= 21*{H}*{W}")


def phase_times(model: FCN8s, dev, smi: str) -> None:
    rng = np.random.default_rng(4)
    images8 = rng.integers(0, 256, (BATCH, H, W, 3), dtype=np.uint8)
    labels8 = rng.integers(0, C, (BATCH, H, W), dtype=np.uint8)
    p1 = host_ms(lambda: model.predict(images8[:1]))
    p8 = host_ms(lambda: model.predict(images8))
    im_d = torch.from_numpy(images8).to(dev)
    lb_d = torch.from_numpy(labels8).to(dev)
    mask = torch.ones(BATCH, device=dev)
    state = empty_metrics_state(C, device=dev)
    with torch.inference_mode():
        fwd = cuda_ms(lambda: apply_fcn8s(model._run_params, im_d), reps=10)
        ev = host_ms(lambda: eval_step(model._run_params, state, im_d, lb_d, mask,
                                       num_classes=C))
    print(f"times on {smi}: predict {H}x{W} batch 1 {p1:.2f} ms, batch 8 {p8:.2f} ms "
          f"(host clock, PNG-free, H2D+D2H included); forward bf16 batch 8 {fwd:.2f} ms "
          f"(CUDA events); eval step batch 8 {ev:.2f} ms (host clock)")


def main() -> None:
    smi = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    measured = phase_kernels(dev)
    phase_card_vs_cpu(dev)
    model = FCN8s(num_classes=C, device=dev)  # full VGG-16 width, bf16, seeded init
    for fn in WRAPPERS.values():
        fn.launches = 0
    phase_serving(model)
    phase_evaluate(model)
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    phase_times(model, dev, smi)
    model.close()
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
         "launches": launches[name], **measured[name]} for name in WRAPPERS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
