#!/usr/bin/env python3
"""Drive the PyTorch port's serving, eval, training, KB calibration and
checkpoint paths once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: require CUDA; print the device name and nvidia-smi's name and
   power limit;
2. build the CUDA kernels from ``fcn8s_tensorflow_tpu_torch/csrc`` (nvcc,
   sm_90a, one process per source) and print the build time;
3. the eval-path kernels (K4f, K1, K5) against their plain PyTorch twins on
   the card at the serving shapes (batch 8 x 512x1024, 20 classes, bf16),
   with median times from CUDA events;
4. the card against the CPU: a narrow fp32 model (TF32 off) gives the same
   logits, loss and ids on both;
5. serving at full VGG-16 width: ``FCN8s`` -> ``InferenceService`` ->
   ``make_server`` on a thread, answering /predict, /overlay, /healthz,
   /stats, concurrent and undecodable requests;
6. ``FCN8s.evaluate`` at full width over three synthetic batches;
7. times: predict latency at batch 1 and 8, the forward and the eval step;
8. the training kernels (K4a, K4b, K3, CE grad) against their twins at the
   train shapes (batch 8 x 1024x512, bench.py's, 20 classes, bf16): the
   pool pair bit-exact on tie-heavy inputs at all five pool inputs, and
   against ``F.max_pool2d``'s gradient;
9. the card against the CPU for training: three Adam ``train_step``s of a
   narrow fp32 model (TF32 off) from the same weights;
10. ``FCN8s.train`` at full width: 2 epochs x 4 steps with keep_prob 0.5
    and two validation batches per epoch, then ``predict`` on the new
    weights;
11. a learnable batch: 8 steps on one fixed batch lower the loss;
12. the weighted train path: ``ignore_label`` and ``class_weights`` (K3);
13. train-step times: host clock, images/s, the CUDA-event split into
    forward, backward and optimizer, peak memory, fc6's share, and
    ``gradient_accumulation=2``;
14. the conv1 calibration (KB, ``ops/conv1_core.py``) at the calibration
    script's full shape and data: KB against its twin, then KB, the twin and
    cuDNN's conv1_2 forward + ReLU timed (ms, TFLOP/s);
15. persistence at full width, from phase 10's model: a blocking ``save``
    and ``FCN8s(model_load_dir=...)`` restore params, step and Adam state
    bit-equal and predict the same ids; one more step from each gives the
    same loss; ``save(block=False)`` while two steps run holds the state of
    the call; the serving CLI serves the checkpoint (/healthz, /predict);
    checkpoint size, save, async-call and load times. The files live in a
    temporary directory, removed at the end.

Kernel launch counts are zeroed just before each path is driven and read
just after it: serving + evaluation (phases 5-6), training (phase 10), the
weighted training (phase 12) and the conv1 calibration's timed runs (phase
14); every kernel of a path must have launched. The line before the last is
``{"kernels": [...]}``: ``launches`` from the path named in ``path``; ``ms``,
``plain_ms`` and ``library_ms`` (one PyTorch call of the same function, where
there is one; ``null`` otherwise) per call, from back-to-back calls between
CUDA events; ``bound_ms``, the larger of the bytes the kernel must move over
3.35 TB/s and its operations over 989 TFLOP/s bf16 (``bound_by`` says
which; ``bytes`` and ``flops`` are the counts). The last line is ``{"ok":
true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
import statistics
import subprocess
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from fcn8s_tensorflow_tpu_torch import bridge
from fcn8s_tensorflow_tpu_torch.engine import serving
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s
from fcn8s_tensorflow_tpu_torch.engine.serving import InferenceService, make_server
from fcn8s_tensorflow_tpu_torch.kernels import build
from fcn8s_tensorflow_tpu_torch.labels import TRAINIDS_TO_RGBA_DICT
from fcn8s_tensorflow_tpu_torch.models.fcn8s import apply_fcn8s, decoder_l2_loss
from fcn8s_tensorflow_tpu_torch.ops import conv1_core as KB
from fcn8s_tensorflow_tpu_torch.ops import kernels as K
from fcn8s_tensorflow_tpu_torch.ops import pool as P
from fcn8s_tensorflow_tpu_torch.ops.metrics import empty_metrics_state
from fcn8s_tensorflow_tpu_torch.ops.nn import max_pool_2x2
from fcn8s_tensorflow_tpu_torch.ops.pool import maxpool2x2_nhwc
from fcn8s_tensorflow_tpu_torch.parallel import steps as S
from fcn8s_tensorflow_tpu_torch.parallel.steps import eval_step

BATCH, H, W, C = 8, 512, 1024, 20  # serving and eval: Cityscapes' landscape at half size
TH, TW = 1024, 512  # training: bench.py's main config (H=1024, W=512)
POOL_INPUTS = [(64, H, W), (128, H // 2, W // 2), (256, H // 4, W // 4),
               (512, H // 8, W // 8), (512, H // 16, W // 16)]  # (C, H, W) per VGG block
TRAIN_POOL_INPUTS = [(ch, h * TH // H, w * TW // W) for ch, h, w in POOL_INPUTS]
WRAPPERS = {"maxpool2x2_nhwc": maxpool2x2_nhwc, "ce_sum_per_sample": K.ce_sum_per_sample,
            "confusion_matrix_accumulate": K.confusion_matrix_accumulate,
            "maxpool2x2_code_nhwc": P.maxpool2x2_code_nhwc,
            "maxpool2x2_bwd_nhwc": P.maxpool2x2_bwd_nhwc,
            "ce_sum_weighted": K.ce_sum_weighted, "ce_grad": K.ce_grad,
            "conv1_core": KB.conv1_core}
SOURCES = {
    "maxpool2x2_nhwc": ("fcn8s_tensorflow_tpu_torch/csrc/maxpool2x2.cu",
                        "fcn8s_tensorflow_tpu/ops/pallas_pool.py:96"),
    "ce_sum_per_sample": ("fcn8s_tensorflow_tpu_torch/csrc/ce_sum.cu",
                          "fcn8s_tensorflow_tpu/ops/pallas_kernels.py:211"),
    "confusion_matrix_accumulate": ("fcn8s_tensorflow_tpu_torch/csrc/confmat.cu",
                                    "fcn8s_tensorflow_tpu/ops/pallas_kernels.py:69"),
    "maxpool2x2_code_nhwc": ("fcn8s_tensorflow_tpu_torch/csrc/maxpool2x2.cu",
                             "fcn8s_tensorflow_tpu/ops/pallas_pool.py:44"),
    "maxpool2x2_bwd_nhwc": ("fcn8s_tensorflow_tpu_torch/csrc/maxpool2x2.cu",
                            "fcn8s_tensorflow_tpu/ops/pallas_pool.py:73"),
    "ce_sum_weighted": ("fcn8s_tensorflow_tpu_torch/csrc/ce_sum.cu",
                        "fcn8s_tensorflow_tpu/ops/pallas_kernels.py:130"),
    # no pallas_call: the hand form of the custom-VJP bodies _ce_sum_sample_bwd (:267)
    # and _ce_sum_bwd (:190), which XLA fused
    "ce_grad": ("fcn8s_tensorflow_tpu_torch/csrc/ce_grad.cu",
                "fcn8s_tensorflow_tpu/ops/pallas_kernels.py:267"),
    "conv1_core": ("fcn8s_tensorflow_tpu_torch/csrc/conv1_core.cu",
                   "benchmarks/conv1_block_calibration.py:53"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = 5, n: int = 10, warmup: int = 2) -> float:
    """Milliseconds of one call of ``fn`` on the device: the median over
    ``reps`` of the mean of ``n`` back-to-back calls between two CUDA
    events. One call between events would also time the host's launch of
    it wherever that is slower than the kernel (a wrapper's checks add
    ~30 us to a ~0.1 ms kernel)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)


def bound(bytes_moved: float, flops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the bf16 peak."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    ms = plain_ms = lib_ms = err = 0.0
    moved = 0
    for c, h, w in POOL_INPUTS:
        x = torch.randn((BATCH, c, h, w), generator=g, device=dev, dtype=torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        y, ref = maxpool2x2_nhwc(x), max_pool_2x2(x)
        check(y.is_contiguous(memory_format=torch.channels_last), "K4f output not channels_last")
        err = max(err, float((y.float() - ref.float()).abs().max()))
        check(torch.equal(y, ref), f"K4f differs from its twin at {tuple(x.shape)}")
        k_ms, p_ms = cuda_ms(lambda: maxpool2x2_nhwc(x)), cuda_ms(lambda: max_pool_2x2(x))
        l_ms = cuda_ms(lambda: F.max_pool2d(x, 2, 2))
        print(f"K4f maxpool2x2_nhwc {tuple(x.shape)} bf16: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, F.max_pool2d {l_ms:.4f} ms, bit-exact")
        ms, plain_ms, lib_ms = ms + k_ms, plain_ms + p_ms, lib_ms + l_ms
        moved += nbytes(x, y)  # x read once, y written once
        del x, y, ref
    xf = torch.randn((2, 64, 32, 64), generator=g, device=dev).contiguous(
        memory_format=torch.channels_last)
    xf[0, 5, 2, 3] = float("nan")
    yf, reff = maxpool2x2_nhwc(xf), max_pool_2x2(xf)
    check(bool(torch.isnan(yf[0, 5, 1, 1])), "K4f drops NaN")
    check(torch.equal(torch.nan_to_num(yf), torch.nan_to_num(reff)), "K4f fp32 differs")
    out["maxpool2x2_nhwc"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              **bound(moved), "library_ms": lib_ms,
                              "library": "F.max_pool2d(x, 2, 2)", "shapes": len(POOL_INPUTS)}

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
    # the library's CE at unit weight, on in-range labels (it refuses others)
    lib_labels = labels.long().clamp_(max=C - 1)
    l_ms = cuda_ms(lambda: F.cross_entropy(logits, lib_labels, reduction="sum"))
    moved = nbytes(logits, labels, mask, s_k)
    print(f"K1 ce_sum_per_sample ({p}, {C}) bf16 + uint8: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, F.cross_entropy (unit weight) {l_ms:.4f} ms, bound "
          f"{bound(moved)['bound_ms']:.4f} ms ({moved} bytes); |diff| {err:.6g} of "
          f"{float(s_t):.9g} (rtol 1e-5)")
    out["ce_sum_per_sample"] = {"max_abs_err": err, "rel_err": err / abs(float(s_t)),
                                "ms": k_ms, "plain_ms": p_ms, **bound(moved), "library_ms": l_ms,
                                "library": "F.cross_entropy(logits, labels, reduction='sum'): "
                                           "the same function at unit weight, labels in range"}
    del lib_labels

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
    pair_ids = labels.long().clamp_(max=C - 1) * C + pred.long()
    l_ms = cuda_ms(lambda: torch.bincount(pair_ids, minlength=C * C))
    moved = nbytes(pred, labels, mask, acc, acc)  # conf is read and written
    print(f"K5 confusion_matrix_accumulate ({p},) int32 + uint8, C={C}: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, torch.bincount {l_ms:.4f} ms, exact")
    out["confusion_matrix_accumulate"] = {"max_abs_err": float(err), "ms": k_ms, "plain_ms": p_ms,
                                          **bound(moved), "library_ms": l_ms,
                                          "library": "torch.bincount(gt * C + pred, minlength=C*C)"}
    del pair_ids
    return out


def phase_card_vs_cpu(dev) -> None:
    """A narrow fp32 model on the card and on the CPU: logits within the
    CPU tests' tolerance (atol 1e-4 * max|logits|, rtol 1e-4), the eval loss
    within rtol 1e-4, argmax ids equal on >= 99.9% of pixels."""
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(width_mult=1 / 32, fc_channels=32, compute_dtype=torch.float32)
    cpu = FCN8s(num_classes=C, seed=1, device="cpu", **kw)
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
        fwd = cuda_ms(lambda: apply_fcn8s(model._run_params, im_d), reps=3)
        ev = host_ms(lambda: eval_step(model._run_params, state, im_d, lb_d, mask,
                                       num_classes=C))
    print(f"times on {smi}: predict {H}x{W} batch 1 {p1:.2f} ms, batch 8 {p8:.2f} ms "
          f"(host clock, PNG-free, H2D+D2H included); forward bf16 batch 8 {fwd:.2f} ms "
          f"(CUDA events); eval step batch 8 {ev:.2f} ms (host clock)")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _ties(shape, dev, g):
    """bf16 channels_last values on a coarse grid: most 2x2 windows hold ties."""
    x = torch.round(torch.randn(shape, generator=g, device=dev) * 2).to(torch.bfloat16)
    return x.contiguous(memory_format=torch.channels_last)


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor, wg: torch.Tensor) -> tuple[float, bool]:
    """(max |got - want| in bf16 ulps of the larger magnitude, whether every
    element is within one ulp plus 2**-20 * |w * g|). The second term is
    for the label class where softmax is near 1: softmax - 1 cancels, and
    both sides carry their fp32 softmax error (a few 2**-24 * |w * g|) into
    a tiny result."""
    g, w = got.float(), want.float()
    top = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    diff = (g - w).abs()
    return float((diff / ulp).max()), bool((diff <= ulp + 2.0 ** -20 * wg.abs()).all())


def phase_train_kernels(dev) -> dict:
    """K4a, K4b, K3 and the CE grad against their twins at the train shapes;
    returns {name: {max_abs_err, ms, plain_ms, ...}} (the pool pair's times
    sum the five pool inputs)."""
    g = torch.Generator(device=dev).manual_seed(10)
    out = {}
    sums = {"a": 0.0, "a_plain": 0.0, "a_lib": 0.0, "b": 0.0, "b_plain": 0.0, "b_lib": 0.0}
    moved = {"a": 0, "b": 0}
    for c, h, w in TRAIN_POOL_INPUTS:
        x = _ties((BATCH, c, h, w), dev, g)
        y, code = P.maxpool2x2_code_nhwc(x)
        y_t, code_t = P.maxpool2x2_code_plain(x)
        check(torch.equal(y, y_t) and torch.equal(code, code_t),
              f"K4a differs from its twin at {tuple(x.shape)}")
        dy = torch.randn(y.shape, generator=g, device=dev).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        dx = P.maxpool2x2_bwd_nhwc(dy, code)
        check(torch.equal(dx, P.maxpool2x2_bwd_plain(dy, code)),
              f"K4b differs from its twin at {tuple(x.shape)}")
        xr = x.detach().clone().requires_grad_()
        F.max_pool2d(xr, 2, 2).backward(dy)
        check(torch.equal(dx, xr.grad),
              f"K4b differs from F.max_pool2d's gradient at {tuple(x.shape)}")
        ties = float((code != 0).float().mean())
        _, idx = F.max_pool2d(x, 2, 2, return_indices=True)
        t = {"a": cuda_ms(lambda: P.maxpool2x2_code_nhwc(x)),
             "a_plain": cuda_ms(lambda: P.maxpool2x2_code_plain(x)),
             "a_lib": cuda_ms(lambda: F.max_pool2d(x, 2, 2, return_indices=True)),
             "b": cuda_ms(lambda: P.maxpool2x2_bwd_nhwc(dy, code)),
             "b_plain": cuda_ms(lambda: P.maxpool2x2_bwd_plain(dy, code)),
             "b_lib": cuda_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                 dy, x, [2, 2], [2, 2], [0, 0], [1, 1], False, idx))}
        print(f"K4a/K4b {tuple(x.shape)} bf16 (code != 0 on {ties:.3f}): K4a {t['a']:.4f} ms "
              f"(plain {t['a_plain']:.4f}, F.max_pool2d with indices {t['a_lib']:.4f}), K4b "
              f"{t['b']:.4f} ms (plain {t['b_plain']:.4f}, aten max_pool2d_with_indices_backward "
              f"{t['b_lib']:.4f}); y, code and dx bit-exact, dx = F.max_pool2d's gradient")
        sums = {k: sums[k] + t[k] for k in sums}
        moved["a"] += nbytes(x, y, code)  # x read, y and the code written
        moved["b"] += nbytes(dy, code, dx)  # dy and the code read, dx written
        del x, y, code, y_t, code_t, dy, dx, xr, idx
    out["maxpool2x2_code_nhwc"] = {
        "max_abs_err": 0.0, "ms": sums["a"], "plain_ms": sums["a_plain"], **bound(moved["a"]),
        "library_ms": sums["a_lib"], "library": "F.max_pool2d(x, 2, 2, return_indices=True)",
        "shapes": len(TRAIN_POOL_INPUTS)}
    out["maxpool2x2_bwd_nhwc"] = {
        "max_abs_err": 0.0, "ms": sums["b"], "plain_ms": sums["b_plain"], **bound(moved["b"]),
        "library_ms": sums["b_lib"],
        "library": "aten.max_pool2d_with_indices_backward on F.max_pool2d's indices",
        "shapes": len(TRAIN_POOL_INPUTS)}

    # K3: a 255 label share, class-weight-style weights, zero weights
    p = BATCH * TH * TW
    logits = (torch.randn((p, C), generator=g, device=dev) * 3).to(torch.bfloat16)
    labels = torch.randint(0, C, (p,), generator=g, device=dev, dtype=torch.uint8)
    labels[::13] = 255
    cw = torch.rand(C, generator=g, device=dev) * 2
    cw[4] = 0.0
    weights = torch.where(labels == 255, 0.0, cw[labels.long().clamp(max=C - 1)])
    s_k = K.ce_sum_weighted(logits, labels, weights)
    s_t = K.ce_sum_weighted_plain(logits, labels, weights)
    err = abs(float(s_k) - float(s_t))
    check(err <= 1e-5 * abs(float(s_t)), f"K3 {float(s_k)} vs twin {float(s_t)}")
    check(torch.equal(s_k, K.ce_sum_weighted(logits, labels, weights)),
          "K3 is not run-to-run identical")
    k_ms = cuda_ms(lambda: K.ce_sum_weighted(logits, labels, weights))
    p_ms = cuda_ms(lambda: K.ce_sum_weighted_plain(logits, labels, weights))
    # the library call that computes K3's function on these inputs exactly:
    # class weights, 255 ignored (checked in fp32 against the twin first)
    lib_labels = labels.long()
    lib = float(F.cross_entropy(logits.float(), lib_labels, weight=cw, ignore_index=255,
                                reduction="sum"))
    check(abs(lib - float(s_t)) <= 1e-5 * abs(float(s_t)), f"K3's library call {lib} vs {float(s_t)}")
    cw_lib = cw.to(logits.dtype)  # the call takes weights in the logits' dtype
    l_ms = cuda_ms(lambda: F.cross_entropy(logits, lib_labels, weight=cw_lib, ignore_index=255,
                                           reduction="sum"))
    moved = nbytes(logits, labels, weights, s_k)
    print(f"K3 ce_sum_weighted ({p}, {C}) bf16 + uint8 + fp32 weights: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, F.cross_entropy(weight=cw, ignore_index=255) {l_ms:.4f} ms, "
          f"bound {bound(moved)['bound_ms']:.4f} ms ({moved} bytes); |diff| {err:.6g} of "
          f"{float(s_t):.9g} (rtol 1e-5), run-to-run identical")
    out["ce_sum_weighted"] = {"max_abs_err": err, "rel_err": err / abs(float(s_t)), "ms": k_ms,
                              "plain_ms": p_ms, **bound(moved), "library_ms": l_ms,
                              "library": "F.cross_entropy(logits, labels, weight=cw, "
                                         "ignore_index=255, reduction='sum'), cw in bf16"}
    del lib_labels, cw_lib

    # CE grad, both weight modes; g on the device as autograd hands it over
    grad_out = torch.tensor(1.0 / p, device=dev)
    mask = torch.ones(BATCH, device=dev)
    mask[BATCH // 2] = 0.0
    worst = {"err": 0.0, "ulps": 0.0}
    times = {}
    for mode, (w_, pps) in {"per-sample": (mask, TH * TW), "per-pixel": (weights, None)}.items():
        d_k = K.ce_grad(logits, labels, w_, grad_out, pps)
        d_t = K.ce_grad_plain(logits, labels, w_, grad_out, pps)
        wg = (w_.repeat_interleave(pps) if pps else w_)[:, None] * grad_out
        ulps, close = _bf16_ulps(d_k, d_t, wg)
        check(close, f"CE grad ({mode}) is {ulps} bf16 ulps from its twin")
        del wg
        zero = (w_ == 0).repeat_interleave(pps) if pps else (w_ == 0)
        check(bool((d_k[zero] == 0).all()), f"CE grad ({mode}) is not zero where the weight is")
        worst = {"err": max(worst["err"], float((d_k.float() - d_t.float()).abs().max())),
                 "ulps": max(worst["ulps"], ulps)}
        times[mode] = (cuda_ms(lambda: K.ce_grad(logits, labels, w_, grad_out, pps)),
                       cuda_ms(lambda: K.ce_grad_plain(logits, labels, w_, grad_out, pps)))
        print(f"CE grad {mode} ({p}, {C}) bf16: kernel {times[mode][0]:.4f} ms, plain "
              f"{times[mode][1]:.4f} ms, {ulps:.3g} bf16 ulp from the twin at most (bound: one "
              f"ulp + 2^-20 |w g|), exact zeros at zero weight")
        del d_k, d_t
    # per-sample, as timed: the masked-out sample's rows are neither read nor
    # their labels; every row's gradient is written
    live = int((mask != 0).sum()) * TH * TW
    moved = live * (C * logits.element_size() + labels.element_size()) + nbytes(
        mask, grad_out, logits)
    out["ce_grad"] = {"max_abs_err": worst["err"], "max_bf16_ulps": worst["ulps"],
                      "ms": times["per-sample"][0], "plain_ms": times["per-sample"][1],
                      **bound(moved), "library_ms": None, "library": "none",
                      "per_pixel_ms": times["per-pixel"][0],
                      "per_pixel_plain_ms": times["per-pixel"][1]}
    return out


def phase_train_card_vs_cpu(dev) -> None:
    """Three TF1-Adam train steps of a narrow fp32 model (TF32 off) on the
    card and on the CPU from the same weights. Losses agree to rtol 1e-4.
    Adam's update is about lr * sign(g) wherever |g| >> eps, so the updates
    are compared where the CPU's first gradient is clear of zero (|g| >
    1e-3 * max|g| of its leaf): there they agree to 1e-2 * lr, where fp32
    summation-order noise (~1e-5 relative) moves them by ~1e-4 * lr; a
    near-zero gradient's sign is noise, so elsewhere only Adam's bound
    (|update| <= lr per step) is held."""
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(width_mult=1 / 32, fc_channels=32, compute_dtype=torch.float32)
    tree = bridge.to_numpy(FCN8s(num_classes=C, seed=2, device="cpu", **kw).params)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (2, 128, 256, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, C, (2, 128, 256), dtype=np.uint8))
    mask = torch.ones(2)
    lr, steps = 1e-3, 3
    grads0 = S.loss_and_grads(S.create_train_state(bridge.to_port(tree), S.make_optimizer()).params,
                              images, labels, mask, seed=0, step=0, l2_rate=0.01, keep_prob=1.0,
                              compute_dtype=torch.float32)[1]
    runs = {}
    for d in ("cpu", dev):
        opt = S.make_optimizer("adam")
        state = S.create_train_state(bridge.to_port(tree, device=d), opt)
        losses = []
        for _ in range(steps):
            state, loss = S.train_step(state, images.to(d), labels.to(d), mask.to(d), 0, lr, 0.01,
                                       1.0, optimizer=opt, num_classes=C,
                                       compute_dtype=torch.float32)
            losses.append(float(loss))
        runs[str(d)] = (losses, [t.detach().cpu() for t in bridge.param_leaves(state.params)])
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (l_cpu, p_cpu), (l_gpu, p_gpu) = runs["cpu"], runs[str(dev)]
    check(all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(l_cpu, l_gpu)),
          f"train losses: CPU {l_cpu}, card {l_gpu}")
    p0 = bridge.param_leaves(bridge.to_port(tree))
    worst, clear_share, n = 0.0, 0, 0
    for a, b, start, g in zip(p_cpu, p_gpu, p0, grads0):
        diff = ((b - start.detach()) - (a - start.detach())).abs()
        check(float(diff.max()) <= 2 * steps * lr, "card update beyond Adam's bound")
        clear = g.abs() > 1e-3 * g.abs().max()
        if bool(clear.any()):
            worst = max(worst, float(diff[clear].max()))
        clear_share, n = clear_share + int(clear.sum()), n + clear.numel()
    check(worst <= 1e-2 * lr, f"card updates differ from the CPU's by {worst} where |g| is clear")
    print(f"train card vs CPU (fp32, TF32 off, 3 Adam steps, 2x128x256): losses {l_gpu} vs "
          f"{l_cpu}; max update diff {worst:.3g} (= {worst / lr:.3g} lr) on the "
          f"{clear_share / n:.4f} of params whose first gradient is clear of zero")


def _synthetic(rng, n):
    """n random images and id maps at the train shape."""
    return (rng.integers(0, 256, (n, TH, TW, 3), dtype=np.uint8),
            rng.integers(0, C, (n, TH, TW), dtype=np.uint8))


def zero_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def phase_train(dev) -> tuple[FCN8s, dict]:
    """``FCN8s.train`` at full width and bench.py's shape; returns the model
    and the launch counts of the run."""
    model = FCN8s(num_classes=C, device=dev, seed=3)
    rng = np.random.default_rng(6)

    def stream():
        while True:
            yield _synthetic(rng, BATCH)

    w0 = model.params["encoder"]["conv1_1"]["weight"].detach().clone()
    conversions = P.MaxPool2x2.dy_conversions
    zero_counts()
    t0 = time.perf_counter()
    model.train(stream(), epochs=2, steps_per_epoch=4, learning_rate_schedule=lambda s: 1e-4,
                keep_prob=0.5, l2_regularization=0.0, metrics={"loss", "mean_iou"},
                eval_dataset="val", val_generator=stream(), val_steps=2, eval_frequency=1,
                record_summaries=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    want = {"maxpool2x2_code_nhwc": 40, "maxpool2x2_bwd_nhwc": 40, "ce_sum_per_sample": 12,
            "ce_grad": 8, "ce_sum_weighted": 0, "maxpool2x2_nhwc": 20,
            "confusion_matrix_accumulate": 4, "conv1_core": 0}
    check(counts == want, f"train launched {counts}, expected {want}")
    check(math.isfinite(model.training_loss), f"training loss {model.training_loss}")
    check(not torch.equal(model.params["encoder"]["conv1_1"]["weight"], w0), "params did not move")
    images = _synthetic(rng, 2)[0]
    with torch.inference_mode():
        logits = apply_fcn8s(bridge.cast_params(model.params, torch.bfloat16),
                             torch.from_numpy(images).to(dev), logits_dtype=torch.bfloat16)
        want_ids = torch.argmax(logits, dim=-1).cpu().numpy()
    check(np.array_equal(model.predict(images), want_ids),
          "predict after train is not the new weights'")
    print(f"FCN8s.train at full width, 8 steps of ({BATCH}, {TH}, {TW}, 3) + 2 x 2 val batches in "
          f"{seconds:.2f} s: training loss {model.training_loss:.5f}, eval {model.metric_values}; "
          f"launches {counts}; dy layout conversions in the pool backward: "
          f"{P.MaxPool2x2.dy_conversions - conversions}; predict after train = the new weights")
    return model, counts


def phase_learnable(dev) -> None:
    """Labels that are a function of the image (64x64 colour blocks, one
    colour per class): 8 steps at full width and keep_prob 1 on one fixed
    batch bring the loss below the first step's."""
    rng = np.random.default_rng(7)
    palette = rng.integers(0, 256, (C, 3), dtype=np.uint8)
    blocks = rng.integers(0, C, (BATCH, TH // 64, TW // 64))
    labels = np.repeat(np.repeat(blocks, 64, axis=1), 64, axis=2).astype(np.uint8)
    images = palette[labels]
    model = FCN8s(num_classes=C, device=dev, seed=4)
    opt = model.optimizer
    state = S.create_train_state(model.params, opt)
    im, lb = torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev)
    mask = torch.ones(BATCH, device=dev)
    losses = []
    for _ in range(8):
        state, loss = S.train_step(state, im, lb, mask, 0, 1e-4, 0.0, 1.0, optimizer=opt,
                                   num_classes=C)
        losses.append(loss)
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"the loss did not fall on a learnable batch: {losses}")
    print(f"learnable batch (full width, keep_prob 1, lr 1e-4): "
          f"losses {[round(v, 5) for v in losses]}")
    model.close()


def phase_weighted(dev, model: FCN8s) -> dict:
    """Two steps with ``ignore_label=255`` on a fresh model, then two with
    ``class_weights`` on ``model``: each pair launches K3 and the CE grad
    twice and K1 never. Returns the counts of the four steps."""
    rng = np.random.default_rng(8)

    def stream(ignore):
        while True:
            images, labels = _synthetic(rng, BATCH)
            if ignore:
                labels[rng.random(labels.shape) < 0.1] = 255
            yield images, labels

    ignoring = FCN8s(num_classes=C, device=dev, seed=5, ignore_label=255)
    total = dict.fromkeys(WRAPPERS, 0)
    cw = np.linspace(0.5, 2.0, C).astype(np.float32)
    for m, kw, ignore in ((ignoring, {}, True), (model, {"class_weights": cw}, False)):
        zero_counts()
        m.train(stream(ignore), epochs=1, steps_per_epoch=2, learning_rate_schedule=lambda s: 1e-4,
                keep_prob=0.5, record_summaries=False, **kw)
        counts = read_counts()
        check(counts["ce_sum_weighted"] == 2 and counts["ce_grad"] == 2
              and counts["ce_sum_per_sample"] == 0, f"weighted train launched {counts}")
        check(math.isfinite(m.training_loss), f"weighted training loss {m.training_loss}")
        print(f"weighted train ({'ignore_label=255' if ignore else 'class_weights'}): loss "
              f"{m.training_loss:.5f}; launches {counts}")
        total = {k: total[k] + counts[k] for k in total}
    ignoring.close()
    return total


def phase_train_times(dev, model: FCN8s, smi: str) -> None:
    """The full-width train step at batch 8 x 1024x512, bf16, keep_prob 0.5."""
    rng = np.random.default_rng(9)
    images, labels = _synthetic(rng, BATCH)
    im, lb = torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev)
    mask = torch.ones(BATCH, device=dev)
    state, opt = model.state, model.optimizer

    def step(accum=1):
        S.train_step(state, im, lb, mask, 0, 1e-4, 0.0, 0.5, optimizer=opt, num_classes=C,
                     grad_accum=accum)

    torch.cuda.reset_peak_memory_stats()
    step_ms = host_ms(step, reps=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    accum_ms = host_ms(lambda: step(2), reps=5, warmup=1)

    leaves = bridge.param_leaves(state.params)
    split = {"forward": [], "backward": [], "optimizer": []}
    for i in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        run = bridge.cast_params(state.params, torch.bfloat16)
        logits = apply_fcn8s(run, im, keep_prob=0.5, deterministic=False,
                             generator=S.dropout_generator(dev, 0, state.step),
                             logits_dtype=torch.bfloat16)
        loss = K.softmax_cross_entropy(logits, lb, mask) + 0.0 * decoder_l2_loss(
            state.params["decoder"])
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        opt.apply(state.params, grads, state.opt_state, 1e-4)
        ev[3].record()
        torch.cuda.synchronize()
        if i:  # the first is a warm-up
            for k, (a, b) in zip(split, zip(ev, ev[1:])):
                split[k].append(a.elapsed_time(b))
        del run, logits, loss, grads
    split = {k: statistics.median(v) for k, v in split.items()}

    fc6 = state.params["encoder"]["fc6"]
    x = torch.randn((BATCH, fc6["weight"].shape[1], TH // 32, TW // 32), device=dev,
                    dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    w6 = fc6["weight"].detach().to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w6.requires_grad_()
    b6 = fc6["bias"].detach().to(torch.bfloat16).requires_grad_()
    out = F.conv2d(x, w6, b6, padding=3)
    dout = torch.randn_like(out)
    fc6_fwd = cuda_ms(lambda: F.conv2d(x, w6, b6, padding=3), reps=3)
    fc6_bwd = cuda_ms(lambda: torch.autograd.grad(out, (x, w6, b6), dout, retain_graph=True),
                      reps=3)
    print(f"train times on {smi}: step {step_ms:.2f} ms (host clock, median of 5), "
          f"{BATCH / step_ms * 1e3:.2f} images/s at batch {BATCH} x {TH}x{TW} bf16 keep_prob 0.5; "
          f"CUDA-event split forward {split['forward']:.2f} ms, "
          f"backward {split['backward']:.2f} ms, "
          f"optimizer {split['optimizer']:.2f} ms; peak memory {peak:.2f} GiB "
          f"(max_memory_allocated); gradient_accumulation=2 step {accum_ms:.2f} ms "
          f"({BATCH / accum_ms * 1e3:.2f} images/s); "
          f"fc6 (7x7, 512->4096) forward {fc6_fwd:.2f} ms, "
          f"backward {fc6_bwd:.2f} ms = {(fc6_fwd + fc6_bwd) / step_ms:.1%} of the step")


# ---------------------------------------------------------------------------
# the conv1 calibration (KB) and persistence
# ---------------------------------------------------------------------------


def phase_conv1_calibration(dev, smi: str) -> tuple[dict, dict]:
    """KB at the calibration script's shape and data: checked against its
    twin (one launch, before the counted window), then the script's timings
    with the counts zeroed. Returns (measured, launch counts)."""
    inputs = KB.calibration_inputs(dev)
    checked = KB.check_against_twin(inputs)
    zero_counts()
    times = KB.time_calibration(inputs)
    counts = read_counts()
    check(counts["conv1_core"] > 0, "the calibration never launched conv1_core")
    x = inputs["xmain"]
    kb_bound = bound(nbytes(x, inputs["w128"], inputs["w64"], x),  # out is x's size
                     KB.kb_flops(*x.shape[:2]))
    del inputs, x
    torch.cuda.empty_cache()
    print(f"conv1 calibration on {smi}, x ({KB.CAL_TILES * KB.TH}, {KB.CAL_W}, {KB.C}) bf16, "
          f"{times['gflop']:.1f} GFLOP: KB {times['ms']:.4f} ms ({times['tflops']:.1f} TFLOP/s), "
          f"twin (fp32, TF32 off) {times['plain_ms']:.4f} ms ({times['plain_tflops']:.1f} "
          f"TFLOP/s), cuDNN conv1_2 + ReLU (8, 1024, 512, 64) bf16 {times['cudnn_ms']:.4f} ms "
          f"({times['cudnn_tflops']:.1f} TFLOP/s); KB vs twin max |diff| "
          f"{checked['max_abs_err']:.4g} of max |twin| {checked['max_abs_ref']:.4g}, every "
          f"element within 2^-7 |twin| + 2^-7; launches {counts['conv1_core']}")
    measured = {"max_abs_err": checked["max_abs_err"], "ms": times["ms"],
                "plain_ms": times["plain_ms"], **kb_bound, "library_ms": None,
                "library": "none (cuDNN's conv1_2 + ReLU is its same-FLOPs reference)",
                "cudnn_conv1_2_ms": times["cudnn_ms"],
                "tflops": times["tflops"], "plain_tflops": times["plain_tflops"],
                "cudnn_conv1_2_tflops": times["cudnn_tflops"]}
    return measured, counts


def _by_path(params: dict, tensors: list) -> dict:
    return dict(zip(bridge.jax_leaf_paths(params), tensors))


def _assert_same_state(a: FCN8s, b_params: dict, b_step: int, b_opt, what: str) -> None:
    """``a``'s params, step and Adam state bit-equal to the others."""
    check(a.state.step == b_step, f"{what}: step {a.state.step} vs {b_step}")
    pa, pb = (_by_path(a.params, bridge.param_leaves(a.params)),
              _by_path(b_params, bridge.param_leaves(b_params)))
    check(pa.keys() == pb.keys() and all(torch.equal(pa[k].detach(), pb[k].detach().to(pa[k].device))
                                         for k in pa), f"{what}: params differ")
    oa = a.state.opt_state
    check(oa.count == b_opt.count and oa.inner.count == b_opt.inner.count,
          f"{what}: optimizer counts {oa.count}/{oa.inner.count} vs "
          f"{b_opt.count}/{b_opt.inner.count}")
    for moment in ("mu", "nu"):
        ma = _by_path(a.params, getattr(oa.inner, moment))
        mb = _by_path(b_params, getattr(b_opt.inner, moment))
        check(all(torch.equal(ma[k], mb[k].to(ma[k].device)) for k in ma),
              f"{what}: Adam {moment} differs")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def phase_persistence(dev, model: FCN8s, smi: str) -> None:
    """Save, restore, continue and serve the full-width model of phase 10."""
    rng = np.random.default_rng(11)
    images, labels = _synthetic(rng, BATCH)
    model._refresh_run_params()  # phase 13 stepped the masters directly
    root = tempfile.mkdtemp(prefix="fcn8s_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = model.save(os.path.join(root, "blocking"), force_save=True)
        save_s = time.perf_counter() - t0
        size = _dir_bytes(path)
        t0 = time.perf_counter()
        loaded = FCN8s(model_load_dir=path, device=dev)
        load_s = time.perf_counter() - t0
        check(loaded._staged_opt_state is not None
              and all(t.device.type == "cpu" for t in loaded._staged_opt_state.inner.mu),
              "the restored Adam moments are not staged on the host")
        loaded.state.opt_state = loaded._staged_opt_state  # compared on the host, as staged
        _assert_same_state(loaded, model.params, model.state.step, model.state.opt_state,
                           "blocking save + load")
        loaded.state.opt_state = None
        check(np.array_equal(model.predict(images), loaded.predict(images)),
              "the restored model predicts other ids")

        # one more step from each: the same loss (dropout off, cuDNN deterministic)
        det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        losses = []
        for m in (model, loaded):
            m.train(iter([(images, labels)]), 1, 1, lambda s: 1e-4, keep_prob=1.0,
                    record_summaries=False, prefetch=0)
            losses.append(m.training_loss)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        check(math.isclose(losses[0], losses[1], rel_tol=1e-6), f"one more step: losses {losses}")
        pa = _by_path(loaded.params, bridge.param_leaves(loaded.params))
        pb = _by_path(model.params, bridge.param_leaves(model.params))
        step_diff = max(float((pa[k].detach() - pb[k].detach()).abs().max()) for k in pa)
        loaded.close()
        del loaded
        torch.cuda.empty_cache()

        # an async save while two steps run holds the state of the call
        want_params = {k: t.detach().clone() for k, t in
                       _by_path(model.params, bridge.param_leaves(model.params)).items()}
        inner = model.state.opt_state.inner
        want_mu = {k: t.clone() for k, t in _by_path(model.params, inner.mu).items()}
        want_nu = {k: t.clone() for k, t in _by_path(model.params, inner.nu).items()}
        want_step, want_counts = model.state.step, (model.state.opt_state.count, inner.count)
        im, lb = torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev)
        mask = torch.ones(BATCH, device=dev)

        def two_steps() -> float:
            t0 = time.perf_counter()
            for _ in range(2):
                S.train_step(model.state, im, lb, mask, 0, 1e-4, 0.0, 1.0,
                             optimizer=model.optimizer, num_classes=C)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path2 = model.save(os.path.join(root, "async"), force_save=True, block=False)
        call_ms = (time.perf_counter() - t0) * 1e3
        during_ms = two_steps()  # in place, while the writer copies and writes the snapshot
        t0 = time.perf_counter()
        model._join_pending_save()
        join_ms = (time.perf_counter() - t0) * 1e3
        alone_ms = two_steps()
        snap = FCN8s(model_load_dir=path2, device=dev)
        snap_opt = snap._staged_opt_state
        check(snap.state.step == want_step and (snap_opt.count, snap_opt.inner.count) == want_counts,
              "the async checkpoint's step or counts are not the call's")
        got = _by_path(snap.params, bridge.param_leaves(snap.params))
        got_mu, got_nu = _by_path(snap.params, snap_opt.inner.mu), _by_path(snap.params,
                                                                              snap_opt.inner.nu)
        check(all(torch.equal(got[k].detach(), want_params[k]) for k in want_params)
              and all(torch.equal(got_mu[k], want_mu[k].cpu()) for k in want_mu)
              and all(torch.equal(got_nu[k], want_nu[k].cpu()) for k in want_nu),
              "the async checkpoint does not hold the state of the call")
        check(not all(torch.equal(t.detach(), want_params[k]) for k, t in
                      _by_path(model.params, bridge.param_leaves(model.params)).items()),
              "the two steps after the async save did not move the params")
        snap.close()
        del snap, want_params, want_mu, want_nu
        torch.cuda.empty_cache()

        # the serving CLI on that directory
        server = serving.main([path2, "0"], serve=False)  # --device cuda, the default
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = "http://127.0.0.1:%d" % server.server_address[1]
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            check(health["status"] == "ok" and health["model_config"] == model.model_config,
                  f"/healthz of the served checkpoint: {health}")
            status, body = _post(base + "/predict", _png(images[0]))
            ids = _decode(body)
            check(status == 200 and ids.shape == (TH, TW) and int(ids.max()) < C,
                  f"/predict of the served checkpoint gave {status}")
        finally:
            server.shutdown()
            server.server_close()
            server.service.close()
            thread.join(timeout=60)
            server.service.model.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"persistence on {smi} at full width: checkpoint {size / 1e9:.4f} GB "
          f"({size} bytes: fp32 params + Adam mu, nu); blocking save {save_s:.3f} s, load "
          f"{load_s:.3f} s (moments staged on the host); params, step and Adam state bit-equal, "
          f"ids equal; one more step from each: losses {losses[0]!r} and {losses[1]!r}, params "
          f"then differ by {step_diff:.3g} at most; save(block=False) returned in {call_ms:.1f} "
          f"ms, 2 train steps during the write took {during_ms:.1f} ms vs {alone_ms:.1f} ms "
          f"alone, the writer finished {join_ms:.1f} ms after them; its checkpoint = the state "
          f"of the call; the serving CLI served it (/healthz, /predict)")


def main() -> None:
    smi = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    measured = phase_kernels(dev)
    phase_card_vs_cpu(dev)
    model = FCN8s(num_classes=C, device=dev)  # full VGG-16 width, bf16, seeded init
    zero_counts()
    phase_serving(model)
    phase_evaluate(model)
    serve_counts = read_counts()
    for name in ("maxpool2x2_nhwc", "ce_sum_per_sample", "confusion_matrix_accumulate"):
        check(serve_counts[name] > 0, f"{name} was never launched on the serve + eval path")
    phase_times(model, dev, smi)
    model.close()
    del model
    torch.cuda.empty_cache()

    measured.update(phase_train_kernels(dev))
    phase_train_card_vs_cpu(dev)
    trained, train_counts = phase_train(dev)
    phase_learnable(dev)
    weighted_counts = phase_weighted(dev, trained)
    phase_train_times(dev, trained, smi)
    conv1_measured, conv1_counts = phase_conv1_calibration(dev, smi)
    measured["conv1_core"] = conv1_measured
    phase_persistence(dev, trained, smi)
    trained.close()
    paths = {"serve+eval": serve_counts, "train": train_counts, "train weighted": weighted_counts,
             "conv1 calibration": conv1_counts}
    source_path = {"maxpool2x2_nhwc": "serve+eval", "ce_sum_per_sample": "serve+eval",
                   "confusion_matrix_accumulate": "serve+eval", "maxpool2x2_code_nhwc": "train",
                   "maxpool2x2_bwd_nhwc": "train", "ce_grad": "train",
                   "ce_sum_weighted": "train weighted", "conv1_core": "conv1 calibration"}
    for name in WRAPPERS:
        check(paths[source_path[name]][name] > 0, f"{name} never launched on its path")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
         "launches": paths[source_path[name]][name], "path": source_path[name], **measured[name]}
        for name in WRAPPERS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
