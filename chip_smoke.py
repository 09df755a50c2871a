#!/usr/bin/env python3
"""Drive the PyTorch port's serving, eval, training, KB calibration,
checkpoint, training-feature, int8/TTA/tiled predict, offline-benchmark,
host data pipeline, serving-artifact, video, viewer, annotation, mesh,
spatial-partition and training-survival paths, the measurement scripts and
the tutorial notebook once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: require CUDA; print the device name and nvidia-smi's name and
   power limit;
2. build the CUDA kernels from ``fcn8s_tensorflow_tpu_torch/csrc`` (nvcc,
   sm_90a, one process per source) and print the build time;
3. the eval-path kernels (K4f, K1, K5) against their plain PyTorch twins on
   the card at the serving shapes (batch 8 x 512x1024, 20 classes, bf16),
   with median times from CUDA events; K1 and K5 run twice on one input
   give the same bytes;
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
   against ``F.max_pool2d``'s gradient; K4a (values and codes), K4b, K3 and
   the CE grad run twice on one input give the same bytes;
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
    temporary directory, removed at the end;
16. the training features at full width: ``FCN8s.train`` for 3 epochs x 3
    steps (batch 8 x 1024x512, keep_prob 0.5) with TensorBoard summaries,
    ``ema_decay``, ``device_augment``, the LR-plateau observer and early
    stopping, evaluating each epoch: both event streams hold the JAX
    facade's tags, the train log's LRs halve as the observer says,
    ``predict``/``evaluate(use_ema=True)`` run other weights than the live
    ones, a save + resume + one step equals the uninterrupted run (EMA
    within one fp32 ulp, counters equal), and the augmented batch equals
    the apply functions' CPU run on the card's draws; then the step with
    augment + EMA against the plain one, the EMA update, the augment and
    the weight summaries timed, and the device busy share of 5 such steps
    read from ``utils.profiling.trace``;
17. the rest of predict at full width (batch 8 x 512x1024, bf16, a fresh
    seeded model, its decoder redrawn at unit fan-in scale so that pixels
    have clear top-2 margins): (a) the int8 conv route (``_int_mm`` over
    an explicit im2col) against its fp64 twin at every encoder layer on the
    quantized forward's own int8 inputs (exact int32; batch 1 for
    conv1_1-conv2_2), and each layer's route, int8 conv and bf16 cuDNN conv
    timed; (b) ``predict(quantized=True)``, dynamic then calibrated static
    on 16 images, against the int8 path on its twin, times against bf16 at
    batch 8 and 1, peak memory; (c) ``predict_tta`` with scales (0.75, 1.0,
    1.25) and flip: probabilities sum to 1, the identity view equals
    ``predict``, the mirror's ids are the mirrored ids where the top-2
    margin exceeds 0.05, once quantized;
    (d) a 1024x2048 frame in (512, 512) tiles, overlap 128: the hard paste
    equals its host composition, the blend sums to 1 and equals the lone
    tile where one covers a pixel; (e) the service with ``quantized=True,
    tile=(512, 512)``;
18. the rest of the facade at full width (a fresh seeded model, decoder
    redrawn as in phase 17): (a) ``summary()`` at 8 x 1024x512 equals the
    JAX package's totals and does no device work; (b) ``find_learning_rate``
    (batch 8 x 1024x512, 20 steps from 1e-7 to 1.0, keep_prob 1) on the
    fresh model and after two ``train`` steps: params, Adam's moments,
    counters and step bit-equal after it, ``opt_state`` None again on the
    fresh model, device memory (the bytes the live tensors requested) back
    within 1 MB, ``predict`` unchanged; ms per sweep step beside the plain
    train step; (c) ``predict_and_save`` of
    24 512x1024 PNGs (batch 8) with the on-card overlay, the host compositor
    beside the image, and labelIds, plus two 1024x2048 frames in (512, 512)
    tiles: the PNGs equal ``id_map[predict]`` on >= 99.9% of pixels, the
    overlays within 1 LSB where the ids agree; images/s and the split into
    decode, dispatch, D2H and encode; (d) ``score_benchmark`` on a
    Cityscapes-layout split of 2 cities x 4 1024x2048 frames (every
    evaluated class, void, car and person instances): the matrix sums to
    every pixel, and collapsed to trainIds equals K5's on the card cell for
    cell, IoUs within 1e-6; the predict and scoring seconds and the native
    (host C++) confusion matrix's ms per frame;
19. the host data pipeline and the serving artifact: (a) a synthetic
    Cityscapes tree made from a seed (16 train + 8 val piecewise-smooth
    2048x1024 frames with labelIds 0-33; mean PNG sizes printed) and a KITTI
    tree (8 frames of 1242x375); (b) images/s of the host pipeline alone
    (``examples/train_cityscapes.py``'s settings, resize to 512x1024, flip,
    brightness, translate, scale): ``BatchGenerator`` at workers 1 and
    min(8, cores), ``PackedDataset`` on the same tree packed at that size,
    the KITTI generator at its example's 320x1152; (c) ``BatchGenerator``
    and ``PackedDataset`` yield byte-identical batches for one seed; (d)
    ``FCN8s.train`` at full width, batch 8, fed from disk by each (prefetch
    on) with a val generator each epoch, then ms per step and the device
    busy share against the same model fed in-memory batches, and 2 steps of
    a 2-class model fed by the KITTI generator; (e) ``export_serving`` of
    phase 10's weights at input_hw=(1024, 512), argmax and softmax, loaded
    on the card: 5 K4f launches per artifact forward, ids and softmax
    against ``model.predict`` at batch 8 and 1, export, load and predict
    times, bytes on disk;
20. viz and prep at full width (a fresh seeded model, decoder redrawn as in
    phase 17): (a) ``segment_video`` over a seeded 26-frame 1024x2048
    ``mp4v`` video at batch 8 (3 full batches and a tail of 2), warm: the
    output's frame count and size, the batch loop
    (``overlay_frames``) equal to ``predict(overlay=)`` of the decoded
    frames exactly and its encoding equal to ``segment_video``'s file byte
    for byte, frames/s and decode, predict and encode each timed alone;
    then 8 frames with ``quantized=True`` and in (512, 512) tiles, cold and
    warm; (b) ``predict_and_save(output_format="ids")`` over 2 synthetic 2048x1024
    val frames with disparity, ``view_cityscapes_split(results_dir=)``,
    ``build_interactive_viewer`` and ``serve_viewer`` on port 0: the files
    served equal the files, the prediction layer is the overlay of the saved
    ids, build time per image; (c) seeded ``*_gtFine_polygons.json`` for 8
    train + 4 val 2048x1024 frames (sky, buildings, sidewalks, road, cars,
    persons, a ``cargroup``), one more polygon POSTed through the label
    tool's server, both GT rasterisers (their PNGs equal the in-memory
    images), then ``train`` for 2 steps at batch 8 fed by ``BatchGenerator``
    on the rasterised trainIds at 512x1024 with a val batch, and the
    data-fed step time; label tool latencies per route;
21. ``parallel/mesh.py``: a group of one rank, then two ranks on the one
    card (described after the kernel line's keys below);
22. spatial partitioning (the width over the mesh's 'model' axis, the hand
    halo exchange): a group of one rank, then two ranks on the one card
    (described after phase 21);
23. the training-survival tools and the quickstart at full width (VGG-16,
    fc 4096): (a) ``tools.endurance_canonical`` run with ``python -m`` at
    the recipe's shape (256x512, effective batch 16 = 2 x 8, 6 classes,
    keep_prob 0.5, ``--augment full``, EMA 0.999, the plateau observer,
    save-best-only, the train log), cut in length only (40 steps of 10 an
    epoch, 64 packed scenes, the SIGKILL near step 25, 0.15 s a step of
    throttle, each cut printed): the killed and resumed run's fingerprint
    equals the uninterrupted comparator's, every loss finite; (b)
    ``tools.multihost_fault_injection.run`` on two gloo ranks sharing the
    card, 5 classes, 2 x 256x512 a rank, 4 fp32 steps: rank 1's exit 17 and
    rank 0's failed collective detected, the resumed params and EMA equal
    the straight run's byte for byte; (c)
    ``examples.quickstart_synthetic`` at its defaults. The children write
    their launch counts into their result files: K4a, K4b, K1, the CE grad,
    K4f and K5 in (a)'s resumed and comparator children, K4a, K4b, K1 and
    the CE grad in each rank of (b). Each part's time, the gloo step and
    the fingerprint are printed beside the card's name and power limit.
24. the measurement scripts and the tutorial notebook
    (``fcn8s_tensorflow_tpu_torch/benchmarks``, ``examples/fcn8s_tutorial.ipynb``):
    (a) ``benchmarks.bench`` at its full shape, run with ``python -m``: its
    JSON line printed, a value, a step within 25% of phase 13's, the
    analytic step 10.68 TFLOP, an ``mfu``, the batched, int8 and overlay
    rows; (b) the other scripts at their own shapes, cut in length only (in
    this process, their module constants set): the overlay variants
    bit-identical, the masked and dense losses within 1e-5, the int8 and
    bf16 wgrad errors within 5e-2 and 5e-3, the closed loop's two mIoUs
    finite after 4 steps, the profile ranking K4a, K4b, K1 and the CE grad
    by name, and the hand pool pair equal to ``F.max_pool2d``'s on a
    tie-free input at pool1's shape; a ``{"benchmark_scripts": ...}`` line;
    (c) the notebook's code cells at its defaults (6 x 50 steps at 4 x
    256x512, evaluate, predict).

Kernel launch counts are zeroed just before each path is driven and read
just after it: serving + evaluation (phases 5-6), training (phase 10), the
weighted training (phase 12), the conv1 calibration's timed runs (phase
14), the training features (phase 16: the train run, then the use_ema
inference), the rest of predict (phase 17: each of b-e) and the rest of the
facade (phase 18: each of b-d), phase 19 (each data-fed train run of
(d), each artifact's forward in (e)) and phase 20 (each of a-c); every
kernel of a path must have launched. A ``{"library_routes": [...]}`` line gives the
int8 conv route per layer (ms, its bound over 1,979 TOP/s int8 or the
bytes, share). The line before the last is ``{"kernels": [...]}``:
``launches`` from the path named in ``path``; ``ms``,
``plain_ms`` and ``library_ms`` (one PyTorch call of the same function, where
there is one; ``null`` otherwise) per call, from back-to-back calls between
CUDA events; ``graph_ms``, the same call as ``ms`` replayed from a CUDA graph
of 20 calls, which leaves the host's launch work out (K5's row adds
``coherent_graph_ms`` on eval-like ids); ``bound_ms``, the larger of the
bytes the kernel must move over 3.35 TB/s and its operations over 989
TFLOP/s bf16 (``bound_by`` says which; ``bytes`` and ``flops`` are the
counts; ``launches_train_features`` is the kernel's count in phase 16,
``launches_predict_rest`` in phase 17, ``launches_facade_rest`` in phase 18,
``launches_data_export`` in phase 19 (d) and (e), ``launches_viz_prep`` in
phase 20, ``launches_mesh`` in phase 21 and ``launches_spatial`` in phase
22: ``world1`` its (a), ``world2`` each rank's (b); ``launches_survival``
in phase 23: the endurance's resumed and comparator children, each
fault-injection rank's straight run, the quickstart; ``launches_benchmarks``
in phase 24: (b) the scripts, (c) the notebook). A ``{"viz_prep":
{...}}`` line gives phase 20's numbers.
The last line is ``{"ok": true, "device": {...}}``.

Phase 21 (``parallel/mesh.py``) at full width, bench.py's batch 8 x
1024x512: (a) a process group of one rank on the card (NCCL) and
``FCN8s(mesh=create_mesh(), tensor_parallel=True)``: 3 train steps at
keep_prob 1, evaluate, predict, tiled predict, save and load, each bit for
bit the mesh-less facade's on the same weights; (b) two ranks on the one
card over gloo (NCCL refuses two ranks on one device), this script run
twice as ``chip_smoke.py --mesh-rank R 2 STORE WORK``: first each
collective the port calls on CUDA tensors over gloo, then on the meshes
(2, 1) and (1, 2) with the hand kernels in each rank: one fp32 SGD step
against the single-process step (the masters within rtol 2e-4, atol
1e-6), the fp32 eval confusion matrix and predict ids against the
single-process ones (ids equal where the top-2 logit margin exceeds 1e-4 of
the largest logit, the matrix up to two counts per pixel below it), the
bf16 ids' agreement printed, and one bf16 Adam step at keep_prob 0.5 after
which the leaves replicated over 'model' are equal across its ranks.

Phase 22 (``spatial_partition``) at full width on Cityscapes' full frame,
batch 2 x 1024x2048: (a) an NCCL group of one rank and
``FCN8s(mesh=create_mesh())`` with ``spatial_partition=True``: a train step
at keep_prob 1, evaluate and predict, each bit for bit the mesh-less
facade's; (b) two ranks on the one card over gloo on the (1, 2) mesh, the
width split 1024 + 1024 (``chip_smoke.py --spatial-rank R 2 STORE WORK``),
the hand kernels in each rank: one fp32 SGD step against the
single-process step (rtol 2e-4, atol 1e-6), the fp32 confusion matrix, ids
and overlay against the single process's (the margin rule of phase 21),
bf16 and int8 ids on at least 0.995 of pixels, then three bf16 Adam steps
at keep_prob 0.5 with their times, each rank's peak memory against the
single process's and the halo bytes a rank receives per step. Two ranks
share one card over gloo: no scaling figure.
"""

from __future__ import annotations

import gc
import importlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
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
from fcn8s_tensorflow_tpu_torch.data import BatchGenerator, PackedDataset, pack_dataset
from fcn8s_tensorflow_tpu_torch.data.kitti import batch_generator as kitti_generator
from fcn8s_tensorflow_tpu_torch.engine import model as M
from fcn8s_tensorflow_tpu_torch.engine import serving
from fcn8s_tensorflow_tpu_torch.engine.export import load_serving_artifact
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s
from fcn8s_tensorflow_tpu_torch.engine.serving import InferenceService, make_server
from fcn8s_tensorflow_tpu_torch.engine.summaries import (DEFAULT_INSTRUMENTED, SummaryLogger,
                                                         summary_stats)
from fcn8s_tensorflow_tpu_torch.evaluation import confmat as NC
from fcn8s_tensorflow_tpu_torch.evaluation import pixel_eval
from fcn8s_tensorflow_tpu_torch.kernels import build
from fcn8s_tensorflow_tpu_torch.labels import (IDS_TO_TRAINIDS_ARRAY, TRAINIDS_TO_IDS_ARRAY,
                                               TRAINIDS_TO_RGBA_DICT)
from fcn8s_tensorflow_tpu_torch.labels import labels as CS_LABELS
from fcn8s_tensorflow_tpu_torch.models.fcn8s import apply_fcn8s, decoder_l2_loss
from fcn8s_tensorflow_tpu_torch.models.vgg16 import _BLOCK_ENDS as BLOCK_ENDS
from fcn8s_tensorflow_tpu_torch.models.vgg16 import VGG16_CONV_LAYERS, VGG_MEAN_RGB
from fcn8s_tensorflow_tpu_torch.ops import augment_device as A
from fcn8s_tensorflow_tpu_torch.ops import conv1_core as KB
from fcn8s_tensorflow_tpu_torch.ops import kernels as K
from fcn8s_tensorflow_tpu_torch.ops import pool as P
from fcn8s_tensorflow_tpu_torch.ops import quantize as Q
from fcn8s_tensorflow_tpu_torch.ops.metrics import (benchmark_iou_from_confusion,
                                                    confusion_matrix, empty_metrics_state)
from fcn8s_tensorflow_tpu_torch.ops.nn import conv2d, max_pool_2x2, nchw, nhwc
from fcn8s_tensorflow_tpu_torch.ops.pool import maxpool2x2_nhwc
from fcn8s_tensorflow_tpu_torch.parallel import steps as S
from fcn8s_tensorflow_tpu_torch.parallel.steps import eval_step
from fcn8s_tensorflow_tpu_torch.prep.annotation import Annotation
from fcn8s_tensorflow_tpu_torch.prep.create_gt_imgs import (create_train_id_instance_imgs,
                                                           create_train_id_label_imgs)
from fcn8s_tensorflow_tpu_torch.prep.label_tool import AnnotationTool
from fcn8s_tensorflow_tpu_torch.prep.label_tool import make_server as make_tool_server
from fcn8s_tensorflow_tpu_torch.prep.rasterize import create_instance_image, create_label_image
from fcn8s_tensorflow_tpu_torch.tools import load_tree, save_tree
from fcn8s_tensorflow_tpu_torch.utils.profiling import device_busy, trace
from fcn8s_tensorflow_tpu_torch.utils.summary import model_summary_rows
from fcn8s_tensorflow_tpu_torch.viz.overlay import (overlay_frames, print_segmentation_onto_image,
                                                    segment_video)
from fcn8s_tensorflow_tpu_torch.viz.serve import build_interactive_viewer, serve_viewer
from fcn8s_tensorflow_tpu_torch.viz.viewer import (load_disparity, load_prediction,
                                                   view_cityscapes_split)

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


def graph_ms(fn, reps: int = 5, n: int = 20, reset=None) -> float:
    """Milliseconds of one call of ``fn`` on the device with the host left
    out: ``fn`` captured ``n`` times in a CUDA graph, the median over
    ``reps`` replays of the replay's time / n. ``reset`` runs before each
    replay, outside the timed events (an accumulator's zeroing)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
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
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores (data sheet)


def bound(bytes_moved: float, flops: float = 0.0, peak: float = BF16_FLOPS_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak (bf16 unless given)."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
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
    ms = g_ms = plain_ms = lib_ms = err = 0.0
    moved = 0
    for c, h, w in POOL_INPUTS:
        x = torch.randn((BATCH, c, h, w), generator=g, device=dev, dtype=torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        y, ref = maxpool2x2_nhwc(x), max_pool_2x2(x)
        check(y.is_contiguous(memory_format=torch.channels_last), "K4f output not channels_last")
        err = max(err, float((y.float() - ref.float()).abs().max()))
        check(torch.equal(y, ref), f"K4f differs from its twin at {tuple(x.shape)}")
        k_ms, p_ms = cuda_ms(lambda: maxpool2x2_nhwc(x)), cuda_ms(lambda: max_pool_2x2(x))
        kg_ms, l_ms = graph_ms(lambda: maxpool2x2_nhwc(x)), cuda_ms(lambda: F.max_pool2d(x, 2, 2))
        print(f"K4f maxpool2x2_nhwc {tuple(x.shape)} bf16: kernel {k_ms:.4f} ms (graph "
              f"{kg_ms:.4f}), plain {p_ms:.4f} ms, F.max_pool2d {l_ms:.4f} ms, bit-exact")
        ms, g_ms, plain_ms, lib_ms = ms + k_ms, g_ms + kg_ms, plain_ms + p_ms, lib_ms + l_ms
        moved += nbytes(x, y)  # x read once, y written once
        del x, y, ref
    xf = torch.randn((2, 64, 32, 64), generator=g, device=dev).contiguous(
        memory_format=torch.channels_last)
    xf[0, 5, 2, 3] = float("nan")
    yf, reff = maxpool2x2_nhwc(xf), max_pool_2x2(xf)
    check(bool(torch.isnan(yf[0, 5, 1, 1])), "K4f drops NaN")
    check(torch.equal(torch.nan_to_num(yf), torch.nan_to_num(reff)), "K4f fp32 differs")
    out["maxpool2x2_nhwc"] = {"max_abs_err": err, "ms": ms, "graph_ms": g_ms,
                              "plain_ms": plain_ms,
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
    kg_ms = graph_ms(lambda: K.ce_sum_per_sample(logits, labels, mask, H * W))
    p_ms = cuda_ms(lambda: K.ce_sum_per_sample_plain(logits, labels, mask, H * W))
    # the library's CE at unit weight, on in-range labels (it refuses others)
    lib_labels = labels.long().clamp_(max=C - 1)
    l_ms = cuda_ms(lambda: F.cross_entropy(logits, lib_labels, reduction="sum"))
    moved = nbytes(logits, labels, mask, s_k)
    print(f"K1 ce_sum_per_sample ({p}, {C}) bf16 + uint8: kernel {k_ms:.4f} ms (graph "
          f"{kg_ms:.4f}), plain "
          f"{p_ms:.4f} ms, F.cross_entropy (unit weight) {l_ms:.4f} ms, bound "
          f"{bound(moved)['bound_ms']:.4f} ms ({moved} bytes); |diff| {err:.6g} of "
          f"{float(s_t):.9g} (rtol 1e-5)")
    out["ce_sum_per_sample"] = {"max_abs_err": err, "rel_err": err / abs(float(s_t)),
                                "ms": k_ms, "graph_ms": kg_ms, "plain_ms": p_ms, **bound(moved),
                                "library_ms": l_ms,
                                "library": "F.cross_entropy(logits, labels, reduction='sum'): "
                                           "the same function at unit weight, labels in range"}
    del lib_labels

    # K5: int32 predictions, uint8 GT (a few out of range), one masked sample;
    # then eval-like ids: GT in 32x32 blocks of random classes, predictions
    # equal to it but on ~10% of pixels
    pred = torch.randint(0, C, (p,), generator=g, device=dev, dtype=torch.int32)
    blocks = torch.randint(0, C, (BATCH, H // 32, W // 32), generator=g, device=dev)
    gt_coh = blocks.repeat_interleave(32, 1).repeat_interleave(32, 2).reshape(-1).to(torch.uint8)
    flip = torch.rand((p,), generator=g, device=dev) < 0.1
    pred_coh = torch.where(flip, torch.randint(0, C, (p,), generator=g, device=dev),
                           gt_coh.long()).to(torch.int32)
    del blocks, flip
    for name, (q, t) in {"random": (pred, labels), "coherent": (pred_coh, gt_coh)}.items():
        conf_k = K.confusion_matrix_accumulate(
            torch.zeros((C, C), dtype=torch.int32, device=dev), q, t, mask, H * W)
        conf_t = K.confusion_matrix_accumulate_plain(
            torch.zeros((C, C), dtype=torch.int32, device=dev), q, t, mask, H * W)
        err = int((conf_k - conf_t).abs().max())
        check(err == 0, f"K5 differs from its twin by up to {err} on {name} ids")
        again = K.confusion_matrix_accumulate(
            torch.zeros((C, C), dtype=torch.int32, device=dev), q, t, mask, H * W)
        check(torch.equal(conf_k, again), f"K5 is not run-to-run identical on {name} ids")
    acc = torch.zeros((C, C), dtype=torch.int32, device=dev)
    k_ms = cuda_ms(lambda: K.confusion_matrix_accumulate(acc, pred, labels, mask, H * W))
    kg_ms = graph_ms(lambda: K.confusion_matrix_accumulate(acc, pred, labels, mask, H * W),
                     reset=acc.zero_)
    coh_ms = graph_ms(lambda: K.confusion_matrix_accumulate(acc, pred_coh, gt_coh, mask, H * W),
                      reset=acc.zero_)
    p_ms = cuda_ms(lambda: K.confusion_matrix_accumulate_plain(acc, pred, labels, mask, H * W))
    pair_ids = labels.long().clamp_(max=C - 1) * C + pred.long()
    l_ms = cuda_ms(lambda: torch.bincount(pair_ids, minlength=C * C))
    # the ids of live samples are read (a masked-out sample's are not), the
    # mask once, conf read and written
    live = int((mask != 0).sum()) * H * W
    moved = live * (pred.element_size() + labels.element_size()) + nbytes(mask, acc, acc)
    print(f"K5 confusion_matrix_accumulate ({p},) int32 + uint8, C={C}: kernel {k_ms:.4f} ms "
          f"(graph {kg_ms:.4f}, eval-like ids {coh_ms:.4f}), plain {p_ms:.4f} ms, torch.bincount "
          f"{l_ms:.4f} ms, bound {bound(moved)['bound_ms']:.4f} ms; exact on both inputs")
    out["confusion_matrix_accumulate"] = {"max_abs_err": 0.0, "ms": k_ms, "graph_ms": kg_ms,
                                          "coherent_graph_ms": coh_ms, "plain_ms": p_ms,
                                          **bound(moved), "library_ms": l_ms,
                                          "library": "torch.bincount(gt * C + pred, minlength=C*C)"}
    del pair_ids, pred_coh, gt_coh
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
    sums = dict.fromkeys(("a", "a_graph", "a_plain", "a_lib", "b", "b_graph", "b_plain", "b_lib"),
                         0.0)
    moved = {"a": 0, "b": 0}
    for c, h, w in TRAIN_POOL_INPUTS:
        x = _ties((BATCH, c, h, w), dev, g)
        y, code = P.maxpool2x2_code_nhwc(x)
        y_t, code_t = P.maxpool2x2_code_plain(x)
        check(torch.equal(y, y_t) and torch.equal(code, code_t),
              f"K4a differs from its twin at {tuple(x.shape)}")
        y2, code2 = P.maxpool2x2_code_nhwc(x)
        check(torch.equal(y, y2) and torch.equal(code, code2),
              f"K4a is not run-to-run identical at {tuple(x.shape)}")
        del y2, code2
        dy = torch.randn(y.shape, generator=g, device=dev).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        dx = P.maxpool2x2_bwd_nhwc(dy, code)
        check(torch.equal(dx, P.maxpool2x2_bwd_plain(dy, code)),
              f"K4b differs from its twin at {tuple(x.shape)}")
        check(torch.equal(dx, P.maxpool2x2_bwd_nhwc(dy, code)),
              f"K4b is not run-to-run identical at {tuple(x.shape)}")
        xr = x.detach().clone().requires_grad_()
        F.max_pool2d(xr, 2, 2).backward(dy)
        check(torch.equal(dx, xr.grad),
              f"K4b differs from F.max_pool2d's gradient at {tuple(x.shape)}")
        ties = float((code != 0).float().mean())
        _, idx = F.max_pool2d(x, 2, 2, return_indices=True)
        t = {"a": cuda_ms(lambda: P.maxpool2x2_code_nhwc(x)),
             "a_graph": graph_ms(lambda: P.maxpool2x2_code_nhwc(x)),
             "a_plain": cuda_ms(lambda: P.maxpool2x2_code_plain(x)),
             "a_lib": cuda_ms(lambda: F.max_pool2d(x, 2, 2, return_indices=True)),
             "b": cuda_ms(lambda: P.maxpool2x2_bwd_nhwc(dy, code)),
             "b_graph": graph_ms(lambda: P.maxpool2x2_bwd_nhwc(dy, code)),
             "b_plain": cuda_ms(lambda: P.maxpool2x2_bwd_plain(dy, code)),
             "b_lib": cuda_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                 dy, x, [2, 2], [2, 2], [0, 0], [1, 1], False, idx))}
        print(f"K4a/K4b {tuple(x.shape)} bf16 (code != 0 on {ties:.3f}): K4a {t['a']:.4f} ms "
              f"(graph {t['a_graph']:.4f}, plain {t['a_plain']:.4f}, F.max_pool2d with indices "
              f"{t['a_lib']:.4f}), K4b {t['b']:.4f} ms (graph {t['b_graph']:.4f}, plain "
              f"{t['b_plain']:.4f}, aten max_pool2d_with_indices_backward "
              f"{t['b_lib']:.4f}); y, code and dx bit-exact, dx = F.max_pool2d's gradient")
        sums = {k: sums[k] + t[k] for k in sums}
        moved["a"] += nbytes(x, y, code)  # x read, y and the code written
        moved["b"] += nbytes(dy, code, dx)  # dy and the code read, dx written
        del x, y, code, y_t, code_t, dy, dx, xr, idx
    out["maxpool2x2_code_nhwc"] = {
        "max_abs_err": 0.0, "ms": sums["a"], "graph_ms": sums["a_graph"],
        "plain_ms": sums["a_plain"], **bound(moved["a"]),
        "library_ms": sums["a_lib"], "library": "F.max_pool2d(x, 2, 2, return_indices=True)",
        "shapes": len(TRAIN_POOL_INPUTS)}
    out["maxpool2x2_bwd_nhwc"] = {
        "max_abs_err": 0.0, "ms": sums["b"], "graph_ms": sums["b_graph"],
        "plain_ms": sums["b_plain"], **bound(moved["b"]),
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
    kg_ms = graph_ms(lambda: K.ce_sum_weighted(logits, labels, weights))
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
    print(f"K3 ce_sum_weighted ({p}, {C}) bf16 + uint8 + fp32 weights: kernel {k_ms:.4f} ms "
          f"(graph {kg_ms:.4f}), "
          f"plain {p_ms:.4f} ms, F.cross_entropy(weight=cw, ignore_index=255) {l_ms:.4f} ms, "
          f"bound {bound(moved)['bound_ms']:.4f} ms ({moved} bytes); |diff| {err:.6g} of "
          f"{float(s_t):.9g} (rtol 1e-5), run-to-run identical")
    out["ce_sum_weighted"] = {"max_abs_err": err, "rel_err": err / abs(float(s_t)), "ms": k_ms,
                              "graph_ms": kg_ms,
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
        check(torch.equal(d_k, K.ce_grad(logits, labels, w_, grad_out, pps)),
              f"CE grad ({mode}) is not run-to-run identical")
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
                       cuda_ms(lambda: K.ce_grad_plain(logits, labels, w_, grad_out, pps)),
                       graph_ms(lambda: K.ce_grad(logits, labels, w_, grad_out, pps)))
        print(f"CE grad {mode} ({p}, {C}) bf16: kernel {times[mode][0]:.4f} ms (graph "
              f"{times[mode][2]:.4f}), plain "
              f"{times[mode][1]:.4f} ms, {ulps:.3g} bf16 ulp from the twin at most (bound: one "
              f"ulp + 2^-20 |w g|), exact zeros at zero weight")
        del d_k, d_t
    # per-sample, as timed: the masked-out sample's rows are neither read nor
    # their labels; every row's gradient is written
    live = int((mask != 0).sum()) * TH * TW
    moved = live * (C * logits.element_size() + labels.element_size()) + nbytes(
        mask, grad_out, logits)
    out["ce_grad"] = {"max_abs_err": worst["err"], "max_bf16_ulps": worst["ulps"],
                      "ms": times["per-sample"][0], "graph_ms": times["per-sample"][2],
                      "plain_ms": times["per-sample"][1],
                      **bound(moved), "library_ms": None, "library": "none",
                      "per_pixel_ms": times["per-pixel"][0],
                      "per_pixel_graph_ms": times["per-pixel"][2],
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


def phase_train_times(dev, model: FCN8s, smi: str) -> float:
    """The full-width train step at batch 8 x 1024x512, bf16, keep_prob 0.5;
    returns its host-clock ms."""
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
    return step_ms


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
    kb_graph = graph_ms(lambda: KB.conv1_core(x, inputs["w128"], inputs["w64"]))
    kb_bound = bound(nbytes(x, inputs["w128"], inputs["w64"], x),  # out is x's size
                     KB.kb_flops(*x.shape[:2]))
    del inputs, x
    torch.cuda.empty_cache()
    print(f"conv1 calibration on {smi}, x ({KB.CAL_TILES * KB.TH}, {KB.CAL_W}, {KB.C}) bf16, "
          f"{times['gflop']:.1f} GFLOP: KB {times['ms']:.4f} ms ({times['tflops']:.1f} TFLOP/s; "
          f"graph {kb_graph:.4f} ms, {times['gflop'] / kb_graph:.1f} TFLOP/s), "
          f"twin (fp32, TF32 off) {times['plain_ms']:.4f} ms ({times['plain_tflops']:.1f} "
          f"TFLOP/s), cuDNN conv1_2 + ReLU (8, 1024, 512, 64) bf16 {times['cudnn_ms']:.4f} ms "
          f"({times['cudnn_tflops']:.1f} TFLOP/s); KB vs twin max |diff| "
          f"{checked['max_abs_err']:.4g} of max |twin| {checked['max_abs_ref']:.4g}, every "
          f"element within 2^-7 |twin| + 2^-7; launches {counts['conv1_core']}")
    measured = {"max_abs_err": checked["max_abs_err"], "ms": times["ms"], "graph_ms": kb_graph,
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
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


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


# ---------------------------------------------------------------------------
# the training features: summaries, EMA, observers, device augmentation
# ---------------------------------------------------------------------------

FEATURE_SEED = 13
FEATURE_AUGMENT = {"flip": 0.5, "brightness": (0.8, 1.2, 0.5), "translate": (64, 32, 0.5),
                   "scale": (0.9, 1.1, 0.5), "void_class_id": 0}
FEATURE_OBSERVERS = {"reduce_lr_on_plateau": {"patience": 1, "min_delta": 10.0, "factor": 0.5},
                     "early_stopping": 3}
FEATURE_TRAIN = dict(learning_rate_schedule=lambda s: 1e-4, metrics={"loss", "mean_iou"},
                     eval_frequency=1, ema_decay=0.999, device_augment=FEATURE_AUGMENT,
                     **FEATURE_OBSERVERS)


def _cycle(batches):
    while True:
        yield from batches


def _event_tags(directory: str) -> tuple[dict, dict]:
    """{tag: [steps]} of the scalars and of the histograms in an event dir."""
    from tensorboard.backend.event_processing import event_accumulator as ea

    acc = ea.EventAccumulator(directory, size_guidance={ea.SCALARS: 0, ea.HISTOGRAMS: 0})
    acc.Reload()
    return ({t: [e.step for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]},
            {t: [e.step for e in acc.Histograms(t)] for t in acc.Tags()["histograms"]})


def _max_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| in fp32 ulps of the larger magnitude."""
    big = torch.maximum(a.abs(), b.abs())
    ulp = torch.nextafter(big, torch.full_like(big, math.inf)) - big
    return float(((a - b).abs() / ulp).max())


def _sync_callers(prof) -> dict:
    """{the ops enclosing a host sync, innermost first: count} of a trace."""
    callers = {}
    for e in prof.events():
        if e.name.startswith("cuda") and "Synchronize" in e.name:
            chain, parent = [], e.cpu_parent
            while parent is not None and len(chain) < 3:
                chain.append(parent.name)
                parent = parent.cpu_parent
            where = " < ".join(chain) or "top level"
            callers[where] = callers.get(where, 0) + 1
    return callers


def _augment_on_cpu(key, images: torch.Tensor, labels: torch.Tensor, dev):
    """The smoke's augment config as its apply functions on the CPU, fed the
    draws the card's generators make for ``key``."""
    n = images.shape[0]
    flip_cfg, (b_lo, b_hi, b_p) = FEATURE_AUGMENT["flip"], FEATURE_AUGMENT["brightness"]
    tx, ty, t_p = FEATURE_AUGMENT["translate"]
    s_lo, s_hi, s_p = FEATURE_AUGMENT["scale"]
    factor = A.draw_photometric(A.transform_generator(key, A.BRIGHTNESS, dev), n, b_lo, b_hi,
                                b_p, 1.0).cpu()
    flip = A.draw_flip(A.transform_generator(key, A.FLIP, dev), n, flip_cfg).cpu()
    dx, dy = A.draw_translate(A.transform_generator(key, A.TRANSLATE, dev), n, tx, ty, t_p)
    zoom = A.draw_scale(A.transform_generator(key, A.SCALE, dev), n, s_lo, s_hi, s_p).cpu()
    im = A.apply_brightness(images.cpu(), factor)
    im, lb = A.apply_flip(im, labels.cpu(), flip)
    return A.apply_translate_scale(im, lb, dx.cpu(), dy.cpu(), zoom,
                                   FEATURE_AUGMENT["void_class_id"])


def phase_training_features(dev, smi: str) -> dict:
    """``FCN8s.train`` at full width with every training feature on:
    summaries, the EMA, device augmentation and both observers; then
    ``use_ema`` inference, a save/resume that continues the EMA and the
    counters, the augmentation against its CPU run, and the features'
    times. Returns the launch counts of the train run and the use_ema calls."""
    rng = np.random.default_rng(12)
    batches = [_synthetic(rng, BATCH) for _ in range(3)]
    model = FCN8s(num_classes=C, device=dev, seed=FEATURE_SEED)
    root = tempfile.mkdtemp(prefix="fcn8s_features_")
    try:
        log, tb = os.path.join(root, "train_log.jsonl"), os.path.join(root, "tb")
        zero_counts()
        t0 = time.perf_counter()
        model.train(_cycle(batches), epochs=3, steps_per_epoch=3, keep_prob=0.5,
                    record_summaries=True, summaries_dir=tb, summaries_frequency=3,
                    train_log=log, **FEATURE_TRAIN)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        want = {"maxpool2x2_code_nhwc": 45, "maxpool2x2_bwd_nhwc": 45, "ce_sum_per_sample": 18,
                "ce_grad": 9, "ce_sum_weighted": 0, "maxpool2x2_nhwc": 45,
                "confusion_matrix_accumulate": 9, "conv1_core": 0}
        check(counts == want, f"the features' train launched {counts}, expected {want}")
        check(model.g_step == 9 and math.isfinite(model.training_loss),
              f"features' train: step {model.g_step}, loss {model.training_loss}")

        # the observer: min_delta 10 makes every eval after the first stale
        lrs = [json.loads(line)["learning_rate"] for line in open(log)]
        check(lrs == [1e-4, 1e-4, 5e-5], f"plateau LRs {lrs}, expected [1e-4, 1e-4, 5e-5]")
        obs = model._observer_state
        check(obs["lr_scale"] == 0.25 and obs["rp_stale"] == 0 and obs["es_stale"] <= 2,
              f"observer state {obs}")

        # both event streams hold the JAX facade's tags, at its steps
        scalars, hists = _event_tags(os.path.join(tb, "summaries_training"))
        weights = [f"{g}/{layer}/{p}" for g, layer in DEFAULT_INSTRUMENTED
                   for p in ("kernel", "bias")]
        want_scalars = {"total_loss", "learning_rate"} | {
            f"{w}/{s}" for w in weights for s in ("mean", "stddev", "min", "max")}
        check(set(scalars) == want_scalars and set(hists) == {f"{w}/histogram" for w in weights},
              f"training stream tags {sorted(set(scalars) ^ want_scalars)[:6]} differ")
        check(all(s == [3, 6, 9] for s in (*scalars.values(), *hists.values())),
              "training stream steps are not [3, 6, 9]")
        ev_scalars, _ = _event_tags(os.path.join(tb, "summaries_evaluation"))
        check(ev_scalars == {"loss": [3, 6, 9], "mean_iou": [3, 6, 9]},
              f"evaluation stream {ev_scalars}")

        # use_ema inference runs, on other weights than the live ones
        zero_counts()
        images = batches[0][0][:2]
        live = model.predict(images, argmax=False)
        averaged = model.predict(images, argmax=False, use_ema=True)
        check(np.isfinite(averaged).all() and not np.array_equal(live, averaged),
              "predict(use_ema=True) gave the live params' output")
        ev_live = model.evaluate(iter(batches), 3, metrics={"loss", "mean_iou"})
        ev_ema = model.evaluate(iter(batches), 3, metrics={"loss", "mean_iou"}, use_ema=True)
        check(all(math.isfinite(v) for v in ev_ema.values()) and ev_ema != ev_live,
              f"evaluate(use_ema=True) {ev_ema} vs live {ev_live}")
        ema_counts = read_counts()
        for name in ("maxpool2x2_nhwc", "ce_sum_per_sample", "confusion_matrix_accumulate"):
            check(ema_counts[name] > 0, f"{name} was not launched by use_ema inference")
        del live, averaged

        # save, resume, one more step: the EMA and the counters continue as
        # in the uninterrupted run (keep_prob 1, deterministic cuDNN)
        det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        ckpts, one = os.path.join(root, "ckpt"), [batches[1]]
        model.train(_cycle(one), epochs=2, steps_per_epoch=1, keep_prob=1.0,
                    record_summaries=False, save_during_training=True, save_dir=ckpts,
                    save_best_only=False, save_frequency=1, **FEATURE_TRAIN)
        first = next(os.path.join(ckpts, d) for d in os.listdir(ckpts) if "(globalstep-10)" in d)
        resumed = FCN8s(model_load_dir=first, device=dev, seed=FEATURE_SEED)
        resumed.train(_cycle(one), epochs=1, steps_per_epoch=1, keep_prob=1.0,
                      record_summaries=False, **FEATURE_TRAIN)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        check(resumed.g_step == model.g_step == 11, f"steps {resumed.g_step} vs {model.g_step}")
        check(resumed._observer_state == model._observer_state,
              f"counters {resumed._observer_state} vs {model._observer_state}")
        ema_a = _by_path(resumed.ema_params, bridge.param_leaves(resumed.ema_params))
        ema_b = _by_path(model.ema_params, bridge.param_leaves(model.ema_params))
        ema_ulps = max(_max_ulps(ema_a[k], ema_b[k]) for k in ema_b)
        check(ema_ulps <= 1.0, f"the resumed EMA differs by {ema_ulps} ulp")
        resumed.close()
        del resumed
        torch.cuda.empty_cache()

        # the augmented batch against the apply functions on the CPU
        im, lb = (torch.from_numpy(x).to(dev) for x in batches[2])
        key = S.augment_key(FEATURE_SEED, 0)
        fn = model._augment_fn
        aug_im, aug_lb = fn(key, im, lb)
        cpu_im, cpu_lb = _augment_on_cpu(key, im, lb, dev)
        check(torch.equal(aug_lb.cpu(), cpu_lb), "augmented labels differ from the CPU run")
        lsb = int((aug_im.cpu().int() - cpu_im.int()).abs().max())
        check(lsb <= 1, f"augmented images differ from the CPU run by {lsb} LSB")
        moved_px = float((aug_lb != lb).float().mean())

        # times
        mask = torch.ones(BATCH, device=dev)
        state, opt = model.state, model.optimizer

        def plain():
            S.train_step(state, im, lb, mask, FEATURE_SEED, 1e-4, 0.0, 0.5, optimizer=opt,
                         num_classes=C)

        def featured():
            S.train_step(state, im, lb, mask, FEATURE_SEED, 1e-4, 0.0, 0.5, optimizer=opt,
                         num_classes=C, augment_fn=fn)
            model._update_ema(0.999)

        turns = [host_ms(f) for f in (plain, featured, featured, plain)]
        ema_ms = cuda_ms(lambda: model._update_ema(0.999))
        param_bytes = nbytes(*bridge.param_leaves(model.params))
        ema_bound = bound(3 * param_bytes)["bound_ms"]
        aug_ms = cuda_ms(lambda: fn(key, im, lb))
        aug_bound = bound(2 * nbytes(im, lb))["bound_ms"]
        logger = SummaryLogger(os.path.join(root, "timing"))
        summ_ms = host_ms(lambda: logger.log_weight_summaries(9, model.params), reps=3, warmup=1)
        pulled = sum(4 * (4 + summary_stats(bridge.leaf_to_jax(t, p))[1].size)
                     for p, t in zip(bridge.jax_leaf_paths(model.params),
                                     bridge.param_leaves(model.params))
                     if tuple(p.split("/")[:2]) in DEFAULT_INSTRUMENTED)
        logger.close()
        with trace(os.path.join(root, "trace")) as prof:
            for _ in range(5):
                featured()
            torch.cuda.synchronize()
        busy = device_busy(prof)
        share = "not read (the trace holds no device events)" if busy["share"] is None else (
            f"{busy['share']:.4f} ({busy['busy_us'] / 1e3:.2f} of {busy['window_us'] / 1e3:.2f} "
            f"ms, {busy['device_events']} device events, {busy['host_syncs']} host syncs, "
            f"under {_sync_callers(prof)})")
        print(f"training features at full width, 3 epochs x 3 steps of ({BATCH}, {TH}, {TW}, 3) "
              f"bf16 keep_prob 0.5 with summaries, ema_decay 0.999, device augment "
              f"{FEATURE_AUGMENT}, plateau + early stopping, eval each epoch: {seconds:.2f} s; "
              f"train log LRs {lrs}; observer {obs}; launches {counts}, use_ema inference "
              f"{ema_counts}; both event streams hold the JAX tags at steps 3, 6, 9; use_ema "
              f"predict/evaluate differ from live (eval {ev_ema} vs {ev_live}); save at step 10 + "
              f"resume + 1 step = uninterrupted: counters equal, EMA within {ema_ulps} ulp; "
              f"augment = CPU apply on the card's draws (labels exact, images within {lsb} LSB; "
              f"{moved_px:.4f} of labels moved)")
        print(f"training features times on {smi}: full step with augment + EMA "
              f"{turns[1]:.2f}, {turns[2]:.2f} ms vs plain step {turns[0]:.2f}, {turns[3]:.2f} ms "
              f"(host clock, median of 5, turns plain/features/features/plain); EMA update "
              f"{ema_ms:.4f} ms (CUDA events; bound {ema_bound:.4f} ms = 3 x {param_bytes} bytes "
              f"at 3.35 TB/s, the two foreach passes move 5 x); augment {aug_ms:.4f} ms (bound "
              f"{aug_bound:.4f} ms); per-epoch weight summaries {summ_ms:.2f} ms (host clock, "
              f"median of 3), {pulled} bytes pulled to the host; device busy share over 5 "
              f"featured train steps (utils.profiling.trace): {share}")
        model.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {k: counts[k] + ema_counts[k] for k in counts}


# ---------------------------------------------------------------------------
# the rest of predict: int8 serving, TTA, tiled inference, the service
# ---------------------------------------------------------------------------

EARLY = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")  # the twin checks batch 1 here
INT8_LAYERS = [name for name, _, _ in VGG16_CONV_LAYERS] + ["fc6", "fc7"]
FRAME = (1024, 2048)  # Cityscapes' full frame, for the tiled predict
TILE, TILE_OVERLAP = (512, 512), 128
TTA_SCALES = (0.75, 1.0, 1.25)
# The resize is mirror-symmetric only to fp32 rounding (~5e-6), and the bf16
# forward of a view turns that into input values a bf16 ulp apart: the
# mirror's probabilities then differ by up to ~0.008 at 1/32 width on the CPU
MIRROR_MARGIN = 0.05


def _k4f_window(fn):
    """``fn()``'s result and the K4f launches it made."""
    before = maxpool2x2_nhwc.launches
    out = fn()
    return out, maxpool2x2_nhwc.launches - before


def phase_int8_route(model: FCN8s, images: np.ndarray, dev) -> list[dict]:
    """(a) The quantized encoder layer by layer on ``images`` (dynamic
    scales): at every layer the route's int32 accumulators equal the fp64
    twin's on the same int8 input, and ``conv2d_int8``'s bf16 output equals
    the twin's accumulators dequantized alike; then the route, the whole
    int8 conv and the bf16 cuDNN conv are timed. Returns the library-route
    rows."""
    q = model._quantized_params()["encoder_q"]
    run = model._run_params["encoder"]
    rows = []
    with torch.inference_mode():
        x = torch.from_numpy(images).to(dev).float() - torch.tensor(VGG_MEAN_RGB, device=dev)
        x = nchw(x.to(torch.bfloat16).contiguous())
        for name in INT8_LAYERS:
            layer = q[name]
            xq, scale = Q.quantize_activation(x)
            xn = nhwc(xq)
            acc = Q.conv2d_int8_im2col(xn, layer["kernel_q"], layer["kernel_mat"])
            sub = 1 if name in EARLY else xn.shape[0]
            twin = Q.conv2d_int8_reference(xn[:sub], layer["kernel_q"])
            check(torch.equal(acc[:sub], twin), f"int8 route differs from its twin at {name}")
            out = Q.conv2d_int8(x, layer)
            ref = torch.addcmul(layer["bias"], twin.float(), scale * layer["scale"]).to(
                torch.bfloat16)
            check(torch.equal(nhwc(out)[:sub], ref), f"int8 dequant differs at {name}")
            del twin, ref
            m, o = acc.shape[0] * acc.shape[1] * acc.shape[2], acc.shape[3]
            k = layer["kernel_q"][0].numel()
            b = bound(nbytes(xq, layer["kernel_mat"], acc), 2.0 * m * k * o, INT8_OPS_PER_S)
            del acc
            w, bias = run[name]["weight"], run[name]["bias"]
            t = {"route_ms": cuda_ms(lambda: Q.conv2d_int8_im2col(xn, layer["kernel_q"],
                                                                  layer["kernel_mat"]),
                                     reps=3, n=5, warmup=1),
                 "int8_conv_ms": cuda_ms(lambda: Q.conv2d_int8(x, layer), reps=3, n=5, warmup=1),
                 "bf16_conv_ms": cuda_ms(lambda: conv2d(x, w, bias), reps=3, n=5, warmup=1)}
            if name == "fc6":  # batch 1 too: bf16's batch-8 fc6 sits on a cuDNN cliff
                x1 = x[:1]
                t["int8_conv_b1_ms"] = cuda_ms(lambda: Q.conv2d_int8(x1, layer), reps=3, n=5)
                t["bf16_conv_b1_ms"] = cuda_ms(lambda: conv2d(x1, w, bias), reps=3, n=5)
            rows.append({"name": "conv2d_int8_im2col", "layer": name,
                         "gemm": [m, k, o], "twin_batch": sub, **t, **b,
                         "share": b["bound_ms"] / t["route_ms"]})
            del xq, xn
            x = torch.relu_(out)
            if name in BLOCK_ENDS:
                x = maxpool2x2_nhwc(x)
        del x, out
    torch.cuda.empty_cache()
    return rows


def _twin_route(fn):
    """``fn()`` with every int8 conv on the fp64 twin (on the card)."""
    route = Q.int8_conv_acc
    Q.int8_conv_acc = lambda xq, qlayer, halo=False: Q.conv2d_int8_reference(
        xq, qlayer["kernel_q"], halo)
    try:
        return fn()
    finally:
        Q.int8_conv_acc = route


def phase_int8_predict(model: FCN8s, images: np.ndarray, rng, smi: str) -> dict:
    """(b) ``predict(quantized=True)`` at 8 x 512x1024, dynamic, then after
    ``calibrate_quantization`` on 16 images (static). Returns the K4f
    launches of the checked calls and the measurements."""
    launches, out = 0, {}
    bf16_ids = model.predict(images)
    for mode in ("dynamic", "static"):
        if mode == "static":
            calib = rng.integers(0, 256, (16, H, W, 3), dtype=np.uint8)
            absmax = model.calibrate_quantization(calib, batch_size=8)
            check(set(absmax) == set(INT8_LAYERS) and all(
                math.isfinite(float(v)) and float(v) > 0 for v in absmax.values()),
                "calibrate_quantization gave no positive absmax per layer")
            check("act_scale" in model._quantized_params()["encoder_q"]["fc7"],
                  "the calibrated scales are not in the int8 tree")
        routes = Q.conv2d_int8_im2col.launches
        ids, k4f = _k4f_window(lambda: model.predict(images, quantized=True))
        routes = Q.conv2d_int8_im2col.launches - routes
        launches += k4f
        check(k4f == 5 and routes == 15, f"int8 predict launched K4f {k4f}, the route {routes}")
        check(ids.shape == (BATCH, H, W) and ids.dtype == np.int32 and 0 <= ids.min()
              and ids.max() < C, "int8 predict ids")
        twin = _twin_route(lambda: model.predict(images, quantized=True))
        agree_twin = float((ids == twin).mean())
        check(agree_twin >= 0.999, f"{mode} int8 ids agree with the twin path on {agree_twin}")
        out[mode] = {"agree_twin": agree_twin, "agree_bf16": float((ids == bf16_ids).mean())}
        del twin
        for b in (8, 1):
            out[mode][f"ms_b{b}"] = host_ms(lambda: model.predict(images[:b], quantized=True))
        torch.cuda.reset_peak_memory_stats()
        model.predict(images, quantized=True)
        out[mode]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["bf16"] = {f"ms_b{b}": host_ms(lambda: model.predict(images[:b])) for b in (8, 1)}
    torch.cuda.reset_peak_memory_stats()
    model.predict(images)
    out["bf16"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"int8 predict at full width, ({BATCH}, {H}, {W}, 3), on {smi}: " + "; ".join(
        f"{m}: {v}" for m, v in out.items()) + " (ms: host clock, median of 5, H2D + D2H in; "
        "agree_twin: ids equal to the int8 path on its fp64 twin on the card; agree_bf16: to "
        "bf16 predict, random-init weights, no threshold); K4f 5 and the route 15 launches a "
        "dispatch")
    return {"launches": launches, **out}


def phase_tta(model: FCN8s, images: np.ndarray, smi: str) -> dict:
    """(c) ``predict_tta`` at 8 x 512x1024 with three scales and the flip."""
    launches = 0
    probs, k4f = _k4f_window(lambda: model.predict_tta(images, scales=TTA_SCALES, argmax=False))
    launches += k4f
    check(k4f == 5 * len(TTA_SCALES), f"TTA launched K4f {k4f} times")
    check(probs.shape == (BATCH, H, W, C) and probs.dtype == np.float32
          and float(np.abs(probs.sum(-1) - 1).max()) <= 1e-5 and probs.min() >= 0,
          "TTA probabilities are no distribution")
    ids = probs.argmax(-1)
    top2 = np.sort(probs, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MIRROR_MARGIN
    del top2
    mirrored, k4f = _k4f_window(lambda: model.predict_tta(images[:, :, ::-1], scales=TTA_SCALES,
                                                          argmax=False))
    launches += k4f
    mirrored = mirrored[:, :, ::-1]
    mirror_dev = float(np.abs(mirrored - probs).max())
    mirrored = mirrored.argmax(-1)
    del probs
    check(np.array_equal(mirrored[clear], ids[clear]),
          f"the mirrored input's TTA ids are not the mirrored ids where the margin > "
          f"{MIRROR_MARGIN}")
    flip_agree = float((mirrored == ids).mean())
    # the identity view is predict's softmax; its ids (the argmax of fp32
    # probabilities) are predict's (the packed argmax of bf16 logits) wherever
    # the top two are clearly apart
    identity, k4f = _k4f_window(lambda: model.predict_tta(images, scales=(1.0,), flip=False,
                                                          argmax=False))
    launches += k4f
    check(np.array_equal(identity, model.predict(images, argmax=False)),
          "predict_tta(scales=(1.0,), flip=False) differs from predict's softmax")
    top2 = np.sort(identity, axis=-1)[..., -2:]
    clear_id = (top2[..., 1] - top2[..., 0]) > 1e-3
    identity_ids, predict_ids = identity.argmax(-1), model.predict(images)
    del identity, top2
    check(np.array_equal(identity_ids[clear_id], predict_ids[clear_id]),
          "predict_tta(scales=(1.0,), flip=False) ids differ from predict's where the margin "
          "is clear")
    identity_agree = float((identity_ids == predict_ids).mean())
    t0 = time.perf_counter()
    q_ids, k4f = _k4f_window(lambda: model.predict_tta(images, scales=TTA_SCALES,
                                                       quantized=True))
    q_ms = (time.perf_counter() - t0) * 1e3
    launches += k4f
    check(q_ids.shape == (BATCH, H, W) and 0 <= q_ids.min() and q_ids.max() < C,
          "quantized TTA ids")
    ms = host_ms(lambda: model.predict_tta(images, scales=TTA_SCALES), reps=3, warmup=1)
    out = {"launches": launches, "ms": ms, "quantized_ms_once": q_ms,
           "clear_share": float(clear.mean()), "mirror_agree": flip_agree,
           "mirror_max_prob_dev": mirror_dev, "identity_vs_predict_agree": identity_agree,
           "int8_vs_bf16_agree": float((q_ids == ids).mean())}
    print(f"predict_tta at full width, ({BATCH}, {H}, {W}, 3), scales {TTA_SCALES} + flip, on "
          f"{smi}: {out} (ms: host clock, median of 3; the quantized call once, static scales); "
          f"probabilities sum to 1 within 1e-5; the identity view = predict's softmax, its ids "
          f"= predict's where the top-2 margin > 1e-3; the mirror's ids = the mirrored ids "
          f"where it is > {MIRROR_MARGIN} (clear_share)")
    return out


def phase_tiled(model: FCN8s, rng, smi: str) -> dict:
    """(d) One 1024x2048 frame in (512, 512) tiles, overlap 128."""
    frame = rng.integers(0, 256, (1, *FRAME, 3), dtype=np.uint8)
    kw = dict(tile=TILE, tile_overlap=TILE_OVERLAP)
    launches = 0
    hard, k4f = _k4f_window(lambda: model.predict(frame, **kw))
    launches += k4f
    rows = model._tile_grid(FRAME[0], TILE[0], TILE_OVERLAP)
    cols = model._tile_grid(FRAME[1], TILE[1], TILE_OVERLAP)
    grid = [(r, c) for r in rows for c in cols]
    tiles = np.concatenate([frame[:, ys:ys + TILE[0], xs:xs + TILE[1]]
                            for (ys, _, _), (xs, _, _) in grid])
    check(k4f == 5 * math.ceil(len(grid) / 8), f"tiled predict launched K4f {k4f} times")
    parts = np.concatenate([model.predict(tiles[i:i + 8]) for i in range(0, len(tiles), 8)])
    composed = np.zeros((1, *FRAME), np.int32)
    coverage = np.zeros(FRAME, np.int32)
    for i, ((ys, ylo, yhi), (xs, xlo, xhi)) in enumerate(grid):
        composed[:, ys + ylo:ys + yhi, xs + xlo:xs + xhi] = parts[i:i + 1, ylo:yhi, xlo:xhi]
        coverage[ys:ys + TILE[0], xs:xs + TILE[1]] += 1
    check(np.array_equal(hard, composed), "the hard paste differs from its host composition")
    hard_p, k4f = _k4f_window(lambda: model.predict(frame, argmax=False, **kw))
    launches += k4f
    blend_p, k4f = _k4f_window(lambda: model.predict(frame, argmax=False, tile_blend=True, **kw))
    launches += k4f
    check(float(np.abs(blend_p.sum(-1) - 1).max()) <= 1e-5, "blended probabilities")
    lone = coverage == 1
    check(np.allclose(blend_p[0][lone], hard_p[0][lone], rtol=2.0 ** -22, atol=0),
          "the blend differs from the lone tile where one covers a pixel")
    full = model.predict(frame)
    out = {"launches": launches, "tiles": len(grid), "lone_share": float(lone.mean()),
           "hard_vs_full_agree": float((hard == full).mean()),
           "blend_vs_full_agree": float((blend_p.argmax(-1) == full).mean()),
           "tiled_ms": host_ms(lambda: model.predict(frame, **kw), reps=3, warmup=1),
           "blend_ms": host_ms(lambda: model.predict(frame, tile_blend=True, **kw), reps=3,
                               warmup=1),
           "full_ms": host_ms(lambda: model.predict(frame), reps=3, warmup=1)}
    print(f"tiled predict of one {FRAME[0]}x{FRAME[1]} frame, tiles {TILE}, overlap "
          f"{TILE_OVERLAP}, on {smi}: {out} (ms: host clock, median of 3); hard paste = host "
          f"composition of the tiles' predict, blend sums to 1 and = the lone tile where one "
          f"covers a pixel")
    return out


def phase_int8_tiled_service(model: FCN8s, rng) -> int:
    """(e) The HTTP service with ``quantized=True, tile=(512, 512)``;
    returns its K4f launches."""
    service = InferenceService(model, color_map=TRAINIDS_TO_RGBA_DICT, quantized=True, tile=TILE)
    srv = make_server(service, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % srv.server_address[1]
    frame = rng.integers(0, 256, (*FRAME, 3), dtype=np.uint8)
    k4f = maxpool2x2_nhwc.launches
    try:
        status, body = _post(base + "/predict", _png(frame))
        check(status == 200, f"/predict of the int8 tiled service gave {status}")
        ids = _decode(body)
        status, body = _post(base + "/overlay", _png(frame[:H, :W]))
        check(status == 200 and _decode(body).shape == (H, W, 3),
              "/overlay of the int8 tiled service")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        service.close()
        thread.join(timeout=60)
    k4f = maxpool2x2_nhwc.launches - k4f
    check(health["quantized"] is True and health["tile"] == list(TILE), f"/healthz {health}")
    want = model.predict(frame[None], quantized=True, tile=TILE)[0]
    check(np.array_equal(ids, want), "/predict differs from predict(quantized=True, tile=...)")
    print(f"int8 tiled service: /predict {FRAME[0]}x{FRAME[1]} = predict(quantized=True, "
          f"tile={TILE}), /overlay {H}x{W}, /healthz {health['quantized']}, {health['tile']}; "
          f"K4f {k4f} launches")
    return k4f


def _redraw_decoder(model: FCN8s, rng) -> None:
    """Redraw the decoder's kernels at unit fan-in scale (biases at 0.1),
    as tests/test_torch_model.py's ``_tree`` does: the fresh init's 1e-3
    sigma leaves every pixel's top two classes within rounding of each
    other, and the margin checks below nothing to hold."""
    tree = bridge.to_numpy({"decoder": model.params["decoder"]})
    for layer in tree["decoder"].values():
        k = layer["kernel"]
        layer["kernel"] = (rng.normal(size=k.shape) / np.sqrt(np.prod(k.shape[:-1]))).astype(
            np.float32)
        layer["bias"] = rng.normal(size=layer["bias"].shape).astype(np.float32) * 0.1
    drawn = bridge.to_port(tree)["decoder"]
    with torch.no_grad():
        for name, layer in model.params["decoder"].items():
            for key, t in layer.items():
                t.copy_(drawn[name][key])
    model._refresh_run_params()


def phase_predict_rest(dev, smi: str) -> tuple[dict, list]:
    """Phase 17 on a fresh full-width model with a redrawn decoder. Returns
    (the launch counts of b-e, the library-route rows)."""
    model = FCN8s(num_classes=C, device=dev, seed=17)
    rng = np.random.default_rng(17)
    _redraw_decoder(model, rng)
    images = rng.integers(0, 256, (BATCH, H, W, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    rows = phase_int8_route(model, images, dev)
    print(f"int8 conv route per layer at ({BATCH}, {H}, {W}) on {smi}, exact against the fp64 "
          f"twin: " + "; ".join(
              f"{r['layer']} {r['route_ms']:.3f} ms (int8 conv {r['int8_conv_ms']:.3f}, bf16 "
              f"{r['bf16_conv_ms']:.3f}; bound {r['bound_ms']:.3f} {r['bound_by']})" for r in rows))
    zero_counts()
    Q.conv2d_int8_im2col.launches = 0
    measured = {"int8": phase_int8_predict(model, images, rng, smi),
                "tta": phase_tta(model, images, smi),
                "tiled": phase_tiled(model, rng, smi)}
    service_k4f = phase_int8_tiled_service(model, rng)
    counts = read_counts()
    route_launches = Q.conv2d_int8_im2col.launches
    paths = {"int8 predict": measured["int8"]["launches"], "tta": measured["tta"]["launches"],
             "tiled": measured["tiled"]["launches"], "service": service_k4f}
    for path, k4f in paths.items():
        check(k4f > 0, f"K4f was never launched on the {path} path")
    check(route_launches > 0, "the int8 route was never launched")
    print(f"phase 17 launches: K4f per path {paths}, all kernels {counts}, int8 route "
          f"{route_launches}; {time.perf_counter() - t0:.1f} s")
    model.close()
    del model
    torch.cuda.empty_cache()
    return counts, [{**r, "launches": route_launches} for r in rows]


# phase 18: the rest of the facade
SUMMARY_HW, SUMMARY_BATCH = (1024, 512), 8
# The JAX package's utils/summary.py totals for the full-width 20-class fcn8s at
# 8 x 1024x512, computed on the CPU from the shapes of its init_fcn8s
# (jax.eval_shape); tests/test_torch_facade_rest.py holds them equal to it
SUMMARY_TOTALS = {"params": 134473144, "macs": 1780160135168, "act_bytes": 2506522624}
SWEEP = dict(steps=20, min_lr=1e-7, max_lr=1.0, keep_prob=1.0)
SAVE_IMAGES = 24  # 512x1024 PNGs through predict_and_save, in chunks of BATCH
BENCH_CITIES, BENCH_FRAMES = ("aachen", "bonn"), 4  # a 1024x2048 Cityscapes-layout split
NUM_LABEL_IDS = 34  # the scorer's labelId matrix side (ids 0..33)


def _state_snapshot(model: FCN8s) -> dict:
    """Clones, on the card, of what a sweep may touch."""
    opt = model.state.opt_state
    return {"params": [t.detach().clone() for t in bridge.param_leaves(model.params)],
            "step": model.state.step,
            "opt": None if opt is None else (M._opt_scalars(opt),
                                             [t.clone() for t in M._opt_tensors(opt)])}


def _check_restored(model: FCN8s, snap: dict, what: str) -> None:
    check(model.state.step == snap["step"], f"{what}: the step moved")
    check(all(torch.equal(a, b) for a, b in zip(bridge.param_leaves(model.params),
                                                snap["params"])), f"{what}: the params moved")
    opt = model.state.opt_state
    if snap["opt"] is None:
        check(opt is None, f"{what}: the optimizer state is not None again")
        return
    scalars, tensors = snap["opt"]
    check(M._opt_scalars(opt) == scalars, f"{what}: the optimizer counters moved")
    check(all(torch.equal(a, b) for a, b in zip(M._opt_tensors(opt), tensors)),
          f"{what}: Adam's moments moved")


def phase_summary(model: FCN8s, dev) -> None:
    """(a) ``summary()`` at 8 x 1024x512: the JAX package's totals, no device work."""
    mem = torch.cuda.memory_allocated(dev)
    zero_counts()
    t0 = time.perf_counter()
    text = model.summary(SUMMARY_HW, SUMMARY_BATCH)
    ms = (time.perf_counter() - t0) * 1e3
    rows = model_summary_rows(model.params, SUMMARY_HW, SUMMARY_BATCH)
    totals = {key: sum(r[key] for r in rows) for key in SUMMARY_TOTALS}
    check(totals == SUMMARY_TOTALS, f"summary totals {totals}, the JAX package's {SUMMARY_TOTALS}")
    check(f"params {SUMMARY_TOTALS['params']:,} " in text, "summary text lacks the param total")
    check(torch.cuda.memory_allocated(dev) == mem and not any(read_counts().values()),
          "summary did device work")
    print(f"summary({SUMMARY_HW}, batch={SUMMARY_BATCH}) in {ms:.2f} ms (host, no device work): "
          f"{len(rows)} layers, {totals} = the JAX package's; " + text.splitlines()[-1])


def _allocated(dev) -> tuple[int, int, int]:
    """Bytes requested by the live allocations on the card, their number,
    and the bytes of the allocator's blocks that hold them, after
    collecting tensors of earlier phases held in reference cycles and
    dropping the cuBLAS workspaces PyTorch keeps per handle and stream. The
    requested bytes are the tensors' own; the block bytes also count the
    up-to-1-MB tail the allocator leaves unsplit in a large block, which
    moves when a tensor is made again elsewhere (the sweep rebuilds the
    compute-dtype params), so they are printed but not held to a bound."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    stats = torch.cuda.memory_stats(dev)
    return (stats["requested_bytes.all.current"], stats["allocation.all.current"],
            stats["allocated_bytes.all.current"])


def phase_lr_sweep(model: FCN8s, dev, smi: str) -> tuple[dict, dict]:
    """(b) ``find_learning_rate`` at 8 x 1024x512, on the fresh model
    (``opt_state`` None) and after two ``train`` steps: everything restored
    bit for bit, memory back within 1 MB, ``predict`` unchanged (each after
    a 2-step warm-up sweep, which must restore too). Returns
    (the launch counts of both sweeps, the measurements)."""
    rng = np.random.default_rng(182)
    images, labels = _synthetic(rng, BATCH)
    probe = rng.integers(0, 256, (BATCH, H, W, 3), dtype=np.uint8)

    def stream():
        while True:
            yield images, labels

    total, out = dict.fromkeys(WRAPPERS, 0), {}
    for when in ("fresh", "after 2 train steps"):
        if when != "fresh":
            model.train(stream(), epochs=1, steps_per_epoch=2, learning_rate_schedule=lambda s: 1e-4,
                        keep_prob=0.5, record_summaries=False)
        check((model.state.opt_state is None) == (when == "fresh"), f"{when}: opt_state")
        snap = _state_snapshot(model)
        ids = model.predict(probe)
        # a short sweep first: what the libraries under the step keep once
        # made (handles, workspaces) is then made before the reading
        model.find_learning_rate(stream(), **{**SWEEP, "steps": 2})
        mem, allocs, blocks = _allocated(dev)
        zero_counts()
        t0 = time.perf_counter()
        result = model.find_learning_rate(stream(), **SWEEP)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        mem_after, allocs_after, blocks_after = _allocated(dev)
        drift = mem_after - mem
        check(abs(drift) <= 2**20, f"{when}: device memory moved by {drift} bytes "
                                   f"({allocs_after - allocs} allocations, blocks "
                                   f"{blocks_after - blocks} bytes) over the sweep")
        _check_restored(model, snap, f"sweep ({when})")
        check(np.array_equal(model.predict(probe), ids), f"{when}: predict differs after the sweep")
        for name in ("maxpool2x2_code_nhwc", "maxpool2x2_bwd_nhwc", "ce_sum_per_sample", "ce_grad"):
            check(counts[name] > 0, f"the sweep ({when}) never launched {name}")
        steps = len(result["losses"])
        out[when] = {"steps": steps, "ms_per_step": seconds * 1e3 / steps,
                     "first_loss": result["losses"][0], "last_loss": result["losses"][-1],
                     "suggestion": result["suggestion"], "memory_drift_bytes": drift,
                     "allocation_drift": allocs_after - allocs,
                     "block_bytes_drift": blocks_after - blocks}
        total = {k: total[k] + counts[k] for k in total}
        del snap
    im, lb = torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev)
    mask = torch.ones(BATCH, device=dev)
    out["plain_step_ms"] = host_ms(lambda: float(S.train_step(
        model.state, im, lb, mask, 0, 1e-7, 0.0, 1.0, optimizer=model.optimizer,
        num_classes=C)[1]))
    model._refresh_run_params()  # the plain steps moved the masters
    print(f"find_learning_rate at full width, ({BATCH}, {TH}, {TW}, 3), {SWEEP}, on {smi}: {out} "
          f"(ms_per_step: host clock over the sweep, H2D and the loss read-back in; "
          f"plain_step_ms: train_step on device tensors + the loss read-back, median of 5); "
          f"params, moments, counters and step bit-equal after each sweep, opt_state None again "
          f"on the fresh model, predict unchanged; launches {total}")
    return total, out


def _decode_dir(directory: str) -> dict:
    return {name: np.asarray(Image.open(os.path.join(directory, name)))
            for name in sorted(os.listdir(directory)) if name.endswith(".png")}


def phase_predict_and_save(model: FCN8s, root: str, smi: str) -> tuple[dict, dict]:
    """(c) ``predict_and_save`` over 24 512x1024 PNGs (batch 8): on-device
    overlay, host compositor beside the image, labelIds; and two 1024x2048
    frames in (512, 512) tiles. Returns (launch counts, measurements)."""
    rng = np.random.default_rng(183)
    src = os.path.join(root, "images")
    os.makedirs(src)
    images = rng.integers(0, 256, (SAVE_IMAGES, H, W, 3), dtype=np.uint8)
    for i, image in enumerate(images):
        Image.fromarray(image).save(os.path.join(src, f"frame_{i:03d}.png"), compress_level=1)
    runs = {"overlay, on the card": dict(color_map=TRAINIDS_TO_RGBA_DICT),
            "overlay, host compositor + image": dict(color_map=TRAINIDS_TO_RGBA_DICT,
                                                     on_device_overlay=False,
                                                     include_unprocessed_image=True),
            "labelIds": dict(output_format="ids", id_map=TRAINIDS_TO_IDS_ARRAY)}
    out, saved = {}, {}
    zero_counts()
    for name, kw in runs.items():
        target = os.path.join(root, name.split(",")[0] + str(len(saved)))
        model.predict_and_save(target, src, batch_size=BATCH, verbose=False, **kw)
        t = model.predict_and_save_timings
        out[name] = {"images_per_s": t["images"] / t["seconds"],
                     **{k: v for k, v in t.items() if k != "images"}}
        saved[name] = _decode_dir(target)
    frames = rng.integers(0, 256, (2, *FRAME, 3), dtype=np.uint8)
    big = os.path.join(root, "frames")
    os.makedirs(big)
    for i, frame in enumerate(frames):
        Image.fromarray(frame).save(os.path.join(big, f"big_{i}.png"), compress_level=1)
    model.predict_and_save(os.path.join(root, "tiled"), big, output_format="ids",
                           id_map=TRAINIDS_TO_IDS_ARRAY, tile=TILE, tile_overlap=TILE_OVERLAP,
                           batch_size=BATCH, verbose=False)
    t = model.predict_and_save_timings
    out["labelIds, tiled 1024x2048"] = {"images_per_s": t["images"] / t["seconds"],
                                        **{k: v for k, v in t.items() if k != "images"}}
    counts = read_counts()
    check(counts["maxpool2x2_nhwc"] > 0, "predict_and_save never launched K4f")

    want = np.concatenate([model.predict(images[i:i + BATCH])
                           for i in range(0, SAVE_IMAGES, BATCH)])
    got = np.stack(list(saved["labelIds"].values()))
    check(got.dtype == np.uint8 and got.shape == want.shape, "labelId PNGs' dtype or shape")
    agree = float((got == TRAINIDS_TO_IDS_ARRAY[want]).mean())
    check(agree >= 0.999, f"labelId PNGs equal id_map[predict] on {agree} of pixels")
    tiled = np.stack(list(_decode_dir(os.path.join(root, "tiled")).values()))
    tiled_agree = float((tiled == TRAINIDS_TO_IDS_ARRAY[model.predict(frames, tile=TILE,
                                                                      tile_overlap=TILE_OVERLAP)]
                         ).mean())
    check(tiled_agree >= 0.999, f"tiled labelId PNGs equal id_map[predict] on {tiled_agree}")
    device_ov = np.stack(list(saved["overlay, on the card"].values()))
    split = np.stack(list(saved["overlay, host compositor + image"].values()))
    check(split.shape == (SAVE_IMAGES, 2 * H, W, 3) and np.array_equal(split[:, H:], images),
          "the split view's lower half is not the image")
    same_ids = got == TRAINIDS_TO_IDS_ARRAY[want]
    diff = np.abs(device_ov.astype(np.int16) - split[:, :H])[same_ids]
    check(int(diff.max()) <= 1, f"on-card and host overlays differ by {int(diff.max())} LSB")
    out["checks"] = {"ids_agree": agree, "tiled_ids_agree": tiled_agree,
                     "overlay_exact_share": float((diff == 0).mean())}
    print(f"predict_and_save at full width, {SAVE_IMAGES} x ({H}, {W}) PNGs, batch {BATCH}, and "
          f"2 x {FRAME} in {TILE} tiles, on {smi}: {out} (seconds, host clock: decode and encode "
          f"summed over their 4-thread pools, decode_wait/encode_wait the caller's waits, "
          f"dispatch = pad + H2D + launch, d2h = the copy back with the wait for the card; "
          f"overlay_exact_share: on-card overlay = host compositor, else 1 LSB, where the ids "
          f"agree); launches {counts}")
    return counts, out


def _benchmark_split(root: str, rng) -> tuple[str, list]:
    """Two cities x 4 Cityscapes-size frames: labelId GT over every evaluated
    class and void in 8 x 16 blocks (128x128 px), 12 car and person
    instances (ids > 1000) in instanceIds. Returns (dataset dir, [(gt path,
    gt labelIds)])."""
    ds = os.path.join(root, "cityscapes")
    evaluated = [l.id for l in CS_LABELS if l.id >= 0 and not l.ignoreInEval]
    void = [l.id for l in CS_LABELS if l.id >= 0 and l.ignoreInEval]
    fh, fw = FRAME
    block, small, large = fh // 8, max(4, fh // 25), fh // 5
    gts = []
    for city in BENCH_CITIES:
        img_dir = os.path.join(ds, "leftImg8bit", "val", city)
        gt_dir = os.path.join(ds, "gtFine", "val", city)
        os.makedirs(img_dir)
        os.makedirs(gt_dir)
        for n in range(BENCH_FRAMES):
            blocks = rng.choice(evaluated + void, size=(fh // block, fw // block))
            blocks.flat[:len(evaluated)] = evaluated  # every evaluated class, every frame
            gt = np.repeat(np.repeat(blocks, block, 0), block, 1).astype(np.uint8)
            inst = gt.astype(np.uint16)
            for k in range(12):
                label = 26 if k % 2 else 24
                y, x = int(rng.integers(0, fh - large)), int(rng.integers(0, fw - large))
                hh, ww = (int(v) for v in rng.integers(small, large, 2))
                gt[y:y + hh, x:x + ww] = label
                inst[y:y + hh, x:x + ww] = label * 1000 + k
            name = f"{city}_{n:06d}_000019"
            Image.fromarray(rng.integers(0, 256, (fh, fw, 3), dtype=np.uint8)).save(
                os.path.join(img_dir, f"{name}_leftImg8bit.png"), compress_level=1)
            gt_path = os.path.join(gt_dir, f"{name}_gtFine_labelIds.png")
            Image.fromarray(gt).save(gt_path, compress_level=1)
            Image.fromarray(inst).save(os.path.join(gt_dir, f"{name}_gtFine_instanceIds.png"),
                                       compress_level=1)
            gts.append((gt_path, gt))
    return ds, gts


def phase_score_benchmark(model: FCN8s, root: str, dev, smi: str) -> tuple[dict, dict]:
    """(d) ``score_benchmark`` on a 2 x 4-frame 1024x2048 split; the closed
    loop against K5 on the card; the native confusion matrix timed per frame.
    Returns (launch counts, measurements)."""
    rng = np.random.default_rng(184)
    ds, gts = _benchmark_split(root, rng)
    results_dir = os.path.join(root, "results")
    real, scoring = pixel_eval.evaluate_img_lists, {}

    def timed_scorer(*args, **kwargs):
        t0 = time.perf_counter()
        result = real(*args, **kwargs)
        scoring["s"] = time.perf_counter() - t0
        return result

    zero_counts()
    pixel_eval.evaluate_img_lists = timed_scorer
    try:
        t0 = time.perf_counter()
        result = model.score_benchmark(ds, results_dir, batch_size=BATCH)
        seconds = time.perf_counter() - t0
    finally:
        pixel_eval.evaluate_img_lists = real
    n_px = len(gts) * FRAME[0] * FRAME[1]
    conf = np.asarray(result["confMatrix"], np.int64)
    check(conf.shape == (NUM_LABEL_IDS, NUM_LABEL_IDS) and conf.sum() == n_px,
          f"the scorer's matrix sums to {conf.sum()}, not {n_px}")
    check(result["classInstScores"]["car"] == result["classInstScores"]["car"]
          and result["classInstScores"]["person"] == result["classInstScores"]["person"],
          "iIoU of car or person is NaN: the instances were not scored")

    # closed loop: the written labelIds and the GT in trainId space through K5
    args = pixel_eval.EvalArgs()
    args.prediction_path = results_dir
    preds = np.stack([np.asarray(Image.open(pixel_eval.get_prediction(args, path)))
                      for path, _ in gts])
    gt_ids = np.stack([gt for _, gt in gts])
    to_train = IDS_TO_TRAINIDS_ARRAY
    k5 = confusion_matrix(torch.from_numpy(to_train[preds]).to(dev),
                          torch.from_numpy(to_train[gt_ids]).to(dev), C)
    counts = read_counts()
    check(counts["confusion_matrix_accumulate"] > 0, "the closed loop never launched K5")
    collapsed = np.zeros((C, C), np.int64)
    rows, cols = np.nonzero(conf)
    np.add.at(collapsed, (to_train[rows], to_train[cols]), conf[rows, cols])
    check(np.array_equal(collapsed, k5.cpu().numpy().astype(np.int64)),
          "the scorer's matrix collapsed to trainIds differs from K5's")
    iou, valid = (t.cpu().numpy() for t in benchmark_iou_from_confusion(k5, void_class=0))
    worst = 0.0
    for label in CS_LABELS:
        if label.id < 0 or label.ignoreInEval:
            continue
        score = result["classScores"][label.name]
        check(bool(valid[label.trainId]) == (score == score), f"{label.name}: validity differs")
        if valid[label.trainId]:
            worst = max(worst, abs(score - float(iou[label.trainId])))
    check(worst <= 1e-6, f"per-class IoU differs from K5's by {worst}")

    # the native confusion matrix on one frame, against its numpy twin
    frame_pred, frame_gt = preds[0], gt_ids[0]
    native = np.zeros((NUM_LABEL_IDS, NUM_LABEL_IDS), np.uint64)
    NC.accumulate_confusion(frame_pred, frame_gt, native)
    twin = NC.accumulate_confusion_plain(frame_pred, frame_gt, np.zeros_like(native))
    check(np.array_equal(native, twin), "the native confusion matrix differs from its twin")

    def median_ms(fn, reps):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    native_ms = median_ms(lambda: NC.accumulate_confusion(frame_pred, frame_gt, native), 21)
    plain_ms = median_ms(lambda: NC.accumulate_confusion_plain(frame_pred, frame_gt, native), 5)
    out = {"seconds": seconds, "predict_and_save_s": seconds - scoring["s"],
           "scoring_s": scoring["s"], "frames": len(gts), "pixels": n_px,
           "native_confmat_ms_per_frame": native_ms, "numpy_twin_ms_per_frame": plain_ms,
           "host_threads": os.cpu_count(), "mIoU_classes": result["averageScoreClasses"],
           "iIoU_classes": result["averageScoreInstClasses"], "closed_loop_max_iou_diff": worst}
    print(f"score_benchmark at full width, {len(BENCH_CITIES)} cities x {BENCH_FRAMES} frames "
          f"of {FRAME}, on {smi}: {out} (seconds, host clock; the native confusion matrix and "
          f"its numpy twin median of 21 / 5 calls on one 2 MP frame); matrix sums to {n_px}, "
          f"collapsed to trainIds = K5's on the card cell for cell; launches {counts}")
    return counts, out


def phase_facade_rest(dev, smi: str) -> dict:
    """Phase 18 on a fresh full-width model with a redrawn decoder; returns
    the launch counts summed over b-d (each read just after its path)."""
    def version(module: str) -> str:
        try:
            return getattr(importlib.import_module(module), "__version__", "present")
        except ImportError as e:
            return f"absent ({e})"

    gxx = shutil.which("g++")
    gxx_version = subprocess.run([gxx, "--version"], capture_output=True, text=True).stdout \
        .splitlines()[0] if gxx else "absent"
    print(f"card installation: cv2 {version('cv2')}, tqdm {version('tqdm')}, g++ {gxx_version}")
    t0 = time.perf_counter()
    model = FCN8s(num_classes=C, device=dev, seed=18)
    _redraw_decoder(model, np.random.default_rng(18))
    phase_summary(model, dev)
    total = dict.fromkeys(WRAPPERS, 0)
    root = tempfile.mkdtemp(prefix="fcn8s_facade_")
    try:
        sweep_counts, _ = phase_lr_sweep(model, dev, smi)
        save_counts, _ = phase_predict_and_save(model, root, smi)
        score_counts, _ = phase_score_benchmark(model, root, dev, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for counts in (sweep_counts, save_counts, score_counts):
        total = {k: total[k] + counts[k] for k in total}
    check(model.device.type == "cuda" and all(
        t.device.type == "cuda" for t in bridge.param_leaves(model._run_params)),
        "phase 18's model left the card")
    print(f"phase 18 launches: {total}; {time.perf_counter() - t0:.1f} s")
    model.close()
    del model
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 19: the host data pipeline and the torch.export artifact
# ---------------------------------------------------------------------------

DATA_SEED = 19
DATA_FRAME = (1024, 2048)  # a Cityscapes frame
DATA_RESIZE = (512, 1024)  # its aspect at the flagship step's 524,288 pixels
DATA_TRAIN, DATA_VAL = 16, 8
HOST_SETTINGS = dict(convert_ids_to_ids=IDS_TO_TRAINIDS_ARRAY, void_class_id=0,
                     convert_to_one_hot=False)  # examples/train_cityscapes.py's
HOST_AUG = dict(flip=0.5, brightness=(0.8, 1.2, 0.5), translate=((0, 16), (0, 8), 0.5),
                scale=(0.8, 1.2, 0.5))
KITTI_FRAME, KITTI_RESIZE = (375, 1242), (320, 1152)  # examples/train_kitti.py's resize
KITTI_FRAMES = 8
RATE_BATCHES = 4
DATA_KERNELS = ("maxpool2x2_code_nhwc", "maxpool2x2_bwd_nhwc", "ce_sum_per_sample", "ce_grad",
                "maxpool2x2_nhwc", "confusion_matrix_accumulate")


def _scene(rng, h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """A piecewise-smooth frame and its labelIds: 64x64-pixel regions of
    34 classes, each class a colour, a vertical gradient and +-3 noise on
    top, so that PNG sizes and decode times look like a photograph's."""
    ids = np.repeat(np.repeat(rng.integers(0, 34, (h // 64, w // 64)), 64, 0), 64, 1)
    colour = rng.integers(40, 216, (34, 3)).astype(np.int16)
    ramp = np.linspace(-30, 30, h).astype(np.int16)[:, None, None]
    image = colour[ids] + ramp + rng.integers(-3, 4, (h, w, 3), dtype=np.int16)
    return np.clip(image, 0, 255).astype(np.uint8), ids.astype(np.uint8)


def _write_pngs(jobs) -> list[int]:
    """Encode (path, array) pairs on 8 threads; returns the file sizes."""
    from concurrent.futures import ThreadPoolExecutor

    def write(job):
        path, array = job
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(array).save(path)
        return os.path.getsize(path)

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(write, jobs))


def _cityscapes_tree(root: str, rng) -> dict:
    """leftImg8bit/{train,val}/<city>/*_leftImg8bit.png and gtFine/.../
    *_gtFine_labelIds.png at 2048x1024: 16 train frames in two cities, 8
    val frames in a third. Returns the paths and the mean PNG sizes."""
    jobs, sizes = [], {"image": [], "gt": []}
    for split, cities, n in (("train", ("aachen", "bremen"), DATA_TRAIN // 2),
                             ("val", ("frankfurt",), DATA_VAL)):
        for city in cities:
            for i in range(n):
                stem = f"{city}_{i:06d}_000019"
                image, ids = _scene(rng, *DATA_FRAME)
                jobs += [(os.path.join(root, "leftImg8bit", split, city,
                                       f"{stem}_leftImg8bit.png"), image),
                         (os.path.join(root, "gtFine", split, city,
                                       f"{stem}_gtFine_labelIds.png"), ids)]
    written = _write_pngs(jobs)
    return {"root": root, "image_png": statistics.mean(written[0::2]),
            "gt_png": statistics.mean(written[1::2])}


def _kitti_tree(root: str, rng) -> tuple[str, str]:
    """image_2/um_*.png (375x1242) and gt_image_2/um_road_*.png: background
    (255, 0, 0), road (255, 0, 255) below a random horizon."""
    jobs = []
    h, w = KITTI_FRAME
    for i in range(KITTI_FRAMES):
        image, _ = _scene(rng, 384, 1280)
        gt = np.zeros((h, w, 3), np.uint8)
        gt[..., 0] = 255
        gt[int(rng.integers(180, 260)):, :, 2] = 255
        jobs += [(os.path.join(root, "image_2", f"um_{i:06d}.png"), image[:h, :w].copy()),
                 (os.path.join(root, "gt_image_2", f"um_road_{i:06d}.png"), gt)]
    _write_pngs(jobs)
    return os.path.join(root, "image_2"), os.path.join(root, "gt_image_2")


def _generators(root: str):
    def make(split):
        return BatchGenerator(image_dirs=[os.path.join(root, "leftImg8bit", split)],
                              ground_truth_dirs=[os.path.join(root, "gtFine", split)],
                              image_name_split_separator="leftImg8bit",
                              ground_truth_suffix="gtFine_labelIds", num_classes=C)

    return make("train"), make("val")


def _images_per_s(it, batches: int = RATE_BATCHES) -> float:
    """Images/s of a generator over ``batches`` batches after one warm-up."""
    next(it)
    t0, n = time.perf_counter(), 0
    for _ in range(batches):
        n += len(next(it)[0])
    rate = n / (time.perf_counter() - t0)
    it.close()
    return rate


def _data_fed(model: FCN8s, stream, steps: int) -> tuple[float, dict]:
    """ms per step of ``steps`` train steps fed by ``stream`` (host clock,
    the first batch's host work in), then the device busy share of 3 more
    steps under ``utils.profiling.trace``."""
    kw = dict(learning_rate_schedule=lambda s: 1e-4, keep_prob=0.5, record_summaries=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.train(stream, epochs=1, steps_per_epoch=steps, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    root = tempfile.mkdtemp(prefix="fcn8s_data_trace_")
    try:
        with trace(root) as prof:
            model.train(stream, epochs=1, steps_per_epoch=3, **kw)
            torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return ms, device_busy(prof)


def _busy(b: dict) -> str:
    if b["share"] is None:
        return "not read (the trace holds no device events)"
    return (f"{b['share']:.4f} ({b['busy_us'] / 1e3:.2f} of {b['window_us'] / 1e3:.2f} ms, "
            f"{b['host_syncs']} host syncs)")


def phase_data_pipeline(dev, root: str, smi: str) -> dict:
    """Phase 19 (a)-(d). Returns the launch counts of the data-fed runs."""
    rng = np.random.default_rng(DATA_SEED)
    cores = len(os.sched_getaffinity(0))
    workers = min(8, os.cpu_count())
    t0 = time.perf_counter()
    tree = _cityscapes_tree(os.path.join(root, "cityscapes"), rng)
    kitti = _kitti_tree(os.path.join(root, "kitti"), rng)
    print(f"phase 19 (a): {DATA_TRAIN} train + {DATA_VAL} val synthetic {DATA_FRAME[1]}x"
          f"{DATA_FRAME[0]} Cityscapes frames and {KITTI_FRAMES} KITTI {KITTI_FRAME[1]}x"
          f"{KITTI_FRAME[0]} frames in {time.perf_counter() - t0:.1f} s; mean PNG "
          f"{tree['image_png'] / 1e6:.3f} MB image, {tree['gt_png'] / 1e6:.3f} MB labelIds; "
          f"host cores {cores} (os.cpu_count() {os.cpu_count()})")

    # (b) the host pipeline alone
    train_gen, val_gen = _generators(tree["root"])
    host = dict(resize=DATA_RESIZE, **HOST_SETTINGS, **HOST_AUG)
    rates = {f"BatchGenerator workers={w}": _images_per_s(
        train_gen.generate(batch_size=BATCH, seed=0, workers=w, **host)) for w in (1, workers)}
    packed_dir = os.path.join(root, "packed")
    t0 = time.perf_counter()
    pack_dataset(train_gen, packed_dir, convert_ids_to_ids=IDS_TO_TRAINIDS_ARRAY,
                 resize=DATA_RESIZE)
    pack_s = time.perf_counter() - t0
    packed = PackedDataset(packed_dir, num_classes=C)
    packed_kw = dict(void_class_id=0, convert_to_one_hot=False, **HOST_AUG)
    rates["PackedDataset"] = _images_per_s(packed.generate(BATCH, seed=0, **packed_kw))
    rates[f"KITTI {KITTI_RESIZE}"] = _images_per_s(kitti_generator(
        BATCH, *kitti, resize=KITTI_RESIZE, flip=0.5, seed=0, one_hot=False))
    print(f"phase 19 (b) host pipeline alone on {cores} cores, images/s over {RATE_BATCHES} "
          f"batches of {BATCH} after one warm-up: " + ", ".join(
              f"{k} {v:.2f} ({1e3 / v:.1f} ms/image)" for k, v in rates.items())
          + f"; pack_dataset of {DATA_TRAIN} frames {pack_s:.2f} s")

    # (c) BatchGenerator and PackedDataset: the same bytes for one seed
    a = train_gen.generate(batch_size=BATCH, seed=5, **host)
    b = packed.generate(BATCH, seed=5, **packed_kw)
    for i in range(3):
        (ia, la), (ib, lb) = next(a), next(b)
        check(ia.dtype == ib.dtype and la.dtype == lb.dtype and np.array_equal(ia, ib)
              and np.array_equal(la, lb), f"BatchGenerator and PackedDataset differ at batch {i}")
    a.close()
    b.close()
    print("phase 19 (c): BatchGenerator(workers=1) and PackedDataset yield byte-identical "
          f"batches for one seed (3 batches of {BATCH}, across an epoch boundary)")

    # (d) training fed from disk, with evaluation
    model = FCN8s(num_classes=C, device=dev, seed=DATA_SEED)
    synthetic = [(rng.integers(0, 256, (BATCH,) + DATA_RESIZE + (3,), dtype=np.uint8),
                  rng.integers(0, C, (BATCH,) + DATA_RESIZE, dtype=np.uint8)) for _ in range(2)]
    total = dict.fromkeys(WRAPPERS, 0)
    feeders = {
        f"BatchGenerator workers={workers}":
            lambda: train_gen.generate(batch_size=BATCH, seed=1, workers=workers, **host),
        "PackedDataset": lambda: packed.generate(BATCH, seed=1, **packed_kw),
    }
    lines = []
    for name, feed in feeders.items():
        val = val_gen.generate(batch_size=BATCH, shuffle=False, seed=0, resize=DATA_RESIZE,
                               **HOST_SETTINGS)
        zero_counts()
        t0 = time.perf_counter()
        model.train(feed(), epochs=2, steps_per_epoch=3, learning_rate_schedule=lambda s: 1e-4,
                    keep_prob=0.5, metrics={"loss", "mean_iou"}, eval_dataset="val",
                    val_generator=val, val_steps=1, eval_frequency=1, record_summaries=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        for kernel in DATA_KERNELS:
            check(counts[kernel] > 0, f"{kernel} was never launched in training fed by {name}")
        check(math.isfinite(model.training_loss), f"{name}: loss {model.training_loss}")
        total = {k: total[k] + counts[k] for k in total}
        lines.append(f"{name}: 6 steps + 2 val batches {seconds:.2f} s, loss "
                     f"{model.training_loss:.5f}, eval {model.metric_values}, launches {counts}")
    step = {"synthetic (in memory)": _data_fed(model, _cycle(synthetic), 4)}
    for name, feed in feeders.items():
        step[name] = _data_fed(model, feed(), 4)
    model.close()
    zero_counts()
    kmodel = FCN8s(num_classes=2, device=dev, seed=DATA_SEED)
    kmodel.train(kitti_generator(BATCH, *kitti, resize=KITTI_RESIZE, flip=0.5, seed=0,
                                 one_hot=False),
                 epochs=1, steps_per_epoch=2, learning_rate_schedule=lambda s: 1e-4,
                 keep_prob=0.5, record_summaries=False)
    torch.cuda.synchronize()
    kcounts = read_counts()
    for kernel in ("maxpool2x2_code_nhwc", "maxpool2x2_bwd_nhwc", "ce_sum_per_sample", "ce_grad"):
        check(kcounts[kernel] > 0, f"{kernel} was never launched in training fed by KITTI")
    check(math.isfinite(kmodel.training_loss), f"KITTI loss {kmodel.training_loss}")
    kmodel.close()
    total = {k: total[k] + kcounts[k] for k in total}
    print(f"phase 19 (d) training fed from disk, batch {BATCH} x {DATA_RESIZE[0]}x"
          f"{DATA_RESIZE[1]}, full width, keep_prob 0.5: "
          + "; ".join(lines) + f"; KITTI 2 steps at {KITTI_RESIZE}, 2 classes: loss "
          f"{kmodel.training_loss:.5f}, launches {kcounts}")
    print(f"phase 19 (d) step times on {smi} (host clock over 4 steps, the first batch's host "
          "work in; device busy share over 3 more under utils.profiling.trace): " + "; ".join(
              f"{k} {ms:.2f} ms/step ({BATCH * 1e3 / ms:.2f} images/s), busy {_busy(b)}"
              for k, (ms, b) in step.items()))
    del model, kmodel
    torch.cuda.empty_cache()
    return total


def phase_export(dev, tree: dict, root: str, smi: str) -> dict:
    """Phase 19 (e): ``export_serving`` of phase 10's weights at
    ``input_hw=(1024, 512)``, argmax and softmax; each artifact loaded on
    the card against ``model.predict``. Returns the artifacts' launch counts."""
    model = FCN8s.from_params(tree, device=dev)
    images = np.random.default_rng(DATA_SEED).integers(0, 256, (BATCH, TH, TW, 3),
                                                       dtype=np.uint8)
    total = dict.fromkeys(WRAPPERS, 0)
    out = []
    for argmax in (True, False):
        directory = os.path.join(root, f"artifact_{'ids' if argmax else 'softmax'}")
        t0 = time.perf_counter()
        model.export_serving(directory, input_hw=(TH, TW), argmax=argmax)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        art = load_serving_artifact(directory, device=dev)
        load_s = time.perf_counter() - t0
        program_bytes = os.path.getsize(os.path.join(directory, "forward.pt2"))
        zero_counts()
        got8 = art.predict(images)
        counts = read_counts()
        check(counts["maxpool2x2_nhwc"] == 5 and sum(counts.values()) == 5,
              f"an artifact forward launched {counts}, expected K4f 5 times")
        total = {k: total[k] + counts[k] for k in total}
        # batch 1 against the facade at batch 1: cuDNN may pick other
        # algorithms for another batch size, so ids of near-ties may differ
        # between a batch-1 and a batch-8 forward of the same image
        got1, want1 = art.predict(images[:1]), model.predict(images[:1], argmax=argmax)
        want8 = model.predict(images, argmax=argmax)
        for got, want in ((got8, want8), (got1, want1)):
            check(got.dtype == want.dtype and got.shape == want.shape,
                  f"artifact output {got.dtype} {got.shape}, facade {want.dtype} {want.shape}")
        if argmax:
            shares = [float((g == w).mean()) for g, w in ((got8, want8), (got1, want1))]
            check(min(shares) >= 0.999, f"artifact ids equal facade ids on {shares} of pixels")
            what = f"ids equal on {shares[0]:.6f} (batch 8), {shares[1]:.6f} (batch 1) of pixels"
        else:
            gaps = [float(np.abs(g - w).max()) for g, w in ((got8, want8), (got1, want1))]
            check(max(gaps) <= 1e-2 and np.allclose(got8.sum(-1), 1.0, atol=1e-3),
                  f"artifact softmax differs by {gaps}")
            what = (f"softmax max gap {gaps[0]:.3g} (batch 8), {gaps[1]:.3g} (batch 1), its "
                    f"argmax equal on {float((got8.argmax(-1) == want8.argmax(-1)).mean()):.6f}")
        turns = [host_ms(fn, reps=5) for fn in (lambda: model.predict(images, argmax=argmax),
                                                 lambda: art.predict(images),
                                                 lambda: art.predict(images),
                                                 lambda: model.predict(images, argmax=argmax))]
        out.append(f"{'argmax' if argmax else 'softmax'}: export {export_s:.2f} s, load "
                   f"{load_s:.2f} s, {_dir_bytes(directory)} bytes on disk (program "
                   f"{program_bytes}); {what}; K4f {counts['maxpool2x2_nhwc']} launches per "
                   f"forward; predict batch {BATCH} facade {turns[0]:.2f}, {turns[3]:.2f} ms vs "
                   f"artifact {turns[1]:.2f}, {turns[2]:.2f} ms (host clock, median of 5, turns "
                   "facade/artifact/artifact/facade)")
        del art
    print(f"phase 19 (e) export_serving of phase 10's weights at input_hw=({TH}, {TW}), loaded "
          f"on the card, on {smi}: " + "; ".join(out))
    model.close()
    del model
    torch.cuda.empty_cache()
    return total


def phase_data_export(dev, tree: dict, smi: str) -> dict:
    """Phase 19 in a temporary directory, removed at the end; returns the
    launch counts of (d) and (e) summed."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="fcn8s_data_")
    try:
        data = phase_data_pipeline(dev, root, smi)
        export = phase_export(dev, tree, root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s")
    return {k: data[k] + export[k] for k in data}


# ---------------------------------------------------------------------------
# phase 20: viz and prep
# ---------------------------------------------------------------------------

VIZ_SEED = 20
VIDEO_FRAMES, VIDEO_FPS = 26, 10.0  # 3 full batches of BATCH and a tail of 2
VIDEO_SHORT = 8  # frames of the int8 and tiled runs
VIDEO_PAN = 16  # pixels the scene moves between frames
VIEWER_CITY, VIEWER_FRAMES = "lindau", 2
GT_CITIES, GT_TRAIN, GT_VAL = {"train": "hamburg", "val": "munster"}, 8, 4
TOOL_ROUNDS = 3  # timed requests per route


def _write_video(path: str, frames, fps: float) -> None:
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    check(writer.isOpened(), f"OpenCV cannot write {path}")
    for frame in frames:
        writer.write(np.ascontiguousarray(frame[:, :, ::-1]))  # RGB -> BGR
    writer.release()


def _read_video(path: str) -> tuple[list, float]:
    """The RGB frames of a video and its frame rate, as segment_video reads them."""
    import cv2

    cap = cv2.VideoCapture(path)
    check(cap.isOpened(), f"OpenCV cannot read {path}")
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1])
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return frames, fps


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def phase_video(model: FCN8s, root: str, smi: str) -> tuple[dict, dict]:
    """Phase 20 (a): ``segment_video`` over a seeded 26-frame Cityscapes-size
    ``mp4v`` video at batch 8, the decode/predict/encode split, then 8
    frames with ``quantized=True`` and in (512, 512) tiles, each twice (the
    first run quantizes the weights and makes cuDNN's choices). Returns
    (launch counts, measurements)."""
    rng = np.random.default_rng(VIZ_SEED)
    h, w = DATA_FRAME
    scene, _ = _scene(rng, h, -(-(w + VIDEO_PAN * VIDEO_FRAMES) // 64) * 64)  # 64-pixel regions
    frames = [scene[:, i * VIDEO_PAN:i * VIDEO_PAN + w] for i in range(VIDEO_FRAMES)]
    src, short = os.path.join(root, "drive.mp4"), os.path.join(root, "drive_short.mp4")
    _write_video(src, frames, VIDEO_FPS)
    _write_video(short, frames[:VIDEO_SHORT], VIDEO_FPS)
    cmap = TRAINIDS_TO_RGBA_DICT

    (decoded, fps), decode_s = _timed(lambda: _read_video(src))
    check(len(decoded) == VIDEO_FRAMES and decoded[0].shape == (h, w, 3) and fps == VIDEO_FPS,
          f"decoded {len(decoded)} frames of {decoded[0].shape} at {fps}")
    # the batches one predict at a time; the first predict at these shapes
    # (cuDNN's choices in), so the runs below are warm
    want, first_s = _timed(lambda: np.concatenate([
        model.predict(np.stack(decoded[i:i + BATCH]), overlay=cmap)
        for i in range(0, VIDEO_FRAMES, BATCH)]))
    overlaid, predict_s = _timed(lambda: list(overlay_frames(model, iter(decoded), cmap,
                                                             batch_size=BATCH)))
    check(np.array_equal(np.stack(overlaid), want),
          "the batch loop's frames differ from predict(overlay=) of the decoded frames")
    zero_counts()
    out, seconds = _timed(lambda: segment_video(model, src, os.path.join(root, "segmented"),
                                                cmap, batch_size=BATCH))
    counts = read_counts()
    check(counts["maxpool2x2_nhwc"] > 0, "segment_video never launched K4f")
    check(out == os.path.join(root, "segmented.mp4"), f"segment_video returned {out}")
    written, out_fps = _read_video(out)
    check(len(written) == VIDEO_FRAMES and written[0].shape == (h, w, 3) and out_fps == fps,
          f"segment_video wrote {len(written)} frames of {written[0].shape} at {out_fps}")
    again = os.path.join(root, "encoded.mp4")
    _, encode_s = _timed(lambda: _write_video(again, overlaid, fps))
    check(_file_bytes(again) == _file_bytes(out),
          "segment_video's file is not the encoding of the batch loop's frames")

    other = {}
    for name, kw in (("int8", dict(quantized=True)),
                     ("tiled", dict(tile=TILE, tile_overlap=TILE_OVERLAP))):
        zero_counts()
        times = []
        for run in ("cold", "warm"):
            target = os.path.join(root, f"{name}_{run}")
            path, t = _timed(lambda: segment_video(model, short, target, cmap, batch_size=BATCH,
                                                   **kw))
            times.append(t)
        k4f = read_counts()["maxpool2x2_nhwc"]
        check(k4f > 0, f"segment_video({name}) never launched K4f")
        got, _ = _read_video(path)
        check(len(got) == VIDEO_SHORT and got[0].shape == (h, w, 3),
              f"segment_video({name}) wrote {len(got)} frames of {got[0].shape}")
        counts["maxpool2x2_nhwc"] += k4f
        other[name] = {"frames_per_s_cold": VIDEO_SHORT / times[0],
                       "frames_per_s_warm": VIDEO_SHORT / times[1], "k4f": k4f}
    out = {"frames_per_s": VIDEO_FRAMES / seconds, "seconds": seconds, "decode_s": decode_s,
           "predict_s": predict_s, "encode_s": encode_s, "first_predict_s": first_s,
           "output_bytes": os.path.getsize(again), **other}
    print(f"phase 20 (a) segment_video, {VIDEO_FRAMES} frames of {h}x{w} (mp4v, {VIDEO_FPS} "
          f"frames/s), batch {BATCH}, on {smi}: {VIDEO_FRAMES / seconds:.2f} frames/s end to end "
          f"({seconds:.3f} s); split, each part alone (host clock): decode {decode_s:.3f} s, "
          f"predict (overlay_frames on the card) {predict_s:.3f} s, encode {encode_s:.3f} s, sum "
          f"{decode_s + predict_s + encode_s:.3f} s; the first predicts at these shapes "
          f"{first_s:.3f} s (cuDNN's choices); the batch loop's frames = predict(overlay=) "
          f"exactly, and their encoding = segment_video's file byte for byte; {VIDEO_SHORT} "
          f"frames int8 {other['int8']['frames_per_s_warm']:.2f} frames/s warm "
          f"({other['int8']['frames_per_s_cold']:.2f} cold), tiled {TILE} "
          f"{other['tiled']['frames_per_s_warm']:.2f} ({other['tiled']['frames_per_s_cold']:.2f}"
          f" cold); launches {counts}")
    return counts, out


def _fetch(url: str, body: bytes | None = None) -> bytes:
    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=60) as r:
        check(r.status == 200, f"{url}: HTTP {r.status}")
        return r.read()


def phase_viewer(model: FCN8s, root: str, smi: str) -> tuple[dict, dict]:
    """Phase 20 (b): ``predict_and_save(output_format="ids")`` over a
    synthetic val split with disparity, then ``view_cityscapes_split``,
    ``build_interactive_viewer`` and ``serve_viewer`` on port 0. Returns
    (launch counts, measurements)."""
    rng = np.random.default_rng(VIZ_SEED + 1)
    split = os.path.join(root, "cityscapes")
    jobs = []
    for i in range(VIEWER_FRAMES):
        stem = os.path.join(VIEWER_CITY, f"{VIEWER_CITY}_{i:06d}_000019")
        image, ids = _scene(rng, *DATA_FRAME)
        disp = np.repeat(np.repeat(rng.integers(0, 30000, (DATA_FRAME[0] // 64,
                                                           DATA_FRAME[1] // 64)), 64, 0), 64, 1)
        jobs += [(os.path.join(split, "leftImg8bit", "val", f"{stem}_leftImg8bit.png"), image),
                 (os.path.join(split, "gtFine", "val", f"{stem}_gtFine_labelIds.png"), ids),
                 (os.path.join(split, "disparity", "val", f"{stem}_disparity.png"),
                  disp.astype(np.uint16))]
    _write_pngs(jobs)
    images_dir = os.path.join(split, "leftImg8bit", "val", VIEWER_CITY)
    paths = [os.path.join(images_dir, n) for n in sorted(os.listdir(images_dir))]
    results = os.path.join(root, "predictions")
    zero_counts()
    _, predict_s = _timed(lambda: model.predict_and_save(results, images_dir, output_format="ids",
                                                         batch_size=BATCH, verbose=False))
    counts = read_counts()
    check(counts["maxpool2x2_nhwc"] > 0, "predict_and_save never launched K4f")

    gallery = os.path.join(root, "gallery")
    index, gallery_s = _timed(lambda: view_cityscapes_split(split, "val", gallery,
                                                            results_dir=results,
                                                            max_images=VIEWER_FRAMES))
    panels = sorted(n for n in os.listdir(gallery) if n.endswith("_panel.png"))
    panel = np.asarray(Image.open(os.path.join(gallery, panels[0])))
    check(len(panels) == VIEWER_FRAMES and panel.shape == (*DATA_FRAME[:1], 4 * DATA_FRAME[1], 3),
          f"gallery: {len(panels)} panels of {panel.shape}")

    def gt_loader(path):
        gt = path.replace("leftImg8bit", "gtFine").replace("_gtFine.png", "_gtFine_labelIds.png")
        return IDS_TO_TRAINIDS_ARRAY[np.asarray(Image.open(gt))]

    viewer_dir = os.path.join(root, "viewer")
    html, viewer_s = _timed(lambda: build_interactive_viewer(
        viewer_dir, paths, gt_loader=gt_loader,
        pred_loader=lambda p: load_prediction(p, results), disp_loader=load_disparity))
    first = os.path.splitext(os.path.basename(paths[0]))[0]
    image = np.asarray(Image.open(paths[0]).convert("RGB"))
    layer = np.asarray(Image.open(os.path.join(viewer_dir, f"{first}_pred.png")))
    check(np.array_equal(layer, print_segmentation_onto_image(
        image, load_prediction(paths[0], results), TRAINIDS_TO_RGBA_DICT)),
        "the viewer's prediction layer is not the overlay of the saved ids")
    server = serve_viewer(viewer_dir, port=0, blocking=False)
    try:
        base = f"http://{server.server_address[0]}:{server.server_address[1]}"
        served = {}
        for name in ("viewer.html", f"{first}_pred.png"):
            got = _fetch(f"{base}/{name}")
            check(got == _file_bytes(os.path.join(viewer_dir, name)),
                  f"{name} served differs from the file")
            served[name] = len(got)
        latency = [_timed(lambda: _fetch(f"{base}/{first}_img.png"))[1] for _ in range(TOOL_ROUNDS)]
    finally:
        server.shutdown()
        server.server_close()
    out = {"predict_and_save_s": predict_s, "gallery_s_per_image": gallery_s / VIEWER_FRAMES,
           "viewer_s_per_image": viewer_s / VIEWER_FRAMES,
           "serve_layer_ms_median": statistics.median(latency) * 1e3, "served_bytes": served}
    print(f"phase 20 (b) viewer over {VIEWER_FRAMES} predicted {DATA_FRAME[1]}x{DATA_FRAME[0]} val "
          f"frames with disparity, on {smi} (host clock): predict_and_save (ids) {predict_s:.3f} "
          f"s; view_cityscapes_split {gallery_s / VIEWER_FRAMES:.3f} s per image (4-column "
          f"panels); build_interactive_viewer {viewer_s / VIEWER_FRAMES:.3f} s per image (5 "
          f"layers); serve_viewer: {served} bytes equal the files, a {DATA_FRAME[1]}x"
          f"{DATA_FRAME[0]} layer in {statistics.median(latency) * 1e3:.2f} ms (median of "
          f"{TOOL_ROUNDS}); launches {counts}")
    return counts, out


def _polygons(rng, h: int, w: int) -> dict:
    """A seeded Cityscapes ``*_polygons.json`` body: sky above a horizon,
    building blocks, sidewalks and road below it, then 2-4 cars, 2-4
    persons and a ``cargroup`` on the road, drawn last (on top)."""
    horizon = int(h * rng.uniform(0.35, 0.5))
    near = h - 1

    def quad(x0, y0, x1, y1):
        return [[int(x0), int(y0)], [int(x1), int(y0)], [int(x1), int(y1)], [int(x0), int(y1)]]

    objects = [{"label": "sky", "polygon": quad(0, 0, w - 1, horizon)}]
    x = 0
    while x < w:
        bw = int(rng.integers(w // 12, w // 5))
        top = rng.integers(horizon // 4, horizon - h // 50)
        objects.append({"label": "building",
                        "polygon": quad(x, top, min(x + bw, w - 1), horizon + h // 25)})
        x += bw
    far, left, right = horizon + h // 25, w // 2 - w // 20, w // 2 + w // 20
    objects += [
        {"label": "sidewalk", "polygon": [[0, far], [left, far], [w // 8, near], [0, near]]},
        {"label": "sidewalk", "polygon": [[right, far], [w - 1, far], [w - 1, near],
                                          [w - w // 8, near]]},
        {"label": "road", "polygon": [[left, far], [right, far], [w - w // 8, near],
                                      [w // 8, near]]},
    ]
    for label, n, (bw, bh) in (("car", int(rng.integers(2, 5)), (w // 10, h // 10)),
                               ("person", int(rng.integers(2, 5)), (w // 60, h // 8)),
                               ("cargroup", 1, (w // 5, h // 9))):
        for _ in range(n):
            x0 = int(rng.integers(w // 8, w - w // 8 - bw))
            y0 = int(rng.integers(horizon + h // 20, near - bh))
            objects.append({"label": label, "polygon": quad(x0, y0, x0 + bw, y0 + bh)})
    return {"imgWidth": w, "imgHeight": h, "objects": objects}


def phase_annotate_train(model: FCN8s, root: str, smi: str) -> tuple[dict, dict]:
    """Phase 20 (c): seeded polygons for 8 train + 4 val frames, one more
    polygon POSTed through the label tool's server, both GT rasterisers,
    then ``train`` fed by ``BatchGenerator`` on the rasterised trainIds.
    Returns (launch counts, measurements)."""
    rng = np.random.default_rng(VIZ_SEED + 2)
    h, w = DATA_FRAME
    jobs, polygon_files = [], []
    for split, n in (("train", GT_TRAIN), ("val", GT_VAL)):
        city = GT_CITIES[split]
        for i in range(n):
            stem = os.path.join(city, f"{city}_{i:06d}_000019")
            image, _ = _scene(rng, h, w)
            jobs.append((os.path.join(root, "leftImg8bit", split, f"{stem}_leftImg8bit.png"),
                         image))
            path = os.path.join(root, "gtFine", split, f"{stem}_gtFine_polygons.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump(_polygons(rng, h, w), f)
            polygon_files.append(path)
    _write_pngs(jobs)

    city = GT_CITIES["train"]
    tool = AnnotationTool(os.path.join(root, "leftImg8bit", "train", city),
                          annotation_dir=os.path.join(root, "gtFine", "train", city))
    server = make_tool_server(tool, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    person = {"label": "person", "polygon": [[w // 2, h // 2], [w // 2 + w // 40, h // 2],
                                             [w // 2 + w // 40, h // 2 + h // 6],
                                             [w // 2, h // 2 + h // 6]]}
    latency = {}
    try:
        base = f"http://{server.server_address[0]}:{server.server_address[1]}"
        check(len(json.loads(_fetch(f"{base}/api/images"))) == GT_TRAIN, "/api/images")
        payload = json.loads(_fetch(f"{base}/api/annotation/0"))
        payload["objects"].append(person)
        body = json.dumps(payload).encode()
        routes = {"GET /api/images": lambda: _fetch(f"{base}/api/images"),
                  "GET /api/annotation/0": lambda: _fetch(f"{base}/api/annotation/0"),
                  "POST /api/annotation/0": lambda: _fetch(f"{base}/api/annotation/0", body),
                  "GET /api/image/0": lambda: _fetch(f"{base}/api/image/0"),
                  "GET /api/preview/0": lambda: _fetch(f"{base}/api/preview/0")}
        for route, fn in routes.items():
            latency[route] = statistics.median(_timed(fn)[1] for _ in range(TOOL_ROUNDS)) * 1e3
        saved = json.loads(_fetch(f"{base}/api/annotation/0"))
        check(saved["objects"][-1]["polygon"] == person["polygon"]
              and len(saved["objects"]) == len(payload["objects"]),
              "the POSTed polygon did not come back")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    n_labels, labels_s = _timed(lambda: create_train_id_label_imgs(root, quiet=True))
    n_instances, instances_s = _timed(lambda: create_train_id_instance_imgs(root, quiet=True))
    check(n_labels == n_instances == GT_TRAIN + GT_VAL, f"rasterised {n_labels}, {n_instances}")
    for path in polygon_files:
        ann = Annotation()
        ann.from_json_file(path)
        for suffix, want in (("_labelTrainIds.png", create_label_image(ann, "trainIds")),
                             ("_instanceTrainIds.png", create_instance_image(ann, "trainIds"))):
            got = np.asarray(Image.open(path.replace("_polygons.json", suffix)))
            check(np.array_equal(got, np.asarray(want)),
                  f"{path}: the rasterised {suffix} differs from the in-memory image")

    def generator(split):
        return BatchGenerator(image_dirs=[os.path.join(root, "leftImg8bit", split)],
                              ground_truth_dirs=[os.path.join(root, "gtFine", split)],
                              image_name_split_separator="leftImg8bit",
                              ground_truth_suffix="gtFine_labelTrainIds", num_classes=C)

    workers = min(8, os.cpu_count())
    host = dict(convert_ids_to_ids=None, resize=DATA_RESIZE, convert_to_one_hot=False)
    train_gen, val_gen = generator("train"), generator("val")
    zero_counts()
    _, train_s = _timed(lambda: model.train(
        train_gen.generate(batch_size=BATCH, seed=0, workers=workers, **host), epochs=1,
        steps_per_epoch=2, learning_rate_schedule=lambda s: 1e-4, keep_prob=0.5,
        metrics={"loss", "mean_iou"}, eval_dataset="val",
        val_generator=val_gen.generate(batch_size=GT_VAL, shuffle=False, seed=0, **host),
        val_steps=1, eval_frequency=1, record_summaries=False))
    counts = read_counts()
    for kernel in DATA_KERNELS:
        check(counts[kernel] > 0, f"{kernel} was never launched in training on rasterised GT")
    loss, evaluation = model.training_loss, model.metric_values
    check(math.isfinite(loss), f"loss {loss} on rasterised GT")
    step_ms, busy = _data_fed(model, train_gen.generate(batch_size=BATCH, seed=1,
                                                        workers=workers, **host), 2)
    out = {"label_images_per_s": n_labels / labels_s,
           "instance_images_per_s": n_instances / instances_s, "tool_ms": latency,
           "train_s": train_s, "loss": loss, "step_ms": step_ms,
           "busy": busy["share"]}
    print(f"phase 20 (c) annotate -> rasterise -> train, {GT_TRAIN} + {GT_VAL} frames of {w}x{h}, "
          f"on {smi} (host clock): label tool median of {TOOL_ROUNDS} "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in latency.items())
          + f"; rasterised PNGs = create_label_image/create_instance_image in memory; "
          f"labelTrainIds {n_labels / labels_s:.2f} images/s, instanceTrainIds "
          f"{n_instances / instances_s:.2f} images/s; train 2 steps + 1 val batch fed by "
          f"BatchGenerator(workers={workers}) at {DATA_RESIZE}: {train_s:.2f} s, loss "
          f"{loss:.5f}, eval {evaluation}; data-fed step {step_ms:.2f} "
          f"ms (host clock over 2 steps), busy {_busy(busy)}; launches {counts}")
    return counts, out


def phase_viz_prep(dev, smi: str) -> dict:
    """Phase 20 on a fresh full-width model with a redrawn decoder, in a
    temporary directory removed at the end; returns the launch counts of
    (a)-(c) summed."""
    t0 = time.perf_counter()
    model = FCN8s(num_classes=C, device=dev, seed=VIZ_SEED)
    _redraw_decoder(model, np.random.default_rng(VIZ_SEED))
    root = tempfile.mkdtemp(prefix="fcn8s_viz_")
    measured = {}
    try:
        total = dict.fromkeys(WRAPPERS, 0)
        for name, phase in (("video", phase_video), ("viewer", phase_viewer),
                            ("annotate_train", phase_annotate_train)):
            os.makedirs(os.path.join(root, name))
            t1 = time.perf_counter()
            counts, measured[name] = phase(model, os.path.join(root, name), smi)
            measured[name]["phase_s"] = time.perf_counter() - t1
            total = {k: total[k] + counts[k] for k in total}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    model.close()
    del model
    torch.cuda.empty_cache()
    print(json.dumps({"viz_prep": measured}))
    print(f"phase 20 launches: {total}; {time.perf_counter() - t0:.1f} s")
    return total


MESH_SEED = 21
MESH_STEPS = 3  # phase 21 (a): train steps of each model
MESH_TIMEOUT_S = 600  # phase 21 (b): the two ranks, launch to join
MESH_SHAPES = ((2, 1), (1, 2))  # phase 21 (b): the meshes of the two ranks


def _mesh_tree(dev) -> dict:
    """Phase 21's weights: a seeded full-width model with the decoder
    redrawn (``_redraw_decoder``), as a JAX-layout numpy tree."""
    model = FCN8s(num_classes=C, device=dev, seed=MESH_SEED)
    _redraw_decoder(model, np.random.default_rng(MESH_SEED))
    tree = bridge.to_numpy(model.params)
    model.close()
    return tree


def _same_params(a: dict, b: dict) -> bool:
    """Bit-equal trees, leaf by path (a loaded tree has the checkpoint's order)."""
    pa, pb = (_by_path(t, bridge.param_leaves(t)) for t in (a, b))
    return pa.keys() == pb.keys() and all(torch.equal(pa[k].detach(), pb[k].detach())
                                          for k in pa)


def _file_bytes_of(directory: str) -> bytes:
    with open(os.path.join(directory, "checkpoint.msgpack"), "rb") as f:
        return f.read()


def phase_mesh_world1(dev, tree: dict, root: str, smi: str) -> dict:
    """Phase 21 (a): a process group of one rank on the card (NCCL) and the
    facade on ``create_mesh()`` with ``tensor_parallel=True``, against the
    mesh-less facade on the same weights: 3 train steps at keep_prob 1 (cuDNN
    deterministic), evaluate, predict, tiled predict, save and load, each
    bit for bit. Returns the launch counts of the mesh model's run."""
    import torch.distributed as dist

    from fcn8s_tensorflow_tpu_torch.parallel.mesh import create_mesh

    rng = np.random.default_rng(MESH_SEED + 1)
    batches = [_synthetic(rng, BATCH) for _ in range(MESH_STEPS)]
    frame = rng.integers(0, 256, (1, *FRAME, 3), dtype=np.uint8)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{os.path.join(root, 'store1')}",
                            rank=0, world_size=1)
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        mesh = create_mesh(devices=[dev])
        check(mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is not None,
              f"create_mesh() over a world of 1: {mesh.shape}")
        results, counts, step_ms = [], None, {}
        for name, kw in (("plain", {}), ("mesh", dict(mesh=mesh, tensor_parallel=True))):
            model = FCN8s.from_params(tree, device=dev, seed=MESH_SEED, **kw)
            if name == "mesh":
                zero_counts()
            train = dict(learning_rate_schedule=lambda s: 1e-4, keep_prob=1.0, metrics=set(),
                         record_summaries=False)
            model.train(iter(batches[:1]), epochs=1, steps_per_epoch=1, **train)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.train(iter(batches[1:]), epochs=1, steps_per_epoch=MESH_STEPS - 1, **train)
            torch.cuda.synchronize()
            step_ms[name] = (time.perf_counter() - t0) * 1e3 / (MESH_STEPS - 1)
            out = {"loss": model.training_loss,
                   "evaluate": model.evaluate(iter(batches[:2]), 2),
                   "conf": model.metrics_state["conf_matrix"].cpu(),
                   "predict": model.predict(batches[0][0]),
                   "tiled": model.predict(frame, tile=TILE, tile_overlap=TILE_OVERLAP)}
            if name == "mesh":
                counts = read_counts()
            path = model.save(os.path.join(root, name))
            out["bytes"] = _file_bytes_of(path)
            if name == "mesh":
                loaded = FCN8s(model_load_dir=path, device=dev, **kw)
                check(_same_params(loaded.params, model.params),
                      "phase 21 (a): the loaded mesh model differs from the saved one")
                loaded.close()
                del loaded
            out["params"] = model.params
            results.append(out)
            model.close()
            del model
        plain, meshed = results
        for key in ("loss", "evaluate", "bytes"):
            check(plain[key] == meshed[key], f"phase 21 (a): {key} differs from the mesh-less run")
        for key in ("conf",):
            check(torch.equal(plain[key], meshed[key]), f"phase 21 (a): {key} differs")
        for key in ("predict", "tiled"):
            check(np.array_equal(plain[key], meshed[key]), f"phase 21 (a): {key} differs")
        check(_same_params(plain["params"], meshed["params"]),
              "phase 21 (a): the trained params differ from the mesh-less run")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        dist.destroy_process_group()
    for kernel in DATA_KERNELS:
        check(counts[kernel] > 0, f"{kernel} was never launched on the world-of-1 mesh")
    print(f"phase 21 (a) a {backend} group of one rank, FCN8s(mesh=create_mesh(), "
          f"tensor_parallel=True) vs the mesh-less facade at full width on {smi}: {MESH_STEPS} "
          f"train steps of ({BATCH}, {TH}, {TW}, 3) at keep_prob 1, evaluate, predict, tiled "
          f"predict ({FRAME[0]}x{FRAME[1]} in {TILE}), save and load bit for bit equal; step "
          f"(host clock over steps 2-{MESH_STEPS}) mesh {step_ms['mesh']:.2f} ms, mesh-less "
          f"{step_ms['plain']:.2f} ms; launches {counts}")
    return {"counts": counts, "step_ms": step_ms}


def _mesh_refs(dev, tree: dict, work: str) -> None:
    """Phase 21 (b)'s single-process references, written into ``work`` for
    the ranks: one fp32 SGD step's masters, the fp32 eval confusion matrix,
    the fp32 and bf16 predict ids, and the fp32 logits' top-2 margins."""
    rng = np.random.default_rng(MESH_SEED + 2)
    images, labels = _synthetic(rng, BATCH)
    np.savez(os.path.join(work, "batch.npz"), images=images, labels=labels)
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump({"device": str(dev), "classes": C, "batch": BATCH}, f)
    save_tree(os.path.join(work, "tree.npz"), tree)
    # fp32 references with TF32 off, as the ranks run (cuDNN defaults it on)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _mesh_ref_runs(dev, tree, work, images, labels)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _mesh_ref_runs(dev, tree: dict, work: str, images, labels) -> None:
    """``_mesh_refs``' device runs."""
    f32 = torch.float32
    params = bridge.to_port(tree, device=dev)
    opt = S.make_optimizer("sgd")
    state = S.create_train_state(params, opt)
    im, lb = torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev)
    mask = torch.ones(BATCH, device=dev)
    state, loss = S.train_step(state, im, lb, mask, MESH_SEED, 1e-3, 0.0, 1.0, optimizer=opt,
                               num_classes=C, compute_dtype=f32)
    torch.save({"loss": float(loss), "params": [t.detach().cpu() for t in
                                                bridge.param_leaves(state.params)]},
               os.path.join(work, "step_ref.pt"))
    del state, params
    refs = {}
    with torch.inference_mode():
        for dtype, tag in ((f32, "fp32"), (torch.bfloat16, "bf16")):
            run = bridge.cast_params(bridge.to_port(tree, device=dev), dtype)
            metrics = S.eval_step(run, empty_metrics_state(C, device=dev), im, lb, mask,
                                  num_classes=C, compute_dtype=dtype)
            refs[f"conf_{tag}"] = metrics["conf_matrix"].cpu().numpy()
            refs[f"ids_{tag}"] = S.predict_step(run, im, compute_dtype=dtype).cpu().numpy()
            if dtype == f32:
                logits = apply_fcn8s(run, im, compute_dtype=f32).float()
                top2 = torch.topk(logits, 2, dim=-1).values
                refs["margin"] = (top2[..., 0] - top2[..., 1]).cpu().numpy()
                refs["scale"] = float(logits.abs().max())
            del run
    np.savez(os.path.join(work, "refs.npz"), **refs)


def _gloo_cuda_check(dev) -> list:
    """Each collective the port calls, on CUDA tensors over the gloo group;
    returns their names. One that fails raises."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    done = []
    t = torch.full((5,), float(rank + 1), device=dev)
    dist.all_reduce(t)
    check(torch.equal(t, torch.full_like(t, world * (world + 1) / 2)), "gloo all_reduce SUM")
    done.append("all_reduce(SUM)")
    t = torch.full((3,), float(rank), device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    check(torch.equal(t, torch.full_like(t, world - 1)), "gloo all_reduce MAX")
    done.append("all_reduce(MAX)")
    t = torch.full((2, 2), rank, dtype=torch.int32, device=dev)
    dist.all_reduce(t)
    check(int(t[0, 0]) == world * (world - 1) // 2, "gloo all_reduce int32")
    done.append("all_reduce(int32)")
    parts = [torch.empty(4, device=dev) for _ in range(world)]
    dist.all_gather(parts, torch.full((4,), float(rank), device=dev))
    check(all(torch.equal(p, torch.full_like(p, r)) for r, p in enumerate(parts)),
          "gloo all_gather")
    done.append("all_gather")
    box = [{"rank": rank}]
    dist.broadcast_object_list(box, src=0)
    check(box[0] == {"rank": 0}, "gloo broadcast_object_list")
    done.append("broadcast_object_list")
    dist.barrier()
    done.append("barrier")
    return done


def mesh_rank_main(rank: int, world: int, store: str, work: str) -> None:
    """One rank of phase 21 (b) (``chip_smoke.py --mesh-rank R W STORE
    WORK``): a gloo group on the one card; for each mesh of
    ``MESH_SHAPES``, one fp32 SGD train step held against the
    single-process step, the fp32 eval confusion matrix and predict ids
    against the single-process ones, the bf16 ids' agreement, and one bf16
    Adam step at keep_prob 0.5 after which the leaves replicated over
    'model' are equal across its ranks. Writes ``rank<R>.json``."""
    import datetime

    import torch.distributed as dist

    from fcn8s_tensorflow_tpu_torch.parallel import collectives as CL
    from fcn8s_tensorflow_tpu_torch.parallel.mesh import (MODEL_AXIS, batch_rows, create_mesh,
                                                          gather_params, shard_params,
                                                          sharded_leaves)

    with open(os.path.join(work, "config.json")) as f:
        config = json.load(f)
    dev = torch.device(config["device"])
    check(dev.type != "cuda" or torch.cuda.is_available(),
          "no CUDA device: this script runs only on the card")
    classes, batch = config["classes"], config["batch"]
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    report = {"rank": rank}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    try:
        if dev.type == "cuda":
            build.library()
        report["gloo_cuda"] = _gloo_cuda_check(dev)
        tree = load_tree(os.path.join(work, "tree.npz"))
        whole = bridge.to_port(tree, device=dev)  # once; each use takes fresh shards of it
        del tree

        def shards(mesh):
            return {part: {name: {k: t.clone() for k, t in layer.items()}
                           for name, layer in layers.items()}
                    for part, layers in shard_params(whole, mesh, True).items()}
        with np.load(os.path.join(work, "batch.npz")) as z:
            images, labels = z["images"], z["labels"]
        refs = dict(np.load(os.path.join(work, "refs.npz")))
        step_ref = torch.load(os.path.join(work, "step_ref.pt")) if rank == 0 else None
        clear = refs["margin"] > 1e-4 * refs["scale"]
        f32, bf16 = torch.float32, torch.bfloat16
        zero_counts()
        t_path = time.perf_counter()
        for shape in MESH_SHAPES:
            tag = f"{shape[0]}x{shape[1]}"
            mesh = create_mesh(*shape, devices=[dev] * world)
            rows = batch_rows(batch, mesh)
            local = [torch.from_numpy(a if rows is None else a[rows]).to(dev)
                     for a in (images, labels, np.ones(batch, np.float32))]
            # (1) one fp32 SGD step against the single-process step
            params = shards(mesh)
            opt = S.make_optimizer("sgd")
            state = S.create_train_state(params, opt)
            sync()
            t0 = time.perf_counter()
            state, loss = S.train_step(state, *local, MESH_SEED, 1e-3, 0.0, 1.0, optimizer=opt,
                                       num_classes=classes, compute_dtype=f32, mesh=mesh,
                                       tensor_parallel=True)
            sync()
            step_ms = (time.perf_counter() - t0) * 1e3
            full = gather_params(state.params, mesh, True)
            if rank == 0:
                worst, where = 0.0, None
                for got, want, path in zip(bridge.param_leaves(full), step_ref["params"],
                                           bridge.jax_leaf_paths(full)):
                    want = want.to(dev)
                    err = float(((got.detach() - want).abs() / (1e-6 + 2e-4 * want.abs())).max())
                    if err > worst:
                        worst, where = err, path
                check(worst <= 1.0, f"{tag}: fp32 masters after the step exceed rtol 2e-4, "
                                    f"atol 1e-6 (worst {worst:.3f} of the bound, {where})")
                check(abs(float(loss) - step_ref["loss"]) <= 1e-5 * abs(step_ref["loss"]),
                      f"{tag}: loss {float(loss)} vs {step_ref['loss']}")
                report[f"{tag}/step_worst_of_bound"] = worst
            report[f"{tag}/step_ms"] = step_ms
            del state, params, full
            # (2) eval and predict, fp32 and bf16
            for dtype, dtag in ((f32, "fp32"), (bf16, "bf16")):
                run = bridge.cast_params(shards(mesh), dtype)
                with torch.inference_mode():
                    metrics = S.eval_step(run, empty_metrics_state(classes, device=dev), *local,
                                          num_classes=classes, compute_dtype=dtype, mesh=mesh,
                                          tensor_parallel=True)
                    ids = S.predict_step(run, local[0], compute_dtype=dtype, mesh=mesh,
                                         tensor_parallel=True).cpu().numpy()
                conf = metrics["conf_matrix"].cpu().numpy()
                want_ids, want_conf = refs[f"ids_{dtag}"], refs[f"conf_{dtag}"]
                report[f"{tag}/{dtag}_ids_agree"] = float((ids == want_ids).mean())
                report[f"{tag}/{dtag}_conf_exact"] = bool(np.array_equal(conf, want_conf))
                if dtype == f32:
                    check(np.array_equal(ids[clear], want_ids[clear]),
                          f"{tag}: fp32 ids differ where the top-2 margin is clear")
                    unclear = int((~clear).sum())
                    check(int(np.abs(conf.astype(np.int64) - want_conf).sum()) <= 2 * unclear,
                          f"{tag}: fp32 confusion matrix beyond its {unclear} near-tie pixels")
                    report[f"{tag}/near_tie_pixels"] = unclear
                del run
            # (3) keep_prob 0.5: the leaves replicated over 'model' stay equal
            params = shards(mesh)
            opt = S.make_optimizer("adam")
            state = S.create_train_state(params, opt)
            state, _ = S.train_step(state, *local, MESH_SEED, 1e-4, 0.0, 0.5, optimizer=opt,
                                    num_classes=classes, compute_dtype=bf16, mesh=mesh,
                                    tensor_parallel=True)
            same = True
            for t, split in zip(bridge.param_leaves(state.params),
                                sharded_leaves(state.params, mesh, tensor_parallel=True)):
                if split:
                    continue
                hi, lo = t.detach().clone(), t.detach().clone()
                CL.all_reduce(hi, mesh, MODEL_AXIS, op=dist.ReduceOp.MAX)
                CL.all_reduce(lo, mesh, MODEL_AXIS, op=dist.ReduceOp.MIN)
                same = same and torch.equal(hi, lo)
            check(same, f"{tag}: replicated leaves differ across the 'model' ranks after a "
                        "keep_prob 0.5 step")
            report[f"{tag}/replicated_equal_kp05"] = True
            del state, params
            torch.cuda.empty_cache()
        sync()
        report["path_s"] = time.perf_counter() - t_path
        report["launches"] = read_counts()
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def phase_mesh_world2(dev, tree: dict, root: str, smi: str) -> dict:
    """Phase 21 (b): two ranks on the one card over gloo (NCCL refuses two
    ranks on one device), this script run twice with ``--mesh-rank``;
    returns each rank's report."""
    work = os.path.join(root, "world2")
    os.makedirs(work)
    t0 = time.perf_counter()
    _mesh_refs(dev, tree, work)
    refs_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    store = os.path.join(work, "store")
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(os.path.abspath(__file__))] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    logs = [open(os.path.join(work, f"rank{r}.log"), "w+") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
                               "2", store, work], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, MESH_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    for r, log in enumerate(logs):
        log.seek(0)
        text = log.read()
        log.close()
        if procs[r].returncode != 0:
            print(text[-6000:])
        check(procs[r].returncode == 0, f"phase 21 (b) rank {r} exited {procs[r].returncode}")
    reports = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    for report in reports:
        for kernel in DATA_KERNELS:
            check(report["launches"][kernel] > 0,
                  f"{kernel} was never launched on rank {report['rank']}")
    print(f"phase 21 (b) two ranks sharing one card over gloo (not a scaling figure) on {smi}: "
          f"meshes {MESH_SHAPES} at full width, batch {BATCH} of {TH}x{TW} split over 'data': "
          f"gloo took CUDA tensors for {reports[0]['gloo_cuda']}; references {refs_s:.1f} s, "
          f"ranks {ranks_s:.1f} s; rank 0 {json.dumps(reports[0])}; rank 1 "
          f"{json.dumps(reports[1])}")
    return {"reports": reports}


def phase_mesh(dev, smi: str) -> dict:
    """Phase 21: ``parallel/mesh.py`` on the card, (a) then (b), in a
    temporary directory removed at the end."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="fcn8s_mesh_")
    try:
        tree = _mesh_tree(dev)
        torch.cuda.empty_cache()
        world1 = phase_mesh_world1(dev, tree, root, smi)
        torch.cuda.empty_cache()
        world2 = phase_mesh_world2(dev, tree, root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")
    return {"world1": world1["counts"],
            "world2": [r["launches"] for r in world2["reports"]]}


SPATIAL_SEED = 22
SPATIAL_BATCH = 2  # phase 22: Cityscapes' full frame (FRAME), the option's regime
SPATIAL_STEPS = 3  # phase 22 (b): bf16 Adam steps of each rank and of the single process
SPATIAL_TIMEOUT_S = 600  # phase 22 (b): the two ranks, launch to join
SPATIAL_SHAPE = (1, 2)  # phase 22 (b): the width split over two 'model' positions
SPATIAL_LUT = np.array([TRAINIDS_TO_RGBA_DICT.get(i, (0, 0, 0, 0)) for i in range(C)],
                       np.float32)


def _frames(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Phase 22's batch: SPATIAL_BATCH random full frames and id maps."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (SPATIAL_BATCH, *FRAME, 3), dtype=np.uint8),
            rng.integers(0, C, (SPATIAL_BATCH, *FRAME), dtype=np.uint8))



def phase_spatial_world1(dev, tree: dict, root: str, smi: str) -> dict:
    """Phase 22 (a): a process group of one rank on the card (NCCL) and the
    facade on ``create_mesh()`` with ``spatial_partition=True`` (a one
    position 'model' axis: the plain layout) against the mesh-less facade
    on the same weights and a batch of full frames: a train step at
    keep_prob 1 (cuDNN deterministic), evaluate and predict, bit for bit.
    Returns the launch counts of the spatial model's run."""
    import torch.distributed as dist

    from fcn8s_tensorflow_tpu_torch.parallel.mesh import create_mesh

    images, labels = _frames(SPATIAL_SEED + 1)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(root, 'store1')}",
                            rank=0, world_size=1)
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    t0 = time.perf_counter()
    try:
        mesh = create_mesh(devices=[dev])
        results, counts = [], None
        for spatial, kw in ((False, {}), (True, dict(mesh=mesh))):
            model = FCN8s.from_params(tree, device=dev, seed=SPATIAL_SEED, **kw)
            if spatial:
                zero_counts()
            model.train(iter([(images, labels)]), epochs=1, steps_per_epoch=1,
                        learning_rate_schedule=lambda s: 1e-4, keep_prob=1.0, metrics=set(),
                        record_summaries=False, spatial_partition=spatial)
            out = {"loss": model.training_loss,
                   "evaluate": model.evaluate(iter([(images, labels)]), 1,
                                              spatial_partition=spatial),
                   "conf": model.metrics_state["conf_matrix"].cpu(),
                   "predict": model.predict(images, spatial_partition=spatial),
                   "params": model.params}
            if spatial:
                counts = read_counts()
            results.append(out)
            model.close()
            del model
        plain, spatial = results
        for key in ("loss", "evaluate"):
            check(plain[key] == spatial[key], f"phase 22 (a): {key} differs from the mesh-less run")
        check(torch.equal(plain["conf"], spatial["conf"]), "phase 22 (a): conf differs")
        check(np.array_equal(plain["predict"], spatial["predict"]), "phase 22 (a): predict differs")
        check(_same_params(plain["params"], spatial["params"]),
              "phase 22 (a): the trained params differ from the mesh-less run")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        dist.destroy_process_group()
    for kernel in DATA_KERNELS:
        check(counts[kernel] > 0, f"{kernel} was never launched in phase 22 (a)")
    print(f"phase 22 (a) an nccl group of one rank, FCN8s(mesh=create_mesh()) with "
          f"spatial_partition=True vs the mesh-less facade at full width on {smi}: a train "
          f"step of ({SPATIAL_BATCH}, {FRAME[0]}, {FRAME[1]}, 3) at keep_prob 1, evaluate and "
          f"predict bit for bit equal ({time.perf_counter() - t0:.1f} s); launches {counts}")
    return counts


def _step_memory(step) -> tuple[float, int, int]:
    """(ms, peak bytes, peak bytes above the resident ones) of one call of
    ``step`` on the card, host clock around a synchronised call."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    return ms, peak, peak - base


def _bf16_steps(dev, tree: dict, images, labels, **kw) -> dict:
    """SPATIAL_STEPS bf16 Adam steps at keep_prob 0.5 from ``tree``: the last
    ones' mean time, the largest peak memory, and (with ``kw``'s mesh) the
    halo bytes of one step."""
    from fcn8s_tensorflow_tpu_torch.parallel.collectives import halo_exchange

    params = bridge.to_port(tree, device=dev)
    opt = S.make_optimizer("adam")
    state = S.create_train_state(params, opt)
    im, lb = torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev)
    mask = torch.ones(im.shape[0], device=dev)
    times, peaks, own = [], [], []
    for _ in range(SPATIAL_STEPS):
        halo_exchange.bytes = 0
        ms, peak, above = _step_memory(lambda: S.train_step(
            state, im, lb, mask, SPATIAL_SEED, 1e-4, 0.0, 0.5, optimizer=opt, num_classes=C,
            compute_dtype=torch.bfloat16, **kw))
        times.append(ms)
        peaks.append(peak)
        own.append(above)
    halo = halo_exchange.bytes
    del state, params, opt
    torch.cuda.empty_cache()
    return {"step_ms": statistics.mean(times[1:]), "step_ms_each": times,
            "peak_bytes": max(peaks), "peak_above_resident_bytes": max(own),
            "halo_bytes_per_step": halo}


def _spatial_refs(dev, tree: dict, work: str) -> dict:
    """Phase 22 (b)'s single-process references, written into ``work`` for
    the ranks: one fp32 SGD step's masters, the fp32 eval confusion matrix,
    the fp32 ids, overlay and top-2 logit margins, the bf16 and int8 ids;
    then the bf16 Adam step's time and peak memory, returned."""
    images, labels = _frames(SPATIAL_SEED + 2)
    np.savez(os.path.join(work, "batch.npz"), images=images, labels=labels)
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump({"device": str(dev)}, f)
    save_tree(os.path.join(work, "tree.npz"), tree)
    f32, bf16 = torch.float32, torch.bfloat16
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        im, lb = torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev)
        mask = torch.ones(SPATIAL_BATCH, device=dev)
        params = bridge.to_port(tree, device=dev)
        opt = S.make_optimizer("sgd")
        state = S.create_train_state(params, opt)
        state, loss = S.train_step(state, im, lb, mask, SPATIAL_SEED, 1e-3, 0.0, 1.0,
                                   optimizer=opt, num_classes=C, compute_dtype=f32)
        torch.save({"loss": float(loss), "params": [t.detach().cpu() for t in
                                                    bridge.param_leaves(state.params)]},
                   os.path.join(work, "step_ref.pt"))
        del state, params
        refs = {}
        with torch.inference_mode():
            run = bridge.cast_params(bridge.to_port(tree, device=dev), f32)
            metrics = S.eval_step(run, empty_metrics_state(C, device=dev), im, lb, mask,
                                  num_classes=C, compute_dtype=f32)
            refs["conf_fp32"] = metrics["conf_matrix"].cpu().numpy()
            refs["ids_fp32"] = S.predict_step(run, im, compute_dtype=f32).cpu().numpy()
            refs["overlay_fp32"] = S.predict_step(run, im, compute_dtype=f32,
                                                  overlay_lut=SPATIAL_LUT).cpu().numpy()
            logits = apply_fcn8s(run, im, compute_dtype=f32).float()
            top2 = torch.topk(logits, 2, dim=-1).values
            refs["margin"] = (top2[..., 0] - top2[..., 1]).cpu().numpy()
            refs["scale"] = float(logits.abs().max())
            del run, logits, top2
            run = bridge.cast_params(bridge.to_port(tree, device=dev), bf16)
            refs["ids_bf16"] = S.predict_step(run, im, compute_dtype=bf16).cpu().numpy()
            del run
            qrun = Q.quantize_fcn8s_params(bridge.to_port(tree, device=dev), compute_dtype=bf16)
            refs["ids_int8"] = S.predict_step(qrun, im, quantized=True,
                                              compute_dtype=bf16).cpu().numpy()
            del qrun
        np.savez(os.path.join(work, "refs.npz"), **refs)
        del im, lb, mask
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()
    return _bf16_steps(dev, tree, images, labels)


def spatial_rank_main(rank: int, world: int, store: str, work: str) -> None:
    """One rank of phase 22 (b) (``chip_smoke.py --spatial-rank R W STORE
    WORK``): a gloo group on the one card and the (1, 2) mesh, the width of
    full frames split over 'model', the hand kernels in the rank: one fp32
    SGD step against the single-process step, the fp32 eval confusion
    matrix, ids and overlay, the bf16 and int8 ids against the single
    process, then bf16 Adam steps timed, with the peak memory and the halo
    bytes. Writes ``rank<R>.json``."""
    import datetime

    import torch.distributed as dist

    from fcn8s_tensorflow_tpu_torch.parallel import collectives as CL
    from fcn8s_tensorflow_tpu_torch.parallel.mesh import create_mesh

    with open(os.path.join(work, "config.json")) as f:
        dev = torch.device(json.load(f)["device"])
    check(dev.type != "cuda" or torch.cuda.is_available(),
          "no CUDA device: this script runs only on the card")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=SPATIAL_TIMEOUT_S))
    report = {"rank": rank}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    try:
        if dev.type == "cuda":
            build.library()
        mesh = create_mesh(*SPATIAL_SHAPE, devices=[dev] * world)
        # the halo's all-gather moves bytes: bf16 and int8 as uint8, on CUDA tensors
        for dtype in (torch.bfloat16, torch.int8):
            mine = torch.full((3, 2), rank + 1, dtype=dtype, device=dev)
            parts = CL._all_gather_raw(mine, mesh, "model")
            check(all(torch.equal(p, torch.full_like(mine, r + 1)) for r, p in enumerate(parts)),
                  f"gloo all_gather of {dtype} as bytes")
        tree = load_tree(os.path.join(work, "tree.npz"))
        with np.load(os.path.join(work, "batch.npz")) as z:
            images, labels = z["images"], z["labels"]
        refs = dict(np.load(os.path.join(work, "refs.npz")))
        clear = refs["margin"] > 1e-4 * refs["scale"]
        f32, bf16 = torch.float32, torch.bfloat16
        im, lb = torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev)
        mask = torch.ones(im.shape[0], device=dev)
        layout = dict(mesh=mesh, spatial_partition=True)
        zero_counts()
        t_path = time.perf_counter()
        # (1) one fp32 SGD step against the single-process step
        params = bridge.to_port(tree, device=dev)
        opt = S.make_optimizer("sgd")
        state = S.create_train_state(params, opt)
        sync()
        t0 = time.perf_counter()
        state, loss = S.train_step(state, im, lb, mask, SPATIAL_SEED, 1e-3, 0.0, 1.0,
                                   optimizer=opt, num_classes=C, compute_dtype=f32, **layout)
        sync()
        report["fp32_step_ms"] = (time.perf_counter() - t0) * 1e3
        if rank == 0:
            step_ref = torch.load(os.path.join(work, "step_ref.pt"))
            worst, where = 0.0, None
            for got, want, path in zip(bridge.param_leaves(state.params), step_ref["params"],
                                       bridge.jax_leaf_paths(state.params)):
                want = want.to(dev)
                err = float(((got.detach() - want).abs() / (1e-6 + 2e-4 * want.abs())).max())
                if err > worst:
                    worst, where = err, path
            check(worst <= 1.0, f"fp32 masters after the spatial step exceed rtol 2e-4, atol "
                                f"1e-6 (worst {worst:.3f} of the bound, {where})")
            check(abs(float(loss) - step_ref["loss"]) <= 1e-5 * abs(step_ref["loss"]),
                  f"spatial fp32 loss {float(loss)} vs {step_ref['loss']}")
            report["step_worst_of_bound"], report["step_worst_leaf"] = worst, where
            report["loss"], report["loss_ref"] = float(loss), step_ref["loss"]
            del step_ref
        del state, params
        # (2) eval, predict and overlay in fp32; bf16 and int8 ids
        with torch.inference_mode():
            run = bridge.cast_params(bridge.to_port(tree, device=dev), f32)
            metrics = S.eval_step(run, empty_metrics_state(C, device=dev), im, lb, mask,
                                  num_classes=C, compute_dtype=f32, **layout)
            ids = S.predict_step(run, im, compute_dtype=f32, **layout).cpu().numpy()
            overlay = S.predict_step(run, im, compute_dtype=f32, overlay_lut=SPATIAL_LUT,
                                     **layout).cpu().numpy()
            del run
            run = bridge.cast_params(bridge.to_port(tree, device=dev), bf16)
            ids_bf16 = S.predict_step(run, im, compute_dtype=bf16, **layout).cpu().numpy()
            del run
            qrun = Q.quantize_fcn8s_params(bridge.to_port(tree, device=dev), compute_dtype=bf16)
            ids_int8 = S.predict_step(qrun, im, quantized=True, compute_dtype=bf16,
                                      **layout).cpu().numpy()
            del qrun
        conf = metrics["conf_matrix"].cpu().numpy()
        check(np.array_equal(ids[clear], refs["ids_fp32"][clear]),
              "fp32 spatial ids differ where the top-2 margin is clear")
        check(np.array_equal(overlay[clear], refs["overlay_fp32"][clear]),
              "fp32 spatial overlay differs where the top-2 margin is clear")
        unclear = int((~clear).sum())
        check(int(np.abs(conf.astype(np.int64) - refs["conf_fp32"]).sum()) <= 2 * unclear,
              f"fp32 spatial confusion matrix beyond its {unclear} near-tie pixels")
        report["near_tie_pixels"] = unclear
        report["conf_exact"] = bool(np.array_equal(conf, refs["conf_fp32"]))
        for tag, got in (("bf16", ids_bf16), ("int8", ids_int8)):
            agree = float((got == refs[f"ids_{tag}"]).mean())
            check(agree >= 0.995, f"{tag} spatial ids agree with the single process on "
                                  f"{agree:.5f} of pixels, under 0.995")
            report[f"{tag}_ids_agree"] = agree
        del metrics, im, lb, mask
        torch.cuda.empty_cache()
        # (3) bf16 Adam steps at keep_prob 0.5: time, peak memory, halo bytes
        report.update(_bf16_steps(dev, tree, images, labels, **layout))
        sync()
        report["path_s"] = time.perf_counter() - t_path
        report["launches"] = read_counts()
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def phase_spatial_world2(dev, tree: dict, root: str, smi: str) -> dict:
    """Phase 22 (b): two ranks on the one card over gloo, this script run
    twice with ``--spatial-rank``; returns the single process's bf16 step
    numbers and each rank's report."""
    work = os.path.join(root, "world2")
    os.makedirs(work)
    t0 = time.perf_counter()
    single = _spatial_refs(dev, tree, work)
    refs_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    store = os.path.join(work, "store")
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(os.path.abspath(__file__))] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    logs = [open(os.path.join(work, f"rank{r}.log"), "w+") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--spatial-rank",
                               str(r), "2", store, work], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, SPATIAL_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    for r, log in enumerate(logs):
        log.seek(0)
        text = log.read()
        log.close()
        if procs[r].returncode != 0:
            print(text[-6000:])
        check(procs[r].returncode == 0, f"phase 22 (b) rank {r} exited {procs[r].returncode}")
    reports = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    for report in reports:
        for kernel in DATA_KERNELS:
            check(report["launches"][kernel] > 0,
                  f"{kernel} was never launched on spatial rank {report['rank']}")
    print(f"phase 22 (b) two ranks sharing one card over gloo (not a scaling figure) on {smi}: "
          f"mesh {SPATIAL_SHAPE}, the width of {SPATIAL_BATCH} full {FRAME[0]}x{FRAME[1]} "
          f"frames split 1024 + 1024 over 'model', full VGG-16 width; single process bf16 "
          f"Adam step {json.dumps(single)}; references {refs_s:.1f} s, ranks {ranks_s:.1f} s; "
          f"rank 0 {json.dumps(reports[0])}; rank 1 {json.dumps(reports[1])}")
    return {"single": single, "reports": reports}


def phase_spatial(dev, smi: str) -> dict:
    """Phase 22: spatial partitioning on the card, (a) then (b), in a
    temporary directory removed at the end."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="fcn8s_spatial_")
    try:
        model = FCN8s(num_classes=C, device=dev, seed=SPATIAL_SEED)
        _redraw_decoder(model, np.random.default_rng(SPATIAL_SEED))
        tree = bridge.to_numpy(model.params)
        model.close()
        del model
        torch.cuda.empty_cache()
        world1 = phase_spatial_world1(dev, tree, root, smi)
        torch.cuda.empty_cache()
        world2 = phase_spatial_world2(dev, tree, root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 22: {time.perf_counter() - t0:.1f} s")
    return {"world1": world1, "world2": [r["launches"] for r in world2["reports"]]}


# ---------------------------------------------------------------------------
# phase 23: the training-survival tools and the quickstart
# ---------------------------------------------------------------------------

SURVIVAL_SEED = 23
# the endurance recipe's shape (256x512, effective batch 16 = 2 x 8, 6
# classes, keep_prob 0.5, --augment full, EMA, plateau, save-best-only, the
# train log), cut in length only: a 64-scene pool, 10 steps an epoch, 4
# epochs, the kill 0.1 s after step 20's record, while that epoch's 2.15 GB
# asynchronous save is still writing (so the resume reads step 10's and
# replays step 20, which ``replay`` holds against the killed trainer's
# record), a throttle of THROTTLE_S a step so the kill lands mid-epoch
ENDURANCE = {"total-steps": 40, "spe": 10, "batch": 16, "grad-accum": 2, "height": 256,
             "width": 512, "dataset-size": 64, "width-mult": 1.0, "fc-channels": 4096,
             "augment": "full", "kill-at-step": 20, "kill-delay-s": 0.1, "poll-s": 0.1,
             "stall-timeout-s": 300, "first-progress-timeout-s": 600, "max-resumes": 2,
             "miou-floor": 0.0}
ENDURANCE_CUTS = ("13,000 -> 40 steps", "500 -> 10 steps an epoch", "2,048 -> 64 scenes",
                  "kill at ~6,500 -> ~21 (step 20's save still writing)",
                  "throttle 0.15 s a step")
THROTTLE_S = 0.15
ENDURANCE_TIMEOUT_S = 600
FAULT_HW = (256, 512)  # 2 x 256x512 a rank
TRAIN_KERNELS = ("maxpool2x2_code_nhwc", "maxpool2x2_bwd_nhwc", "ce_sum_per_sample", "ce_grad")
EVAL_KERNELS = ("maxpool2x2_nhwc", "ce_sum_per_sample", "confusion_matrix_accumulate")


def phase_endurance(root: str, smi: str) -> dict:
    """(a) ``tools.endurance_canonical`` at full width, run as a user runs it
    (``python -m``): a SIGKILL, a resume, the comparator; returns the report."""
    from fcn8s_tensorflow_tpu_torch.tools import child_env

    report = os.path.join(root, "endurance_report.json")
    cmd = [sys.executable, "-m", "fcn8s_tensorflow_tpu_torch.tools.endurance_canonical",
           "--device", "cuda", "--packed", os.path.join(root, "packed"),
           "--out-root", os.path.join(root, "out"), "--report", report]
    for key, value in ENDURANCE.items():
        cmd += [f"--{key}", str(value)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, env=dict(child_env(), ENDURANCE_THROTTLE_S=str(THROTTLE_S)),
                         capture_output=True, text=True, timeout=ENDURANCE_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(out.returncode == 0, f"endurance run failed (rc {out.returncode}):\n"
          f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    with open(report) as f:
        rep = json.load(f)
    check(rep["bitexact_resume"], "the killed and resumed run is not bit-exact: "
          f"{rep['final']['fingerprint']} vs {rep['comparator']['fingerprint']}")
    check(rep["replay"]["match"], "the resumed trainer's replayed train-log records differ "
          f"from the killed trainer's: {rep['replay']}")
    check(rep["all_losses_finite"], "a non-finite training loss")
    kills = [e for e in rep["events"] if e["event"] == "sigkill"]
    check(len(kills) == 1 and rep["final"]["final_step"] == ENDURANCE["total-steps"],
          f"events {rep['events']}, final step {rep['final']['final_step']}")
    for who in ("final", "comparator"):
        counts = rep[who]["launches"]
        for name in TRAIN_KERNELS + EVAL_KERNELS:
            check(counts[name] > 0, f"{name} never launched in the endurance {who} child")
    miou = [r.get("eval_mean_iou") for r in rep["history"]]
    print(f"phase 23 (a) endurance on {smi}: {seconds:.1f} s (train {rep['wall_s_train']} s); "
          f"cuts: {'; '.join(ENDURANCE_CUTS)}; SIGKILL at logged step {kills[0]['at_step']} "
          f"(checkpoint {kills[0]['ckpt']}; writes the kill cut: {kills[0]['cut_writes']}), "
          f"resumed; bit-exact {rep['bitexact_resume']}, the killed trainer's records of steps "
          f"{rep['replay']['replayed_steps']} replayed equal, "
          f"fingerprint {rep['final']['fingerprint']}; losses finite; eval mIoU per epoch "
          f"{miou}; launches (resumed child) {rep['final']['launches']}; child seconds "
          f"(resumed, comparator): {rep['final']['seconds']}, {rep['comparator']['seconds']}")
    return {"seconds": seconds, "report": rep}


def phase_fault_injection(root: str, smi: str) -> dict:
    """(b) ``tools.multihost_fault_injection.run`` on two gloo ranks sharing
    the card, at full width (5 classes), 2 x 256x512 a rank, 4 steps."""
    from fcn8s_tensorflow_tpu_torch.models.fcn8s import init_fcn8s
    from fcn8s_tensorflow_tpu_torch.tools import multihost_fault_injection as fi

    tree = init_fcn8s(torch.Generator().manual_seed(SURVIVAL_SEED), fi.NUM_CLASSES)
    t0 = time.perf_counter()
    out = fi.run(os.path.join(root, "fault"), tree, device="cuda", hw=FAULT_HW,
                 global_batch=2 * fi.NUM_PROCESSES)
    seconds = time.perf_counter() - t0
    check(out["straight_ok"], "the straight fault-injection run failed")
    check(out["detected"], f"the injected fault was not detected: exit codes {out['fault_rcs']}")
    check(out["resume_ok"] and out["bitexact"],
          f"the resumed run differs from the straight run: {out['differing_leaves']}")
    ranks = out["results"]["straight"]
    for r, res in enumerate(ranks):
        check(res["backend"] == "gloo", f"rank {r} ran {res['backend']}")
        for name in TRAIN_KERNELS:
            check(res["launches"][name] > 0, f"{name} never launched in fault-injection rank {r}")
    step_ms = [round(1e3 * t, 1) for t in ranks[0]["step_s"]]
    print(f"phase 23 (b) fault injection on {smi}: {seconds:.1f} s; two gloo ranks on the "
          f"card, full width, 5 classes, 2 x {FAULT_HW[0]}x{FAULT_HW[1]} a rank, fp32: rank 1 "
          f"exit {out['fault_rcs'][1]}, rank 0 exit {out['fault_rcs'][0]} (detected); resumed "
          f"from step 2, params and EMA bit-exact; the gloo step (rank 0, host clock, loss "
          f"read back) {step_ms} ms; launches per rank "
          f"{[res['launches'] for res in ranks]}")
    return {"seconds": seconds, "launches": [res["launches"] for res in ranks],
            "step_ms": step_ms}


def phase_quickstart(root: str, smi: str) -> dict:
    """(c) ``examples.quickstart_synthetic`` at its defaults on the card
    (full width), in this process; returns its launch counts."""
    from fcn8s_tensorflow_tpu_torch.examples import quickstart_synthetic

    out = os.path.join(root, "quickstart")
    zero_counts()
    t0 = time.perf_counter()
    quickstart_synthetic.main(["--out", out])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    preds = sorted(os.listdir(os.path.join(out, "predictions")))
    check(len(preds) == 8 and os.path.isfile(os.path.join(out, "viewer", "index.html")),
          f"quickstart wrote {preds}")
    for name in TRAIN_KERNELS + EVAL_KERNELS:
        check(counts[name] > 0, f"{name} never launched in the quickstart")
    print(f"phase 23 (c) quickstart_synthetic at its defaults on {smi}: {seconds:.1f} s, "
          f"8 predictions and the gallery; launches {counts}")
    return {"seconds": seconds, "launches": counts}


def phase_survival(dev, smi: str) -> dict:
    """Phase 23: (a) the endurance kill-and-resume, (b) fault injection, (c)
    the quickstart, in a temporary directory removed at the end. The tools'
    children run with ``tools.make_deterministic``; this process does not."""
    del dev
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="fcn8s_survival_")
    try:
        endurance = phase_endurance(root, smi)
        fault = phase_fault_injection(root, smi)
        quick = phase_quickstart(root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 23: {time.perf_counter() - t0:.1f} s ({smi})")
    rep = endurance["report"]
    return {"endurance": rep["final"]["launches"], "comparator": rep["comparator"]["launches"],
            "fault": fault["launches"], "quickstart": quick["launches"]}


# ---------------------------------------------------------------------------
# phase 24: the measurement scripts and the tutorial notebook
# ---------------------------------------------------------------------------

BENCH_TIMEOUT_S = 600
BENCH_STEP_TOLERANCE = 0.25  # the bench's step against phase 13's
BENCH_STEP_TFLOPS = 10.68  # the JAX bench's analytic step at 8 x 1024x512 (6 x fwd MACs)
# (b): each script at its own shapes, cut in length only
SCRIPT_CUTS = {
    "overlay_bench": {"WARMUP": 1, "ITERS": 2},
    "ignore_label_bench": {"WARMUP": 2, "ITERS": 2},
    "int8_wgrad_bench": {"ITERS": 5},
    "pallas_pool_bench": {"WARMUP": 1, "ITERS": 2},
    "device_augment_bench": {"WARMUP": 1, "ITERS": 2},
    "e2e_input_bench": {"WARM_STEPS": 1, "TIMED_STEPS": 2, "ROUNDS": 1},
    "packed_input_bench": {"N_BATCHES": 5},
}
CLOSED_LOOP_ARGS = ["--steps", "4", "--batch", "4", "--val-images", "4"]
PROFILE_ARGS = ["--steps", "2", "--top", "100000"]
# the hand kernels' names in a CUPTI trace (demangled, or mangled): K4a and
# K4b are modes 1 and 2 of csrc/maxpool2x2.cu's pool_kernel, K1 the
# per-sample instance of csrc/ce_sum.cu's partial-sum kernel
PROFILE_KERNELS = {
    "maxpool2x2_code_nhwc": r"pool_kernel<\(?[^,]*Mode\)?1\b|pool_kernelILN\w*ModeE1E",
    "maxpool2x2_bwd_nhwc": r"pool_kernel<\(?[^,]*Mode\)?2\b|pool_kernelILN\w*ModeE2E",
    "ce_sum_per_sample": r"ce_partial_kernel<false|ce_partial_kernelILb0E",
    "ce_grad": r"ce_grad_kernel",
}
SCRIPT_KERNELS = ("maxpool2x2_nhwc", "maxpool2x2_code_nhwc", "maxpool2x2_bwd_nhwc",
                  "ce_sum_per_sample", "ce_sum_weighted", "ce_grad")


def phase_bench(smi: str, train_step_ms: float) -> dict:
    """(a) ``benchmarks.bench`` at its full shape, run as a user runs it."""
    from fcn8s_tensorflow_tpu_torch.tools import child_env

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "fcn8s_tensorflow_tpu_torch.benchmarks.bench"],
                         env=child_env(), capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(out.returncode == 0, f"bench failed (rc {out.returncode}):\n{out.stdout[-2000:]}\n"
          f"{out.stderr[-4000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    ex = line["extras"]
    print(f"phase 24 (a) bench on {smi}, {seconds:.1f} s: {json.dumps(line)}")
    check(line["value"] is not None and line["value"] > 0, f"bench value {line['value']}")
    ratio = ex["train_ms_per_step"] / train_step_ms
    check(abs(ratio - 1.0) <= BENCH_STEP_TOLERANCE,
          f"bench step {ex['train_ms_per_step']} ms against phase 13's {train_step_ms:.2f}")
    check(ex["train_step_analytic_tflops"] == BENCH_STEP_TFLOPS,
          f"analytic step {ex['train_step_analytic_tflops']} TFLOP, expected {BENCH_STEP_TFLOPS}")
    check(ex["mfu"] is not None, f"mfu null on {ex['device']}")
    for row in ("batched", "int8", "overlay"):
        stats = ex[f"infer_{row}_stats"]
        check(stats is not None and stats["images_per_sec_per_chip"] > 0, f"{row} row {stats}")
    return {"seconds": seconds, "line": line}


class _cut:
    """Set a module's constants for a block, then restore them."""

    def __init__(self, mod, values: dict):
        self.mod, self.values = mod, values

    def __enter__(self):
        self.old = {k: getattr(self.mod, k) for k in self.values}
        for k, v in self.values.items():
            setattr(self.mod, k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(self.mod, k, v)


def _pool_pair_check(dev) -> None:
    """The hand pool pair against ``F.max_pool2d``'s on a tie-free input at
    pool1's shape: the same max and the same dx, bit for bit."""
    from fcn8s_tensorflow_tpu_torch.benchmarks import pallas_pool_bench as pp

    g = torch.Generator(device=dev).manual_seed(24)
    n, h, w, c = pp.N, pp.H, pp.W, pp.C
    pos = torch.zeros((h, w), dtype=torch.int64, device=dev)
    pos[0::2, 1::2], pos[1::2, 0::2], pos[1::2, 1::2] = 1, 2, 3
    # the low two bits name the position in the 2x2 window: no ties
    x = (torch.randint(0, 60, (n, h, w, c), generator=g, device=dev) * 4
         + pos[None, :, :, None]).to(torch.bfloat16)
    dy = torch.randn((n, h // 2, w // 2, c), generator=g, device=dev).to(torch.bfloat16)
    (yk, dxk), (yl, dxl) = (pair(nchw(x), nchw(dy)) for pair in (pp.kernel_pair, pp.library_pair))
    check(torch.equal(yk, yl) and torch.equal(dxk, dxl),
          "the hand pool pair differs from F.max_pool2d's on a tie-free input")


def _profile_kernels(ranked: list) -> dict:
    """{wrapper: the ranked device op names that are its kernel}."""
    import re

    return {k: [name for name, _, _ in ranked if re.search(pat, name)]
            for k, pat in PROFILE_KERNELS.items()}


def phase_scripts(dev, root: str, smi: str) -> tuple[dict, dict]:
    """(b) every other script at its own shapes, cut in length, in this
    process; returns (their results, launch counts)."""
    import importlib

    from fcn8s_tensorflow_tpu_torch import benchmarks as B

    results = {}
    zero_counts()
    t0 = time.perf_counter()
    for name, cut in SCRIPT_CUTS.items():
        mod = importlib.import_module(f"fcn8s_tensorflow_tpu_torch.benchmarks.{name}")
        t1 = time.perf_counter()
        with _cut(mod, cut):
            results[name] = mod.main([] if name == "packed_input_bench" else ["--device", "cuda"])
        print(f"phase 24 (b) {name} ({cut}): {time.perf_counter() - t1:.1f} s")
    from fcn8s_tensorflow_tpu_torch.benchmarks import int8_closed_loop, profile_train_step

    results["int8_closed_loop"] = int8_closed_loop.main(
        CLOSED_LOOP_ARGS + ["--device", "cuda", "--out", os.path.join(root, "closed_loop.json")])
    prof = profile_train_step.main(PROFILE_ARGS + ["--device", "cuda", "--keep-trace",
                                                   os.path.join(root, "trace")])
    torch.cuda.synchronize()
    counts = read_counts()
    seconds = time.perf_counter() - t0
    _pool_pair_check(dev)

    check(all(results["overlay_bench"]["bit_identical_vs_v0"].values()),
          f"overlay variants differ: {results['overlay_bench']['bit_identical_vs_v0']}")
    check(results["ignore_label_bench"]["loss_rel_disagreement"] <= 1e-5,
          f"masked vs dense loss {results['ignore_label_bench']['loss_rel_disagreement']}")
    wg = results["int8_wgrad_bench"]
    check(wg["dw_rel_err_int8"] <= 5e-2 and wg["dw_rel_err_bf16"] <= 5e-3,
          f"wgrad dW errors int8 {wg['dw_rel_err_int8']}, bf16 {wg['dw_rel_err_bf16']}")
    cl = results["int8_closed_loop"]
    check(all(math.isfinite(cl[k]) for k in ("bf16_miou", "int8_miou")), f"closed loop {cl}")
    found = _profile_kernels(prof["ranked"])
    check(all(found.values()), f"hand kernels missing from the profile: {found}; ranked "
          f"{[n for n, _, _ in prof['ranked']]}")
    check(prof["steps"] == 2 and prof["device_total_ms"] > 0, f"profile {prof['steps']} steps, "
          f"{prof['device_total_ms']} ms")
    for k in SCRIPT_KERNELS:
        check(counts[k] > 0, f"{k} never launched by the scripts")
    top = [(n[:60], round(ms / prof["steps"], 3)) for n, ms, _ in prof["ranked"][:5]]
    print(f"phase 24 (b) the scripts on {smi}: {seconds:.1f} s; profile per step "
          f"{prof['device_total_ms'] / prof['steps']:.2f} ms on the card, top {top}, the hand "
          f"kernels {({k: v[0][:60] for k, v in found.items() if v})}; the pool pair equals "
          f"F.max_pool2d's; launches {counts}")
    print(json.dumps({"benchmark_scripts": results | {"profile_train_step": {
        "device_total_ms": prof["device_total_ms"], "steps": prof["steps"], "top": top}}}))
    return results, counts


def phase_notebook(root: str, smi: str) -> dict:
    """(c) the tutorial notebook's code cells at its own defaults on the
    card (6 x 50 steps at 4 x 256x512, evaluate, predict), in ``root``."""
    from fcn8s_tensorflow_tpu_torch.examples import run_notebook

    cwd = os.getcwd()
    zero_counts()
    t0 = time.perf_counter()
    os.chdir(root)
    try:
        ns = run_notebook()
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    metrics = {k: float(v) for k, v in ns["metrics"].items()}
    h, w = ns["RESOLUTION"]
    check(ns["model"].state.step == ns["EPOCHS"] * ns["STEPS_PER_EPOCH"],
          f"notebook trained {ns['model'].state.step} steps")
    check(all(math.isfinite(v) for v in metrics.values()), f"notebook metrics {metrics}")
    check(ns["grid"].shape == (2 * h, 2 * w, 3), f"notebook panels {ns['grid'].shape}")
    for k in TRAIN_KERNELS + EVAL_KERNELS:
        check(counts[k] > 0, f"{k} never launched by the notebook")
    print(f"phase 24 (c) the tutorial notebook at its defaults on {smi}: {seconds:.1f} s, "
          f"{ns['model'].state.step} steps, evaluate {metrics}; launches {counts}")
    ns["model"].close()
    return counts


def phase_benchmarks(dev, smi: str, train_step_ms: float) -> dict:
    """Phase 24: (a) the bench, (b) the other scripts, (c) the notebook, in
    a temporary directory removed at the end."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="fcn8s_benchmarks_")
    try:
        phase_bench(smi, train_step_ms)
        torch.cuda.empty_cache()
        _, scripts = phase_scripts(dev, root, smi)
        torch.cuda.empty_cache()
        notebook = phase_notebook(root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 24: {time.perf_counter() - t0:.1f} s ({smi})")
    return {"scripts": scripts, "notebook": notebook}


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
    train_step_ms = phase_train_times(dev, trained, smi)
    conv1_measured, conv1_counts = phase_conv1_calibration(dev, smi)
    measured["conv1_core"] = conv1_measured
    phase_persistence(dev, trained, smi)
    phase10_weights = bridge.to_numpy(trained.params)  # phase 19 exports them
    trained.close()
    del trained
    torch.cuda.empty_cache()
    feature_counts = phase_training_features(dev, smi)
    for name in ("maxpool2x2_code_nhwc", "maxpool2x2_bwd_nhwc", "ce_sum_per_sample", "ce_grad",
                 "maxpool2x2_nhwc", "confusion_matrix_accumulate"):
        check(feature_counts[name] > 0, f"{name} was never launched on the training-features path")
    torch.cuda.empty_cache()
    predict_counts, routes = phase_predict_rest(dev, smi)
    print(json.dumps({"library_routes": routes}))
    facade_counts = phase_facade_rest(dev, smi)
    for name in ("maxpool2x2_nhwc", "maxpool2x2_code_nhwc", "maxpool2x2_bwd_nhwc",
                 "ce_sum_per_sample", "ce_grad", "confusion_matrix_accumulate"):
        check(facade_counts[name] > 0, f"{name} was never launched on the facade's rest")
    data_counts = phase_data_export(dev, phase10_weights, smi)
    viz_counts = phase_viz_prep(dev, smi)
    for name in DATA_KERNELS:
        check(viz_counts[name] > 0, f"{name} was never launched in phase 20 (viz and prep)")
    mesh_counts = phase_mesh(dev, smi)
    torch.cuda.empty_cache()
    spatial_counts = phase_spatial(dev, smi)
    torch.cuda.empty_cache()
    survival_counts = phase_survival(dev, smi)
    torch.cuda.empty_cache()
    bench_counts = phase_benchmarks(dev, smi, train_step_ms)
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
         "launches": paths[source_path[name]][name], "path": source_path[name],
         "launches_train_features": feature_counts[name],
         "launches_predict_rest": predict_counts[name],
         "launches_facade_rest": facade_counts[name],
         "launches_data_export": data_counts[name],
         "launches_viz_prep": viz_counts[name],
         "launches_mesh": {"world1": mesh_counts["world1"][name],
                           "world2": [c[name] for c in mesh_counts["world2"]]},
         "launches_spatial": {"world1": spatial_counts["world1"][name],
                              "world2": [c[name] for c in spatial_counts["world2"]]},
         "launches_survival": {"endurance": survival_counts["endurance"][name],
                               "comparator": survival_counts["comparator"][name],
                               "fault": [c[name] for c in survival_counts["fault"]],
                               "quickstart": survival_counts["quickstart"][name]},
         "launches_benchmarks": {"scripts": bench_counts["scripts"][name],
                                 "notebook": bench_counts["notebook"][name]},
         **measured[name]}
        for name in WRAPPERS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":
        mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    elif len(sys.argv) > 1 and sys.argv[1] == "--spatial-rank":
        spatial_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        main()
