"""KB, the conv1_2-core calibration: its CUDA kernel, plain twin and the
calibration run.

Port of ``benchmarks/conv1_block_calibration.py``. On the TPU that script
asked whether a hand-written kernel could reach the throughput a fused
conv1 block would need: it timed a Pallas emulation of conv1_2's forward
core (``kernel2``) against XLA's real conv1_2. Here:

* ``conv1_core`` launches ``csrc/conv1_core.cu`` (KB) on a CUDA tensor and
  takes the plain twin ``conv1_core_reference`` on a CPU tensor; it counts
  its launches in ``conv1_core.launches``;
* ``calibrate`` is the script's ``main()`` on the card, at the script's
  shapes and data: KB, its twin and cuDNN's conv1_2 forward + ReLU, timed
  with CUDA events, KB checked against the twin.

What KB computes, for an (R, W, 64) bf16 ``x`` with R a multiple of 8 (the
script's ``xmain``) and every output row r::

    out[r] = relu(sum_{ky<3} [a || a] @ w128[ky] + a @ w64[ky]),  a = x[(r + ky) mod R]

bf16 products with fp32 accumulation, rounded to bf16 once after the ReLU.
The halo wraps mod R because the script fed it from ``roll(xmain, -8, 0)``.
"""

from __future__ import annotations

import contextlib
import statistics

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..kernels import build

C = 64  # channels in and out, fixed as in the TPU kernel
TH = 8  # output rows per tile
STRIP = 128  # pixels a work item of the kernel (csrc/conv1_core.cu kStrip)
# the script's shapes (benchmarks/conv1_block_calibration.py:26-29)
CAL_TILES, CAL_W = 1024, 512
CONV_SHAPE = (8, 1024, CAL_W, C)  # its reference conv1_2 input, NHWC


def _check(x: torch.Tensor, w128: torch.Tensor, w64: torch.Tensor) -> None:
    name = "conv1_core"
    kernels.require(x.dim() == 3 and x.shape[2] == C and x.shape[0] % TH == 0 and x.shape[0] > 0
                    and x.shape[1] > 0,
                    f"{name}: x must be (R, W, {C}) with R a positive multiple of {TH}, "
                    f"got {tuple(x.shape)}")
    kernels.require(tuple(w128.shape) == (3, 2 * C, C) and tuple(w64.shape) == (3, C, C),
                    f"{name}: w128 must be (3, {2 * C}, {C}) and w64 (3, {C}, {C}), got "
                    f"{tuple(w128.shape)} and {tuple(w64.shape)}")
    for t in (x, w128, w64):
        kernels.require(t.dtype == torch.bfloat16 and t.is_contiguous()
                        and t.data_ptr() % 16 == 0,
                        f"{name}: inputs must be contiguous 16-byte aligned bf16 tensors")


@contextlib.contextmanager
def _fp32_matmul():
    """Full fp32 matrix products on the card while the twin runs."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def conv1_core_reference(x: torch.Tensor, w128: torch.Tensor, w64: torch.Tensor) -> torch.Tensor:
    """Plain twin of KB: the formula in fp32 (TF32 off on the card), the
    mod-R halo as ``torch.roll(x, -ky, 0)``, one bf16 rounding at the end."""
    with _fp32_matmul():
        xf = x.float()
        acc = None
        for ky in range(3):
            a = torch.roll(xf, -ky, 0)
            term = torch.cat([a, a], dim=-1) @ w128[ky].float() + a @ w64[ky].float()
            acc = term if acc is None else acc.add_(term)
            del a, term
        return torch.relu_(acc).to(torch.bfloat16)


def work_split(rows: int, width: int, sms: int) -> tuple[int, int, int]:
    """(strips, rows a run, runs): how KB's persistent blocks cut an (R, W)
    output. W falls into STRIP-pixel strips; R into runs of consecutive rows,
    as many as make strips x runs about one item per SM, so each input row is
    loaded once per strip and only 2 halo rows a run are loaded twice."""
    strips = -(-width // STRIP)
    runs = min(rows, max(1, sms // strips))
    run_rows = -(-rows // runs)
    return strips, run_rows, -(-rows // run_rows)


def conv1_core(x: torch.Tensor, w128: torch.Tensor, w64: torch.Tensor) -> torch.Tensor:
    """KB: ``relu(sum_ky [a || a] @ w128[ky] + a @ w64[ky])`` per output row,
    ``a = x[(r + ky) mod R]``, for x (R, W, 64) bf16 (R a multiple of 8, any
    W), w128 (3, 128, 64) and w64 (3, 64, 64) bf16; returns (R, W, 64) bf16.
    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel or
    raises."""
    if x.device.type == "cpu":
        return conv1_core_reference(x, w128, w64)
    _check(x, w128, w64)
    dev = kernels.require_cuda(x, w128, w64)
    out = torch.empty_like(x)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    strips, run_rows, runs = work_split(x.shape[0], x.shape[1], sms)
    with torch.cuda.device(dev):
        rc = build.library().fcn8s_conv1_core(x.data_ptr(), w128.data_ptr(), w64.data_ptr(),
                                              out.data_ptr(), x.shape[0], x.shape[1], run_rows,
                                              min(strips * runs, sms), kernels.stream_handle(dev))
    build.check(rc, "conv1_core")
    conv1_core.launches += 1
    return out


conv1_core.launches = 0


def within_one_bf16_step(got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within 2^-7 |want| +
    2^-7): one bf16 rounding step of the result, what two fp32 sums in
    different orders can differ by after the final bf16 rounding."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return float(diff.max()), bool((diff <= w.abs() * 2.0**-7 + 2.0**-7).all())


# ---------------------------------------------------------------------------
# the calibration on the card
# ---------------------------------------------------------------------------


def kb_flops(rows: int, width: int) -> int:
    """The script's count for the emulated core (`:88`)."""
    return rows * width * (3 * 2 * C * C + 3 * C * C) * 2


def conv_flops(shape=CONV_SHAPE) -> int:
    """The script's count for conv1_2's forward (`:106`)."""
    n, h, w, c = shape
    return n * h * w * 9 * c * c * 2


def _normal_bf16(rng, shape, device, chunk_rows: int = 512) -> torch.Tensor:
    """``rng.standard_normal(shape)`` (float64, the script's stream) as a bf16
    tensor on ``device``, drawn in slices of the first axis to bound host
    memory: consecutive draws give the same numbers as one."""
    out = torch.empty(shape, dtype=torch.bfloat16, device=device)
    for a in range(0, shape[0], chunk_rows):
        b = min(a + chunk_rows, shape[0])
        part = rng.standard_normal((b - a, *shape[1:])).astype(np.float32)
        out[a:b] = torch.from_numpy(part).to(device).to(torch.bfloat16)
    return out


def calibration_inputs(device, seed: int = 0) -> dict:
    """The script's data in its draw order (`:44-47`, `:93-94`): x
    (TILES*TH + 2, W, C), w128, w64, the conv input and its HWIO kernel, all
    bf16 on ``device``. ``xmain`` is x's first TILES*TH rows, as in the
    script."""
    rng = np.random.default_rng(seed)
    x = _normal_bf16(rng, (CAL_TILES * TH + 2, CAL_W, C), device)
    w128 = _normal_bf16(rng, (3, 2 * C, C), device)
    w64 = _normal_bf16(rng, (3, C, C), device)
    xc = _normal_bf16(rng, CONV_SHAPE, device)
    k = _normal_bf16(rng, (3, 3, C, C), device)
    return {"xmain": x[: CAL_TILES * TH], "w128": w128, "w64": w64,
            # NCHW views of NHWC memory (channels_last), OIHW kernel: what cuDNN takes
            "conv_x": xc.permute(0, 3, 1, 2),
            "conv_w": k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)}


def check_against_twin(inputs: dict) -> dict:
    """KB against its twin on the calibration data; raises unless every
    element is within one bf16 step (``within_one_bf16_step``)."""
    got = conv1_core(inputs["xmain"], inputs["w128"], inputs["w64"])
    want = conv1_core_reference(inputs["xmain"], inputs["w128"], inputs["w64"])
    err, ok = within_one_bf16_step(got, want)
    finite = bool(torch.isfinite(got.float()).all())
    if not (ok and finite):
        raise RuntimeError(f"conv1_core differs from its twin: max |diff| {err} (finite {finite})")
    return {"max_abs_err": err, "max_abs_ref": float(want.float().abs().max())}


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
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


def time_calibration(inputs: dict, reps: int = 20) -> dict:
    """The script's timings on the card: KB, its twin and cuDNN's conv1_2
    forward + ReLU (bf16, channels_last), as median ms and TFLOP/s by the
    script's FLOP counts."""
    x, w128, w64 = inputs["xmain"], inputs["w128"], inputs["w64"]
    xc, k = inputs["conv_x"], inputs["conv_w"]
    ms = _cuda_ms(lambda: conv1_core(x, w128, w64), reps)
    plain_ms = _cuda_ms(lambda: conv1_core_reference(x, w128, w64), max(3, reps // 4), warmup=1)
    cudnn_ms = _cuda_ms(lambda: torch.relu_(F.conv2d(xc, k, padding=1)), reps)
    n, c, h, w = xc.shape
    flops, cflops = kb_flops(*x.shape[:2]), conv_flops((n, h, w, c))
    return {"ms": ms, "plain_ms": plain_ms, "cudnn_ms": cudnn_ms,
            "gflop": flops / 1e9, "conv_gflop": cflops / 1e9,
            "tflops": flops / ms / 1e9, "plain_tflops": flops / plain_ms / 1e9,
            "cudnn_tflops": cflops / cudnn_ms / 1e9}


def calibrate(device) -> dict:
    """The script's ``main()`` on a CUDA ``device``: KB checked against its
    twin, then KB, the twin and cuDNN's conv1_2 timed. Returns the merged
    results of ``check_against_twin`` and ``time_calibration``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"calibrate times the card; got device {device}")
    inputs = calibration_inputs(device)
    return {**check_against_twin(inputs), **time_calibration(inputs)}
