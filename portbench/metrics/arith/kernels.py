"""The port's hand kernels: how their names read in a device trace, and the
least time each could take at the shapes of a step, from the bytes it must
move (each input read once, each output written once) over the card's
memory bandwidth. The byte counts follow the port's ``chip_smoke.py``
kernel bounds (PERF.md's kernel table): K4f reads x and writes y; K4a also
writes the uint8 window code; K4b reads dy and the code and writes dx; K1
reads the bf16 logits, the uint8 labels and the sample mask; the CE grad
reads the live rows' logits and labels and writes the whole logits'
gradient. Their FLOPs are a few per byte, far under the tensor-core peak,
so the bytes bound them all."""

from __future__ import annotations

import re

BF16 = 2

_POOL = re.compile(r"pool_kernel<[^,]*?(\d|kFwdCode|kFwd|kBwd)\b")
_MODES = {"0": "K4f", "kFwd": "K4f", "1": "K4a", "kFwdCode": "K4a", "2": "K4b", "kBwd": "K4b"}


def kernel_of(name: str) -> str | None:
    """The hand kernel a device event belongs to (K4f, K4a, K4b, K1,
    K1.final, CEgrad), or None. ``K1.final`` is K1's second, one-block
    kernel: its time is K1's, its calls are not counted apart."""
    if "pool_kernel" in name:
        found = _POOL.search(name)
        return _MODES.get(found.group(1)) if found else None
    if "ce_partial_kernel" in name:
        return "K1"
    if "ce_final_kernel" in name:
        return "K1.final"
    if "ce_grad_kernel" in name:
        return "CEgrad"
    return None


def pool_inputs(cfg: dict, n: int, hw, widths: dict | None = None) -> list[int]:
    """Elements of each pooled activation (N, C, H, W) of a forward."""
    h, w = hw
    convs = widths["convs"] if widths else [tuple(x) for x in cfg["encoder"]["conv_layers"]]
    out, s = [], 1
    for name, _, cout in convs:
        if name in cfg["encoder"]["pool_after"]:
            out.append(n * cout * (h // s) * (w // s))
            s *= 2
    return out


def step_bytes(cfg: dict, n: int, hw, kind: str, widths: dict | None = None) -> dict:
    """``{kernel: (calls, bytes)}`` of the hand kernels in one step of
    ``kind`` ('train' or 'predict') on ``n`` images of ``hw``."""
    xs = pool_inputs(cfg, n, hw, widths)
    if kind == "predict":
        return {"K4f": (len(xs), sum(x * BF16 + x // 4 * BF16 for x in xs))}
    pixels, c = n * hw[0] * hw[1], cfg["num_classes"]
    return {
        "K4a": (len(xs), sum(x * BF16 + x // 4 * (BF16 + 1) for x in xs)),
        "K4b": (len(xs), sum(x // 4 * (BF16 + 1) + x * BF16 for x in xs)),
        "K1": (1, pixels * (c * BF16 + 1) + 4 * n + 4),
        "CEgrad": (1, pixels * (c * BF16 + 1) + 4 * n + 4 + pixels * c * BF16),
    }


def roofline(kernels: dict, per_step: dict, bytes_per_s: float) -> float | None:
    """The sum of the kernels' bound times over the sum of their device
    times, as a share: ``kernels`` is ``{trace name: [calls, seconds]}``
    (summed over the ranks), ``per_step`` ``step_bytes``. Each call is
    given its kernel's mean bytes a call at these shapes. None where the
    trace holds none of them."""
    calls: dict = {}
    seconds = 0.0
    for name, (count, secs) in kernels.items():
        kernel = kernel_of(name)
        if kernel is None:
            continue
        base = kernel.split(".")[0]
        if base not in per_step:
            continue
        seconds += secs
        if kernel == base:
            calls[base] = calls.get(base, 0) + count
    if not calls or seconds <= 0:
        return None
    bound = sum(count * per_step[k][1] / per_step[k][0] / bytes_per_s for k, count in calls.items())
    return bound / seconds
