"""A/B: on-card overlay-compositing formulations for the serving path. Port
of ``benchmarks/overlay_bench.py``.

Candidates, all the same fp32 ops in the same order, so bit-identical
(checked by a full-output compare here; the script exits 1 otherwise):

  argmax_u8    the plain id map, uint8 (the reference row)
  v0_gather4   a (C, 4) fp32 row gather, then the blend on (N, H, W, 4);
               equal to ``parallel.steps.predict_step(overlay_lut=)``
  v1_planar    four (C,) planar gathers, a per-channel blend, one stack
  v2_packed32  one (C,) int32 gather (RGBA byte-packed), bit-unpacked
  v3_selects   no gather: per-class compare + select, as ``predict_step``

Timing is compute-sync: the output stays on the card, synced by a
1-element D2H. The sizes come from ``OVERLAY_BENCH_H``, ``_W``, ``_BATCH``,
``_WARMUP`` and ``_ITERS``; the device from ``--device``.

    python -m fcn8s_tensorflow_tpu_torch.benchmarks.overlay_bench [--device cuda]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..examples import add_device_argument, resolve
from . import device_name, first_element, fresh_params, log, to_device

H = int(os.environ.get("OVERLAY_BENCH_H", 1024))
W = int(os.environ.get("OVERLAY_BENCH_W", 512))
BATCH = int(os.environ.get("OVERLAY_BENCH_BATCH", 8))
NUM_CLASSES = 20
WARMUP = int(os.environ.get("OVERLAY_BENCH_WARMUP", 3))
ITERS = int(os.environ.get("OVERLAY_BENCH_ITERS", 10))


def overlay_lut(num_classes: int = NUM_CLASSES) -> np.ndarray:
    """(C, 4) fp32 RGBA rows of the Cityscapes trainId colours."""
    from ..labels import TRAINIDS_TO_RGBA_DICT

    lut = np.zeros((num_classes, 4), np.float32)
    for cid, rgba in TRAINIDS_TO_RGBA_DICT.items():
        if 0 <= cid < num_classes:
            lut[cid] = rgba
    return lut


def pred_ids(params: dict, images: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Argmax ids (N, H, W) of the forward in ``compute_dtype``, computed in
    the packed subpixel layout as ``predict_step`` computes them."""
    from ..models.fcn8s import apply_fcn8s

    logits = apply_fcn8s(params, images, compute_dtype=compute_dtype,
                         logits_dtype=compute_dtype, packed_final=True)
    pred = torch.argmax(logits, dim=-1)  # (n, H/s, W/s, s, s)
    n, h, w, s, _ = pred.shape
    return pred.permute(0, 1, 3, 2, 4).reshape(n, h * s, w * s)


def _blend(images: torch.Tensor, chan: list) -> torch.Tensor:
    """floor(img * (1 - a) + colour * a) per channel, a = alpha / 255."""
    alpha = chan[3] * (1.0 / 255.0)
    outs = [images[..., c].float() * (1.0 - alpha) + chan[c] * alpha for c in range(3)]
    return torch.floor(torch.stack(outs, dim=-1)).to(torch.uint8)


def variants(lut: np.ndarray, compute_dtype=torch.bfloat16) -> dict:
    """{name: fn(params, images)} of the five rows, the forward in
    ``compute_dtype``."""

    def argmax_u8(params, images):
        return pred_ids(params, images, compute_dtype).to(torch.uint8)

    def v0_gather4(params, images):
        pred = pred_ids(params, images, compute_dtype)
        rgba = torch.as_tensor(lut, device=images.device)[pred]  # (N, H, W, 4)
        alpha = rgba[..., 3:4] * (1.0 / 255.0)
        out = images.float() * (1.0 - alpha) + rgba[..., :3] * alpha
        return torch.floor(out).to(torch.uint8)

    def v1_planar(params, images):
        pred = pred_ids(params, images, compute_dtype)
        return _blend(images, [torch.as_tensor(lut[:, c], device=images.device)[pred]
                               for c in range(4)])

    def v2_packed32(params, images):
        pred = pred_ids(params, images, compute_dtype)
        u = lut.astype(np.uint32)
        packed = (u[:, 0] | (u[:, 1] << 8) | (u[:, 2] << 16) | (u[:, 3] << 24)).view(np.int32)
        v = torch.as_tensor(packed, device=images.device)[pred]  # (N, H, W) int32
        return _blend(images, [((v >> (8 * c)) & 255).float() for c in range(4)])

    def v3_selects(params, images):
        pred = pred_ids(params, images, compute_dtype)
        zero = torch.zeros(pred.shape, dtype=torch.float32, device=pred.device)
        chan = [zero, zero, zero, zero]
        for cls in range(lut.shape[0]):
            m = pred == cls
            for c in range(4):
                if lut[cls, c] != 0.0:
                    chan[c] = torch.where(m, float(lut[cls, c]), chan[c])
        return _blend(images, chan)

    return {"argmax_u8": argmax_u8, "v0_gather4": v0_gather4, "v1_planar": v1_planar,
            "v2_packed32": v2_packed32, "v3_selects": v3_selects}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve(args.device)

    from .. import bridge

    kind = device_name(dev)
    log(f"device: {kind}")
    with torch.no_grad():
        params = bridge.cast_params(fresh_params(NUM_CLASSES, dev), torch.bfloat16)
    rng = np.random.default_rng(0)
    images = to_device(dev, rng.integers(0, 255, (BATCH, H, W, 3), np.uint8))[0]

    def sync_ms(fn):
        for _ in range(WARMUP):
            first_element(fn(params, images))
        samples = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            first_element(fn(params, images))
            samples.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(samples))

    rows, outputs = {}, {}
    with torch.inference_mode():
        for name, fn in variants(overlay_lut()).items():
            ms = sync_ms(fn)
            rows[name] = round(ms, 1)
            log(f"{name}: {ms:.1f} ms compute-sync /batch{BATCH}")
            if name != "argmax_u8":
                outputs[name] = fn(params, images).cpu().numpy()

    ref = outputs["v0_gather4"]
    identical = {k: bool(np.array_equal(v, ref)) for k, v in outputs.items()}
    log(f"bit-identity vs v0: {identical}")
    result = {"bench": "overlay_compositing_ab", "shape": [BATCH, H, W],
              "compute_sync_ms": rows, "bit_identical_vs_v0": identical, "device": kind}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if all(main()["bit_identical_vs_v0"].values()) else 1)
