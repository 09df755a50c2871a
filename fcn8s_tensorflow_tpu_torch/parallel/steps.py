"""The eval and predict steps. Port of ``eval_step`` and ``predict_step`` of
``fcn8s_tensorflow_tpu/parallel/steps.py``.

One card needs no mesh or sharding, and eager PyTorch needs no compiled
executable per shape, so each step is a plain function of (params, device
tensors). The train step and the TTA step come with later parts of the
port. ``params`` are the compute-dtype params of ``bridge.cast_params``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.fcn8s import apply_fcn8s
from ..ops.kernels import softmax_cross_entropy_per_sample
from ..ops.metrics import update_metrics_state


def eval_step(params: dict, metrics_state: dict, images: torch.Tensor, label_ids: torch.Tensor,
              sample_mask: torch.Tensor, *, num_classes: int, compute_dtype=torch.bfloat16,
              ignore_label: int | None = None, class_weights=None) -> dict:
    """Forward-only metric accumulation at keep_prob=1: the forward in
    ``compute_dtype`` with logits kept in it, the per-sample CE through the
    K1 kernel with ``sample_mask``, the argmax, and the confusion matrix
    through the K5 kernel. Updates ``metrics_state`` in place and returns it."""
    if ignore_label is not None or class_weights is not None:
        raise NotImplementedError("eval_step: ignore_label and class_weights are not ported yet")
    logits = apply_fcn8s(params, images, compute_dtype=compute_dtype,
                         logits_dtype=compute_dtype)
    loss = softmax_cross_entropy_per_sample(logits, label_ids, sample_mask)
    pred = torch.argmax(logits, dim=-1).to(torch.int32)
    return update_metrics_state(metrics_state, loss=loss, pred_ids=pred, gt_ids=label_ids,
                                num_classes=num_classes, sample_mask=sample_mask)


def predict_step(params: dict, images: torch.Tensor, *, argmax: bool = True,
                 compute_dtype=torch.bfloat16, id_dtype=torch.int32, overlay_lut=None,
                 quantized: bool = False) -> torch.Tensor:
    """Inference head on NHWC ``images``: argmax ids ``(N, H, W)`` in
    ``id_dtype``, the fp32 softmax ``(N, H, W, C)`` (``argmax=False``), or
    with ``overlay_lut`` ((C, 4) RGBA rows) the alpha-composited uint8 RGB
    ``floor(img * (1 - a) + color * a)``.

    Ids are computed in the packed subpixel layout, so full-resolution
    logits never go through a depth-to-space; only the id map does. The
    overlay is the JAX package's per-class compare/select chain in fp32,
    in the same order, with the final ``floor``."""
    if quantized:
        raise NotImplementedError("predict_step: int8 serving is not ported yet")
    want_ids = argmax or overlay_lut is not None
    logits = apply_fcn8s(params, images, compute_dtype=compute_dtype,
                         logits_dtype=compute_dtype, packed_final=want_ids)
    if not want_ids:
        return torch.softmax(logits.float(), dim=-1)
    pred = torch.argmax(logits, dim=-1)  # (n, H/s, W/s, s, s)
    n, h, w, s, _ = pred.shape
    pred = pred.permute(0, 1, 3, 2, 4).reshape(n, h * s, w * s)
    if overlay_lut is None:
        return pred.to(id_dtype)
    lut = np.asarray(overlay_lut, np.float32)
    zero = torch.zeros(pred.shape, dtype=torch.float32, device=pred.device)
    chan = [zero, zero, zero, zero]
    for cls in range(lut.shape[0]):
        mask = pred == cls
        for c in range(4):
            if lut[cls, c] != 0.0:
                chan[c] = torch.where(mask, float(lut[cls, c]), chan[c])
    alpha = chan[3] * (1.0 / 255.0)
    out = [images[..., c].float() * (1.0 - alpha) + chan[c] * alpha for c in range(3)]
    return torch.floor(torch.stack(out, dim=-1)).to(torch.uint8)
