"""Streaming metrics: loss / mean-IoU / pixel accuracy, on the device.

Port of ``fcn8s_tensorflow_tpu/ops/metrics.py``. The accumulator is an
explicit dict of device tensors, as in JAX, but ``update_metrics_state``
updates it IN PLACE (JAX's arrays are immutable; here an in-place add saves
a (C, C) allocation per batch) and returns the same dict. The running
confusion matrix is int32 with rows = ground truth and cols = prediction;
each batch's counts come from the K5 kernel (``ops/kernels.py``), exact
integers up to 2^31 - 1 per cell, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..kernels import resolve_device
from .kernels import confusion_matrix_accumulate


def empty_metrics_state(num_classes: int, device="cuda") -> dict:
    """Zeroed accumulators (the reference's ``metrics_reset_op``) on
    ``device``: the card by default, as JAX's builds on its default backend;
    without a card it raises unless the caller passes ``device="cpu"``."""
    device = resolve_device(device)
    return {
        "loss_sum": torch.zeros((), dtype=torch.float32, device=device),
        "loss_count": torch.zeros((), dtype=torch.float32, device=device),
        "conf_matrix": torch.zeros((num_classes, num_classes), dtype=torch.int32, device=device),
    }


def confusion_matrix(pred_ids: torch.Tensor, gt_ids: torch.Tensor, num_classes: int,
                     sample_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(C, C) int32 counts of one batch, rows = GT, cols = prediction, from
    (N, ...) integer id maps; ``sample_mask`` (N,) of 0/1 excludes padded
    samples. Ids outside [0, C) drop out."""
    conf = torch.zeros((num_classes, num_classes), dtype=torch.int32, device=pred_ids.device)
    return _accumulate(conf, pred_ids, gt_ids, sample_mask)


def _accumulate(conf, pred_ids, gt_ids, sample_mask):
    batch = pred_ids.shape[0]
    pps = pred_ids.numel() // batch
    mask = (torch.ones(batch, dtype=torch.float32, device=pred_ids.device) if sample_mask is None
            else sample_mask.float())

    def ids(t):
        t = t.reshape(-1)
        return t if t.dtype in (torch.uint8, torch.int32) else t.to(torch.int32)

    return confusion_matrix_accumulate(conf, ids(pred_ids), ids(gt_ids), mask, pps)


def update_metrics_state(state: dict, *, loss: torch.Tensor, pred_ids: torch.Tensor,
                         gt_ids: torch.Tensor, num_classes: int,
                         sample_mask: torch.Tensor | None = None) -> dict:
    """Add one batch to ``state`` in place (the reference's
    ``metric_update_ops``) and return it. ``sample_mask`` (N,) of 0/1
    excludes batch-padding samples exactly."""
    if state["conf_matrix"].shape != (num_classes, num_classes):
        raise ValueError(f"metrics state is for {state['conf_matrix'].shape[0]} classes, "
                         f"not {num_classes}")
    state["loss_sum"] += loss.float()
    state["loss_count"] += 1.0
    _accumulate(state["conf_matrix"], pred_ids, gt_ids, sample_mask)
    return state


def per_class_iou_from_confusion(conf_matrix: torch.Tensor):
    """(C,) per-class IoU = diag / (row + col - diag) and its validity mask;
    classes absent from both GT and prediction report 0, invalid."""
    conf = conf_matrix.float()
    diag = torch.diagonal(conf)
    denom = conf.sum(dim=0) + conf.sum(dim=1) - diag
    valid = denom > 0
    iou = torch.where(valid, diag / torch.where(valid, denom, 1.0), 0.0)
    return iou, valid


def benchmark_iou_from_confusion(conf_matrix: torch.Tensor, void_class: int = 0):
    """Per-class IoU under the Cityscapes benchmark's FP rule: false
    positives exclude pixels whose ground truth is the void class (every
    ignored id collapses onto it in the modified trainId scheme). Returns
    (iou, valid); ``void_class`` and absent classes are invalid."""
    conf = conf_matrix.float()
    c = conf.shape[0]
    diag = torch.diagonal(conf)
    row = conf.sum(dim=1)
    col_nonvoid = conf.sum(dim=0) - conf[void_class, :]
    denom = diag + (col_nonvoid - diag) + (row - diag)
    valid = (denom > 0) & (torch.arange(c, device=conf.device) != void_class)
    iou = torch.where(valid, diag / torch.where(valid, denom, 1.0), 0.0)
    return iou, valid


def mean_iou_from_confusion(conf_matrix: torch.Tensor) -> torch.Tensor:
    """``tf.metrics.mean_iou``: IoU averaged over classes with a non-zero
    denominator."""
    iou, valid = per_class_iou_from_confusion(conf_matrix)
    return iou.sum() / torch.clamp(valid.sum(), min=1)


def finalize_metrics(state: dict) -> dict:
    """Resolve the accumulators to {'loss', 'mean_iou', 'accuracy'} 0-d
    tensors; accuracy = trace / sum of the integer confusion matrix."""
    conf = state["conf_matrix"].float()
    return {
        "loss": state["loss_sum"] / torch.clamp(state["loss_count"], min=1.0),
        "mean_iou": mean_iou_from_confusion(state["conf_matrix"]),
        "accuracy": torch.trace(conf) / torch.clamp(conf.sum(), min=1.0),
    }
