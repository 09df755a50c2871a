"""Losses and pixel weights. Port of ``fcn8s_tensorflow_tpu/ops/losses.py``.

Labels are integer id maps, never one-hot: CE for a hard label is
``logsumexp(logits) - logits[label]``. These are the plain formulations;
the train and eval steps run the fused kernels of ``ops/kernels.py``
(``softmax_cross_entropy``), whose plain twins build on
``softmax_cross_entropy_with_ids``.
"""

from __future__ import annotations

import torch


def softmax_cross_entropy_with_ids(logits: torch.Tensor, label_ids: torch.Tensor) -> torch.Tensor:
    """Per-pixel CE in fp32. ``logits`` (..., C), ``label_ids`` (...) int.

    A label outside [0, C) picks nothing (its CE is the bare log-sum-exp):
    the semantics of the per-sample Pallas path that the K1 kernel ports
    (``softmax_cross_entropy_pallas``). JAX's own ``take_along_axis`` would
    fill such a pick with NaN; in-range labels agree exactly. This is the
    plain twin of K1 (``ops/kernels.py``)."""
    logits = logits.float()
    c = logits.shape[-1]
    ids = label_ids.long()
    valid = (ids >= 0) & (ids < c)
    picked = torch.gather(logits, -1, torch.where(valid, ids, 0).unsqueeze(-1)).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - torch.where(valid, picked, 0.0)


def mean_softmax_cross_entropy(logits: torch.Tensor, label_ids: torch.Tensor) -> torch.Tensor:
    """Scalar mean CE over all pixels (the reference's reduce_mean)."""
    return softmax_cross_entropy_with_ids(logits, label_ids).mean()


def _per_sample(sample_mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """(N,) mask -> (N, 1, ...) broadcastable against ndim-D labels."""
    return sample_mask.float().reshape(sample_mask.shape + (1,) * (ndim - 1))


def valid_pixel_weights(label_ids: torch.Tensor, sample_mask: torch.Tensor,
                        ignore_label: int) -> torch.Tensor:
    """Per-pixel 0/1 fp32 weights of ``label_ids``' shape: zero where the GT
    id equals ``ignore_label`` (Cityscapes' 255-ignore trainId scheme) or
    where the sample is batch padding."""
    valid = (label_ids.to(torch.int32) != ignore_label).float()
    return valid * _per_sample(sample_mask, label_ids.dim())


def class_pixel_weights(label_ids: torch.Tensor, sample_mask: torch.Tensor, class_weights,
                        ignore_label: int | None = None) -> torch.Tensor:
    """Per-pixel fp32 weights ``class_weights[label]`` times the batch-padding
    sample mask and, with ``ignore_label``, a validity factor. The gather is
    OOB-safe as JAX's is: the ignore id maps to slot 0 and is then zeroed;
    any other id outside [0, C) reads the slot JAX's clamped gather reads
    (negative ids wrap once, then the index clamps to [0, C-1])."""
    cw = torch.as_tensor(class_weights, dtype=torch.float32, device=label_ids.device)
    c = cw.shape[0]
    ids = label_ids.long()
    if ignore_label is not None:
        keep = ids != ignore_label
        valid = keep.float()
        ids = torch.where(keep, ids, 0)
    else:
        valid = 1.0
    ids = torch.where(ids < 0, ids + c, ids).clamp(0, c - 1)
    return cw[ids] * valid * _per_sample(sample_mask, label_ids.dim())


def median_frequency_class_weights(class_pixel_counts) -> torch.Tensor:
    """Median-frequency balancing (Eigen & Fergus 2015): weight_c =
    median(freq) / freq_c over the classes present; classes with zero
    pixels get weight 0. The median of an even count is the mean of the two
    middle values, as ``jnp.nanmedian`` takes it. Returns (C,) fp32."""
    counts = torch.as_tensor(class_pixel_counts, dtype=torch.float32)
    freq = counts / torch.clamp(counts.sum(), min=1.0)
    present = freq > 0
    if not bool(present.any()):
        return torch.zeros_like(freq)
    med = torch.quantile(freq[present], 0.5)
    return torch.where(present, med / torch.where(present, freq, 1.0), 0.0)


def masked_mean_softmax_cross_entropy(logits: torch.Tensor, label_ids: torch.Tensor,
                                      pixel_weights: torch.Tensor) -> torch.Tensor:
    """Weighted-mean CE ``sum(w * ce) / max(sum(w), 1)``. The pick index is
    clamped to 0 where the weight is zero, so an ignored (possibly out of
    range) label contributes exactly as if the pixel did not exist."""
    w = pixel_weights.float()
    safe_ids = torch.where(w > 0, label_ids.long(), 0)
    ce = softmax_cross_entropy_with_ids(logits, safe_ids)
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def softmax_cross_entropy_one_hot(logits: torch.Tensor,
                                  one_hot_labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel CE against one-hot (or soft) labels, in fp32."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    return -(one_hot_labels.float() * log_probs).sum(dim=-1)
