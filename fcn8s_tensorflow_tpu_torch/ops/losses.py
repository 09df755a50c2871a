"""Losses. Port of ``fcn8s_tensorflow_tpu/ops/losses.py`` (the forward CE;
the masked and class-weighted variants come with the training path).

Labels are integer id maps, never one-hot: CE for a hard label is
``logsumexp(logits) - logits[label]``.
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
