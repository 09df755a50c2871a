"""TensorBoard metric and weight-distribution logging. Port of
``fcn8s_tensorflow_tpu/engine/summaries.py``.

The same two event streams (``<name>_training``, ``<name>_evaluation``),
tags and statistics as the JAX package, written with
``torch.utils.tensorboard.SummaryWriter``: scalar loss and learning-rate
curves, and for each instrumented weight its mean, standard deviation, min,
max and a histogram of a strided sample of at most ``_HIST_SAMPLE`` values.

The statistics reduce on the tensor's device and only the sample crosses
to the host, with the four scalars, in one copy per tensor (fc6 alone is
411 MB). The port keeps convolution kernels as OIHW (``bridge``); the
sample is taken in the JAX layout (HWIO), so both packages histogram the
same values.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import bridge

# The 20 instrumented weight tensors of the reference: all six decoder
# kernels+biases plus the heavy encoder kernels.
DEFAULT_INSTRUMENTED = (
    ("decoder", "pool3_1x1"),
    ("decoder", "pool4_1x1"),
    ("decoder", "fc7_1x1"),
    ("decoder", "fc7_deconv"),
    ("decoder", "fc7_pool4_deconv"),
    ("decoder", "fc7_pool4_pool3_deconv"),
    ("encoder", "fc6"),
    ("encoder", "fc7"),
    ("encoder", "conv4_3"),
    ("encoder", "conv3_3"),
)

_HIST_SAMPLE = 65536


def summary_stats(t: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(``[mean, std, min, max]``, strided sample) of ``t`` as fp32 numpy
    arrays. ``t`` may be a non-contiguous view (a leaf in JAX layout): the
    statistics reduce it where it lies, and the sample is every
    ``numel // _HIST_SAMPLE``-th element of its row-major flattening,
    gathered by index, so the leaf is never copied whole. One
    device-to-host copy."""
    x = t.detach().float()
    n = x.numel()
    stride = max(1, n // _HIST_SAMPLE)
    idx = torch.arange(0, n, stride, device=x.device)
    sample = x[torch.unravel_index(idx, x.shape)] if x.dim() else x.reshape(1)
    var, mean = torch.var_mean(x, correction=0)
    lo, hi = torch.aminmax(x)
    host = torch.cat([torch.stack([mean, var.sqrt(), lo, hi]), sample]).cpu().numpy()
    return host[:4], host[4:]


def add_variable_summaries(writer, name: str, t: torch.Tensor, step: int) -> None:
    """mean / stddev / min / max scalars + histogram for one tensor (the
    reference's ``tf_variable_summaries`` stat set)."""
    (mean, std, lo, hi), sample = summary_stats(t)
    writer.add_scalar(f"{name}/mean", float(mean), step)
    writer.add_scalar(f"{name}/stddev", float(std), step)
    writer.add_scalar(f"{name}/min", float(lo), step)
    writer.add_scalar(f"{name}/max", float(hi), step)
    writer.add_histogram(f"{name}/histogram", sample, step)


class SummaryLogger:
    """Dual train/eval event streams with the reference's summary content."""

    def __init__(self, summaries_dir: str, summaries_name: str | None = None):
        from torch.utils.tensorboard import SummaryWriter

        name = summaries_name or "summaries"
        self.training_writer = SummaryWriter(os.path.join(summaries_dir, name + "_training"))
        self.evaluation_writer = SummaryWriter(os.path.join(summaries_dir, name + "_evaluation"))

    def log_training_step(self, step: int, loss: float, learning_rate: float) -> None:
        self.training_writer.add_scalar("total_loss", loss, step)
        self.training_writer.add_scalar("learning_rate", learning_rate, step)

    def log_weight_summaries(self, step: int, params: dict,
                             instrumented=DEFAULT_INSTRUMENTED) -> None:
        """``params``: the port's tree; each leaf is summarised in its JAX
        layout under its JAX name (``kernel``/``bias``)."""
        for group, layer in instrumented:
            if group in params and layer in params[group]:
                for key, t in params[group][layer].items():
                    path = f"{group}/{layer}/{'bias' if key == 'bias' else 'kernel'}"
                    add_variable_summaries(self.training_writer, path,
                                           bridge.leaf_to_jax(t, path), step)

    def log_evaluation(self, step: int, metric_values: dict) -> None:
        for name, value in metric_values.items():
            self.evaluation_writer.add_scalar(name, float(value), step)

    def flush(self) -> None:
        self.training_writer.flush()
        self.evaluation_writer.flush()

    def close(self) -> None:
        self.training_writer.close()
        self.evaluation_writer.close()
