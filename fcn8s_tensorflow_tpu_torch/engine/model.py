"""A slim ``FCN8s`` facade for serving and evaluation on one card.

Port of the inference half of ``fcn8s_tensorflow_tpu/engine/model.py``:
construction from a seed or from a JAX param tree, ``predict`` (stride-32
padding and crop back, on-device overlay), ``evaluate`` and ``close``, with
the JAX facade's argument names. Training, checkpoints, tiling, TTA, EMA,
int8 and spatial partitioning belong to later parts of the port: their
arguments are accepted and raise ``NotImplementedError`` when set.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bridge
from ..models.fcn8s import decoder_variant, init_fcn8s
from ..ops.metrics import empty_metrics_state, finalize_metrics
from ..parallel.steps import eval_step, predict_step

_ALLOWED_METRICS = {"loss", "mean_iou", "accuracy"}


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to the PyTorch package yet")


class FCN8s:
    """FCN-8s semantic segmentation on one device (``device``, default the
    CPU). Parameters are held in fp32 (``self.params``, the port's tree) and
    once more in ``compute_dtype`` for the forward.

    Arguments follow the JAX facade: ``num_classes``; ``width_mult`` and
    ``fc_channels`` for width-scaled test models; ``variant`` 'fcn8s',
    'fcn16s' or 'fcn32s'; ``compute_dtype`` (bf16 by default);
    ``bilinear_deconv_init``; ``seed`` for the fresh init, drawn from a
    ``torch.Generator`` (not JAX's stream: use ``from_params`` to load the
    JAX package's weights)."""

    def __init__(self, num_classes: int, *, width_mult: float = 1.0,
                 fc_channels: int | None = None, variant: str = "fcn8s",
                 compute_dtype=torch.bfloat16, bilinear_deconv_init: bool = False,
                 seed: int = 0, device="cpu"):
        gen = torch.Generator().manual_seed(seed)
        tree = init_fcn8s(gen, num_classes, bilinear_deconv_init=bilinear_deconv_init,
                          width_mult=width_mult, fc_channels=fc_channels, variant=variant)
        self._setup(tree, width_mult=width_mult, fc_channels=fc_channels,
                    compute_dtype=compute_dtype, device=device)

    @classmethod
    def from_params(cls, tree: dict, *, width_mult: float = 1.0, fc_channels: int | None = None,
                    compute_dtype=torch.bfloat16, device="cpu") -> "FCN8s":
        """A model on the weights of a JAX-layout param tree (numpy arrays,
        e.g. ``init_fcn8s`` of the JAX package through ``np.asarray``).
        ``width_mult``/``fc_channels`` only describe the tree in
        ``model_config``; the shapes come from the tree."""
        model = cls.__new__(cls)
        model._setup(tree, width_mult=width_mult, fc_channels=fc_channels,
                     compute_dtype=compute_dtype, device=device)
        return model

    def _setup(self, tree, *, width_mult, fc_channels, compute_dtype, device):
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.params = bridge.to_port(tree, device=self.device)
        self._run_params = bridge.cast_params(self.params, compute_dtype)
        self.num_classes = int(tree["decoder"]["fc7_1x1"]["bias"].shape[0])
        self.variant = decoder_variant(tree["decoder"])
        self.model_config = {
            "num_classes": self.num_classes,
            "width_mult": width_mult,
            "fc_channels": fc_channels,
            "variant": self.variant,
            "ignore_label": None,
            "compute_dtype": str(compute_dtype).removeprefix("torch."),
        }
        self.metric_names = []
        self.metric_values = []

    # ------------------------------------------------------------------
    def _overlay_lut(self, color_map) -> np.ndarray:
        """(C, 4) RGBA rows for a class_id -> RGBA dict; ids outside
        [0, num_classes) (e.g. the -1 licence-plate entry) are dropped."""
        lut = np.zeros((self.num_classes, 4), np.float32)
        for class_id, rgba in color_map.items():
            if 0 <= int(class_id) < self.num_classes:
                lut[int(class_id)] = [int(x) for x in rgba]
        return lut

    @staticmethod
    def _labels_to_ids(labels: np.ndarray) -> np.ndarray:
        """One-hot (N, H, W, C) — the reference's contract — or id maps
        (N, H, W) -> uint8 id maps."""
        if labels.ndim == 4:
            return np.argmax(labels, axis=-1).astype(np.uint8)
        return labels.astype(np.uint8)

    @staticmethod
    def _prepare_images(images):
        """Pad H and W to multiples of 32 with zeros. Returns (padded,
        (n, h, w)). One card needs no batch padding."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        n, h, w = images.shape[:3]
        ph, pw = (-h) % 32, (-w) % 32
        if ph or pw:
            images = np.pad(images, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="constant")
        return images, (n, h, w)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        # copies only an array torch cannot wrap (read-only, e.g. a decoded image)
        return torch.from_numpy(np.require(array, requirements=("C", "W"))).to(self.device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def predict(self, images, argmax=True, spatial_partition=False, overlay=None,
                quantized=False, tile=None, tile_overlap=128, tile_blend=False,
                use_ema=False):
        """Predict segmentations of (N, H, W, 3) images of any H, W (padded
        to stride 32, output cropped back). Returns (N, H, W) int32 ids, the
        (N, H, W, C) softmax with ``argmax=False``, or with ``overlay`` (a
        class_id -> RGBA dict) the composited uint8 RGB, computed on the
        device. ``tile_overlap`` only matters with ``tile``."""
        if spatial_partition:
            _not_ported("predict(spatial_partition=True)")
        if quantized:
            _not_ported("predict(quantized=True)")
        if tile is not None or tile_blend:
            _not_ported("tiled predict")
        if use_ema:
            _not_ported("predict(use_ema=True)")
        lut = self._overlay_lut(overlay) if overlay is not None else None
        padded, (n, h, w) = self._prepare_images(images)
        compact = argmax and lut is None and self.num_classes <= 255
        out = predict_step(self._run_params, self._to_device(padded), argmax=argmax,
                           compute_dtype=self.compute_dtype,
                           id_dtype=torch.uint8 if compact else torch.int32, overlay_lut=lut)
        out = out.cpu().numpy()[:n, :h, :w]
        if compact:
            out = out.astype(np.int32)  # ids travel D2H compact; the API stays int32
        return out

    def predict_tta(self, *args, **kwargs):
        _not_ported("predict_tta")

    # ------------------------------------------------------------------
    def _initialize_metrics(self, metrics) -> None:
        self.metric_names = [m for m in ("loss", "mean_iou", "accuracy") if m in metrics]
        self.metric_values = []

    @torch.inference_mode()
    def _evaluate(self, data_generator, num_batches):
        """Reset the accumulators, run ``eval_step`` on ``num_batches``
        (images, labels) pairs from ``data_generator``, finalize, print."""
        state = empty_metrics_state(self.num_classes, device=self.device)
        for _ in range(num_batches):
            images, labels = next(data_generator)
            label_ids = self._labels_to_ids(np.asarray(labels))
            # one card runs a short batch as it is, so every sample counts;
            # batch padding (mask 0) comes with the multi-device path
            mask = np.ones(len(label_ids), np.float32)
            state = eval_step(self._run_params, state, self._to_device(np.asarray(images)),
                              self._to_device(label_ids), self._to_device(mask),
                              num_classes=self.num_classes, compute_dtype=self.compute_dtype)
        self.metrics_state = state
        values = {k: float(v) for k, v in finalize_metrics(state).items()}
        self.metric_values = [values[name] for name in self.metric_names]
        print("  ".join(f"{n}: {v:.4f}" for n, v in zip(self.metric_names, self.metric_values)))
        return values

    def evaluate(self, data_generator, num_batches, metrics={"loss", "mean_iou", "accuracy"},
                 l2_regularization=0.0, dataset="val", spatial_partition=False, use_ema=False):
        """Evaluate on ``num_batches`` batches of (images, labels) from
        ``data_generator``; labels are id maps or one-hot. Returns
        {'loss', 'mean_iou', 'accuracy'} floats; the running confusion
        matrix stays in ``self.metrics_state``. ``l2_regularization`` is
        accepted for parity and, as in the JAX facade, does not change the
        reported loss."""
        metrics = set(metrics)
        if not metrics <= _ALLOWED_METRICS:
            raise ValueError(f"metrics must be a subset of {_ALLOWED_METRICS}")
        if dataset not in {"train", "val"}:
            raise ValueError("dataset must be 'train' or 'val'")
        if spatial_partition:
            _not_ported("evaluate(spatial_partition=True)")
        if use_ema:
            _not_ported("evaluate(use_ema=True)")
        self.eval_dataset = dataset
        self._initialize_metrics(metrics)
        return self._evaluate(data_generator, num_batches)

    def close(self):
        """Release the device tensors (the reference closes its session)."""
        self.params = self._run_params = None
        print("The session has been closed.")
