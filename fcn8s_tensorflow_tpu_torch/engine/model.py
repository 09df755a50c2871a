"""A slim ``FCN8s`` facade for training, serving, evaluation and
checkpoints on one card.

Port of ``fcn8s_tensorflow_tpu/engine/model.py``: construction from a seed,
a JAX param tree, a checkpoint (``model_load_dir``, ``resume``) or a partial
restore on a fresh model (``variables_load_dir``, ``vgg16_dir``); ``train``
(LR schedule, dropout, L2, gradient accumulation, class weights,
ignore_label, periodic evaluation, best-value bookkeeping, periodic and
best-only asynchronous saves, a JSONL train log, prefetch); ``predict``
(stride-32 padding and crop back, on-device overlay); ``evaluate``;
``save``/``load_variables``; and ``close``, with the JAX facade's argument
names. Checkpoints are the JAX package's format (``engine/checkpoint.py``):
one written by either package loads in the other. Summaries, tiling, TTA,
EMA, int8, device augmentation, the plateau and early-stopping observers
and spatial partitioning belong to later parts of the port: their
arguments are accepted and raise ``NotImplementedError`` when set.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque

import numpy as np
import torch

from .. import bridge
from . import checkpoint as ckpt
from ..data.prefetch import DevicePrefetcher, host_tensors, to_device
from ..models.fcn8s import decoder_variant, init_fcn8s
from ..ops.metrics import empty_metrics_state, finalize_metrics
from ..parallel.steps import (
    Optimizer,
    TrainState,
    create_train_state,
    eval_step,
    make_optimizer,
    predict_step,
    train_step,
)

_ALLOWED_METRICS = {"loss", "mean_iou", "accuracy"}


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to the PyTorch package yet")


def _resolve_device(device) -> torch.device:
    """The facade's device: the card unless the caller asks for the CPU. A
    CUDA device without a card raises instead of running on the host."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for device={str(device)!r}: pass device=\"cpu\" "
                           "to run on the CPU")
    return device


class FCN8s:
    """FCN-8s semantic segmentation on one device (``device``, default
    ``"cuda"``; without a card that raises, and the CPU runs only when asked
    for with ``device="cpu"``). Parameters are held in fp32 (``self.params``, the port's tree,
    whose leaves require grad) and, for inference, once more in
    ``compute_dtype`` (rebuilt whenever training moved the masters).

    Arguments follow the JAX facade: ``num_classes``, or ``model_load_dir``
    (a checkpoint directory: its ``model_config``, params, global step and
    optimizer state are restored, the compute dtype too unless
    ``compute_dtype`` is given, and the optimizer is rebuilt from its saved
    name; a user-supplied ``Optimizer`` cannot be combined with it);
    ``variables_load_dir`` (a checkpoint whose params replace a fresh
    model's) and ``vgg16_dir`` (one whose encoder params do, loaded first);
    ``width_mult`` and ``fc_channels`` for width-scaled test models;
    ``variant`` 'fcn8s', 'fcn16s' or 'fcn32s'; ``compute_dtype`` (bf16 by
    default); ``bilinear_deconv_init``; ``seed`` for the fresh init, drawn
    from a ``torch.Generator`` (not JAX's stream: load a JAX checkpoint or
    use ``from_params`` for the JAX package's weights), and for the training
    dropout draws; ``remat`` (checkpoint each encoder block and the head in
    training); ``ignore_label`` (pixels of that GT id get no loss and no
    gradient); ``optimizer`` ('adam' — TF1-exact, the default — 'adamw',
    'momentum', 'sgd', or an ``Optimizer`` from
    ``parallel.steps.make_optimizer``) with ``optimizer_kwargs`` and
    ``clip_norm``."""

    def __init__(self, num_classes: int | None = None, *, model_load_dir=None,
                 variables_load_dir=None, vgg16_dir=None, width_mult: float = 1.0,
                 fc_channels: int | None = None, variant: str = "fcn8s", compute_dtype=None,
                 bilinear_deconv_init: bool = False, seed: int = 0, device="cuda",
                 remat: bool = False, ignore_label: int | None = None, optimizer="adam",
                 optimizer_kwargs: dict | None = None, clip_norm: float | None = None):
        if model_load_dir is None and num_classes is None:
            raise ValueError(
                "You must provide either `model_load_dir` or `num_classes` "
                "(optionally with `vgg16_dir` for pretrained encoder weights).")
        device = _resolve_device(device)
        restored = None
        if model_load_dir is not None:
            cfg = ckpt.load_metadata(model_load_dir)["model_config"]
            width_mult = cfg.get("width_mult", 1.0)
            fc_channels = cfg.get("fc_channels")
            ignore_label = cfg.get("ignore_label")
            if compute_dtype is None:  # the checkpoint's own, as in the JAX facade
                compute_dtype = getattr(torch, cfg.get("compute_dtype", "bfloat16"))
            # the optimizer state only restores into the matching rule
            if not isinstance(optimizer, str):
                raise ValueError(
                    "model_load_dir restores the checkpoint's own optimizer "
                    "config; a custom Optimizer cannot be combined with it (use "
                    "variables_load_dir to load weights into a freshly-configured "
                    "model instead)")
            optimizer = cfg.get("optimizer", "adam")
            if optimizer == "custom":
                raise ValueError(
                    "this checkpoint was trained with a user-supplied optimizer, "
                    "which cannot be rebuilt from config; construct "
                    "FCN8s(num_classes=..., optimizer=<yours>, variables_load_dir=...) "
                    "to restore the weights into it instead")
            optimizer_kwargs = cfg.get("optimizer_kwargs")
            clip_norm = cfg.get("clip_norm")
            restored = ckpt.load_checkpoint(model_load_dir, make_optimizer(
                optimizer, clip_norm=clip_norm, **(optimizer_kwargs or {})))
            params = restored["params"]
        else:
            gen = torch.Generator().manual_seed(seed)
            params = bridge.to_port(init_fcn8s(
                gen, num_classes, bilinear_deconv_init=bilinear_deconv_init,
                width_mult=width_mult, fc_channels=fc_channels, variant=variant))
        self._setup(params, width_mult=width_mult, fc_channels=fc_channels,
                    compute_dtype=torch.bfloat16 if compute_dtype is None else compute_dtype,
                    device=device, seed=seed, remat=remat, ignore_label=ignore_label,
                    optimizer=optimizer, optimizer_kwargs=optimizer_kwargs, clip_norm=clip_norm)
        if restored is not None:
            self.state.step = self.g_step = restored["step"] or 0
            # staged on the host: a model loaded to serve never puts the
            # optimizer's moments on the card; the first train() moves them
            self._staged_opt_state = restored["opt_state"]
            self._ema_leaves = restored["ema_leaves"]
            self._observer_state = dict(restored["metadata"].get("train_observer") or {})
        else:
            # the reference's order: pretrained encoder, then a variables restore
            if vgg16_dir is not None:
                self._restore_params(vgg16_dir, parts=("encoder",))
            if variables_load_dir is not None:
                self.load_variables(variables_load_dir)

    @classmethod
    def from_params(cls, tree: dict, *, width_mult: float = 1.0, fc_channels: int | None = None,
                    compute_dtype=torch.bfloat16, device="cuda", seed: int = 0,
                    remat: bool = False, ignore_label: int | None = None, optimizer="adam",
                    optimizer_kwargs: dict | None = None,
                    clip_norm: float | None = None) -> "FCN8s":
        """A model on the weights of a JAX-layout param tree (numpy arrays,
        e.g. ``init_fcn8s`` of the JAX package through ``np.asarray``).
        ``width_mult``/``fc_channels`` only describe the tree in
        ``model_config``; the shapes come from the tree. The other arguments
        are the constructor's."""
        device = _resolve_device(device)
        model = cls.__new__(cls)
        model._setup(bridge.to_port(tree), width_mult=width_mult, fc_channels=fc_channels,
                     compute_dtype=compute_dtype, device=device, seed=seed, remat=remat,
                     ignore_label=ignore_label, optimizer=optimizer,
                     optimizer_kwargs=optimizer_kwargs, clip_norm=clip_norm)
        return model

    @classmethod
    def resume(cls, save_dir: str, **kwargs) -> "FCN8s":
        """Resume from the most recent checkpoint under ``save_dir`` (the
        directory passed to ``train(save_dir=...)``): params, optimizer
        state and the global step, so LR schedules continue where they left
        off. ``kwargs`` go to the constructor."""
        path = ckpt.latest_checkpoint(save_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {save_dir}")
        return cls(model_load_dir=path, **kwargs)

    def _setup(self, params, *, width_mult, fc_channels, compute_dtype, device, seed, remat,
               ignore_label, optimizer, optimizer_kwargs, clip_norm):
        """``params``: the port's fp32 tree on the CPU."""
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.params = {part: {name: {k: t.to(self.device) for k, t in layer.items()}
                              for name, layer in layers.items()}
                       for part, layers in params.items()}
        self.num_classes = int(self.params["decoder"]["fc7_1x1"]["bias"].shape[0])
        self.variant = decoder_variant(self.params["decoder"])
        self.remat = remat
        self.ignore_label = ignore_label
        self._train_seed = seed
        if isinstance(optimizer, str):
            self.optimizer = make_optimizer(optimizer, clip_norm=clip_norm,
                                            **(optimizer_kwargs or {}))
        elif isinstance(optimizer, Optimizer):
            self.optimizer = optimizer
        else:
            raise TypeError("optimizer must be a name or an Optimizer from make_optimizer")
        self.model_config = {
            "num_classes": self.num_classes,
            "width_mult": width_mult,
            "fc_channels": fc_channels,
            "variant": self.variant,
            "ignore_label": ignore_label,
            "compute_dtype": str(compute_dtype).removeprefix("torch."),
            "optimizer": optimizer if isinstance(optimizer, str) else "custom",
            "optimizer_kwargs": optimizer_kwargs,
            "clip_norm": clip_norm,
        }
        # the optimizer state (Adam's two moments, 1 GB at full width) is
        # allocated, or moved from the host where a checkpoint staged it, by
        # the first train(), so a serving model never holds it
        self.state = TrainState(step=0, params=self.params, opt_state=None)
        self._staged_opt_state = None
        self._ema_leaves = None  # a restored JAX EMA average, carried through saves
        self._observer_state = {}  # restored observer counters, carried through saves
        self._save_thread = None
        for t in bridge.param_leaves(self.params):
            t.requires_grad_(True)
        self._refresh_run_params()
        self._class_weights = None
        self._grad_accum = 1
        self._train_stream = None
        self.variables_updated = False
        self.eval_dataset = None
        self.metric_names = []
        self.metric_values = []
        self.best_metric_values = []
        self.training_loss = None
        self.best_training_loss = 99999999.9
        self.g_step = 0

    def _refresh_run_params(self) -> None:
        """(Re)build the compute-dtype tree that predict and evaluate read,
        from the current masters. Stale after any optimizer step."""
        with torch.no_grad():
            self._run_params = bridge.cast_params(self.params, self.compute_dtype)

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
    def _pad_batch_dim(*arrays, multiple: int):
        """Pad the batch dim up to a multiple of ``multiple`` by repeating the
        last sample; returns (padded_arrays..., sample_mask), the mask 0 on
        the padding, which keeps loss and gradient exactly the short
        batch's."""
        n = arrays[0].shape[0]
        pad = (-n) % multiple
        mask = np.ones((n + pad,), np.float32)
        if pad:
            mask[n:] = 0.0
            arrays = tuple(np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
                           for a in arrays)
        return (*arrays, mask)

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
    def train(self, train_generator, epochs, steps_per_epoch, learning_rate_schedule,
              keep_prob=0.5, l2_regularization=0.0, eval_dataset="train", eval_frequency=5,
              val_generator=None, val_steps=None, metrics={}, save_during_training=False,
              save_dir=None, save_best_only=True, save_tags=["default"], save_name="",
              save_frequency=5, saver="saved_model", monitor="loss", record_summaries=True,
              summaries_frequency=10, summaries_dir=None, summaries_name=None,
              training_loss_display_averaging=3, device_augment=None, prefetch=2,
              gradient_accumulation=1, spatial_partition=False, ema_decay=None,
              class_weights=None, early_stopping=None, reduce_lr_on_plateau=None,
              train_log=None):
        """Train the model, with the JAX facade's signature and validation
        order. The generator yields (images, ground_truth), GT one-hot
        (N, H, W, C) or id maps (N, H, W); ``learning_rate_schedule`` is a
        ``step -> float`` callable re-evaluated every step; ``metrics``
        (a subset of {'loss', 'mean_iou', 'accuracy'}) are evaluated every
        ``eval_frequency`` epochs on ``eval_dataset`` 'train' (sharing the
        training stream) or 'val' (``val_steps`` batches of
        ``val_generator``). ``keep_prob`` and ``l2_regularization`` feed the
        loss; ``gradient_accumulation=A`` splits each batch (padded with
        masked samples to a multiple of A) into A microbatches;
        ``class_weights`` ((num_classes,), non-negative) makes the loss the
        weighted mean and persists for later ``evaluate`` calls;
        ``prefetch`` is the depth of the background input pipeline (0:
        synchronous). The loss is read back from the card only every
        ``summaries_frequency`` steps and at each epoch's end
        (``training_loss`` averages the last
        ``training_loss_display_averaging`` steps). ``train_log`` appends
        one JSON record per epoch. ``save_during_training`` saves into
        ``save_dir`` every ``save_frequency`` epochs, asynchronously
        (``save(block=False)``), and with ``save_best_only`` only when
        ``monitor`` improved (``_monitor_improved``); ``saver``,
        ``save_tags`` and ``save_name`` are ``save``'s.

        Not ported yet (``NotImplementedError``): ``record_summaries`` (the JAX default True first requires
        ``summaries_dir``, as there; pass ``record_summaries=False``),
        ``device_augment``, ``ema_decay``, ``spatial_partition``,
        ``early_stopping`` and ``reduce_lr_on_plateau``."""
        metrics = set(metrics)  # the reference's default `{}` is a dict literal
        if not metrics <= _ALLOWED_METRICS:
            raise ValueError(f"metrics must be a subset of {_ALLOWED_METRICS}, got {metrics}")
        if monitor not in _ALLOWED_METRICS:
            raise ValueError(f"monitor must be one of {_ALLOWED_METRICS}, got '{monitor}'")
        if eval_dataset not in {"train", "val"}:
            raise ValueError("eval_dataset must be 'train' or 'val'")
        if eval_dataset == "val" and (val_generator is None or val_steps is None):
            raise ValueError("eval_dataset == 'val' requires val_generator and val_steps")
        if save_during_training and save_dir is None:
            raise ValueError("save_during_training requires save_dir")
        if monitor != "loss" and monitor not in metrics:
            raise ValueError(f"monitor '{monitor}' requires it to be in metrics {metrics}")
        if ema_decay is not None and not (0.0 < float(ema_decay) < 1.0):
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        if ema_decay is not None:
            _not_ported("train(ema_decay=...)")
        if early_stopping is not None:
            _not_ported("train(early_stopping=...)")
        if reduce_lr_on_plateau is not None:
            _not_ported("train(reduce_lr_on_plateau=...)")
        if class_weights is not None:
            cw = tuple(float(w) for w in np.asarray(class_weights).reshape(-1))
            if len(cw) != self.num_classes:
                raise ValueError(f"class_weights must have length num_classes="
                                 f"{self.num_classes}, got {len(cw)}")
            if any(w < 0 for w in cw):
                raise ValueError("class_weights must be non-negative")
            self._class_weights = torch.tensor(cw, dtype=torch.float32, device=self.device)
        else:
            self._class_weights = None
        if gradient_accumulation < 1:
            raise ValueError(f"gradient_accumulation must be >= 1, got {gradient_accumulation}")
        self._grad_accum = gradient_accumulation
        if spatial_partition:
            _not_ported("train(spatial_partition=True)")
        if device_augment is not None:
            _not_ported("train(device_augment=...)")
        self.eval_dataset = eval_dataset
        self._initialize_metrics(metrics)
        if record_summaries:
            if summaries_dir is None:
                raise ValueError("record_summaries requires summaries_dir")
            _not_ported("train(record_summaries=True)")

        if self.state.opt_state is None:
            if self._staged_opt_state is not None:  # restored from a checkpoint
                self.state.opt_state = self._staged_opt_state.to(self.device)
                self._staged_opt_state = None
            else:
                self.state = create_train_state(self.params, self.optimizer)
                self.state.step = self.g_step
        g_step = self.state.step
        learning_rate = float(learning_rate_schedule(g_step))
        loss_history = deque(maxlen=training_loss_display_averaging)
        train_stream = self._make_train_stream(train_generator, prefetch)
        try:
            for epoch in range(1, epochs + 1):
                for step_i in range(steps_per_epoch):
                    im_d, lb_d, mask_d = next(train_stream)
                    self.state, loss = train_step(
                        self.state, im_d, lb_d, mask_d, self._train_seed, learning_rate,
                        l2_regularization, keep_prob, optimizer=self.optimizer,
                        num_classes=self.num_classes, compute_dtype=self.compute_dtype,
                        remat=self.remat, grad_accum=self._grad_accum,
                        ignore_label=self.ignore_label, class_weights=self._class_weights)
                    g_step += 1
                    self.variables_updated = True
                    loss_history.append(loss)  # a device scalar: no sync
                    # read the loss back only on the display cadence and at the
                    # epoch's end, so the host runs ahead of the card between
                    if g_step % summaries_frequency == 0 or step_i == steps_per_epoch - 1:
                        self.training_loss = float(torch.stack(list(loss_history)).mean())
                    learning_rate = float(learning_rate_schedule(g_step))
                self.g_step = g_step
                epoch_lr = learning_rate  # what the train log of the JAX facade records
                print(f"Epoch {epoch}/{epochs}: training loss {self.training_loss}, "
                      f"learning rate {epoch_lr:.3g}")

                evaluated = bool(metrics and eval_frequency and epoch % eval_frequency == 0)
                if evaluated:
                    self._refresh_run_params()
                    if eval_dataset == "train":
                        self._evaluate(train_stream, steps_per_epoch, device_stream=True)
                    else:
                        self._evaluate(val_generator, val_steps)

                if save_during_training and epoch % save_frequency == 0:
                    if not save_best_only or self._monitor_improved(monitor):
                        # the masters are consistent here: save() snapshots
                        # them on the device and writes on a thread
                        self.save(model_save_dir=save_dir, saver=saver, tags=save_tags,
                                  name=save_name or None, block=False)

                if self.training_loss is not None and self.training_loss < self.best_training_loss:
                    self.best_training_loss = self.training_loss
                for i, name in enumerate(self.metric_names):
                    if i < len(self.metric_values):
                        better = (self.metric_values[i] < self.best_metric_values[i]
                                  if name == "loss"
                                  else self.metric_values[i] > self.best_metric_values[i])
                        if better:
                            self.best_metric_values[i] = self.metric_values[i]

                if train_log:
                    record = {"epoch": epoch, "global_step": g_step,
                              "training_loss": self.training_loss, "learning_rate": epoch_lr,
                              "time": time.time()}
                    if evaluated and self.metric_values:
                        record.update({f"eval_{n}": float(v) for n, v in
                                       zip(self.metric_names, self.metric_values)})
                    with open(train_log, "a") as log_f:
                        log_f.write(json.dumps(record) + "\n")
        finally:
            self._close_train_stream()
            self._refresh_run_params()
        self._join_pending_save()  # don't return with a checkpoint mid-write

    def _make_train_stream(self, train_generator, prefetch: int):
        """Iterator of device (images, label_ids, mask) triples. The host
        part converts labels to uint8 ids and pads the batch to a multiple
        of the gradient accumulation (masked samples). With ``prefetch > 0``
        a background thread runs it ``prefetch`` batches ahead, in pinned
        memory; with 0 it runs in the caller, synchronously."""
        self._close_train_stream()
        accum = self._grad_accum

        def host_pipeline():
            while True:
                images, labels = next(train_generator)
                label_ids = self._labels_to_ids(np.asarray(labels))
                yield self._pad_batch_dim(np.asarray(images), label_ids, multiple=accum)

        if prefetch and prefetch > 0:
            self._train_stream = DevicePrefetcher(host_pipeline(), self.device, depth=prefetch)
            return self._train_stream
        pin = self.device.type == "cuda"
        return (to_device(host_tensors(batch, pin), self.device) for batch in host_pipeline())

    def _close_train_stream(self) -> None:
        if self._train_stream is not None:
            self._train_stream.close()
            self._train_stream = None

    # ------------------------------------------------------------------
    def _initialize_metrics(self, metrics) -> None:
        self.metric_names = [m for m in ("loss", "mean_iou", "accuracy") if m in metrics]
        self.metric_values = []
        self.best_metric_values = [99999999.9 if n == "loss" else -1.0 for n in self.metric_names]

    @torch.inference_mode()
    def _evaluate(self, data_generator, num_batches, device_stream=False):
        """Reset the accumulators, run ``eval_step`` on ``num_batches``
        batches, finalize, print. ``data_generator`` yields host (images,
        labels) pairs, or with ``device_stream`` the training stream's device
        (images, label_ids, mask) triples."""
        state = empty_metrics_state(self.num_classes, device=self.device)
        for _ in range(num_batches):
            if device_stream:
                im_d, lb_d, mask_d = next(data_generator)
            else:
                images, labels = next(data_generator)
                label_ids = self._labels_to_ids(np.asarray(labels))
                # one card runs a short batch as it is, so every sample counts
                mask = np.ones(len(label_ids), np.float32)
                im_d, lb_d, mask_d = (self._to_device(np.asarray(images)),
                                      self._to_device(label_ids), self._to_device(mask))
            state = eval_step(self._run_params, state, im_d, lb_d, mask_d,
                              num_classes=self.num_classes, compute_dtype=self.compute_dtype,
                              ignore_label=self.ignore_label, class_weights=self._class_weights)
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
        matrix stays in ``self.metrics_state``. The loss honours
        ``ignore_label`` and the class weights of the last ``train``.
        ``l2_regularization`` is accepted for parity and, as in the JAX
        facade, does not change the reported loss."""
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

    def _monitor_improved(self, monitor) -> bool:
        """Save-best-only, as in the JAX facade: save iff the monitored value
        improved on its best so far (lower for loss, higher otherwise).
        Until the monitored eval metric has been measured once, every
        save epoch saves (the first save wins)."""
        if monitor == "loss" and "loss" not in self.metric_names:
            return self.training_loss is not None and self.training_loss < self.best_training_loss
        if monitor not in self.metric_names or not self.metric_values:
            return True
        i = self.metric_names.index(monitor)
        if monitor == "loss":
            return self.metric_values[i] < self.best_metric_values[i]
        return self.metric_values[i] > self.best_metric_values[i]

    # ------------------------------------------------------------------
    def save(self, model_save_dir, saver="saved_model", tags=["default"], name=None,
             include_global_step=True, include_last_training_loss=True, include_metrics=True,
             force_save=False, block=True):
        """Save a self-describing checkpoint in the JAX package's format under
        ``model_save_dir``, in a directory named by the reference's scheme
        (global step, training loss, metrics); returns its path, or None when
        nothing was trained since the last save (unless ``force_save``).
        ``saver``/``tags`` are accepted for parity. The five newest
        checkpoints in ``model_save_dir`` are kept.

        ``block=False`` snapshots params and optimizer state on the device
        (the optimizer updates them in place) and writes on a thread
        (``checkpoint.save_checkpoint_async``); the previous writer is joined
        first, so one save is in flight at a time, and a failed write raises
        at the next join (the next save, ``train``'s end or ``close``)."""
        if not self.variables_updated and not force_save:
            print("Abort: Nothing to save, no training has been performed since the model "
                  "was last saved.")
            return None
        if saver not in {"saved_model", "train_saver", "msgpack"}:
            raise ValueError(
                "Unexpected value for `saver`: Can be either 'saved_model' or "
                f"'train_saver', but received '{saver}'.")
        metric_values = (dict(zip(self.metric_names, self.metric_values))
                         if include_metrics and self.metric_values else None)
        step = int(self.state.step)
        directory = os.path.join(model_save_dir, ckpt.compose_checkpoint_name(
            name=name, global_step=step if include_global_step else None,
            training_loss=self.training_loss if include_last_training_loss else None,
            eval_dataset=self.eval_dataset, metric_values=metric_values))
        metadata = {
            "model_config": self.model_config,
            "global_step": step,
            "training_loss": self.training_loss,
            "eval_dataset": self.eval_dataset,
            "metrics": metric_values or {},
            "saved_at": time.time(),
        }
        if self._observer_state:
            metadata["train_observer"] = dict(self._observer_state)
        opt_state = (self.state.opt_state or self._staged_opt_state
                     or self.optimizer.init(self.params, device="cpu"))
        state = TrainState(step=step, params=self.params, opt_state=opt_state)
        self._join_pending_save()
        if block:
            ckpt.save_checkpoint(directory, state, metadata, max_to_keep=5,
                                 ema_leaves=self._ema_leaves)
        else:
            self._save_thread = ckpt.save_checkpoint_async(directory, state, metadata,
                                                           max_to_keep=5,
                                                           ema_leaves=self._ema_leaves)
        self.variables_updated = False
        return directory

    def _join_pending_save(self) -> None:
        thread = self._save_thread
        if thread is not None:
            thread.join()
            self._save_thread = None
            if thread.exc is not None:
                # the dirty flag was cleared at the save: re-arm it and surface
                self.variables_updated = True
                raise RuntimeError("async checkpoint write failed") from thread.exc

    def load_variables(self, path):
        """Restore the params only, from the checkpoint directory ``path``
        (the reference's ``load_variables``); the optimizer state stays."""
        self._restore_params(path, parts=tuple(self.params))

    def _restore_params(self, path, parts) -> None:
        """Copy the checkpoint's params of the tree parts ``parts`` (e.g.
        ``('encoder',)``, ``vgg16_dir``'s restore) into the masters, matched
        by path."""
        example = {}  # JAX-layout shapes, as meta tensors
        for part in parts:
            for name, layer in self.params[part].items():
                for key, t in layer.items():
                    jkey = "bias" if key == "bias" else "kernel"
                    example.setdefault(part, {}).setdefault(name, {})[jkey] = bridge.leaf_to_jax(
                        torch.empty_like(t, device="meta"), f"{part}/{name}/{jkey}")
        restored = ckpt.load_params_only(path, example)
        with torch.no_grad():
            for part in parts:
                for name, layer in self.params[part].items():
                    for key, t in layer.items():
                        jkey = "bias" if key == "bias" else "kernel"
                        value = torch.from_numpy(restored[part][name][jkey])
                        t.copy_(bridge.leaf_from_jax(value, f"{part}/{name}/{jkey}"))
        self._refresh_run_params()

    def close(self):
        """Stop the input pipeline, join an in-flight checkpoint write and
        release the device tensors (the reference closes its session)."""
        self._close_train_stream()
        try:
            self._join_pending_save()
        finally:
            self.params = self._run_params = self.state = None
        print("The session has been closed.")
