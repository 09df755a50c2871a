"""A slim ``FCN8s`` facade for training, serving, evaluation and
checkpoints, on one card or on a ('data', 'model') mesh of them.

Port of ``fcn8s_tensorflow_tpu/engine/model.py``: construction from a seed,
a JAX param tree, a checkpoint (``model_load_dir``, ``resume``) or a partial
restore on a fresh model (``variables_load_dir``, ``vgg16_dir``); ``train``
(LR schedule, dropout, L2, gradient accumulation, class weights,
ignore_label, device augmentation, periodic evaluation, TensorBoard
summaries, an EMA of the weights, early stopping and the LR-plateau
observer, best-value bookkeeping, periodic and best-only asynchronous
saves, a JSONL train log, prefetch); ``predict`` (stride-32 padding and
crop back, on-device overlay, ``use_ema``, int8 with ``quantized``, tiled
with ``tile``/``tile_overlap``/``tile_blend``); ``predict_tta``;
``calibrate_quantization``; ``evaluate`` (``use_ema``);
``ema_params``/``adopt_ema``; ``save``/``load_variables``; ``summary``
(``utils/summary.py``); ``find_learning_rate`` (the LR range test, which
leaves the model bit for bit as it found it); ``predict_and_save`` (a
directory of images to overlay or id PNGs, the Cityscapes submission
format); ``score_benchmark`` (predict a split, write labelId PNGs and run
the offline scorer, ``evaluation/pixel_eval.py``); and ``close``, with the
JAX facade's argument names; and ``export_serving`` (a ``torch.export``
artifact, ``engine/export.py``). Checkpoints are the JAX package's format
(``engine/checkpoint.py``): one written by either package loads in the
other, EMA average and observer counters included.

``mesh=``/``tensor_parallel=`` (``parallel/mesh.py``): one process per mesh
position, each making the same calls on the same global batch. Batches pad
to the 'data' axis and each rank puts its rows on its card; params (and the
EMA and the optimizer moments) live as this rank's shards; every call
returns on every rank what the JAX facade returns, and files are written by
rank 0, the others waiting at a barrier. ``spatial_partition=True`` on
``train``, ``evaluate`` and ``predict`` splits the width over the mesh's
'model' axis (``parallel/mesh.py``, ``width_split``: units of 32 columns)
with a hand halo exchange at every conv and deconv; the params are then
replicated, so a tensor-parallel model runs such a call on its gathered
params (and, for ``train``, moments and EMA, laid back into shards when
the call ends). On a mesh whose 'model' axis has one position it is the
plain layout, as JAX's spatial spec is there.

The steps run compiled, as the JAX facade's do: ``train`` and
``find_learning_rate`` through ``_get_train_step``, evaluation through
``_get_eval_step``, ``predict`` (tiled too), ``predict_and_save``,
``score_benchmark`` and the service through ``_get_predict_step``, and
``predict_tta`` through ``_get_tta_step``: each a ``compile_*_step`` of
``parallel/steps.py``, a CUDA graph captured at its first call per tree
and replayed after, with the eager steps' results bit for bit. Each cache
keeps a bounded number of steps, the least recently used evicted
(``_StepCache``), and the trees the steps read (the compute-dtype params,
the EMA's cast, the int8 tree) are refreshed in place, so a refresh keeps
their captures valid. On a mesh of more than one position, and with
``spatial_partition``, the same caches hold compiled steps of that layout
(keyed by it), whose graphs are cut at the step's collectives
(``parallel/graphs.py`` ``Segments``); every rank makes the same calls, so
every rank captures and replays alike. A spatial evaluate or predict on a
tensor-parallel model runs on its params gathered into one tree refreshed
in place (``_replicated``), so its captures replay too.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import sys
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from glob import glob

import numpy as np
import torch
import torch.distributed as dist
from PIL import Image

from .. import bridge
from ..kernels import resolve_device
from . import checkpoint as ckpt
from ..data.prefetch import DevicePrefetcher, host_tensors, to_device
from ..models.fcn8s import decoder_variant, init_fcn8s
from ..models.segformer import is_segformer
from ..ops.augment_device import make_augment_fn
from ..ops.metrics import empty_metrics_state, finalize_metrics
from ..ops.quantize import collect_activation_absmax, quantize_fcn8s_params
from ..parallel import collectives
from ..parallel.graphs import tensors_of
from ..parallel.mesh import (
    DATA_AXIS,
    batch_rows,
    create_mesh,
    gather_params,
    param_sharding_tree,
    shard_params,
)
from ..parallel.steps import (
    Optimizer,
    ScaleByAdamTF1State,
    TrainState,
    compile_eval_step,
    compile_predict_step,
    compile_train_step,
    compile_tta_step,
    create_train_state,
    eval_step,
    OptimizerState,
    make_optimizer,
    predict_step,
    train_step,
    tta_step,
)
from ..utils.profiling import annotate
from .summaries import SummaryLogger

_ALLOWED_METRICS = {"loss", "mean_iou", "accuracy"}
_TILE_CHUNK = 8  # tiles per dispatch of a tiled predict, per 'data' position
_DECODE_AHEAD = 3  # predict_and_save: chunks decoded ahead of the dispatch


def _default_mesh(device) -> "Mesh":
    """The mesh of ``FCN8s(mesh=None)``: JAX's ``create_mesh()``, every rank
    of an initialised group on one 'data' axis (on the card of its
    ``LOCAL_RANK`` for the default ``"cuda"``), else this one process on
    ``device``."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world > 1 and torch.device(device) == torch.device("cuda"):
        return create_mesh()
    return create_mesh(devices=[device] * world)


def check_tile(tile, tile_overlap: int) -> None:
    """Raise ``ValueError`` for a ``tile``/``tile_overlap`` that
    ``FCN8s.predict`` refuses: tile dims not multiples of 32, an odd or
    negative overlap."""
    th, tw = tile
    if th % 32 or tw % 32:
        raise ValueError(f"tile dims must be multiples of 32, got {tile}")
    if tile_overlap % 2 or tile_overlap < 0:
        raise ValueError(f"tile_overlap must be even and >= 0, got {tile_overlap}")


def _map_tree(fn, tree: dict) -> dict:
    """``fn`` over every tensor of a port tree ({part: {layer: {key: t}}})."""
    return {part: {name: {k: fn(t) for k, t in layer.items()} for name, layer in layers.items()}
            for part, layers in tree.items()}


def _opt_tensors(opt_state) -> list:
    """The tensors of an ``OptimizerState``: Adam's moments, the momentum
    traces, or none (sgd)."""
    inner = opt_state.inner
    if isinstance(inner, ScaleByAdamTF1State):
        return inner.mu + inner.nu
    return list(inner or [])


def _map_opt_leaves(opt_state, fn):
    """An ``OptimizerState`` with ``fn`` applied to each list of its
    per-param tensors (Adam's moments, the momentum traces)."""
    inner = opt_state.inner
    if isinstance(inner, ScaleByAdamTF1State):
        inner = ScaleByAdamTF1State(count=inner.count, mu=fn(inner.mu), nu=fn(inner.nu))
    elif inner is not None:
        inner = fn(inner)
    return OptimizerState(count=opt_state.count, learning_rate=opt_state.learning_rate,
                          inner=inner)


def _opt_scalars(opt_state) -> tuple:
    """(count, last learning rate, Adam's own count or None)."""
    inner = opt_state.inner
    adam_count = inner.count if isinstance(inner, ScaleByAdamTF1State) else None
    return (opt_state.count, opt_state.learning_rate, adam_count)


def _layout(tree):
    """A nest's keys, and the shape, strides and dtype of each tensor."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.stride(), tree.dtype)
    if isinstance(tree, dict):
        return tuple((k, _layout(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(_layout(v) for v in tree)
    return tree


def _refill(old, new):
    """``new``'s values written into the tensors of ``old`` when the two
    trees have one structure and every tensor one shape, strides and dtype,
    so the captures over ``old`` stay valid; else ``new`` itself. Written
    under inference mode: ``old`` may have been made there."""
    if old is None or _layout(old) != _layout(new):
        return new
    pairs = [(a, b) for a, b in zip(tensors_of(old), tensors_of(new)) if a is not b]
    if pairs:
        with torch.inference_mode():
            torch._foreach_copy_([a for a, _ in pairs], [b for _, b in pairs])
    return old


class _StepCache:
    """The facade's compiled steps of one kind by key, the least recently
    used evicted beyond ``limit``. An evicted or dropped step releases its
    captures (graphs, static buffers, private pools). ``captures_made``
    counts the captures of every step it held."""

    def __init__(self, limit: int):
        self.limit = limit
        self._steps: OrderedDict = OrderedDict()
        self._retired = 0  # captures made by the steps no longer held

    def get(self, key, make):
        step = self._steps.pop(key, None)
        if step is None:
            while len(self._steps) >= self.limit:
                self._drop(next(iter(self._steps)))
            step = make()
        self._steps[key] = step  # the most recently used
        return step

    def _drop(self, key) -> None:
        step = self._steps.pop(key)
        self._retired += step.captures_made
        step.release()

    def drop(self, predicate) -> None:
        """Drop the steps whose key satisfies ``predicate``."""
        for key in [k for k in self._steps if predicate(k)]:
            self._drop(key)

    def clear(self) -> None:
        self.drop(lambda key: True)

    def purge(self) -> None:
        """Release every held step's captures whose tensors are gone."""
        for step in self._steps.values():
            step.purge()

    def keys(self) -> list:
        return list(self._steps)

    @property
    def captures_made(self) -> int:
        return self._retired + sum(step.captures_made for step in self._steps.values())


class FCN8s:
    """FCN-8s semantic segmentation on one device (``device``, default
    ``"cuda"``; without a card that raises, and the CPU runs only when asked
    for with ``device="cpu"``) or on a mesh. Parameters are held in fp32
    (``self.params``, the port's tree, whose leaves require grad) and, for
    inference, once more in ``compute_dtype`` (rebuilt whenever training
    moved the masters).

    Arguments follow the JAX facade, positionally too: ``model_load_dir``,
    ``tags`` (accepted for signature parity and ignored), ``vgg16_dir``,
    ``num_classes``, ``variables_load_dir``; then by keyword ``mesh`` (a
    ``parallel.mesh.create_mesh`` mesh over the initialised process group;
    default ``create_mesh()``'s, which without a group is this one process)
    and ``tensor_parallel`` (fc6/fc7 sharded over the mesh's 'model' axis).
    On a mesh the model runs on ``mesh.device``; ``device`` must then be
    the default or of the same type.

    ``num_classes``, or ``model_load_dir``
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

    def __init__(self, model_load_dir=None, tags=None, vgg16_dir=None, num_classes=None,
                 variables_load_dir=None, *, mesh=None, tensor_parallel: bool = False,
                 compute_dtype=None, width_mult: float = 1.0, fc_channels: int | None = None,
                 bilinear_deconv_init: bool = False, seed: int = 0, remat: bool = False,
                 variant: str = "fcn8s", ignore_label: int | None = None, optimizer="adam",
                 optimizer_kwargs: dict | None = None, clip_norm: float | None = None,
                 device="cuda"):
        del tags
        if model_load_dir is None and num_classes is None:
            raise ValueError(
                "You must provide either `model_load_dir` or `num_classes` "
                "(optionally with `vgg16_dir` for pretrained encoder weights).")
        device = resolve_device(device)
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
                    optimizer=optimizer, optimizer_kwargs=optimizer_kwargs, clip_norm=clip_norm,
                    mesh=mesh, tensor_parallel=tensor_parallel)
        if restored is not None:
            self.state.step = self.g_step = restored["step"] or 0
            # staged on the host, whole: a model loaded to serve never puts
            # the optimizer's moments on the card; the first train() shards
            # and moves them
            self._staged_opt_state = restored["opt_state"]
            # a live device tree (this rank's shards), so that
            # train(ema_decay=...) continues it
            if restored["ema"] is not None:
                self._ema = _map_tree(lambda t: t.to(self.device), self._shard(restored["ema"]))
            # the interrupted run's observer counters: carried through saves,
            # and continued by the next train() call only
            observer = restored["metadata"].get("train_observer") or {}
            self._observer_state = dict(observer)
            self._observer_pending = dict(observer)
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
                    optimizer_kwargs: dict | None = None, clip_norm: float | None = None,
                    mesh=None, tensor_parallel: bool = False) -> "FCN8s":
        """A model on the weights of a JAX-layout param tree (numpy arrays,
        e.g. ``init_fcn8s`` of the JAX package through ``np.asarray``):
        ``bridge.to_port``, then on a mesh this rank's shards
        (``parallel.mesh.shard_params``). ``width_mult``/``fc_channels``
        only describe the tree in ``model_config``; the shapes come from the
        tree. A SegFormer tree (``models/segformer.py``, told by its head)
        gives a SegFormer model (``variant`` 'segformer') on the same steps;
        the paths it does not take raise ``ValueError``. The other arguments
        are the constructor's."""
        device = resolve_device(device)
        model = cls.__new__(cls)
        model._setup(bridge.to_port(tree), width_mult=width_mult, fc_channels=fc_channels,
                     compute_dtype=compute_dtype, device=device, seed=seed, remat=remat,
                     ignore_label=ignore_label, optimizer=optimizer,
                     optimizer_kwargs=optimizer_kwargs, clip_norm=clip_norm, mesh=mesh,
                     tensor_parallel=tensor_parallel)
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
               ignore_label, optimizer, optimizer_kwargs, clip_norm, mesh=None,
               tensor_parallel=False):
        """``params``: the port's whole fp32 tree on the CPU."""
        if mesh is None:
            mesh = _default_mesh(device)
        elif mesh.device.type != torch.device(device).type:
            raise ValueError(f"device={str(device)!r} differs from the mesh's {mesh.device}")
        self.mesh = mesh
        self.tensor_parallel = tensor_parallel
        self._tp = mesh.tensor_parallel(tensor_parallel)
        self._writer = mesh.is_writer
        self.device = mesh.device
        self.compute_dtype = compute_dtype
        if is_segformer(params):
            if self._tp:
                raise ValueError("SegFormer does not run tensor_parallel")
            self.num_classes = int(params["decoder"]["linear_pred"]["bias"].shape[0])
            self.variant = "segformer"
        else:
            self.num_classes = int(params["decoder"]["fc7_1x1"]["bias"].shape[0])
            self.variant = decoder_variant(params["decoder"])
        self.params = _map_tree(lambda t: t.to(self.device), self._shard(params))
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
        self._ema = None  # the EMA average of train(ema_decay=...), a port tree
        self._ema_run = None  # its compute-dtype cast for predict/evaluate
        self._ema_stale = False  # the EMA moved since _ema_run was cast
        self._observer_state = {}  # the observers' counters, written by save()
        self._observer_pending = {}  # restored counters for the next train() only
        self._summary_logger = None
        self._act_absmax = None  # calibrate_quantization's layer -> max|x|
        self._qparams = None  # the int8 tree, built lazily by _quantized_params
        self._qparams_stale = False  # the masters moved since it was built
        self._run_params = None  # the compute-dtype cast, _refresh_run_params
        self._replicated_run = None  # a spatial call's whole tree under TP (_replicated)
        # the compiled steps (see _get_train_step and _get_eval_step)
        self._train_steps = _StepCache(self._TRAIN_STEP_CACHE_MAX)
        self._eval_steps = _StepCache(self._FORWARD_STEP_CACHE_MAX)
        self._predict_steps = _StepCache(self._FORWARD_STEP_CACHE_MAX)
        self._tta_steps = _StepCache(self._FORWARD_STEP_CACHE_MAX)
        self._train_spatial = False  # the last train()'s spatial_partition
        self._augment_fn = self._device_augment_cfg = None
        self._save_thread = None
        self._save_pending = False  # an async save not yet joined (every rank)
        self.predict_and_save_timings = None  # the last predict_and_save's time split
        for t in bridge.param_leaves(self.params):
            t.requires_grad_(True)
        self._refresh_run_params()
        self._class_weights = None
        self._class_weights_cfg = None  # the tuple the compiled steps were built with
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

    def _refuse_segformer(self, what: str, refused: bool = True) -> None:
        """``ValueError`` for a path that SegFormer does not take (int8,
        TTA, tensor parallelism, spatial partitioning, the service, the
        export and the FCN summary)."""
        if refused and self.variant == "segformer":
            raise ValueError(f"SegFormer does not run {what}; its model runs train, evaluate "
                             "and predict, on one card or a data-parallel mesh")

    def _refresh_run_params(self) -> None:
        """Cast the current masters into the compute-dtype tree that predict
        and evaluate read, and mark the int8 tree stale. Stale after any
        optimizer step; every change of the masters (``train``,
        ``adopt_ema``, ``load_variables``, ``vgg16_dir`` and
        ``variables_load_dir``) ends here. The cast is written into the
        tree's own tensors (``_refill``: ``bridge.cast_params``'s bytes;
        ``bridge.cast_into`` without a new cast where no leaf is derived, as
        in SegFormer's ~1,600), so the compiled steps captured over them
        replay; a tree of another layout (a relayout of the masters) is
        built anew."""
        with torch.no_grad():
            if not bridge.cast_into(self._run_params, self.params):
                self._run_params = _refill(self._run_params,
                                           bridge.cast_params(self.params, self.compute_dtype))
        self._invalidate_quantized()

    # ------------------------------------------------------------------
    # the mesh: this rank's shards and rows
    # ------------------------------------------------------------------
    def _shard(self, tree: dict) -> dict:
        """This rank's blocks of a whole tree of the params' structure."""
        return shard_params(tree, self.mesh, True) if self._tp else tree

    def _gather(self, tree: dict) -> dict:
        """The whole tree from this rank's blocks (a collective under
        tensor parallelism: every rank calls it)."""
        return gather_params(tree, self.mesh, True) if self._tp else tree

    def _replicated(self, run: dict) -> dict:
        """A spatial call's params: ``run`` (a compute-dtype tree of this
        rank's blocks) whole, gathered under tensor parallelism into one
        tree refreshed in place (``_refill``), so the spatial steps'
        captures over it replay instead of capturing at every call."""
        if not self._tp:
            return run
        self._replicated_run = _refill(self._replicated_run, self._gather(run))
        return self._replicated_run

    def _relayout(self, move, fresh) -> None:
        """``move`` (``_gather`` or ``_shard``) over the masters, the
        optimizer's moments and the EMA; ``fresh`` makes each moved leaf a
        tensor of its own (a shard is a view of the whole)."""
        self.params = _map_tree(fresh, move(self.params))
        for t in bridge.param_leaves(self.params):
            t.requires_grad_(True)
        self.state.params = self.params
        if self.state.opt_state is not None:
            self.state.opt_state = _map_opt_leaves(self.state.opt_state, lambda ts: [
                fresh(t) for t in bridge.param_leaves(move(self._leaves_as_tree(ts)))])
        if self._ema is not None:
            self._ema = _map_tree(fresh, move(self._ema))
        self._ema_run = None

    @contextlib.contextmanager
    def _replicas(self, spatial: bool):
        """For a spatial training call on a tensor-parallel model: the whole
        masters, moments and EMA on every rank inside (JAX's jit lays them
        out again when spatial partitioning drops TP), this rank's shards
        again after. A collective at both ends; nothing off TP."""
        if not (spatial and self._tp):
            yield
            return
        self._relayout(self._gather, lambda t: t.detach())
        self._tp = False
        self._refresh_run_params()
        try:
            yield
        finally:
            self._tp = True
            self._relayout(self._shard, lambda t: t.detach().clone())
            self._refresh_run_params()

    def _leaves_as_tree(self, leaves: list) -> dict:
        """A list aligned with ``bridge.param_leaves(self.params)`` (an
        optimizer's moments) as a tree of the params' structure."""
        it = iter(leaves)
        return {part: {name: {k: next(it) for k in layer} for name, layer in layers.items()}
                for part, layers in bridge.trainable(self.params).items()}

    def _shard_opt(self, opt_state):
        return _map_opt_leaves(opt_state, lambda ts: bridge.param_leaves(
            self._shard(self._leaves_as_tree(ts))))

    def _gather_opt(self, opt_state):
        return _map_opt_leaves(opt_state, lambda ts: bridge.param_leaves(
            self._gather(self._leaves_as_tree(ts))))

    def _full_shape_params(self) -> dict:
        """The whole tree's shapes as meta tensors (no collective)."""
        shardings = param_sharding_tree(self.mesh, self.params, tensor_parallel=self._tp)
        return {part: {name: {k: torch.empty(shardings[part][name][k].full_shape(t.shape),
                                             device="meta") for k, t in layer.items()}
                       for name, layer in layers.items()}
                for part, layers in self.params.items()}

    def _put_batch(self, *arrays):
        """This rank's rows (``parallel.mesh.batch_rows``) of a padded host
        batch, on its device (``_to_device``); the whole batch off a mesh."""
        rows = batch_rows(arrays[0].shape[0], self.mesh)
        out = tuple(self._to_device(a if rows is None else a[rows]) for a in arrays)
        return out[0] if len(out) == 1 else out

    @property
    def _mesh_kwargs(self) -> dict:
        """The steps' ``mesh``/``tensor_parallel`` arguments."""
        return {"mesh": self.mesh, "tensor_parallel": self.tensor_parallel}

    def _step_layout(self, spatial_partition: bool) -> dict:
        """The steps' layout arguments: ``_mesh_kwargs``, or with
        ``spatial_partition`` the width split and no tensor parallelism (the
        JAX facade drops TP there)."""
        if not spatial_partition:
            return self._mesh_kwargs
        return {"mesh": self.mesh, "tensor_parallel": False, "spatial_partition": True}

    # ------------------------------------------------------------------
    # the compiled steps
    # ------------------------------------------------------------------
    # As the JAX facade's: the augment keying keeps alternating configs warm,
    # and the cache is bounded, the least recently used evicted beyond it.
    _TRAIN_STEP_CACHE_MAX = 4
    # The JAX facade's forward caches are unbounded, but a captured graph
    # keeps the memory of its activations in a private pool (GiBs at full
    # width), where an XLA executable keeps none: eval, predict and TTA
    # keep 8 steps each, and a caller that cycles through more shapes
    # recaptures (time, never a wrong result).
    _FORWARD_STEP_CACHE_MAX = 8
    # Run the eager steps instead of the compiled ones: the reference that
    # the compiled facade is held against, bit for bit.
    _eager_steps = False

    def _layout_key(self, spatial_partition: bool) -> tuple:
        """The layout a step bakes in, for the caches' keys."""
        layout = self._step_layout(spatial_partition)
        return (bool(layout.get("spatial_partition", False)), bool(layout["tensor_parallel"]))

    @staticmethod
    def _freeze_cfg(obj):
        """Canonical hashable key for a (possibly nested) augment config."""
        if isinstance(obj, dict):
            return tuple(sorted((k, FCN8s._freeze_cfg(v)) for k, v in obj.items()))
        if isinstance(obj, (list, tuple)):
            return tuple(FCN8s._freeze_cfg(v) for v in obj)
        return obj

    def _get_train_step(self, batch_shape, spatial_partition=False):
        """The compiled train step of this batch shape, device-augment
        config and layout (``_step_layout``), with the settings of the last
        ``train`` baked in (class weights and gradient accumulation clear
        the cache when they change)."""
        key = (tuple(batch_shape), self._freeze_cfg(self._device_augment_cfg),
               self._layout_key(spatial_partition))
        layout = self._step_layout(spatial_partition)
        return self._train_steps.get(key, lambda: compile_train_step(
            optimizer=self.optimizer, num_classes=self.num_classes,
            compute_dtype=self.compute_dtype, augment_fn=self._augment_fn, remat=self.remat,
            grad_accum=self._grad_accum, ignore_label=self.ignore_label,
            class_weights=self._class_weights, device=self.device, **layout))

    def _get_eval_step(self, batch_shape, spatial_partition=False):
        key = (tuple(batch_shape), self._layout_key(spatial_partition))
        layout = self._step_layout(spatial_partition)
        return self._eval_steps.get(key, lambda: compile_eval_step(
            num_classes=self.num_classes, compute_dtype=self.compute_dtype,
            ignore_label=self.ignore_label, class_weights=self._class_weights,
            device=self.device, **layout))

    def _get_predict_step(self, batch_shape, argmax, overlay_lut, quantized, compact,
                          spatial_partition=False):
        """The compiled predict step of this batch shape, head and layout:
        ids (uint8 when ``compact``), softmax or the overlay of
        ``overlay_lut`` (keyed by its bytes), bf16 or int8."""
        lut_key = None if overlay_lut is None else overlay_lut.tobytes()
        key = (tuple(batch_shape), argmax, lut_key, quantized, compact,
               self._layout_key(spatial_partition))
        layout = self._step_layout(spatial_partition)
        return self._predict_steps.get(key, lambda: compile_predict_step(
            argmax=argmax, compute_dtype=self.compute_dtype,
            id_dtype=torch.uint8 if compact else torch.int32, overlay_lut=overlay_lut,
            quantized=quantized, device=self.device, **layout))

    def _get_tta_step(self, batch_shape, scale_hw, flip, quantized):
        key = (tuple(batch_shape), scale_hw, flip, quantized, self._layout_key(False))
        return self._tta_steps.get(key, lambda: compile_tta_step(
            scale_hw=scale_hw, flip=flip, compute_dtype=self.compute_dtype,
            quantized=quantized, device=self.device, **self._mesh_kwargs))

    def _step_caches(self) -> dict:
        return {"train": self._train_steps, "eval": self._eval_steps,
                "predict": self._predict_steps, "tta": self._tta_steps}

    def capture_counts(self) -> dict:
        """The captures the compiled steps have made, by kind ('train',
        'eval', 'predict', 'tta'), those of evicted steps included. Each
        capture first runs its step ``parallel.graphs.WARMUP`` times."""
        return {kind: cache.captures_made for kind, cache in self._step_caches().items()}

    def _train_call(self, state, batch, learning_rate, l2_rate, keep_prob,
                    spatial_partition=False):
        """One train step on the device batch (images, label ids, mask), with
        the settings of the last ``train``: the compiled step (``train_step``
        itself on ``_eager_steps``)."""
        if not self._eager_steps:
            return self._get_train_step(batch[0].shape, spatial_partition)(
                state, *batch, self._train_seed, learning_rate, l2_rate, keep_prob)
        return train_step(state, *batch, self._train_seed, learning_rate, l2_rate, keep_prob,
                          optimizer=self.optimizer, num_classes=self.num_classes,
                          compute_dtype=self.compute_dtype, remat=self.remat,
                          grad_accum=self._grad_accum, ignore_label=self.ignore_label,
                          class_weights=self._class_weights, augment_fn=self._augment_fn,
                          **self._step_layout(spatial_partition))

    def summary(self, input_hw=(1024, 512), batch: int = 1) -> str:
        """Per-layer report: kernel (HWIO, as the JAX package gives them) and
        output shapes, params, forward MACs, activation bytes, with model
        totals (``utils/summary.py``): analytic, from the whole param
        tree's shapes, no device work. ``input_hw`` must be multiples of 32."""
        from ..utils.summary import model_summary

        self._refuse_segformer("summary()")
        return model_summary(self._full_shape_params(), input_hw, batch)

    # ------------------------------------------------------------------
    def _quantized_params(self) -> dict:
        """The int8 inference tree (``ops/quantize.py``), built lazily from
        the fp32 masters and requantized when they have moved
        (``_invalidate_quantized``), into its own tensors while the
        calibration state is the same (``_refill``), with the calibrated
        static activation scales once ``calibrate_quantization`` has run."""
        self._refuse_segformer("int8 (quantized)")
        if self._qparams is None or self._qparams_stale:
            # replicated on a mesh, as JAX keeps it: quantized from the whole tree
            self._qparams = _refill(self._qparams, quantize_fcn8s_params(
                self._gather(self.params), self._act_absmax, compute_dtype=self.compute_dtype))
            self._qparams_stale = False
        return self._qparams

    @torch.inference_mode()
    def calibrate_quantization(self, images, *, batch_size: int = 8) -> dict:
        """Calibrate static int8 activation scales from representative
        ``images`` (N, H, W, 3; a few dozen suffice), in chunks of
        ``batch_size``: each conv's input scale is frozen at the max |x|
        seen over the chunks / 127, replacing the dynamic per-tensor scales.
        The scales persist across training (recalibrate after a large
        distribution shift). Returns the layer -> absmax dict (0-d fp32
        tensors on the model's device), also kept on the model. On a mesh
        each rank runs its rows of each chunk through the whole encoder and
        the maxima are taken over 'data'."""
        self._refuse_segformer("int8 (calibrate_quantization)")
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        absmax = None
        run = self._run_params if not self._tp else bridge.cast_params(
            self._gather(self.params), self.compute_dtype)
        for start in range(0, images.shape[0], batch_size):
            chunk, _ = self._prepare_images(images[start:start + batch_size])
            batch_max = collect_activation_absmax(run, self._put_batch(chunk),
                                                  compute_dtype=self.compute_dtype)
            batch_max = {k: collectives.all_reduce(v, self.mesh, op=dist.ReduceOp.MAX)
                         for k, v in batch_max.items()}
            absmax = batch_max if absmax is None else {
                k: torch.maximum(absmax[k], batch_max[k]) for k in absmax}
        self._act_absmax = absmax
        # the scales change the int8 tree's structure: a new tree, and the
        # quantized predict and TTA steps dropped, as the JAX facade drops them
        self._qparams = None
        self._predict_steps.drop(lambda key: key[3])
        self._tta_steps.drop(lambda key: key[3])
        return absmax

    def _invalidate_quantized(self) -> None:
        """The masters moved: requantize at the next quantized predict."""
        self._qparams_stale = True

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _update_ema(self, decay: float) -> None:
        """One EMA step over the fp32 masters, in place on their device:
        ``ema = ema * d + p * (1 - d)``, in that order (not ``lerp``), as
        two multi-tensor passes, ``_foreach_mul_`` then ``_foreach_add_``
        with ``alpha = 1 - d``; ``d`` and ``1 - d`` are rounded to fp32, as
        JAX's traced scalars are. The first call seeds ``ema`` with a copy
        of the params."""
        self._ema_stale = True
        if self._ema is None:
            self._ema = _map_tree(lambda t: t.detach().clone(), self.params)
            return
        d = np.float32(decay)
        ema = bridge.param_leaves(self._ema)
        torch._foreach_mul_(ema, float(d))
        torch._foreach_add_(ema, bridge.param_leaves(self.params), alpha=float(np.float32(1) - d))
        for mine, live in zip(bridge.state_leaves(self._ema), bridge.state_leaves(self.params)):
            mine.copy_(live)  # the average predicts with the live BatchNorm statistics

    @property
    def ema_params(self) -> dict:
        """The EMA average (the port's fp32 tree; see ``train(ema_decay=...)``)."""
        if self._ema is None:
            raise ValueError("No EMA params: train with ema_decay=<float> first.")
        return self._ema

    def adopt_ema(self) -> None:
        """Copy the EMA average into the live params, in place (the optimizer
        keeps its state: Adam's moments then describe the pre-adoption
        trajectory, the usual finalize-for-serving move), mark the model
        dirty so a following ``save()`` persists the averaged weights, and
        drop the EMA tree."""
        ema = self.ema_params
        with torch.no_grad():
            torch._foreach_copy_(bridge.param_leaves(self.params), bridge.param_leaves(ema))
        self._ema = self._ema_run = None
        self.variables_updated = True
        self._refresh_run_params()

    def _resolve_ema(self, use_ema: bool, quantized: bool):
        """The compute-dtype params that ``use_ema`` asks for (None: the live
        ones), cast once per EMA update. EMA excludes ``quantized``: int8
        scales are calibrated against the live params."""
        if not use_ema:
            return None
        if quantized:
            raise ValueError(
                "use_ema and quantized are mutually exclusive: int8 "
                "activation scales are calibrated for the live params. "
                "adopt_ema() first, then recalibrate and quantize.")
        ema = self.ema_params
        if self._ema_run is None or self._ema_stale:
            with torch.no_grad():  # into the cast's own tensors (_refill)
                self._ema_run = _refill(self._ema_run, bridge.cast_params(ema, self.compute_dtype))
            self._ema_stale = False
        return self._ema_run

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

    def _pad_batch_dim(self, *arrays, multiple: int | None = None):
        """Pad the batch dim up to a multiple of ``multiple`` (default: the
        mesh's 'data' axis) by repeating the last sample; returns
        (padded_arrays..., sample_mask), the mask 0 on the padding, which
        keeps loss, gradient and metrics exactly the short batch's."""
        n = arrays[0].shape[0]
        pad = (-n) % (self.mesh.shape[DATA_AXIS] if multiple is None else multiple)
        mask = np.ones((n + pad,), np.float32)
        if pad:
            mask[n:] = 0.0
            arrays = tuple(np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
                           for a in arrays)
        return (*arrays, mask)

    def _prepare_images(self, images, pad_batch_to=None):
        """Pad H and W to multiples of 32 with zeros, the batch to
        ``pad_batch_to`` with copies of the last image (so that a short
        tail replays the full chunks' step) and then to the mesh's 'data'
        axis. Returns (padded, (n, h, w))."""
        with annotate("fcn8s.predict.prepare"):
            images = np.asarray(images)
            if images.ndim == 3:
                images = images[None]
            n, h, w = images.shape[:3]
            ph, pw = (-h) % 32, (-w) % 32
            if ph or pw:
                images = np.pad(images, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="constant")
            if pad_batch_to is not None and n < pad_batch_to:
                images = np.concatenate(
                    [images, np.repeat(images[-1:], pad_batch_to - n, axis=0)], axis=0)
            images, _ = self._pad_batch_dim(images)
        return images, (n, h, w)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """H2D of a host array; on a card from pinned memory, without
        blocking the host (the copy is ordered on the current stream)."""
        # copies only an array torch cannot wrap (read-only, e.g. a decoded image)
        t = torch.from_numpy(np.require(array, requirements=("C", "W")))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    # ------------------------------------------------------------------
    def _dispatch_predict(self, padded: np.ndarray, argmax=True, overlay_lut=None,
                          quantized=False, params=None, spatial_partition=False) -> torch.Tensor:
        """H2D and the predict step on an H/W-padded batch (its batch padded
        here to the 'data' axis, the extra rows left in the output); returns
        the device output without waiting for it, so callers can overlap the
        next dispatch with this one's D2H (off a mesh). ``params`` overrides
        the live compute-dtype params (the EMA's). ``spatial_partition``:
        the width split over 'model', on replicated params."""
        self._refuse_segformer("spatial_partition", spatial_partition)
        compact = argmax and overlay_lut is None and self.num_classes <= 255
        padded, _ = self._pad_batch_dim(padded)
        run = self._inference_params(params, quantized)
        if spatial_partition and not quantized:  # replicated (the int8 tree already is)
            run = self._replicated(run)
        with annotate("fcn8s.predict.h2d"):
            images = self._put_batch(padded)
        with annotate("fcn8s.predict.step"):
            if not self._eager_steps:
                step = self._get_predict_step(images.shape, argmax, overlay_lut, quantized,
                                              compact, spatial_partition)
                return step(run, images)
            return predict_step(run, images, argmax=argmax,
                                compute_dtype=self.compute_dtype,
                                id_dtype=torch.uint8 if compact else torch.int32,
                                overlay_lut=overlay_lut, quantized=quantized,
                                **self._step_layout(spatial_partition))

    def _inference_params(self, ema, quantized: bool) -> dict:
        """The tree a predict runs: the EMA's (``_resolve_ema``) when given,
        else the int8 tree or the live compute-dtype params."""
        if ema is not None:
            return ema
        return self._quantized_params() if quantized else self._run_params

    @staticmethod
    def _host_output(out: torch.Tensor, argmax, overlay_lut) -> np.ndarray:
        """D2H of a predict output; compact ids are re-widened to the API's int32."""
        with annotate("fcn8s.predict.d2h"):
            out = out.cpu().numpy()
        if argmax and overlay_lut is None and out.dtype == np.uint8:
            with annotate("fcn8s.predict.widen"):
                out = out.astype(np.int32)
        return out

    @torch.inference_mode()
    def predict(self, images, argmax=True, spatial_partition=False, overlay=None,
                quantized=False, tile=None, tile_overlap=128, tile_blend=False,
                use_ema=False):
        """Predict segmentations of (N, H, W, 3) images of any H, W (padded
        to stride 32, output cropped back). Returns (N, H, W) int32 ids, the
        (N, H, W, C) softmax with ``argmax=False``, or with ``overlay`` (a
        class_id -> RGBA dict) the composited uint8 RGB, computed on the
        device.

        ``quantized=True`` runs the int8 encoder (``ops/quantize.py``):
        per-tensor int8 activations (dynamic, or the static scales of
        ``calibrate_quantization``) times per-channel int8 weights, int32
        accumulation, the decoder in ``compute_dtype``. The int8 tree is
        built lazily and rebuilt after any change of the params.

        ``tile=(th, tw)`` (multiples of 32) runs tiled inference: the image
        is covered by overlapping tiles of that shape (``_tile_grid``), run
        in chunks of 8, two in flight so that one chunk's D2H overlaps the
        next one's dispatch, and each tile's core (``tile_overlap`` even and
        >= 0, default 128, clamped to ``min(th, tw) - 32``; within
        ``tile_overlap / 2`` of interior seams the cut truncates the
        receptive field) is pasted into the output. ``tile_blend=True``
        instead accumulates every tile's full softmax on the host, weighted
        by a linear ramp over ``tile_overlap / 2`` px from each tile edge
        (``_feather_profile``) and normalised, before the optional argmax:
        exact where one tile covers a pixel; incompatible with ``overlay``.

        ``use_ema=True`` runs the EMA average (``train(ema_decay=...)``)
        instead of the live params; it excludes ``quantized``.

        ``spatial_partition=True`` splits the (padded) width over the mesh's
        'model' axis in units of 32 columns, at least one per position
        (``ValueError`` otherwise), with the halo exchanged at every conv
        and deconv; it excludes ``tile``.

        Under a profiler the call is the span ``fcn8s.predict``, with its
        phases inside: ``.prepare`` (the pads), ``.h2d``, ``.step`` (the
        compiled step's dispatch), ``.d2h`` and ``.widen``; the tiled path
        names the same phases of each chunk."""
        with annotate("fcn8s.predict"):
            lut = self._overlay_lut(overlay) if overlay is not None else None
            ema = self._resolve_ema(use_ema, quantized)
            if tile is not None:
                if spatial_partition:
                    raise ValueError("tile and spatial_partition are mutually exclusive")
                return self._predict_tiled(images, argmax, lut, quantized, tile, tile_overlap,
                                           params=ema, blend=tile_blend)
            if tile_blend:
                raise ValueError("tile_blend requires tile=(th, tw)")
            padded, (n, h, w) = self._prepare_images(images)
            out = self._dispatch_predict(padded, argmax, lut, quantized, params=ema,
                                         spatial_partition=spatial_partition)
            return self._host_output(out, argmax, lut)[:n, :h, :w]

    @torch.inference_mode()
    def predict_tta(self, images, scales=(1.0,), flip=True, argmax=True, quantized=False,
                    use_ema=False):
        """Test-time-augmentation prediction: class probabilities averaged
        over the horizontal mirror (``flip``) and rescaled views
        (``scales``, each snapped to the stride-32 grid,
        ``max(32, round(p * s / 32) * 32)``), each scale one ``tta_step``
        whose resize, forward and resize back stay on the card; the sum and
        the argmax run on the card too. ``scales=(1.0,)`` with
        ``flip=False`` is ``predict``'s softmax. Returns (N, H, W) int32
        ids, or with ``argmax=False`` the (N, H, W, C) fp32 mean
        probabilities. ``quantized`` and ``use_ema`` as in ``predict``.
        Under a profiler the call is the span ``fcn8s.predict_tta``, with
        ``predict``'s phase names inside (``.step`` once per scale)."""
        self._refuse_segformer("predict_tta")
        if not scales:
            raise ValueError("predict_tta: scales must be non-empty")
        with annotate("fcn8s.predict_tta"):
            padded, (n, h, w) = self._prepare_images(images)
            call_params = self._inference_params(self._resolve_ema(use_ema, quantized),
                                                 quantized)
            with annotate("fcn8s.predict.h2d"):
                im_d = self._put_batch(padded)
            ph, pw = padded.shape[1:3]
            acc = None
            for s in scales:
                sh = max(32, int(round(ph * float(s) / 32)) * 32)
                sw = max(32, int(round(pw * float(s) / 32)) * 32)
                scale_hw = None if (sh, sw) == (ph, pw) else (sh, sw)
                with annotate("fcn8s.predict.step"):
                    if not self._eager_steps:
                        p = self._get_tta_step(im_d.shape, scale_hw, bool(flip),
                                               quantized)(call_params, im_d)
                    else:
                        p = tta_step(call_params, im_d, scale_hw=scale_hw, flip=bool(flip),
                                     compute_dtype=self.compute_dtype, quantized=quantized,
                                     **self._mesh_kwargs)
                acc = p if acc is None else acc.add_(p)
                del p
            probs = acc if len(scales) == 1 else acc.div_(float(len(scales)))
            probs = probs[:n, :h, :w]
            if argmax:
                probs = torch.argmax(probs, dim=-1).to(torch.int32)
            with annotate("fcn8s.predict.d2h"):
                return probs.cpu().numpy()

    @staticmethod
    def _tile_grid(size: int, t: int, overlap: int):
        """1-D tile placement: start offsets with stride t-overlap, last
        tile flush against the end; per-tile core [lo, hi) in tile-local
        coords s.t. the cores partition [0, size) exactly."""
        if t >= size:
            return [(0, 0, size)]
        stride = t - overlap
        starts = list(range(0, size - t, stride)) + [size - t]
        tiles = []
        prev_end = 0
        for i, s in enumerate(starts):
            lo = prev_end - s  # global core start = previous core's end
            hi = t if i == len(starts) - 1 else t - overlap // 2
            # keep at least half the overlap as context on the trailing edge
            hi = max(hi, lo)
            tiles.append((s, lo, hi))
            prev_end = s + hi
        assert prev_end == size, (prev_end, size)
        return tiles

    @staticmethod
    def _feather_profile(t: int, margin: float) -> np.ndarray:
        """1-D blend weight: linear ramp over ``margin`` px from both tile
        edges, flat 1.0 inside; strictly positive everywhere (pixel centers
        at idx+0.5), so single-coverage pixels normalize to exactly their
        own tile's value."""
        idx = np.arange(t, dtype=np.float32) + 0.5
        return np.minimum(np.minimum(idx, t - idx) / margin, 1.0).astype(np.float32)

    def _predict_tiled(self, images, argmax, lut, quantized, tile, overlap, params=None,
                       blend=False):
        """``predict(tile=...)``: see ``predict``. Tiles go in chunks of 8 per
        'data' position, the JAX facade's, the last one padded to the whole
        chunk with copies of its last tile (one compiled step per run; the
        copies leave every result as it is, the dynamic int8 scales'
        per-chunk maxima too); dynamic int8 scales are per dispatch, so the
        chunk is part of the result."""
        check_tile(tile, overlap)
        th, tw = tile
        if blend and lut is not None:
            raise ValueError(
                "tile_blend composites probabilities before any overlay; "
                "predict ids first and composite on host (viz.overlay)")
        # the default overlap (sized for production tiles) auto-clamps so
        # small tiles keep a positive stride
        overlap = min(overlap, min(th, tw) - 32)
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        n, h, w = images.shape[:3]
        # pad up so every tile is full-size (cropped back at the end)
        hp, wp = max(h, th), max(w, tw)
        hp, wp = hp + (-hp) % 32, wp + (-wp) % 32
        padded = np.pad(images, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)))
        rows = self._tile_grid(hp, th, overlap)
        cols = self._tile_grid(wp, tw, overlap)
        origins = [(ys, xs) for ys, _, _ in rows for xs, _, _ in cols]
        # tile-major, then image: batch entry i is tile i // n of image i % n
        batch = np.concatenate([padded[:, ys:ys + th, xs:xs + tw] for ys, xs in origins], axis=0)

        if blend:
            margin = max(overlap / 2.0, 1.0)
            wtile = (self._feather_profile(th, margin)[:, None]
                     * self._feather_profile(tw, margin)[None, :])
            acc = np.zeros((n, hp, wp, self.num_classes), np.float32)
            wsum = np.zeros((hp, wp), np.float32)
        else:
            outs = []

        def consume(dev, start):
            part = self._host_output(dev, argmax and not blend, lut)  # D2H sync point
            part = part[:min(chunk, batch.shape[0] - start)]  # drop the tail's padding
            if not blend:
                outs.append(part)
                return
            for g in range(part.shape[0]):
                ti, j = divmod(start + g, n)
                ys, xs = origins[ti]
                acc[j, ys:ys + th, xs:xs + tw] += part[g] * wtile[:, :, None]
                if j == 0:  # once per tile (identical for every image)
                    wsum[ys:ys + th, xs:xs + tw] += wtile

        chunk = _TILE_CHUNK * self.mesh.shape[DATA_AXIS]
        pending = deque()
        for start in range(0, batch.shape[0], chunk):
            part, _ = self._prepare_images(batch[start:start + chunk], pad_batch_to=chunk)
            pending.append((self._dispatch_predict(part, argmax and not blend, lut, quantized,
                                                   params=params), start))
            if len(pending) >= 2:
                consume(*pending.popleft())
        while pending:
            consume(*pending.popleft())

        if blend:
            probs = acc / wsum[None, :, :, None]
            out = np.argmax(probs, axis=-1).astype(np.int32) if argmax else probs
            return out[:, :h, :w]
        out_tiles = np.concatenate(outs, axis=0)
        out = np.zeros((n, hp, wp) + out_tiles.shape[3:], out_tiles.dtype)
        for i, ((ys, ylo, yhi), (xs, xlo, xhi)) in enumerate(
                (r, c) for r in rows for c in cols):
            out[:, ys + ylo:ys + yhi, xs + xlo:xs + xhi] = (
                out_tiles[i * n:(i + 1) * n, ylo:yhi, xlo:xhi])
        return out[:, :h, :w]

    # ------------------------------------------------------------------
    def predict_and_save(self, results_dir, images_dir, color_map=None, resize=False,
                         image_file_extension="png", include_unprocessed_image=False,
                         arrangement="vertical", overwrite_existing=True, batch_size=8,
                         on_device_overlay=True, tile=None, tile_overlap=128, tile_blend=False,
                         output_format="overlay", id_map=None, use_ema=False, quantized=False,
                         verbose=True):
        """Segment every ``*.<image_file_extension>`` image in ``images_dir``
        and save one PNG per image, named as the image, into
        ``results_dir`` (emptied first unless ``overwrite_existing`` is
        False), with the JAX facade's arguments and checks.

        Images are grouped by size (``resize=(h, w)`` resizes all of them,
        ``viz.overlay.resize_linear_u8``, OpenCV's bilinear) and run in
        chunks of ``batch_size``: chunks are decoded ahead on a thread pool,
        two are in flight on the card (one chunk's D2H overlaps the next
        one's dispatch), and PNGs are encoded on another pool.

        ``output_format='overlay'`` (``color_map``, a class_id -> RGBA dict,
        required) composites on the card (``on_device_overlay``), or with
        ``on_device_overlay=False`` (and always with ``tile_blend``) on the
        host (``viz.overlay.print_segmentation_onto_image``);
        ``include_unprocessed_image`` puts the image beside the overlay
        (``arrangement`` 'vertical' or else horizontal).
        ``output_format='ids'`` writes the class ids, mapped through the 1-D
        LUT ``id_map`` when given (``labels.TRAINIDS_TO_IDS_ARRAY``: the
        Cityscapes submission's labelIds), as uint8 PNGs, or uint16 when an
        id exceeds 255. ``tile``/``tile_overlap``/``tile_blend``,
        ``use_ema`` and ``quantized`` are ``predict``'s.

        On a mesh every rank decodes and predicts, rank 0 alone writes and
        prints, and the others wait for it at a barrier before returning.

        ``verbose`` prints the banner and a progress line. The time split of
        the last call is kept in ``predict_and_save_timings`` (seconds:
        ``decode`` and ``encode`` summed over their pools' threads,
        ``decode_wait`` and ``encode_wait`` the caller's waits for them,
        ``dispatch`` padding, H2D and launch, ``d2h`` the copy back with
        the wait for the card; a tiled chunk's whole predict counts as
        dispatch)."""
        from ..viz.overlay import (create_split_view, print_segmentation_onto_image,
                                   resize_linear_u8)

        t_start = time.perf_counter()
        ema = self._resolve_ema(use_ema, False)
        if quantized and use_ema:
            raise ValueError("quantized and use_ema are mutually exclusive")
        verbose = verbose and self._writer
        if self._writer:
            if overwrite_existing and os.path.exists(results_dir):
                shutil.rmtree(results_dir)
            os.makedirs(results_dir, exist_ok=True)

        image_paths = sorted(glob(os.path.join(images_dir, "*." + image_file_extension)))
        if verbose:
            print(f'The segmented images will be saved to "{results_dir}"')

        # group by output size (PIL reads the size from the header)
        groups: dict = {}
        if resize:
            groups[tuple(resize)] = list(image_paths)
        else:
            for p in image_paths:
                with Image.open(p) as im:
                    w, h = im.size
                groups.setdefault((h, w), []).append(p)

        if tile_blend and tile is None:
            raise ValueError("tile_blend requires tile=(th, tw)")
        if output_format not in ("overlay", "ids"):
            raise ValueError(f"output_format must be 'overlay' or 'ids', got {output_format!r}")
        if output_format == "ids":
            if include_unprocessed_image:
                raise ValueError(
                    "include_unprocessed_image is incompatible with output_format='ids'")
            lut = None
        else:
            if color_map is None:
                raise ValueError("color_map is required for output_format='overlay'")
            lut = (self._overlay_lut(color_map)
                   if on_device_overlay and not (tile is not None and tile_blend) else None)
        id_lut = np.asarray(id_map) if id_map is not None else None
        max_id = int(id_lut.max()) if id_lut is not None else self.num_classes - 1
        id_dtype = np.uint8 if max_id <= 255 else np.uint16
        timings = dict.fromkeys(("decode", "decode_wait", "dispatch", "d2h", "encode",
                                 "encode_wait"), 0.0)
        pool_lock = threading.Lock()

        def timed(key, fn, *args):
            """``fn(*args)`` on a pool thread, its seconds added to ``key``."""
            t0 = time.perf_counter()
            out = fn(*args)
            with pool_lock:
                timings[key] += time.perf_counter() - t0
            return out

        def write_png(path, out, image):
            if output_format == "ids":
                ids = id_lut[out] if id_lut is not None else out
                Image.fromarray(np.ascontiguousarray(ids.astype(id_dtype))).save(
                    os.path.join(results_dir, os.path.basename(path)))
                return
            overlaid = out if lut is not None else print_segmentation_onto_image(
                image, out.astype(np.int32), color_map)
            if include_unprocessed_image:
                h, w = overlaid.shape[:2]
                if arrangement == "vertical":
                    overlaid = create_split_view((2 * h, w), [overlaid, image],
                                                 [(0, 0), (h, 0)], [(h, w)] * 2)
                else:
                    overlaid = create_split_view((h, 2 * w), [overlaid, image],
                                                 [(0, 0), (0, w)], [(h, w)] * 2)
            Image.fromarray(overlaid).save(os.path.join(results_dir, os.path.basename(path)))

        def load_chunk(chunk, gh, gw):
            imgs = []
            for p in chunk:
                image = np.asarray(Image.open(p).convert("RGB"))
                if resize:
                    image = resize_linear_u8(image, (gh, gw))
                imgs.append(image)
            return np.stack(imgs)

        chunks = [(grp[start:start + batch_size], gh, gw)
                  for (gh, gw), grp in groups.items()
                  for start in range(0, len(grp), batch_size)]
        reader = ThreadPoolExecutor(max_workers=4)
        writer = ThreadPoolExecutor(max_workers=4)
        write_futures = []
        done = 0

        def flush(pending):
            nonlocal done
            chunk_paths, out, images_host = pending.popleft()
            t0 = time.perf_counter()
            if isinstance(out, torch.Tensor):
                n, h, w = images_host.shape[:3]
                out = out.cpu().numpy()[:n, :h, :w]  # D2H: waits for the card
            timings["d2h"] += time.perf_counter() - t0
            for j, path in enumerate(chunk_paths if self._writer else ()):
                write_futures.append(writer.submit(timed, "encode", write_png, path, out[j],
                                                   images_host[j]))
            done += len(chunk_paths)
            if verbose:
                print(f"\rProcessing images: {done}/{len(image_paths)}", end="", flush=True)

        decode_futs = deque((c, reader.submit(timed, "decode", load_chunk, c, gh, gw))
                            for c, gh, gw in chunks[:_DECODE_AHEAD])
        next_decode = _DECODE_AHEAD
        pending = deque()
        try:
            with torch.inference_mode():
                while decode_futs:
                    chunk, fut = decode_futs.popleft()
                    t0 = time.perf_counter()
                    images_host = fut.result()
                    t1 = time.perf_counter()
                    if next_decode < len(chunks):
                        c, gh, gw = chunks[next_decode]
                        decode_futs.append((c, reader.submit(timed, "decode", load_chunk, c,
                                                             gh, gw)))
                        next_decode += 1
                    if tile is not None:  # synchronous per chunk: predict(tile=...)
                        out = self._predict_tiled(images_host, True, lut, quantized, tile,
                                                  tile_overlap, params=ema, blend=tile_blend)
                    else:
                        # a short last chunk padded to batch_size: one step a size
                        padded, _ = self._prepare_images(images_host, pad_batch_to=batch_size)
                        out = self._dispatch_predict(padded, argmax=True, overlay_lut=lut,
                                                     quantized=quantized, params=ema)
                    timings["decode_wait"] += t1 - t0
                    timings["dispatch"] += time.perf_counter() - t1
                    pending.append((chunk, out, images_host))
                    if len(pending) >= 2:  # keep one chunk in flight
                        flush(pending)
                while pending:
                    flush(pending)
            t0 = time.perf_counter()
            for f in write_futures:
                f.result()
            timings["encode_wait"] = time.perf_counter() - t0
        finally:
            reader.shutdown(wait=True)
            writer.shutdown(wait=True)
        collectives.barrier(self.mesh)
        if verbose:
            print()
        self.predict_and_save_timings = {"images": len(image_paths),
                                         "seconds": time.perf_counter() - t_start, **timings}

    def score_benchmark(self, dataset_dir, results_dir, *, split="val", id_map=None,
                        batch_size=8, use_ema=False, quantized=False, tile=None,
                        tile_overlap=128, tile_blend=False, instance_level=True, quiet=True,
                        export_file=None):
        """One-call Cityscapes-benchmark scoring, as the JAX facade's: predict
        every ``split`` image under ``dataset_dir``, write the labelId PNGs
        into ``results_dir`` (``predict_and_save(output_format='ids')`` per
        city) and run the offline pixel-level scorer
        (``evaluation.pixel_eval.evaluate_img_lists``).

        ``dataset_dir`` has the standard layout
        (``leftImg8bit/<split>/<city>/*_leftImg8bit.png`` and
        ``gtFine/<split>/<city>/*_gtFine_labelIds.png``, instanceIds too
        unless ``instance_level=False``); the image root and the ground
        truth are checked before any inference. ``id_map`` maps predicted
        ids to labelIds: ``labels.TRAINIDS_TO_IDS_ARRAY`` by default for the
        20-class trainId scheme, required otherwise. The scorer's arguments
        are built here, so a stale ``CITYSCAPES_EXPORT_DIR`` is ignored;
        ``quiet`` (default) keeps stdout silent. The prediction arguments
        pass through. Returns the scorer's result dict, also written as JSON
        to ``export_file`` (default: inside ``results_dir``). On a mesh every
        rank predicts, rank 0 writes and scores, and every rank returns its
        result."""
        from ..evaluation import pixel_eval

        img_root = os.path.join(dataset_dir, "leftImg8bit", split)
        if not os.path.isdir(img_root):
            raise ValueError(f"no such image root: {img_root}")
        if id_map is None:
            from ..labels import NUM_TRAIN_CLASSES, TRAINIDS_TO_IDS_ARRAY

            if self.num_classes != NUM_TRAIN_CLASSES:
                raise ValueError(
                    "id_map is required when the model's class space is not "
                    "the modified 20-class Cityscapes trainId scheme")
            id_map = TRAINIDS_TO_IDS_ARRAY

        # built directly, not by default_args(), which reads the CITYSCAPES_*
        # environment: every field it would set is set here
        args = pixel_eval.EvalArgs()
        args.cityscapes_path = dataset_dir
        args.ground_truth_search = os.path.join(
            dataset_dir, "gtFine", split, "*", "*_gtFine_labelIds.png")
        args.prediction_path = results_dir
        args.eval_inst_level_score = instance_level
        args.quiet = quiet
        args.colorized = hasattr(sys.stderr, "isatty") and sys.stderr.isatty()
        args.export_file = export_file or os.path.join(
            results_dir, "resultPixelLevelSemanticLabeling.json")
        ground_truths = sorted(glob(args.ground_truth_search))
        if not ground_truths:
            raise ValueError(f"no ground truth found under {args.ground_truth_search}")

        if self._writer:
            os.makedirs(results_dir, exist_ok=True)
        for city in sorted(os.listdir(img_root)):
            city_dir = os.path.join(img_root, city)
            if not os.path.isdir(city_dir):
                continue
            self.predict_and_save(
                results_dir, city_dir, output_format="ids", id_map=id_map,
                batch_size=batch_size, overwrite_existing=False, use_ema=use_ema,
                quantized=quantized, tile=tile, tile_overlap=tile_overlap,
                tile_blend=tile_blend, verbose=not quiet)

        result = None
        if self._writer:
            predictions = [pixel_eval.get_prediction(args, gt) for gt in ground_truths]
            result = pixel_eval.evaluate_img_lists(predictions, ground_truths, args)
        return collectives.broadcast_object(result, self.mesh)

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

        ``record_summaries`` (the default, as in the JAX facade; it
        requires ``summaries_dir``) writes TensorBoard event files
        ``<summaries_name or 'summaries'>_training`` and ``..._evaluation``
        under ``summaries_dir``: ``total_loss`` and ``learning_rate`` every
        ``summaries_frequency`` steps (from the loss read-back above), the
        weight summaries of ``engine/summaries.py`` at each epoch's end,
        and each evaluation's metrics.

        ``device_augment``: a dict of kwargs for
        ``ops.augment_device.make_augment_fn`` (e.g. ``{'flip': 0.5,
        'brightness': (0.8, 1.2, 0.5)}``); each padded batch is augmented on
        the card inside the step, with draws from (``seed``, step) alone.

        ``ema_decay``: keep an exponential moving average of the fp32
        masters, ``ema = d * ema + (1 - d) * params`` after every optimizer
        step, seeded with a copy of the params at the first step; it
        persists across ``train`` calls and in checkpoints (a resumed
        ``train(ema_decay=...)`` continues it). Serve or evaluate it with
        ``use_ema=True``, or make it the params with ``adopt_ema()``.

        ``early_stopping``: an int patience or ``{"patience": int,
        "min_delta": float}``: stop once the ``monitor``-ed value has gone
        ``patience`` observations without improving by more than
        ``min_delta``. An observation is each epoch's training loss when
        ``monitor='loss'`` and loss is not among ``metrics``, otherwise each
        periodic evaluation. ``reduce_lr_on_plateau``: an int patience or
        ``{"patience", "factor" (0.1), "min_delta" (0), "min_lr" (0)}``:
        after ``patience`` stale observations the schedule's LR is scaled by
        a further cumulative ``factor``; ``min_lr`` bounds the value right
        after a reduction, never the base schedule. Both observers' counters
        are written into checkpoints, and the first ``train`` on a model
        restored by ``resume``/``model_load_dir`` continues them; later
        calls start fresh.

        On a mesh every rank trains on its rows of each batch (padded to
        ``lcm(data, gradient_accumulation)``), the loss and the metrics the
        observers read are the whole batch's (summed over 'data'), so every
        rank takes the same branch; rank 0 alone prints and writes the
        summaries, the train log and the checkpoints.

        ``spatial_partition=True``: each rank also keeps its columns of the
        rows (the width split over 'model' in units of 32 columns, after
        the device augmentation of the whole rows), with the halo exchanged
        at every conv and deconv in the forward and the backward; the
        periodic evaluation runs the same way, and so does a later
        ``find_learning_rate``. A tensor-parallel model trains on its whole
        params, moments and EMA (gathered at the start of the call, laid
        back into shards at its end).

        Under a profiler the call's work is the span ``fcn8s.train``, with
        its phases inside: ``.start`` (the train state, the relayout and the
        input stream), each step's ``.next_batch``, ``.step`` and
        ``.readback`` (the losses to the host), and ``.end`` (the stream
        closed, the params cast for predict)."""
        self._refuse_segformer("spatial_partition", spatial_partition)
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

        def _observer_cfg(value, name, defaults):
            """Int patience or a dict with patience and the observer's keys."""
            d = dict(value) if isinstance(value, dict) else {"patience": value}
            out = {"patience": int(d.pop("patience"))}
            for key, default in defaults.items():
                out[key] = float(d.pop(key, default))
            if d:
                raise ValueError(f"unknown {name} keys: {sorted(d)}")
            if out["patience"] < 1:
                raise ValueError(f"{name} patience must be >= 1, got {out['patience']}")
            if monitor != "loss" and not (metrics and eval_frequency):
                raise ValueError(
                    f"{name} on an eval metric requires metrics and "
                    f"eval_frequency so the monitor is ever measured")
            return out

        # counters staged by a checkpoint restore: consumed by this call
        pending_observer = self._observer_pending or {}
        self._observer_pending = {}
        lr_scale = 1.0  # cumulative plateau factor; 1.0 when disabled
        if early_stopping is not None:
            es_cfg = _observer_cfg(early_stopping, "early_stopping", {"min_delta": 0.0})
            es_patience, es_min_delta = es_cfg["patience"], es_cfg["min_delta"]
            es_best = pending_observer.get("es_best")
            es_stale = int(pending_observer.get("es_stale", 0))
        if reduce_lr_on_plateau is not None:
            rp_cfg = _observer_cfg(reduce_lr_on_plateau, "reduce_lr_on_plateau",
                                   {"factor": 0.1, "min_delta": 0.0, "min_lr": 0.0})
            rp_patience, rp_factor = rp_cfg["patience"], rp_cfg["factor"]
            rp_min_delta, rp_min_lr = rp_cfg["min_delta"], rp_cfg["min_lr"]
            if not 0.0 < rp_factor < 1.0:
                raise ValueError(f"reduce_lr_on_plateau factor must be in (0, 1), got {rp_factor}")
            rp_best = pending_observer.get("rp_best")
            rp_stale = int(pending_observer.get("rp_stale", 0))
            lr_scale = float(pending_observer.get("lr_scale", 1.0))

        def _improved(obs, best, delta):
            """Lower is better for loss, higher otherwise; the first
            observation always improves."""
            return best is None or (obs < best - delta if monitor == "loss" else obs > best + delta)

        if class_weights is not None:
            cw = tuple(float(w) for w in np.asarray(class_weights).reshape(-1))
            if len(cw) != self.num_classes:
                raise ValueError(f"class_weights must have length num_classes="
                                 f"{self.num_classes}, got {len(cw)}")
            if any(w < 0 for w in cw):
                raise ValueError("class_weights must be non-negative")
        else:
            cw = None
        if gradient_accumulation < 1:
            raise ValueError(f"gradient_accumulation must be >= 1, got {gradient_accumulation}")
        if cw != self._class_weights_cfg:  # baked into the compiled steps, as in JAX
            self._train_steps.clear()
            self._eval_steps.clear()
            self._class_weights = (None if cw is None else
                                   torch.tensor(cw, dtype=torch.float32, device=self.device))
        self._class_weights_cfg = cw
        if gradient_accumulation != self._grad_accum:
            self._train_steps.clear()
        self._grad_accum = gradient_accumulation
        self._train_spatial = bool(spatial_partition)
        if device_augment is not None:
            if self._device_augment_cfg != device_augment:  # built once per distinct config
                self._augment_fn = make_augment_fn(**device_augment)
            self._device_augment_cfg = device_augment
        else:
            self._device_augment_cfg = self._augment_fn = None
        self.eval_dataset = eval_dataset
        self._initialize_metrics(metrics)
        logger = None
        if record_summaries:
            if summaries_dir is None:
                raise ValueError("record_summaries requires summaries_dir")
            if self._summary_logger is not None:
                self._summary_logger.close()
                self._summary_logger = None
            if self._writer:
                logger = self._summary_logger = SummaryLogger(summaries_dir, summaries_name)

        def _lr(step):
            return float(learning_rate_schedule(step)) * lr_scale

        # the call's spans: fcn8s.train, and inside it .start, then each
        # step's .next_batch, .step and .readback, then .end
        with annotate("fcn8s.train"), contextlib.ExitStack() as call:
            with annotate("fcn8s.train.start"):
                call.enter_context(self._replicas(spatial_partition))
                if self.state.opt_state is None:
                    if self._staged_opt_state is not None:  # restored from a checkpoint
                        self.state.opt_state = self._shard_opt(
                            self._staged_opt_state).to(self.device)
                        self._staged_opt_state = None
                    else:
                        self.state = create_train_state(self.params, self.optimizer)
                        self.state.step = self.g_step
                g_step = self.state.step
                learning_rate = _lr(g_step)
                loss_history = deque(maxlen=training_loss_display_averaging)
                train_stream = self._make_train_stream(train_generator, prefetch)
            try:
                for epoch in range(1, epochs + 1):
                    for step_i in range(steps_per_epoch):
                        with annotate("fcn8s.train.next_batch"):
                            batch = next(train_stream)
                        with annotate("fcn8s.train.step"):
                            self.state, loss = self._train_call(
                                self.state, batch, learning_rate, l2_regularization,
                                keep_prob, spatial_partition)
                        g_step += 1
                        self.variables_updated = True
                        if ema_decay is not None:
                            self._update_ema(ema_decay)
                        loss_history.append(loss)  # a device scalar: no sync
                        # read the losses back (one copy) only on the summaries
                        # cadence and at the epoch's end, so the host runs ahead
                        # of the card between
                        if g_step % summaries_frequency == 0 or step_i == steps_per_epoch - 1:
                            with annotate("fcn8s.train.readback"):
                                vals = torch.stack(list(loss_history)).cpu().numpy()
                            self.training_loss = float(vals.mean())
                            if logger is not None and g_step % summaries_frequency == 0:
                                logger.log_training_step(g_step, float(vals[-1]), learning_rate)
                        learning_rate = _lr(g_step)
                    self.g_step = g_step
                    if self._writer:
                        print(f"Epoch {epoch}/{epochs}: training loss {self.training_loss}, "
                              f"learning rate {learning_rate:.3g}")
                    if record_summaries:
                        full = self._gather(self.params)  # every rank: a collective under TP
                        if logger is not None:
                            logger.log_weight_summaries(g_step, full)
                        del full

                    eval_epoch = bool(metrics and eval_frequency and epoch % eval_frequency == 0)
                    if eval_epoch:
                        self._refresh_run_params()
                        if eval_dataset == "train":
                            self._evaluate(train_stream, steps_per_epoch, device_stream=True,
                                           spatial_partition=spatial_partition)
                        else:
                            self._evaluate(val_generator, val_steps,
                                           spatial_partition=spatial_partition)
                        if logger is not None:
                            logger.log_evaluation(g_step, dict(zip(self.metric_names,
                                                                   self.metric_values)))
                    evaluated = eval_epoch and bool(self.metric_values)
                    epoch_lr = learning_rate  # the LR the train log records for this epoch

                    # the observers, updated before the save so that a checkpoint
                    # carries this epoch's counters
                    stop_early = False
                    if early_stopping is not None or reduce_lr_on_plateau is not None:
                        if monitor == "loss" and "loss" not in self.metric_names:
                            obs = self.training_loss
                        elif evaluated:
                            obs = float(self.metric_values[self.metric_names.index(monitor)])
                        else:
                            obs = None  # the monitor was not measured this epoch
                        if obs is not None and reduce_lr_on_plateau is not None:
                            if _improved(obs, rp_best, rp_min_delta):
                                rp_best, rp_stale = obs, 0
                            else:
                                rp_stale += 1
                                if rp_stale >= rp_patience:
                                    new_scale = lr_scale * rp_factor
                                    base = float(learning_rate_schedule(g_step))
                                    # min_lr bounds the reduced value only, and a
                                    # reduction never raises the scale
                                    if base > 0.0 and base * new_scale < rp_min_lr:
                                        new_scale = min(rp_min_lr / base, lr_scale)
                                    lr_scale = new_scale
                                    rp_stale = 0
                                    learning_rate = _lr(g_step)
                                    if self._writer:
                                        print(f"Plateau: '{monitor}' stalled {rp_patience} "
                                              f"observations — learning rate scaled to "
                                              f"{learning_rate:.3e}.")
                        if obs is not None and early_stopping is not None:
                            if _improved(obs, es_best, es_min_delta):
                                es_best, es_stale = obs, 0
                            else:
                                es_stale += 1
                                if es_stale >= es_patience:
                                    if self._writer:
                                        print(f"Early stopping: '{monitor}' has not improved in "
                                              f"{es_stale} observations (best {es_best:.6f}).")
                                    stop_early = True
                        observer_state = {}
                        if reduce_lr_on_plateau is not None:
                            observer_state.update(lr_scale=lr_scale, rp_best=rp_best,
                                                  rp_stale=rp_stale)
                        if early_stopping is not None:
                            observer_state.update(es_best=es_best, es_stale=es_stale)
                        self._observer_state = observer_state

                    if save_during_training and epoch % save_frequency == 0:
                        if not save_best_only or self._monitor_improved(monitor):
                            # the masters are consistent here: save() snapshots
                            # them on the device and writes on a thread
                            self.save(model_save_dir=save_dir, saver=saver, tags=save_tags,
                                      name=save_name or None, block=False)

                    if (self.training_loss is not None
                            and self.training_loss < self.best_training_loss):
                        self.best_training_loss = self.training_loss
                    for i, name in enumerate(self.metric_names):
                        if i < len(self.metric_values):
                            better = (self.metric_values[i] < self.best_metric_values[i]
                                      if name == "loss"
                                      else self.metric_values[i] > self.best_metric_values[i])
                            if better:
                                self.best_metric_values[i] = self.metric_values[i]

                    if train_log and self._writer:
                        record = {"epoch": epoch, "global_step": g_step,
                                  "training_loss": self.training_loss, "learning_rate": epoch_lr,
                                  "time": time.time()}
                        if evaluated:
                            record.update({f"eval_{n}": float(v) for n, v in
                                           zip(self.metric_names, self.metric_values)})
                        with open(train_log, "a") as log_f:
                            log_f.write(json.dumps(record) + "\n")
                    if stop_early:
                        break
                if logger is not None:
                    logger.flush()
            finally:
                with annotate("fcn8s.train.end"):
                    self._close_train_stream()
                    self._refresh_run_params()
        self._join_pending_save()  # don't return with a checkpoint mid-write

    def find_learning_rate(self, train_generator, *, min_lr=1e-7, max_lr=1.0, steps=50,
                           keep_prob=1.0, l2_regularization=0.0, smoothing=0.9,
                           divergence_factor=4.0):
        """LR range test (Smith 2015, arXiv:1506.01186 §3.3), as the JAX
        facade's: the learning rate sweeps exponentially from ``min_lr`` to
        ``max_lr`` over ``steps`` real optimizer steps (``train_step`` with
        the settings of the last ``train``: gradient accumulation, class
        weights, device augmentation), the loss read back after each; the
        sweep stops once the loss is not finite or, from step 10, the
        debiased smoothed loss passes ``divergence_factor`` x its best.

        The model is left exactly as found. The optimizer updates the params
        and its state in place, so the params, the optimizer state and the
        step are cloned before the sweep and copied back into the same
        tensors after it (in a ``finally``: a sweep that ends on a NaN
        leaves no trace either), and the inference trees are rebuilt. A
        model that never trained has no optimizer state on the card: the
        sweep allocates one (a copy of a checkpoint's staged state, where
        there is one) and drops it again. ``variables_updated``, the EMA and
        the observers' counters are untouched.

        Returns ``{"learning_rates", "losses", "smoothed", "suggestion"}``:
        ``suggestion`` is the LR at the steepest descent of the smoothed
        curve (``min_lr`` when nothing descended)."""
        if not (0.0 < min_lr < max_lr):
            raise ValueError(f"need 0 < min_lr < max_lr, got {min_lr}, {max_lr}")
        if steps < 2:
            raise ValueError(f"steps must be >= 2, got {steps}")
        with self._replicas(self._train_spatial):
            was_dirty = self.variables_updated
            state = self.state
            leaves = bridge.param_leaves(self.params) + bridge.state_leaves(self.params)
            saved_step = state.step
            with torch.no_grad():
                saved_params = [t.detach().clone() for t in leaves]
            transient = state.opt_state is None
            if transient:
                staged = self._staged_opt_state
                state.opt_state = (self._shard_opt(staged).to(self.device, copy=True)
                                   if staged is not None else self.optimizer.init(self.params))
                saved_opt = None
            else:
                saved_opt = (_opt_scalars(state.opt_state),
                             [t.clone() for t in _opt_tensors(state.opt_state)])
            stream = self._make_train_stream(train_generator, prefetch=0)
            lrs, losses, smoothed = [], [], []
            avg, best = 0.0, math.inf
            try:
                for i in range(steps):
                    lr = min_lr * (max_lr / min_lr) ** (i / (steps - 1))
                    _, loss = self._train_call(state, next(stream), lr, l2_regularization,
                                               keep_prob, self._train_spatial)
                    loss = float(loss)
                    lrs.append(lr)
                    losses.append(loss)
                    avg = smoothing * avg + (1.0 - smoothing) * loss
                    debiased = avg / (1.0 - smoothing ** (i + 1))
                    smoothed.append(debiased)
                    if math.isfinite(debiased):
                        best = min(best, debiased)
                    if not math.isfinite(loss) or (i >= 10 and debiased > divergence_factor * best):
                        break
            finally:
                self._close_train_stream()
                with torch.no_grad():
                    torch._foreach_copy_(leaves, saved_params)
                del saved_params
                state.step = saved_step
                if transient:
                    state.opt_state = None
                else:
                    (count, lr_last, inner_count), tensors = saved_opt
                    state.opt_state.count, state.opt_state.learning_rate = count, lr_last
                    if inner_count is not None:
                        state.opt_state.inner.count = inner_count
                    if tensors:  # sgd keeps none
                        with torch.no_grad():
                            torch._foreach_copy_(_opt_tensors(state.opt_state), tensors)
                del saved_opt
                self.variables_updated = was_dirty
                self._refresh_run_params()
                self._train_steps.purge()  # a transient state's captures go with it
        # steepest descent of the smoothed curve over log-spaced LRs (equal
        # log spacing: the index of the most negative finite difference)
        diffs = [b - a for a, b in zip(smoothed, smoothed[1:])
                 if math.isfinite(a) and math.isfinite(b)]
        if diffs and min(diffs) < 0:
            idx = min(range(len(smoothed) - 1),
                      key=lambda j: (smoothed[j + 1] - smoothed[j]
                                     if math.isfinite(smoothed[j + 1] - smoothed[j])
                                     else math.inf))
            suggestion = lrs[idx]
        else:
            suggestion = min_lr  # nothing descended: the sweep range is too hot
        return {"learning_rates": lrs, "losses": losses, "smoothed": smoothed,
                "suggestion": float(suggestion)}

    def _make_train_stream(self, train_generator, prefetch: int):
        """Iterator of device (images, label_ids, mask) triples. The host
        part converts labels to uint8 ids, pads the batch to a multiple of
        ``lcm(data axis, gradient accumulation)`` (masked samples) and takes
        this rank's rows in the microbatch layout of ``batch_rows``. With
        ``prefetch > 0`` a background thread runs it ``prefetch`` batches
        ahead, in pinned memory; with 0 it runs in the caller,
        synchronously."""
        self._close_train_stream()
        accum = self._grad_accum
        multiple = math.lcm(self.mesh.shape[DATA_AXIS], accum)

        def host_pipeline():
            while True:
                images, labels = next(train_generator)
                label_ids = self._labels_to_ids(np.asarray(labels))
                batch = self._pad_batch_dim(np.asarray(images), label_ids, multiple=multiple)
                rows = batch_rows(batch[0].shape[0], self.mesh, accum)
                yield batch if rows is None else tuple(a[rows] for a in batch)

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
    def _evaluate(self, data_generator, num_batches, device_stream=False, params=None,
                  spatial_partition=False):
        """Reset the accumulators, run ``eval_step`` on ``num_batches``
        batches, finalize, print. ``data_generator`` yields host (images,
        labels) pairs, or with ``device_stream`` the training stream's device
        (images, label_ids, mask) triples. ``params``: compute-dtype params
        to run instead of the live ones (the EMA's). ``spatial_partition``:
        the width split over 'model', on replicated params."""
        self._refuse_segformer("spatial_partition", spatial_partition)
        run = self._run_params if params is None else params
        if spatial_partition:  # replicated
            run = self._replicated(run)
        state = empty_metrics_state(self.num_classes, device=self.device)
        for _ in range(num_batches):
            if device_stream:
                im_d, lb_d, mask_d = next(data_generator)
            else:
                images, labels = next(data_generator)
                label_ids = self._labels_to_ids(np.asarray(labels))
                # padded to the 'data' axis with masked samples (none off a mesh)
                im_d, lb_d, mask_d = self._put_batch(
                    *self._pad_batch_dim(np.asarray(images), label_ids))
            if not self._eager_steps:
                state = self._get_eval_step(im_d.shape, spatial_partition)(run, state, im_d,
                                                                            lb_d, mask_d)
            else:
                state = eval_step(run, state, im_d, lb_d, mask_d,
                                  num_classes=self.num_classes, compute_dtype=self.compute_dtype,
                                  ignore_label=self.ignore_label,
                                  class_weights=self._class_weights,
                                  **self._step_layout(spatial_partition))
        self.metrics_state = state
        values = {k: float(v) for k, v in finalize_metrics(state).items()}
        self.metric_values = [values[name] for name in self.metric_names]
        if self._writer:
            print("  ".join(f"{n}: {v:.4f}" for n, v in zip(self.metric_names,
                                                             self.metric_values)))
        return values

    def evaluate(self, data_generator, num_batches, metrics={"loss", "mean_iou", "accuracy"},
                 l2_regularization=0.0, dataset="val", spatial_partition=False, use_ema=False):
        """Evaluate on ``num_batches`` batches of (images, labels) from
        ``data_generator``; labels are id maps or one-hot. Returns
        {'loss', 'mean_iou', 'accuracy'} floats; the running confusion
        matrix stays in ``self.metrics_state``. The loss honours
        ``ignore_label`` and the class weights of the last ``train``.
        ``l2_regularization`` is accepted for parity and, as in the JAX
        facade, does not change the reported loss. ``use_ema=True``
        evaluates the EMA average (``train(ema_decay=...)``).
        ``spatial_partition=True`` splits the width over the mesh's 'model'
        axis, as ``predict``'s does."""
        metrics = set(metrics)
        if not metrics <= _ALLOWED_METRICS:
            raise ValueError(f"metrics must be a subset of {_ALLOWED_METRICS}")
        if dataset not in {"train", "val"}:
            raise ValueError("dataset must be 'train' or 'val'")
        self.eval_dataset = dataset
        self._initialize_metrics(metrics)
        return self._evaluate(data_generator, num_batches,
                              params=self._resolve_ema(use_ema, False),
                              spatial_partition=spatial_partition)

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
    def export_serving(self, directory, *, input_hw=(1024, 512), argmax=True,
                       use_ema=False):
        """Write a ``torch.export`` serving artifact (``engine/export.py``):
        the predict head for ``input_hw`` inputs, traced on the model's
        device with a symbolic batch, its params as inputs in a params-only
        checkpoint beside it. ``engine.export.load_serving_artifact(directory,
        device).predict(images)`` runs it without this facade. ``argmax``
        exports the id head, otherwise the softmax; ``use_ema`` the EMA
        average. Returns ``directory``."""
        from .export import export_serving_artifact

        self._refuse_segformer("export_serving")
        return export_serving_artifact(self, directory, input_hw=input_hw, argmax=argmax,
                                       use_ema=use_ema)

    def save(self, model_save_dir, saver="saved_model", tags=["default"], name=None,
             include_global_step=True, include_last_training_loss=True, include_metrics=True,
             force_save=False, block=True):
        """Save a self-describing checkpoint in the JAX package's format under
        ``model_save_dir``, in a directory named by the reference's scheme
        (global step, training loss, metrics); returns its path, or None when
        nothing was trained since the last save (unless ``force_save``).
        ``saver``/``tags`` are accepted for parity. The five newest
        checkpoints in ``model_save_dir`` are kept.

        ``block=False`` snapshots params, optimizer state and the EMA on the
        device (the optimizer and the EMA update them in place) and writes
        on a thread
        (``checkpoint.save_checkpoint_async``); the previous writer is joined
        first, so one save is in flight at a time, and a failed write raises
        at the next join (the next save, ``train``'s end or ``close``).

        On a mesh every rank calls it: the whole tree is gathered (params,
        optimizer moments and EMA; an all-gather over 'model' under tensor
        parallelism), rank 0 writes exactly the file a mesh-less save of
        the same params writes, and the others wait for it at a barrier
        (with ``block=False``, at the join)."""
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
            # the observers' counters, so a resumed run continues them
            metadata["train_observer"] = dict(self._observer_state)
        params = self._gather(self.params)
        if self.state.opt_state is not None:
            opt_state = self._gather_opt(self.state.opt_state)
        else:  # the staged state is whole already
            opt_state = (self._staged_opt_state
                         or self.optimizer.init(self._full_shape_params(), device="cpu"))
        ema = None if self._ema is None else self._gather(self._ema)
        state = TrainState(step=step, params=params, opt_state=opt_state)
        self._join_pending_save()
        if self._writer and block:
            ckpt.save_checkpoint(directory, state, metadata, max_to_keep=5, ema_params=ema)
        elif self._writer:
            self._save_thread = ckpt.save_checkpoint_async(directory, state, metadata,
                                                           max_to_keep=5, ema_params=ema)
        if block:
            collectives.barrier(self.mesh)
        else:
            self._save_pending = True
        self.variables_updated = False
        return directory

    def _join_pending_save(self) -> None:
        """Wait for the in-flight async save: rank 0 joins its writer, and
        every rank then meets at a barrier, so none reads a checkpoint that
        is still being written."""
        thread = self._save_thread
        if thread is not None:
            thread.join()
            self._save_thread = None
        if self._save_pending:
            self._save_pending = False
            collectives.barrier(self.mesh)
        if thread is not None and thread.exc is not None:
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
        by path (on a mesh, this rank's blocks of them)."""
        def jkey(key):  # the JAX key of a port key
            return "kernel" if key == "weight" else key

        full = self._full_shape_params()
        example = {}  # JAX-layout shapes, as meta tensors
        for part in parts:
            for name, layer in full[part].items():
                for key, t in layer.items():
                    example.setdefault(part, {}).setdefault(name, {})[jkey(key)] = \
                        bridge.leaf_to_jax(torch.empty_like(t, device="meta"),
                                           f"{part}/{name}/{jkey(key)}")
        restored = ckpt.load_params_only(path, example)
        values = {part: {name: {key: bridge.leaf_from_jax(
            torch.from_numpy(restored[part][name][jkey(key)]),
            f"{part}/{name}/{jkey(key)}") for key in layer}
            for name, layer in self.params[part].items()} for part in parts}
        shardings = param_sharding_tree(self.mesh, self.params, tensor_parallel=self._tp)
        with torch.no_grad():
            for part in parts:
                for name, layer in self.params[part].items():
                    for key, t in layer.items():
                        t.copy_(shardings[part][name][key].shard(values[part][name][key]))
        self._refresh_run_params()

    def close(self):
        """Stop the input pipeline, join an in-flight checkpoint write, close
        the summary writers and release the device tensors (the reference
        closes its session)."""
        self._close_train_stream()
        try:
            self._join_pending_save()
        finally:
            if self._summary_logger is not None:
                self._summary_logger.close()
                self._summary_logger = None
            for cache in self._step_caches().values():
                cache.clear()
            self.params = self._run_params = self.state = None
            self._ema = self._ema_run = self._qparams = None
        print("The session has been closed.")
