"""The ('data', 'model') device mesh and the param and batch layouts. Port
of ``fcn8s_tensorflow_tpu/parallel/mesh.py``.

* axis ``data``: data parallelism. Each data position holds a slice of
  the batch; gradients, loss normalisers and metrics are summed over it.
* axis ``model``: Megatron tensor parallelism of the two giant encoder
  layers (fc6: 7x7x512x4096, fc7: 1x1x4096x4096, ~119 M of the ~134 M
  params). fc6 is column-parallel (its output channels and bias are
  sharded), fc7 row-parallel (its input channels are sharded); the one
  collective on the activation path is the all-reduce of fc7's partial
  sums (``parallel/collectives.py``). Or, with ``spatial_partition``,
  the image WIDTH is split over it (``width_split``): each rank holds a
  block of columns, every conv and deconv exchanges its halo columns with
  the neighbours (``collectives.halo_exchange``), and the params are
  replicated. The split is in units of 32 columns, the model's stride, so
  every pool level and the stride-8 packed layout of the final deconv stay
  local to a rank.

JAX runs one program that drives every device and lets GSPMD insert the
collectives. PyTorch has no single-controller SPMD, so here each mesh
position is one process of a ``torch.distributed`` group (``torchrun
--nproc-per-node=N``, or ``init_process_group`` with an address, a world
size and a rank). Every rank makes the same facade calls on the same
global batch; each takes its own slice, does its part, and the collectives
leave every rank with what the JAX facade returns. Rank ``r`` sits at
``(r // model, r % model)``, JAX's ``devices.reshape(data, model)``.

Without an initialised group, ``create_mesh()`` is the degenerate (1, 1)
mesh of this one process: no group, no collective, and every step runs
exactly the single-card code.

The specs are the JAX package's ``PartitionSpec`` values, written against
the port's layouts: a convolution kernel is OIHW here, so fc6's output
dim is dim 0 and fc7's input dim is dim 1.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
ALL_AXES = (DATA_AXIS, MODEL_AXIS)  # the whole mesh: a reduction over both axes


class PartitionSpec(tuple):
    """A tensor's layout over the mesh, as ``jax.sharding.PartitionSpec``:
    entry ``i`` names the mesh axis that dim ``i`` is split over (None:
    replicated along that dim); missing trailing entries are None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's view of the mesh: the axis sizes (``shape``, as
    ``jax.sharding.Mesh.shape``), this rank's coordinates and torch device,
    and the ``DeviceMesh`` whose per-axis groups carry the collectives
    (None on a mesh of one position)."""

    shape: dict
    coords: dict
    device: torch.device
    device_mesh: object = None

    axis_names = (DATA_AXIS, MODEL_AXIS)

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    @property
    def rank(self) -> int:
        return self.coords[DATA_AXIS] * self.shape[MODEL_AXIS] + self.coords[MODEL_AXIS]

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes files (rank 0 of the mesh)."""
        return self.rank == 0

    def group(self, axis):
        """The process group along ``axis`` through this rank (``ALL_AXES``:
        the whole mesh), or None when it has one position (nothing to
        communicate)."""
        if axis == ALL_AXES:
            return None if self.size == 1 else dist.group.WORLD
        if self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)

    def tensor_parallel(self, requested: bool) -> bool:
        """Whether fc6/fc7 are sharded: asked for, over a >1 'model' axis."""
        return bool(requested) and self.shape[MODEL_AXIS] > 1


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def create_mesh(data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """Build the 2-D ('data', 'model') mesh over the initialised process
    group (one rank per position; without a group, the (1, 1) mesh of this
    process). ``data=None`` uses all remaining positions. ``devices``: the
    torch device of each rank, in rank order (default: ``cuda:$LOCAL_RANK``
    for every rank, the card; the CPU only when asked for, e.g.
    ``["cpu"] * world``)."""
    world, rank = _world()
    devices = list(devices) if devices is not None else None
    count = len(devices) if devices is not None else world
    if data is None:
        if count % model:
            raise ValueError(f"{count} devices not divisible by model={model}")
        data = count // model
    if data * model > count:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {count}")
    if data * model != world or count != world:
        raise ValueError(
            f"mesh {data}x{model} over {count} devices needs one process per position, "
            f"and the process group has {world}")
    device = resolve_device(devices[rank] if devices is not None
                            else f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    device_mesh = None
    if world > 1 or (dist.is_available() and dist.is_initialized()):
        from torch.distributed.device_mesh import DeviceMesh

        device_mesh = DeviceMesh(device.type, torch.arange(world).reshape(data, model),
                                 mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(shape={DATA_AXIS: data, MODEL_AXIS: model},
                coords={DATA_AXIS: rank // model, MODEL_AXIS: rank % model},
                device=device, device_mesh=device_mesh)


def batch_spec() -> PartitionSpec:
    """Batch tensors: the leading (batch) dim split over 'data', replicated
    over 'model'."""
    return P(DATA_AXIS)


def spatial_spec() -> PartitionSpec:
    """Batch over 'data' and the width dim over 'model': JAX's spatial
    partitioning (the columns of each position: ``width_split``)."""
    return P(DATA_AXIS, None, MODEL_AXIS)


STRIDE = 32  # the model's output stride: the unit of the width split


def width_bounds(width: int, parts: int) -> list[tuple[int, int]]:
    """The column range ``[lo, hi)`` of each of ``parts`` 'model' positions
    in a width of ``width``: whole units of 32 columns, as even as the units
    allow, the extra units on the lowest positions. A width that is not a
    multiple of 32, or has fewer units than positions, raises (the JAX
    package's GSPMD split diverges from the unsharded model there)."""
    if width % STRIDE or width // STRIDE < parts:
        raise ValueError(
            f"spatial_partition splits the width in units of {STRIDE} columns (the model's "
            f"stride), at least one per 'model' position: width {width} does not split over "
            f"{parts} positions")
    base, extra = divmod(width // STRIDE, parts)
    bounds, lo = [], 0
    for j in range(parts):
        hi = lo + STRIDE * (base + (j < extra))
        bounds.append((lo, hi))
        lo = hi
    return bounds


def width_range(width: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's column range ``[lo, hi)`` of a width (``width_bounds``)."""
    return width_bounds(width, mesh.shape[MODEL_AXIS])[mesh.coords[MODEL_AXIS]]


@dataclasses.dataclass(frozen=True)
class WidthSplit:
    """A width split over the mesh's 'model' axis (``width_bounds`` at the
    input's resolution) and this rank's part of it. Every feature map of
    the model is the input's width divided by its stride, so ``widths``
    gives every position's width at any level from this rank's width
    there."""

    mesh: Mesh
    bounds: tuple

    @property
    def lo(self) -> int:
        return self.bounds[self.mesh.coords[MODEL_AXIS]][0]

    @property
    def hi(self) -> int:
        return self.bounds[self.mesh.coords[MODEL_AXIS]][1]

    @property
    def width(self) -> int:
        """The whole width at the input's resolution."""
        return self.bounds[-1][1]

    def stride(self, local_width: int) -> int:
        """The stride of a level at which this rank's width is ``local_width``."""
        return (self.hi - self.lo) // local_width

    def widths(self, local_width: int) -> list[int]:
        """Every position's width at the level where this rank's is ``local_width``."""
        s = self.stride(local_width)
        return [(hi - lo) // s for lo, hi in self.bounds]

    def columns(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's columns of the full-width ``t`` along ``dim``, as a
        contiguous copy (a width slice of a row-major or channels_last
        tensor is a strided view)."""
        return t.narrow(dim, self.lo, self.hi - self.lo).contiguous()


def width_split(width: int, mesh: Mesh | None) -> WidthSplit | None:
    """The split of ``width`` over ``mesh``'s 'model' axis, or None where
    that axis has one position (no mesh, (1, 1), (d, 1)): the width is then
    whole and the single-card code runs."""
    if mesh is None or mesh.shape[MODEL_AXIS] == 1:
        return None
    return WidthSplit(mesh, tuple(width_bounds(width, mesh.shape[MODEL_AXIS])))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as ``jax.sharding.NamedSharding``."""

    mesh: Mesh
    spec: PartitionSpec

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full tensor ``t`` (a view)."""
        for dim, axis in enumerate(self.spec):
            if axis is None or self.mesh.shape[axis] == 1:
                continue
            parts, i = self.mesh.shape[axis], self.mesh.coords[axis]
            if t.shape[dim] % parts:
                raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split over "
                                 f"{parts} '{axis}' positions")
            step = t.shape[dim] // parts
            t = t.narrow(dim, i * step, step)
        return t

    def full_shape(self, local_shape) -> tuple:
        """The full tensor's shape from a block's."""
        shape = list(local_shape)
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                shape[dim] *= self.mesh.shape[axis]
        return tuple(shape)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, batch_spec())


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_spec_tree(params, *, tensor_parallel: bool = True):
    """PartitionSpec tree for a full port param tree (or any tree of its
    structure: the EMA, Adam's moments). With ``tensor_parallel``, fc6 is
    column-parallel (its OIHW weight split on O, its bias with it) and fc7
    row-parallel (its weight split on I); everything else replicates,
    fc7's bias and the whole decoder included."""

    def spec_for(path: tuple[str, ...]) -> PartitionSpec:
        if not tensor_parallel:
            return P()
        if "fc6" in path:
            return P(MODEL_AXIS) if path[-1] == "bias" else P(MODEL_AXIS, None, None, None)
        if "fc7" in path and path[-1] in ("weight", "kernel"):
            return P(None, MODEL_AXIS, None, None)
        return P()

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return spec_for(path)

    return walk(params)


def param_sharding_tree(mesh: Mesh, params, *, tensor_parallel: bool = True):
    """NamedSharding tree matching ``params``."""
    specs = param_spec_tree(params, tensor_parallel=tensor_parallel)
    return _map(lambda s: NamedSharding(mesh, s), specs)


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def sharded_leaves(params: dict, mesh: Mesh, *, tensor_parallel: bool) -> list[bool]:
    """For each tensor of ``bridge.param_leaves(params)``: whether this
    layout splits it over 'model'."""
    specs = param_spec_tree(params, tensor_parallel=mesh.tensor_parallel(tensor_parallel))
    return [any(a is not None for a in spec)
            for layers in specs.values() for layer in layers.values() for spec in layer.values()]


def shard_params(tree: dict, mesh: Mesh, tensor_parallel: bool) -> dict:
    """This rank's blocks of a full port tree (params, the EMA or any tree
    of their structure), as contiguous copies on the tree's devices."""
    shardings = param_sharding_tree(mesh, tree,
                                    tensor_parallel=mesh.tensor_parallel(tensor_parallel))
    return _map(lambda t, s: s.shard(t).contiguous(), tree, shardings)


def gather_params(tree: dict, mesh: Mesh, tensor_parallel: bool) -> dict:
    """The inverse of ``shard_params``: the full tree, on every rank (an
    all-gather over 'model' per sharded leaf; a replicated leaf is returned
    as it is). A collective: every rank of the 'model' group calls it."""
    from .collectives import all_gather_cat

    shardings = param_sharding_tree(mesh, tree,
                                    tensor_parallel=mesh.tensor_parallel(tensor_parallel))

    def gather(t, s):
        for dim, axis in enumerate(s.spec):
            if axis is not None:
                t = all_gather_cat(t.detach().contiguous(), mesh, axis, dim=dim)
        return t

    return _map(gather, tree, shardings)


def batch_rows(n: int, mesh: Mesh, microbatches: int = 1):
    """The rows of an ``n``-sample batch that this rank's data position
    holds (None: all of them). ``n`` must divide by ``data * microbatches``.
    With ``microbatches=A`` the batch is read as (A, data, n / (A*data)) and
    the rank takes its column, so its j-th local microbatch is its slice of
    the j-th global one."""
    d = mesh.shape[DATA_AXIS]
    if d == 1:
        return None
    if n % (d * microbatches):
        raise ValueError(f"batch {n} does not split over data={d} x {microbatches} microbatches")
    b = n // (d * microbatches)
    i = mesh.coords[DATA_AXIS]
    return np.concatenate([np.arange(j * d * b + i * b, j * d * b + (i + 1) * b)
                           for j in range(microbatches)])


def shard_batch(mesh: Mesh, *arrays):
    """Host numpy batch -> this rank's rows (``batch_rows``) as tensors on
    its device. A batch that does not divide raises; the facade pads it
    first (``FCN8s._pad_batch_dim``)."""
    rows = batch_rows(arrays[0].shape[0], mesh)
    out = tuple(torch.from_numpy(np.ascontiguousarray(a if rows is None else a[rows]))
                .to(mesh.device) for a in arrays)
    return out[0] if len(out) == 1 else out
