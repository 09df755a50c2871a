"""CUDA-graph capture for the compiled steps (``parallel/steps.py``'s
``compile_*_step``).

What a JAX compiled step gives its caller is one dispatch of a fixed-shape
executable with the carried state updated in place. Its counterpart on the
card is a captured ``torch.cuda.CUDAGraph``: the step body (forward,
autograd backward, optimizer, with every hand kernel inside) is recorded
once per set of shapes and replayed with one ``replay()``, so the host no
longer dispatches several hundred ops a step. A graph replays the
addresses and the kernel arguments it recorded, which shapes this module:

* inputs are copied into static buffers (``static_like``) before each
  replay, and the host scalars that change from call to call (learning
  rate, L2 rate, keep_prob, Adam's ``lr_scale``) live in one fp32 device
  buffer that ``fill_scalars`` writes with one copy from pinned memory;
* random draws come from ``FixedGenerators``: one CUDA generator per draw
  site, registered with every graph that draws from it and re-seeded
  before each replay with the seed the eager step derives for that site,
  so a replay draws the eager step's masks;
* ``capture`` warms the body up first (cuBLAS handles, cuDNN plans, the
  kernel library and the caching allocator initialise outside the
  capture) and puts back what the warm-up wrote, so the warm-up trains
  nothing; a failed warm-up or capture raises, and nothing falls back to
  eager execution;
* a wrapper's ``.launches += 1`` runs while its kernel is recorded, not
  when it is replayed: ``Captured.run`` adds the recorded counts once per
  replay, so the counters keep counting launches;
* ``binding`` names the tensors a capture reads and writes in place (the
  params, the optimizer's moments) by address, and is part of the key of
  a step's ``CaptureCache``: one step keeps captures over several trees
  side by side (the live params, the EMA, the int8 tree), a caller whose
  tensors changed gets a new capture instead of a replay over stale
  buffers, and a capture whose tensors are gone is released. The graph
  records addresses, so nothing here holds the tree: the body takes it as
  arguments on each call;
* the capture runs in CUDA's thread-local capture mode: a thread that
  pins host memory meanwhile (the input prefetcher) is not refused, while
  an unsafe call made by the capturing thread itself still raises.

On the CPU, which the caller must ask for, nothing is captured: ``capture``
warms up and restores the same way and ``run`` calls the body, so the CPU
tests hold the captured body itself against the JAX package and the eager
step.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict

import torch

from ..ops import conv1_core, kernels, pool, quantize

WARMUP = 2  # calls of a body before its capture
# captures one compiled step keeps (least recently used evicted first): a
# capture holds its activations' memory in a private pool (5.17 GiB for the
# full-width train step at batch 8), so a step keeps a few trees and
# keep_prob regimes side by side, not one per tree it ever saw
MAX_CAPTURES = 4

# every counted launch: the hand kernels, and the int8 conv's library route
KERNEL_WRAPPERS = (pool.maxpool2x2_nhwc, pool.maxpool2x2_code_nhwc, pool.maxpool2x2_bwd_nhwc,
                   kernels.ce_sum_per_sample, kernels.ce_sum_weighted, kernels.ce_grad,
                   kernels.confusion_matrix_accumulate, conv1_core.conv1_core,
                   quantize.conv2d_int8_im2col)


def _launch_counts() -> list[int]:
    return [fn.launches for fn in KERNEL_WRAPPERS]


def tensors_of(tree) -> list[torch.Tensor]:
    """The tensors of a nest of dicts, lists and tuples, in a fixed order
    (dicts by key)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensors_of(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []


def binding(tensors) -> tuple:
    """What a capture over ``tensors`` depends on: each one's address,
    shape, strides and dtype."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for t in tensors)


def signature(tensors) -> tuple:
    """The shapes and dtypes of a call's inputs: a capture is made per
    signature."""
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def static_like(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous buffer on ``device`` with ``t``'s shape and dtype."""
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def fill_scalars(buf: torch.Tensor, values) -> None:
    """Write the floats ``values`` into the 1-D fp32 buffer ``buf``, each
    rounded to fp32 as a float scalar is in a kernel: one non-blocking copy
    from pinned memory on the card. The pinned block comes fresh from
    PyTorch's caching host allocator, which keeps it until the queued copy
    has run, so the next call never overwrites a copy still waiting."""
    host = torch.tensor(values, dtype=torch.float32)
    if buf.device.type == "cuda":
        host = host.pin_memory()
    buf.copy_(host, non_blocking=True)


class FixedGenerators:
    """One generator per draw site on ``device``, kept across calls: a
    CUDA graph replays the generators it captured, so a captured step
    cannot draw from fresh ones as the eager step does. ``reseed(seed_of)``
    seeds every site's generator with ``seed_of(site)`` (at offset 0, as a
    fresh generator starts), and a site met later is seeded the same way;
    so each site draws what a fresh generator with that seed would. A site
    first met while a graph captures raises: the warm-up meets every site
    first."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._gens: dict = {}
        self._seed_of = None

    def reseed(self, seed_of) -> None:
        self._seed_of = seed_of
        for site, gen in self._gens.items():
            gen.manual_seed(seed_of(site))

    def get(self, site) -> torch.Generator:
        gen = self._gens.get(site)
        if gen is None:
            if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"draw site {site!r} first met while capturing")
            gen = torch.Generator(device=self.device).manual_seed(self._seed_of(site))
            self._gens[site] = gen
        return gen

    def all(self) -> list:
        return list(self._gens.values())


class Captured:
    """One captured call of a step body: ``run(*args)`` replays the graph
    (on the CPU, calls the body on ``args``) and returns its outputs, which
    on the card are the static tensors the capture returned: the next
    ``run`` writes them again. A replay reads the tensors the capture was
    made over by address: the caller passes the same ones again."""

    def __init__(self, body, graph, outputs, launches):
        self.body, self.graph, self.outputs, self.launches = body, graph, outputs, launches

    def run(self, *args):
        if self.graph is None:
            return self.body(*args)
        self.graph.replay()
        for fn, n in zip(KERNEL_WRAPPERS, self.launches):
            fn.launches += n
        return self.outputs

    def release(self) -> None:
        """Drop the graph (its private pool goes once nothing else holds
        it), the body and the outputs."""
        if self.graph is not None:
            self.graph.reset()
        self.body = self.graph = self.outputs = None


class CaptureEntry:
    """A capture with its static input buffers (``statics``), the eval
    step's accumulators (``acc``) and weak references to the tensors it
    was made over (``bound``): ``alive()`` is False once one of them is
    gone, and then no caller can pass them again."""

    def __init__(self, captured: Captured, statics: list, bound, acc: dict | None = None):
        self.captured, self.statics, self.acc = captured, statics, acc
        self._refs = [weakref.ref(t) for t in bound]

    def alive(self) -> bool:
        return all(r() is not None for r in self._refs)

    def release(self) -> None:
        self.captured.release()
        self.statics = self.acc = None
        self._refs = []


class CaptureCache:
    """A compiled step's captures by key (the bound tensors' ``binding``,
    the inputs' ``signature`` and what else the body bakes in), the least
    recently used evicted beyond ``limit``. An evicted entry, and one
    whose bound tensors are gone (``purge``, run at every ``lookup``), is
    released: its graph, its static buffers and its accumulators go with
    it. ``made`` counts the captures made."""

    def __init__(self, limit: int = MAX_CAPTURES):
        self.limit = limit
        self.made = 0
        self._entries: OrderedDict = OrderedDict()

    def lookup(self, key) -> CaptureEntry | None:
        self.purge()
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._entries[key] = entry  # the most recently used
        return entry

    def add(self, key, entry: CaptureEntry) -> CaptureEntry:
        while len(self._entries) >= self.limit:
            self._entries.popitem(last=False)[1].release()
        self._entries[key] = entry
        self.made += 1
        return entry

    def purge(self) -> None:
        for key in [k for k, e in self._entries.items() if not e.alive()]:
            self._entries.pop(key).release()

    def clear(self) -> None:
        while self._entries:
            self._entries.popitem()[1].release()

    def values(self) -> list:
        return list(self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)


@torch.no_grad()
def _put_back(tensors, saved) -> None:
    for t, s in zip(tensors, saved):
        t.copy_(s)


def capture(body, device: torch.device, *, args=(), restore=(),
            generators: FixedGenerators | None = None) -> Captured:
    """Warm ``body(*args)`` up ``WARMUP`` times (on a side stream on the
    card), put the tensors of ``restore`` (those the body writes in place)
    back as they were before it, then capture one call into a CUDA graph,
    in thread-local capture mode, with the generators of ``generators``
    registered (first met in the warm-up). The capture records the body's
    kernel launches without running them: the counters are set back, and
    ``Captured.run`` adds them per replay. On the CPU the warm-up and the
    restore run the same way and nothing is captured."""
    saved = [t.detach().clone() for t in restore]
    if device.type != "cuda":
        for _ in range(WARMUP):
            body(*args)
        _put_back(restore, saved)
        return Captured(body, None, None, [0] * len(KERNEL_WRAPPERS))
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            body(*args)
    current.wait_stream(side)
    _put_back(restore, saved)
    del saved
    graph = torch.cuda.CUDAGraph()
    if generators is not None:
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(f"torch {torch.__version__} cannot register a generator with a "
                               "CUDA graph (CUDAGraph.register_generator_state)")
        for gen in generators.all():
            graph.register_generator_state(gen)
    before = _launch_counts()
    try:
        with torch.cuda.device(device), torch.cuda.graph(graph,
                                                         capture_error_mode="thread_local"):
            outputs = body(*args)
    finally:
        recorded = [a - b for a, b in zip(_launch_counts(), before)]
        for fn, n in zip(KERNEL_WRAPPERS, before):
            fn.launches = n
    return Captured(body, graph, outputs, recorded)
