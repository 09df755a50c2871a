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
  params, the optimizer's moments) by address: a caller whose tensors
  changed gets a new capture instead of a replay over stale buffers.

On the CPU, which the caller must ask for, nothing is captured: ``capture``
warms up and restores the same way and ``run`` calls the body, so the CPU
tests hold the captured body itself against the JAX package and the eager
step.
"""

from __future__ import annotations

import torch

from ..ops import conv1_core, kernels, pool, quantize

WARMUP = 2  # calls of a body before its capture

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
    """One captured call of a step body: ``run()`` replays the graph (on
    the CPU, calls the body) and returns its outputs, which on the card
    are the static tensors the capture returned: the next ``run`` writes
    them again."""

    def __init__(self, body, graph, outputs, launches):
        self.body, self.graph, self.outputs, self.launches = body, graph, outputs, launches

    def run(self):
        if self.graph is None:
            return self.body()
        self.graph.replay()
        for fn, n in zip(KERNEL_WRAPPERS, self.launches):
            fn.launches += n
        return self.outputs


@torch.no_grad()
def _put_back(tensors, saved) -> None:
    for t, s in zip(tensors, saved):
        t.copy_(s)


def capture(body, device: torch.device, *, restore=(),
            generators: FixedGenerators | None = None) -> Captured:
    """Warm ``body()`` up ``WARMUP`` times (on a side stream on the card),
    put the tensors of ``restore`` (those the body writes in place) back as
    they were before it, then capture one call into a CUDA graph with the
    generators of ``generators`` registered (first met in the warm-up).
    The capture records the body's kernel launches without running them:
    the counters are set back, and ``Captured.run`` adds them per replay.
    On the CPU the warm-up and the restore run the same way and nothing is
    captured."""
    saved = [t.detach().clone() for t in restore]
    if device.type != "cuda":
        for _ in range(WARMUP):
            body()
        _put_back(restore, saved)
        return Captured(body, None, None, [0] * len(KERNEL_WRAPPERS))
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            body()
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
        with torch.cuda.device(device), torch.cuda.graph(graph):
            outputs = body()
    finally:
        recorded = [a - b for a, b in zip(_launch_counts(), before)]
        for fn, n in zip(KERNEL_WRAPPERS, before):
            fn.launches = n
    return Captured(body, graph, outputs, recorded)
