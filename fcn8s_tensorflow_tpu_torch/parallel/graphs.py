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
  replay, so the counters keep counting launches; so too the calls that
  ``SHAPE_COUNTERS`` count by shape (``nn.attention.calls``);
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

On a mesh of more than one position a step's body issues collectives
(``parallel/collectives.py``: the gradient and metric sums, the gathers of
predict, the Megatron pair, the halo exchange), and a collective over gloo
stages through the host and cannot sit inside a graph. A capture on the
card is a ``Segments``, an ordered plan of graphs that share one private
pool (one graph off a mesh), and ``capture(..., segmented=True)`` cuts the
body at the collectives: each sits between two graphs on the buffers the
capture recorded, and a replay runs graph, collective, graph. A backward's collectives run on autograd's
thread, while a capture must begin and end on the thread that began it: the
body computes its gradients through ``collectives.grad``, which runs the
backward on a thread of its own and leaves the capturing thread to cut at
each collective that the backward hands it (``_Segmenter``). The warm-up,
the restore and the generators hold for every segment, a segment that fails
to capture raises, and ``halo_exchange.bytes`` (a host counter bumped as
the exchange is recorded) is added per replay like the launch counts.

On the CPU, which the caller must ask for, nothing is captured: ``capture``
warms up and restores the same way and ``run`` calls the body, so the CPU
tests hold the captured body itself against the JAX package and the eager
step. A segmented body runs there under the same ``_Segmenter`` with no
graph: its collectives run in the plan's order at the same cut points, the
backward's handed over from its own thread, so the CPU tests exercise the
cuts and the hand-over themselves.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import weakref
from collections import OrderedDict

import torch

from ..ops import conv1_core, kernels, nn, pool, quantize
from ..utils.profiling import annotate
from . import collectives

WARMUP = 2  # calls of a body before its capture
# captures one compiled step keeps (least recently used evicted first): a
# capture holds its activations' memory in a private pool (5.17 GiB for the
# full-width train step at batch 8), so a step keeps a few trees and
# keep_prob regimes side by side, not one per tree it ever saw
MAX_CAPTURES = 4

# every counted launch: the hand kernels, the int8 conv's library route and
# fc6's GEMM route
KERNEL_WRAPPERS = (pool.maxpool2x2_nhwc, pool.maxpool2x2_code_nhwc, pool.maxpool2x2_bwd_nhwc,
                   kernels.ce_sum_per_sample, kernels.ce_sum_weighted, kernels.ce_grad,
                   kernels.confusion_matrix_accumulate, conv1_core.conv1_core,
                   quantize.conv2d_int8_im2col, nn.conv2d_im2col)


# calls counted by shape (``collections.Counter``), added per replay like
# the launches
SHAPE_COUNTERS = (nn.attention.calls,)


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
    rank, shape, strides and dtype, in one flat tuple. Flat, because a key
    is built at every call: a tuple a tensor would keep thousands of
    containers alive while it is built (a tree of ~1,000 leaves with its
    two moments), and so set off the cyclic collector at every step."""
    return tuple(x for t in tensors
                 for x in (t.data_ptr(), t.dim(), *t.shape, *t.stride(), t.dtype))


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


class Segments:
    """A body captured as CUDA graphs cut at its collectives: ``graphs[0]``,
    then ``collectives[0]``, then ``graphs[1]``, and so on, one graph more
    than collectives. The graphs share one private pool, so a tensor made
    in one segment and read in a later one keeps its address, and each
    ``collectives.Collective`` holds the buffers it reads and writes."""

    def __init__(self):
        self.graphs, self.collectives = [], []

    def replay(self) -> None:
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < len(self.collectives):
                self.collectives[i].run()

    def reset(self) -> None:
        for graph in self.graphs:
            graph.reset()
        self.graphs, self.collectives = [], []


class _Segmenter:
    """The cuts of one segmented call (``collectives.segmenter`` while it
    runs). With ``plan`` (a capture on the card) a collective ends the graph
    being captured, joins the plan and begins the next graph; with no plan
    (the CPU) it runs where it stands. Either way ``issued`` lists each
    collective's ``describe()`` in order. Only the thread that runs the body
    (``owner``) cuts: ``grad`` runs the backward on a thread of its own, and
    a collective reached there (on autograd's thread) is handed to the owner,
    which cuts and lets the backward go on."""

    def __init__(self, plan: Segments | None = None, generators=(), pool=None):
        self.plan, self.generators, self.pool = plan, list(generators), pool
        self.issued: list = []
        self.owner = threading.get_ident()
        self.current = None  # the graph being captured
        self._requests = None  # a queue while a backward runs

    def begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.current = graph

    def end(self) -> None:
        graph, self.current = self.current, None
        graph.capture_end()
        self.plan.graphs.append(graph)

    def cut(self, collective) -> None:
        if threading.get_ident() != self.owner:
            self._hand_over(collective)
            return
        self.issued.append(collective.describe())
        if self.plan is None:
            collective.run()
            return
        self.end()
        self.plan.collectives.append(collective)
        self.begin()

    def _hand_over(self, collective) -> None:
        if self._requests is None:
            raise RuntimeError("a collective reached from another thread outside a backward "
                               "of the segmented step")
        done, reply = threading.Event(), {}
        self._requests.put((collective, done, reply))
        done.wait()
        if "error" in reply:
            raise RuntimeError("the capturing thread failed to cut at a collective of the "
                               "backward") from reply["error"]

    def grad(self, outputs, inputs) -> tuple:
        """``torch.autograd.grad`` on a thread of its own (on the capture's
        stream, with this thread's intra-op thread count), this thread
        cutting at each collective that the backward hands over."""
        threads = torch.get_num_threads()
        stream = torch.cuda.current_stream() if self.plan is not None else None
        self._requests = requests = queue.Queue()
        box = {}

        def work():
            try:
                torch.set_num_threads(threads)
                with torch.cuda.stream(stream) if stream is not None else \
                        contextlib.nullcontext():
                    box["grads"] = torch.autograd.grad(outputs, inputs)
            except BaseException as exc:  # raised again on the owner
                box["error"] = exc
            finally:
                requests.put(None)

        worker = threading.Thread(target=work, name="segmented-backward", daemon=True)
        worker.start()
        try:
            while (request := requests.get()) is not None:
                collective, done, reply = request
                try:
                    self.cut(collective)
                except BaseException as exc:
                    reply["error"] = exc
                    box.setdefault("cut_error", exc)
                finally:
                    done.set()
        finally:
            worker.join()
            self._requests = None
        if "cut_error" in box:
            raise box["cut_error"]
        if "error" in box:
            raise box["error"]
        return box["grads"]


@contextlib.contextmanager
def _segmenting(segmenter: _Segmenter):
    collectives.segmenter = segmenter
    try:
        yield segmenter
    finally:
        collectives.segmenter = None


class Captured:
    """One captured call of a step body: ``run(*args)`` replays the graph
    (on the CPU, calls the body on ``args``) and returns its outputs, which
    on the card are the static tensors the capture returned: the next
    ``run`` writes them again. A replay reads the tensors the capture was
    made over by address: the caller passes the same ones again.

    On the card ``graph`` is the capture's ``Segments``; ``issued`` lists the
    collectives of its plan (``Collective.describe``), from the capture on
    the card and from the last run on the CPU, where ``run`` calls the body
    under a ``_Segmenter`` with no graph; ``halo_bytes`` is what one call
    adds to ``halo_exchange.bytes``. ``replays`` counts the calls of
    ``run``, each the span ``fcn8s.step.replay`` under a profiler."""

    def __init__(self, body, graph, outputs, launches, *, segmented: bool = False,
                 halo_bytes: int = 0, issued=(), shapes=()):
        self.body, self.graph, self.outputs, self.launches = body, graph, outputs, launches
        self.shapes = list(shapes)  # per SHAPE_COUNTERS: what one replay counts
        self.segmented, self.halo_bytes, self.issued = segmented, halo_bytes, list(issued)
        self.replays = 0

    @property
    def segments(self) -> int:
        """The graphs a replay runs: one more than its collectives."""
        return len(self.issued) + 1

    def run(self, *args):
        self.replays += 1
        with annotate("fcn8s.step.replay"):
            if self.graph is None:
                if not self.segmented:
                    return self.body(*args)
                with _segmenting(_Segmenter()) as cuts:
                    out = self.body(*args)
                self.issued = cuts.issued
                return out
            self.graph.replay()
        for fn, n in zip(KERNEL_WRAPPERS, self.launches):
            fn.launches += n
        for counter, recorded in zip(SHAPE_COUNTERS, self.shapes):
            counter.update(recorded)
        collectives.halo_exchange.bytes += self.halo_bytes
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


def _drop_blas_workspaces() -> None:
    """Free the cuBLAS workspaces PyTorch keeps, one for every stream a
    matrix product ran on. A capture warms up and records on side streams of
    its own, so without this each capture would leave workspaces behind for
    good, the recording's inside the graph's pool. Dropped before the
    warm-up and after the recording, as ``torch.compile``'s graphs do: the
    graph keeps its workspace's memory in its pool, and a later product
    outside it takes a workspace anew."""
    torch._C._cuda_clearCublasWorkspaces()


@torch.no_grad()
def _put_back(tensors, saved) -> None:
    for t, s in zip(tensors, saved):
        t.copy_(s)


def capture(body, device: torch.device, *, args=(), restore=(),
            generators: FixedGenerators | None = None, segmented: bool = False) -> Captured:
    """Warm ``body(*args)`` up ``WARMUP`` times (on a side stream on the
    card), put the tensors of ``restore`` (those the body writes in place)
    back as they were before it, then capture one call into a CUDA graph,
    in thread-local capture mode, with the generators of ``generators``
    registered (first met in the warm-up), as the one graph of a
    ``Segments``. The capture records the body's kernel launches without
    running them: the counters are set back, and ``Captured.run`` adds them
    per replay. ``segmented``: the body issues collectives, and the capture
    is cut at each. On the CPU the warm-up and the restore run the same way
    and nothing is captured."""
    saved = [t.detach().clone() for t in restore]
    if device.type != "cuda":
        for _ in range(WARMUP):
            body(*args)
        _put_back(restore, saved)
        return Captured(body, None, None, [0] * len(KERNEL_WRAPPERS), segmented=segmented)
    _drop_blas_workspaces()
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            body(*args)
    current.wait_stream(side)
    _put_back(restore, saved)
    del saved
    if generators is not None and not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        raise RuntimeError(f"torch {torch.__version__} cannot register a generator with a "
                           "CUDA graph (CUDAGraph.register_generator_state)")
    gens = generators.all() if generators is not None else []
    before, halo = _launch_counts(), collectives.halo_exchange.bytes
    shapes_before = [counter.copy() for counter in SHAPE_COUNTERS]
    try:
        graph, outputs, issued = _capture_segments(body, args, device, gens, segmented)
    finally:
        _drop_blas_workspaces()
        recorded = [a - b for a, b in zip(_launch_counts(), before)]
        for fn, n in zip(KERNEL_WRAPPERS, before):
            fn.launches = n
        shapes = [counter - b for counter, b in zip(SHAPE_COUNTERS, shapes_before)]
        for counter, b in zip(SHAPE_COUNTERS, shapes_before):
            counter.clear()
            counter.update(b)
        halo_bytes = collectives.halo_exchange.bytes - halo
        collectives.halo_exchange.bytes = halo
    return Captured(body, graph, outputs, recorded, segmented=segmented, halo_bytes=halo_bytes,
                    issued=issued, shapes=shapes)


def _capture_segments(body, args, device: torch.device, generators: list, cut: bool):
    """``body(*args)`` captured as ``Segments`` on a side stream of
    ``device``: the first graph begins here, and with ``cut`` each
    collective the body issues (or its backward hands over) ends one and
    begins the next (without, the plan is one graph); the last ends here.
    Every graph registers ``generators`` and draws from one new private
    pool. A failure ends the open capture, releases the graphs made so far
    and raises."""
    plan = Segments()
    cuts = _Segmenter(plan, generators, torch.cuda.graph_pool_handle())
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.device(device), torch.cuda.stream(stream), \
                _segmenting(cuts) if cut else contextlib.nullcontext():
            cuts.begin()
            try:
                outputs = body(*args)
            except BaseException:
                if cuts.current is not None:
                    with contextlib.suppress(Exception):
                        cuts.current.capture_end()
                    cuts.current = None
                raise
            cuts.end()
    except BaseException:
        plan.reset()
        raise
    torch.cuda.current_stream(device).wait_stream(stream)
    return plan, outputs, cuts.issued
