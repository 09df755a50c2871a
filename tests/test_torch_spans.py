"""PyTorch port, its spans (``utils/profiling.annotate``) on the CPU.

Under a profiler the facade's ``predict`` and ``train`` name their host
phases (``fcn8s.predict.*``, ``fcn8s.train.*``), the compiled steps their
copy-in, replay and capture (``fcn8s.step.*``), the mesh its collectives
(``fcn8s.mesh.*``) and the input prefetcher its pinned staging on its own
thread; each child opens and closes inside its parent on the same thread.
Without a profiler ``annotate`` returns one shared no-op context and makes
no ``record_function`` call. ``span_table`` puts the card's idle time of a
trace under the innermost span open over it and times the collectives'
exposed device work: held here on hand-made events.

A narrow fp32 model (``width_mult=1/32, fc_channels=32``) on 64x96 inputs,
as in ``test_torch_compiled_facade.py``.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import collectives  # noqa: E402
from fcn8s_tensorflow_tpu_torch.utils import profiling  # noqa: E402
from fcn8s_tensorflow_tpu_torch.utils.profiling import annotate, span_table  # noqa: E402

C = 5
HW = (64, 96)
SMALL = dict(width_mult=1 / 32, fc_channels=32, compute_dtype=torch.float32, device="cpu")
PREDICT = ("prepare", "h2d", "step", "d2h", "widen")
TRAIN = ("start", "next_batch", "step", "readback", "end")


def _model():
    return FCN8s(num_classes=C, seed=0, **SMALL)


def _images(seed=0, n=2):
    return np.random.default_rng(seed).integers(0, 256, (n, *HW, 3), dtype=np.uint8)


def _gen(seed=1, n=2):
    rng = np.random.default_rng(seed)
    while True:
        yield (rng.integers(0, 256, (n, *HW, 3), dtype=np.uint8),
               rng.integers(0, C, (n, *HW), dtype=np.uint8))


def _train(model, steps=2, prefetch=0):
    model.train(_gen(), epochs=1, steps_per_epoch=steps, learning_rate_schedule=lambda s: 1e-4,
                record_summaries=False, prefetch=prefetch)


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith("fcn8s.")]


def _inside(child, spans, parent: str) -> bool:
    """``child`` opens and closes inside a span named ``parent`` on its
    thread."""
    return any(p.name == parent and p.thread == child.thread
               and p.time_range.start <= child.time_range.start
               and child.time_range.end <= p.time_range.end for p in spans)


def _names(spans) -> list:
    return [e.name for e in spans]


def test_predict_emits_its_phases_inside_its_span():
    model = _model()
    spans = _profiled(lambda: model.predict(_images()))
    names = _names(spans)
    assert names.count("fcn8s.predict") == 1
    for phase in PREDICT:
        child = [e for e in spans if e.name == f"fcn8s.predict.{phase}"]
        assert len(child) == 1, phase
        assert _inside(child[0], spans, "fcn8s.predict"), phase
    for name in ("fcn8s.step.capture", "fcn8s.step.copy_in", "fcn8s.step.replay"):
        (span,) = [e for e in spans if e.name == name]
        assert _inside(span, spans, "fcn8s.predict.step"), name
    assert len({e.thread for e in spans}) == 1


def test_train_emits_its_phases_inside_its_span():
    model = _model()
    spans = _profiled(lambda: _train(model, steps=3))
    names = _names(spans)
    assert names.count("fcn8s.train") == 1
    counts = {"start": 1, "next_batch": 3, "step": 3, "readback": 1, "end": 1}
    for phase in TRAIN:
        child = [e for e in spans if e.name == f"fcn8s.train.{phase}"]
        assert len(child) == counts[phase], phase
        assert all(_inside(e, spans, "fcn8s.train") for e in child), phase
    for name in ("fcn8s.step.copy_in", "fcn8s.step.replay"):
        inner = [e for e in spans if e.name == name]
        assert len(inner) == 3 and all(_inside(e, spans, "fcn8s.train.step") for e in inner)
    # the phases follow one another in the call's order
    starts = {p: min(e.time_range.start for e in spans if e.name == f"fcn8s.train.{p}")
              for p in TRAIN}
    assert sorted(starts, key=starts.get) == list(TRAIN)


@pytest.mark.parametrize("call", ["predict", "train"])
def test_capture_is_a_span_of_the_first_call_only(call):
    model = _model()
    run = (lambda: model.predict(_images())) if call == "predict" else (lambda: _train(model, 1))
    first, second = _profiled(run), _profiled(run)
    assert _names(first).count("fcn8s.step.capture") == 1
    assert "fcn8s.step.capture" not in _names(second)
    assert _names(second).count("fcn8s.step.replay") == 1
    assert sum(model.capture_counts().values()) == 1


def test_tiled_and_tta_name_the_same_phases():
    model = _model()
    tiled = _names(_profiled(lambda: model.predict(_images(), tile=(32, 64), tile_overlap=0)))
    assert tiled.count("fcn8s.predict") == 1
    assert {f"fcn8s.predict.{p}" for p in PREDICT} <= set(tiled)
    tta = _profiled(lambda: model.predict_tta(_images(), scales=(1.0, 0.5)))
    assert _names(tta).count("fcn8s.predict_tta") == 1
    assert _names(tta).count("fcn8s.predict.step") == 2
    for phase in ("prepare", "h2d", "step", "d2h"):
        assert all(_inside(e, tta, "fcn8s.predict_tta")
                   for e in tta if e.name == f"fcn8s.predict.{phase}"), phase


def test_the_prefetchers_span_runs_on_its_own_thread(tmp_path):
    model = _model()
    with profiling.trace(str(tmp_path)) as prof:
        _train(model, steps=2, prefetch=2)
    spans = [e for e in prof.events() if e.name.startswith("fcn8s.")]
    (call,) = [e for e in spans if e.name == "fcn8s.train"]
    staged = [e for e in spans if e.name == "fcn8s.prefetch.h2d"]
    if profiling._all_threads() is None:
        pytest.skip(f"torch {torch.__version__} traces only the thread that starts the profiler")
    assert staged and all(e.thread != call.thread for e in staged)


def test_a_collective_is_a_mesh_span(monkeypatch):
    calls = []
    monkeypatch.setattr(collectives.dist, "all_reduce",
                        lambda t, op=None, group=None: calls.append("all_reduce"))
    monkeypatch.setattr(collectives.dist, "all_gather",
                        lambda parts, t, group=None: calls.append("all_gather"))
    t = torch.ones(4)
    spans = _profiled(lambda: [
        collectives._issue(collectives.Collective("all_reduce", t, None, op="sum")),
        collectives.Collective("all_gather", t, None, parts=[t]).run()])
    assert calls == ["all_reduce", "all_gather"]
    assert _names(spans) == ["fcn8s.mesh.all_reduce", "fcn8s.mesh.all_gather"]


def test_annotate_without_a_profiler_makes_no_record_function_call(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    first, second = annotate("fcn8s.test"), annotate("fcn8s.test.other")
    assert first is second
    with first, second:
        pass
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("fcn8s.test"):
            pass
    assert made == ["fcn8s.test"]
    assert [e.name for e in prof.events() if e.name == "fcn8s.test"] == ["fcn8s.test"]
    model = _model()
    model.predict(_images())
    _train(model, steps=1)
    assert made == ["fcn8s.test"]  # the facade's spans make none without a profiler


# ----------------------------------------------------------------------
# span_table on hand-made events (microseconds)
# ----------------------------------------------------------------------
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
_ids = iter(range(1, 10_000))


def _ev(name, start, end, device=CPU, thread=1, link=0, note=False):
    return types.SimpleNamespace(name=name, device_type=device, thread=thread, id=next(_ids),
                                 linked_correlation_id=link, is_user_annotation=note,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def _table(events, window=None):
    return span_table(types.SimpleNamespace(events=lambda: events), window)


def test_idle_time_goes_to_the_innermost_span():
    """Window 0-100; device busy 10-20 and 60-90; spans on the call's thread:
    fcn8s.train 5-95 with .start 5-30 and .end 80-95, and .next_batch 30-50
    on it (.step on no thread that opened a call: it cuts nothing)."""
    events = [_ev("portbench.window", 0, 100),
              _ev("fcn8s.train", 5, 95), _ev("fcn8s.train.start", 5, 30),
              _ev("fcn8s.train.next_batch", 30, 50), _ev("fcn8s.train.end", 80, 95),
              _ev("fcn8s.train.step", 50, 60, thread=2),
              _ev("k", 10, 20, CUDA), _ev("k", 60, 90, CUDA),
              _ev("fcn8s.train.start", 12, 14, CUDA, note=True)]  # a span's device copy
    table = _table(events, "portbench.window")
    idle = {name: round(v[2] * 1e6, 6) for name, v in table.items()}
    # idle: 0-10, 20-60, 90-100
    assert idle == {"-": 5 + 5, "fcn8s.train.start": 5 + 10, "fcn8s.train.next_batch": 20,
                    "fcn8s.train": 10, "fcn8s.train.end": 5, "fcn8s.train.step": 0}
    assert sum(idle.values()) == 60
    assert table["fcn8s.train.next_batch"][:2] == [1, 20e-6]
    assert table["fcn8s.train.step"][:2] == [1, 10e-6]


def test_spans_are_clipped_to_the_window_and_none_is_all_idle():
    events = [_ev("w", 10, 50), _ev("fcn8s.predict", 0, 30), _ev("fcn8s.predict.d2h", 20, 40),
              _ev("fcn8s.predict", 60, 70)]
    table = _table(events, "w")
    assert table["fcn8s.predict"][:2] == [1, 20e-6]
    assert round(table["fcn8s.predict"][2] * 1e6, 6) == 10
    assert round(table["fcn8s.predict.d2h"][2] * 1e6, 6) == 20
    assert round(table["-"][2] * 1e6, 6) == 10 and table["-"][0] == 0
    assert _table([_ev("w", 0, 8), _ev("k", 2, 4, CUDA)], "w") == {"-": [0, 0.0, 6e-6, 0.0]}
    with pytest.raises(ValueError):
        _table(events, "nowhere")


def test_exposed_time_leaves_out_what_other_kernels_overlap():
    """Two collectives on the call's thread; the host op inside each
    launched a kernel (linked by id), a runtime call linked too. The first
    kernel, 30-50, is overlapped 40-45 by another kernel; the second, 70-80,
    by none; a kernel launched outside every mesh span counts for none."""
    call = _ev("fcn8s.train", 0, 100)
    mesh1, mesh2 = _ev("fcn8s.mesh.all_reduce", 20, 30), _ev("fcn8s.mesh.all_reduce", 60, 70)
    op1, op2 = _ev("nccl:all_reduce", 21, 29), _ev("nccl:all_reduce", 61, 69)
    launch = _ev("cudaLaunchKernel", 22, 23, link=op1.id)
    other = _ev("aten::add", 35, 36)
    events = [call, mesh1, mesh2, op1, op2, launch, other,
              _ev("nccl", 30, 50, CUDA, link=op1.id), _ev("nccl", 70, 80, CUDA, link=op2.id),
              _ev("add", 40, 45, CUDA, link=other.id), _ev("gather", 85, 90, CUDA, link=launch.id)]
    table = _table(events)
    assert table["fcn8s.mesh.all_reduce"][0] == 2
    assert round(table["fcn8s.mesh.all_reduce"][3] * 1e6, 6) == 15 + 10
    assert table["fcn8s.train"][3] == 0.0


def test_device_busy_leaves_out_the_spans_device_copies():
    events = [_ev("w", 0, 50), _ev("k", 0, 10, CUDA), _ev("fcn8s.train", 20, 30, CUDA, note=True)]
    busy = profiling.device_busy(types.SimpleNamespace(events=lambda: events))
    assert busy["busy_us"] == 10 and busy["device_events"] == 1


def test_the_link_is_read_from_the_raw_events_where_the_trace_lacks_it():
    """A torch whose trace events carry no ``linked_correlation_id``: the
    link comes from the profiler's raw events (a kernel by its id on the
    card, a runtime call by its id and name), and the exposed time is the
    same as with the link on the events."""
    def raw(name, corr, link, card):
        return types.SimpleNamespace(
            name=lambda: name, correlation_id=lambda: corr, linked_correlation_id=lambda: link,
            device_type=lambda: CUDA if card else CPU)

    def plain(name, start, end, ident, device=CPU, thread=1):
        return types.SimpleNamespace(name=name, device_type=device, thread=thread, id=ident,
                                     is_user_annotation=False,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    events = [plain("fcn8s.train", 0, 100, 1), plain("fcn8s.mesh.all_reduce", 20, 30, 2),
              plain("nccl:all_reduce", 21, 29, 3), plain("cudaLaunchKernel", 22, 23, 3),
              plain("ncclDevKernel", 30, 50, 3, CUDA), plain("add", 40, 45, 7, CUDA)]
    results = [raw("cudaLaunchKernel", 3, 3, False), raw("ncclDevKernel_mangled", 3, 3, True)]
    prof = types.SimpleNamespace(
        events=lambda: events,
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
            events=lambda: results)))
    table = span_table(prof)
    assert round(table["fcn8s.mesh.all_reduce"][3] * 1e6, 6) == 15
