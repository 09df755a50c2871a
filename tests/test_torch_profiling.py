"""PyTorch port, ``utils/profiling.py`` (the cases of tests/test_profiling.py,
on the port) and ``engine/schedules.py`` (each schedule against the JAX
package's, exactly: the same Python float arithmetic)."""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fcn8s_tensorflow_tpu.engine import schedules as jsched  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine import schedules as tsched  # noqa: E402
from fcn8s_tensorflow_tpu_torch.utils.profiling import (  # noqa: E402
    StepTimer,
    annotate,
    device_busy,
    hard_sync,
    memory_stats,
    trace,
)


def test_step_timer_percentiles():
    timer = StepTimer(warmup=2)
    for i in range(7):
        with timer.step():
            time.sleep(0.01 if i < 5 else 0.03)
    s = timer.summary()
    assert s["steps"] == 5  # warmup excluded
    assert s["p50_ms"] >= 8
    assert s["max_ms"] >= s["p50_ms"]


def test_step_timer_empty():
    assert StepTimer().summary() == {"steps": 0}


def test_step_timer_sync_on():
    timer = StepTimer(warmup=0)
    x = torch.ones((128, 128))
    with timer.step():
        y = x @ x
        timer.sync_on(y)
    assert timer.summary()["steps"] == 1


def test_hard_sync_accepts_trees():
    hard_sync({"a": torch.ones((4, 4)), "b": [torch.zeros(3), np.ones(2)], "c": (1, "x")})


def test_annotate_and_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("test-span"):
            torch.sum(torch.ones((8, 8)))
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert files and all(f.endswith(".json") for f in files)
    with open(os.path.join(tmp_path, files[0])) as f:
        assert "test-span" in f.read()
    busy = device_busy(prof)
    assert busy["window_us"] > 0 and busy["device_events"] == 0 and busy["share"] is None


def test_memory_stats_shape():
    stats = memory_stats("cpu")  # the CPU reports {}, as JAX's CPU backend does
    assert stats == {}
    for v in memory_stats().values():
        assert isinstance(v, (int, float))


SCHEDULES = {
    "piecewise_constant": (("piecewise_constant", ([10, 30], [1e-3, 1e-4, 1e-5])), {}),
    "reference_tutorial": (("reference_tutorial_schedule", ()), {}),
    "constant": (("constant", (3e-4,)), {}),
    "warmup_cosine": (("warmup_cosine", (1e-3, 100)), {"warmup_steps": 10, "final_lr": 1e-6}),
    "exponential_decay": (("exponential_decay", (1e-3, 7, 0.5)), {}),
    "exponential_staircase": (("exponential_decay", (1e-3, 7, 0.5)), {"staircase": True}),
    "polynomial_decay": (("polynomial_decay", (1e-3, 100)), {"power": 0.9, "warmup_steps": 5,
                                                              "end_lr": 1e-5}),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_matches_jax(case):
    (name, args), kw = SCHEDULES[case]
    got, want = getattr(tsched, name)(*args, **kw), getattr(jsched, name)(*args, **kw)
    steps = list(range(0, 120)) + [10000, 19999, 20000, 40000, 50000]
    assert [got(s) for s in steps] == [want(s) for s in steps]


def test_schedule_validation_matches_jax():
    for fn, args in ((tsched.piecewise_constant, ([1], [1.0])),
                     (tsched.warmup_cosine, (1e-3, 5)),
                     (tsched.polynomial_decay, (1e-3, 5))):
        kw = {} if fn is tsched.piecewise_constant else {"warmup_steps": 5}
        with pytest.raises(ValueError):
            fn(*args, **kw)
