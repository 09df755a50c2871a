"""Every cell's set-up and a one-second window on the CPU at a tiny width,
through the same drivers; the faults that each cell's check must catch;
the result line and the command's refusal without a card."""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import harness
from portbench.tests.tiny import SHAPES, cell_of, dry_run

ROOT = str(harness.root())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_dry_run(cell, trace):
    result = dry_run(cell, trace=trace)
    c = cell_of(cell)
    assert set(result.end_to_end) == {m["name"] for m in c.end_to_end}
    assert all(v > 0 and math.isfinite(v) for v in result.end_to_end.values())
    assert result.attempted > 0 and result.failed == 0
    assert result.checks and all(math.isfinite(v) for _, v, _ in result.checks)
    line = json.loads(json.dumps(harness.line(c, result, trace, {}, {"platform": "cpu"})))
    assert list(line)[-1] == "checks"
    if trace:
        assert result.trace["window_s"] > 0
        read = {m["name"]: harness.reader(m["name"]).read(
            {"trace": result.trace, "counters": result.counters, "device_name": "cpu"})
            for m in c.per_layer}
        # no card: nothing of the device is read, and no share of an unknown peak
        for name, value in read.items():
            if name.startswith(("device_idle", "mfu", "kernels_roofline")):
                assert value is None, name
            else:
                assert value is not None and value > 0, name


def half_batch(setattr_):
    """Half of each train batch left out: its sample mask zeroed, so the
    step's mean runs over the rest (on a mesh, half of each rank's rows)."""
    from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s

    inner = FCN8s._train_call

    def half(self, state, batch, *args, **kwargs):
        images, labels, mask = batch
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = 0.0
        return inner(self, state, (images, labels, mask), *args, **kwargs)

    setattr_(FCN8s, "_train_call", half)


def unchanged_state(setattr_):
    """A step that returns its state unchanged: the optimizer does nothing."""
    from fcn8s_tensorflow_tpu_torch.parallel.steps import Optimizer

    setattr_(Optimizer, "update", lambda self, *args, **kwargs: None)


def exchange_left_out(setattr_):
    """The gradients' sum across the cards left out: each rank steps on its
    own rows' gradient."""
    from fcn8s_tensorflow_tpu_torch.parallel import steps

    setattr_(steps, "all_reduce_flat", lambda grads, mesh, axes: grads)


def altered_answers(setattr_):
    """Answers altered where they are produced: the top rows of every id
    map moved to the next class."""
    from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s

    inner = FCN8s.predict

    def altered(self, images, *args, **kwargs):
        out = np.array(inner(self, images, *args, **kwargs))
        rows = out.shape[1] // 4
        out[:, :rows] = (out[:, :rows] + 1) % self.num_classes
        return out

    setattr_(FCN8s, "predict", altered)


FAULTS = {f.__name__: f for f in (half_batch, unchanged_state, exchange_left_out,
                                   altered_answers)}


def _plant(name, monkeypatch):
    """The fault in this process and in every rank this process starts."""
    from portbench import ranks

    FAULTS[name](monkeypatch.setattr)
    code = ("import sys\n"
            "from portbench.tests.test_portbench_drivers import FAULTS\n"
            f"FAULTS[{name!r}](setattr)\n"
            "from portbench import ranks\n"
            "sys.exit(ranks.main(sys.argv[1:]))\n")
    inner = ranks.spawn
    monkeypatch.setattr(ranks, "spawn", lambda ctx, init, _=None: inner(ctx, init, code))


@pytest.mark.parametrize("cell, fault", [
    ("fcn8s.train.b8", "half_batch"),
    ("fcn8s.train.b8", "unchanged_state"),
    ("fcn8s.train.dp4", "half_batch"),
    ("fcn8s.train.dp4", "unchanged_state"),
    ("fcn8s.train.dp4", "exchange_left_out"),
    ("fcn8s.serve.poisson", "altered_answers"),
    ("fcn32s.predict.full", "altered_answers"),
])
def test_a_fault_underneath_comes_out_not_correct(cell, fault, monkeypatch):
    sound = {name: value for name, value, _ in dry_run(cell).checks}
    _plant(fault, monkeypatch)
    broken = dry_run(cell)
    assert not broken.correct
    worst = max(value / max(sound[name], 1e-12) for name, value, _ in broken.checks)
    assert worst > 3.0, (sound, broken.checks)
    limits = cell_of(cell).limits
    assert any(value > limits[name] for name, value, _ in broken.checks)


def test_parse_result_takes_the_last_line():
    good = {"correct": True, "attempted": 3, "failed": 0,
            "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
            "device": {"platform": "gpu"}, "checks": {}}
    assert harness.parse_result("noise\n" + json.dumps(good) + "\n") == good
    with pytest.raises(ValueError):
        harness.parse_result(json.dumps({"correct": True}))
    with pytest.raises(ValueError):
        harness.parse_result("")


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "fcn8s.train.b8", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_command_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run ends non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "fcn8s.train.b8", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout == ""
