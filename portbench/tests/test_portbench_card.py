"""The cells at their own sizes on the card: a short run of each comes out
correct, the same run with the timed path broken underneath does not, and
each cell's control (the step below bf16) fails its check. Marked ``cuda``:
they skip without a card. On the card:

    python -m pytest portbench/tests -m cuda
"""

from __future__ import annotations

import time

import pytest

from portbench import harness
from portbench.drivers import train as train_driver
from portbench.reference import compare
from portbench.tests.tiny import cell_of
from portbench.traffic import scenes

pytestmark = pytest.mark.cuda

ONE_CARD = ("fcn8s.train.b8", "fcn8s.serve.poisson", "fcn32s.predict.full")


def _run(cell: str, seed: int):
    ctx = harness.Context(cell=cell_of(cell), seed=seed, seconds=2.0, trace=False,
                          t0=time.perf_counter())
    return harness.driver(ctx.cell.traffic["kind"]).run(ctx)


def _fits(card, cell: str) -> None:
    import torch

    if torch.cuda.device_count() < cell_of(cell).chips:
        pytest.skip(f"{cell} needs {cell_of(cell).chips} cards")


@pytest.mark.parametrize("cell", ONE_CARD + ("fcn8s.train.dp4",))
def test_a_short_run_is_correct(card, cell):
    _fits(card, cell)
    result = _run(cell, 2**31 + 101)
    assert result.correct, result.checks


@pytest.mark.parametrize("cell, fault", [
    ("fcn8s.train.b8", "half_batch"),
    ("fcn8s.train.b8", "unchanged_state"),
    ("fcn8s.train.dp4", "exchange_left_out"),
    ("fcn8s.serve.poisson", "altered_answers"),
    ("fcn32s.predict.full", "altered_answers"),
])
def test_a_fault_underneath_is_not_correct(card, cell, fault, monkeypatch):
    from portbench.tests.test_portbench_drivers import _plant

    _fits(card, cell)
    _plant(fault, monkeypatch)
    assert not _run(cell, 2**31 + 102).correct


@pytest.mark.parametrize("cell", ("fcn8s.train.b8", "fcn8s.train.dp4"))
def test_the_fp8_control_fails_the_training_check(card, cell):
    """The plain reference in fp8 put in the program's place, at the
    cell's own sizes."""
    c = cell_of(cell)
    n, (h, w) = c.traffic["batch"], c.traffic["image_hw"]
    seed = 2**31 + 103
    data = [scenes.batch(seed, scenes.TRAIN_STREAM, k, n, h, w) for k in range(3)]
    ref = train_driver.reference_readings(c.config, seed, data, "cuda", None)
    fp8 = train_driver.reference_readings(c.config, seed, data, "cuda", None, precision="fp8")
    checks = train_driver.checks(fp8, ref, c.limits)
    assert any(value > limit for _, value, limit in checks), checks


@pytest.mark.parametrize("cell", ("fcn8s.serve.poisson", "fcn32s.predict.full"))
def test_the_int8_control_fails_the_answer_check(card, cell):
    """The program's own int8 path (``quantized=True``) on the cell's batch
    and frame size, against the plain reference."""
    import numpy as np

    from portbench import system, weights
    from portbench.reference import fcn

    c = cell_of(cell)
    hw, seed = c.traffic["image_hw"], 2**31 + 104
    n = c.traffic.get("batch", c.traffic.get("max_batch"))
    images, _ = scenes.batch(seed, scenes.PREDICT_STREAM, 0, n, *hw)
    model = system.model(c.config, seed, "cuda")
    ids = model.predict(images, argmax=True, quantized=True)
    del model
    system.free("cuda")
    tree = weights.make_tree(c.config, seed, "cuda")
    with fcn.exact_fp32():
        found = compare.answer_gaps((fcn.logits(tree, images[i], c.config), ids[i])
                                    for i in range(n))
    checks = harness.checks(found, c.limits)
    assert any(value > limit for _, value, limit in checks), checks
    assert np.asarray(ids).shape == (n, *hw)
