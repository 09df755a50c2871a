"""PyTorch port, the tutorial notebook
(``fcn8s_tensorflow_tpu_torch/examples/fcn8s_tutorial.ipynb``) against the
JAX package's ``examples/fcn8s_tutorial.ipynb`` on the CPU:

* the same 13 cells in the same order (markdown and code), the port's
  settings cell adding ``DEVICE = "cuda"``, no JAX anywhere in its code;
* its code cells run in order (``examples.run_notebook``) with
  ``DEVICE="cpu"``, a narrow model and a short schedule: training saves a
  checkpoint, ``evaluate`` returns the three metrics, and the four panels
  form one uint8 image;
* its synthetic batches (train and eval) are the JAX notebook's, byte for
  byte, read from the namespaces of both notebooks' first two code cells.
"""

import ast
import functools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.examples import NOTEBOOK, run_notebook  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NOTEBOOK = os.path.join(REPO, "examples", "fcn8s_tutorial.ipynb")
RESOLUTION = (64, 128)


def _cells(path):
    with open(path) as f:
        return json.load(f)["cells"]


def test_the_same_cells_in_the_same_order():
    port, ref = _cells(NOTEBOOK), _cells(JAX_NOTEBOOK)
    assert len(port) == len(ref) == 13
    assert [c["cell_type"] for c in port] == [c["cell_type"] for c in ref]
    first = "".join(next(c for c in port if c["cell_type"] == "code")["source"])
    assert 'DEVICE = "cuda"' in first
    model_cell = "".join(port[5]["source"])
    assert "FCN8s(num_classes=num_classes, device=DEVICE)" in model_cell


def test_notebook_code_imports_no_jax():
    for cell in _cells(NOTEBOOK):
        if cell["cell_type"] != "code":
            continue
        for node in ast.walk(ast.parse("".join(cell["source"]))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) else [])
            assert not [n for n in names if n.split(".")[0] in ("jax", "fcn8s_tensorflow_tpu",
                                                                "matplotlib")], names


def test_notebook_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.chdir(tmp_path)
    ns = run_notebook(overrides=dict(
        DEVICE="cpu", RESOLUTION=RESOLUTION, EPOCHS=2, STEPS_PER_EPOCH=2,
        FCN8s=functools.partial(FCN8s, width_mult=1 / 32, fc_channels=32)))
    assert ns["model"].device == torch.device("cpu") and ns["model"].state.step == 4
    assert set(ns["metrics"]) == {"loss", "mean_iou", "accuracy"}
    assert all(np.isfinite(float(v)) for v in ns["metrics"].values())
    assert os.listdir(tmp_path / "checkpoints")  # save_best_only kept one
    h, w = RESOLUTION
    assert ns["grid"].shape == (2 * h, 2 * w, 3) and ns["grid"].dtype == np.uint8
    np.testing.assert_array_equal(ns["grid"][:h, :w], ns["images"][0])
    assert ns["pred"].shape == (ns["images"].shape[0], h, w)


def _data_cells(path, **overrides) -> dict:
    """The namespace of a notebook's settings and data cells (its first two
    code cells), ``overrides`` set between them."""
    code = [c for c in _cells(path) if c["cell_type"] == "code"]
    ns = {"__name__": "__main__"}
    exec("".join(code[0]["source"]), ns)
    ns.update(overrides)
    exec("".join(code[1]["source"]), ns)
    return ns


def test_synthetic_batches_equal_the_jax_notebooks(monkeypatch):
    overrides = dict(DEVICE="cpu", RESOLUTION=RESOLUTION)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the notebooks prepend to it
    port = _data_cells(NOTEBOOK, **overrides)
    monkeypatch.chdir(os.path.join(REPO, "examples"))  # the JAX notebook's own directory
    ref = _data_cells(JAX_NOTEBOOK, **overrides)
    assert port["num_classes"] == ref["num_classes"] and port["val_steps"] == ref["val_steps"]
    pairs = list(zip(port["eval_set"], ref["eval_set"]))
    pairs += [(next(port["train_it"]), next(ref["train_it"])) for _ in range(2)]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
