"""What the command needs besides the drivers: the benchmark's file, a
cell's configuration, traffic and limits found by name, the per-layer
readers, the card's description, and the result line.

Everything a cell needs sits in files named after it, so a cell, a mix or a
metric is added as files and ``BENCHMARK.json`` entries:

* ``portbench/configs/<config>.json``: the configuration as it is run;
* ``portbench/traffic/<traffic>.json``: the mix, whose ``kind`` names the
  driver ``portbench/drivers/<kind>.py`` (a module with ``run(ctx)``);
* ``portbench/checks/<cell>.json``: the limit of each number compared;
* ``portbench/metrics/<metric>.py``: a reader with ``read(run)``, which
  returns the metric's value or None where the run holds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fcn8s_tensorflow_tpu")


def root() -> Path:
    """The checkout the command runs from (it holds ``BENCHMARK.json``)."""
    return PACKAGE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(root() / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    checks = PACKAGE / "checks" / f"{name}.json"
    return Cell(name=name, chips=int(w["chips"]), config=_json(root() / cfg["file"]),
                traffic=_json(PACKAGE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(checks) if checks.exists() else {},
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(metric: str):
    path = PACKAGE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, and the process's
    start on the host clock (``setup_s`` counts from it). ``width`` and
    ``device`` are for the CPU tests only (a narrow model, ``'cpu'``)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: str = "cuda"
    width: dict | None = None
    shape: dict | None = None  # tests: overrides of the mix's sizes

    def mix(self, key: str):
        if self.shape and key in self.shape:
            return self.shape[key]
        return self.cell.traffic[key]


@dataclasses.dataclass
class Result:
    """What a driver returns. ``end_to_end`` holds the cell's end-to-end
    metrics by name; ``counters`` what the readers read; ``checks``
    ``(name, value, limit)`` of each number compared; ``trace`` the traced
    window's summary (``tracing.summarize``)."""

    setup_s: float
    attempted: int
    failed: int
    end_to_end: dict
    counters: dict
    checks: list
    memory_peak_bytes: int
    device_count: int
    trace: dict | None = None
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            limit is not None and value == value and value <= limit
            for _, value, limit in self.checks)


def checks(numbers: dict, limits: dict) -> list:
    """``(name, value, limit)`` of each number that the cell's checks file
    gives a limit (a file that names a number the driver does not read
    raises); with no file yet, every number, without a limit."""
    names = list(limits) if limits else list(numbers)
    return [(name, float(numbers[name]), limits.get(name)) for name in names]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str | None:
    """``nvidia-smi``'s name and power limit of the card(s), or None."""
    smi = shutil.which("nvidia-smi")
    if not smi:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().replace("\n", "; ") or None


def cache_dirs() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, so only the first run of a checkout builds (the port's CUDA
    library already lives in ``build/torch_kernels``)."""
    base = root() / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)


def line(cell: Cell, result: Result, trace: bool, per_layer: dict, device: dict) -> dict:
    """The contract's last line; ``checks`` comes last."""
    if trace:
        metrics = {m["name"]: {"value": per_layer[m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if per_layer.get(m["name"]) is not None}
    else:
        metrics = {m["name"]: {"value": result.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {"correct": result.correct, "attempted": result.attempted, "failed": result.failed,
           "metrics": metrics, "device": device}
    if trace and result.trace is not None:
        from .tracing import breakdown

        out["breakdown"] = breakdown(result.trace)
    out["checks"] = {name: {"value": value if math.isfinite(value) else None, "limit": limit}
                     for name, value, limit in result.checks}
    return out


REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


def parse_result(stdout: str) -> dict:
    """The result of a run from its standard output: the last line, one
    JSON object with the contract's keys."""
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("the run printed no result")
    result = json.loads(lines[-1])
    missing = [k for k in REQUIRED if k not in result]
    if missing:
        raise ValueError(f"the result line lacks {missing}")
    for name, metric in result["metrics"].items():
        if set(metric) != {"value", "unit"}:
            raise ValueError(f"metric {name} has keys {sorted(metric)}")
    return result
