"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness

PACKAGE = harness.PACKAGE
FORBIDDEN = {"jax", "jaxlib", "flax", "fcn8s_tensorflow_tpu"}
NOT_READ = ("benchmarks", "bench", "probes", "chip_smoke")  # modules and files never read


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_dry_runs_of_every_cell_load_no_jax():
    """A CPU dry run of every cell in a fresh process, then its modules'
    top-level names, compared whole (the port's name begins with the JAX
    package's)."""
    code = ("import json, sys\n"
            "from portbench.tests.tiny import SHAPES, dry_run\n"
            "for cell in sorted(SHAPES):\n"
            "    dry_run(cell, trace=True)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(harness.root()),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(__import__("json").loads(out.stdout.splitlines()[-1]))
    assert "fcn8s_tensorflow_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_a_rank_that_loaded_jax_fails_the_run(monkeypatch):
    """Each rank of a cell on more than one chip checks its own modules:
    one that finds JAX's name ends non-zero, and rank 0 gives no result."""
    import pytest

    from portbench import ranks
    from portbench.tests.tiny import dry_run

    code = ("import sys, types\n"
            "sys.modules['jax'] = types.ModuleType('jax')\n"
            "from portbench import ranks\n"
            "sys.exit(ranks.main(sys.argv[1:]))\n")
    inner = ranks.spawn
    monkeypatch.setattr(ranks, "spawn", lambda ctx, init, _=None: inner(ctx, init, code))
    with pytest.raises(RuntimeError, match="codes"):
        dry_run("fcn8s.train.dp4")


def _strings(path: Path) -> set[str]:
    """The string constants of a file, its docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = {id(node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)}
    return {node.value for node in ast.walk(tree) if isinstance(node, ast.Constant)
            and isinstance(node.value, str) and id(node) not in docs}


def test_no_file_of_the_benchmark_imports_jax():
    """Nor imports or names a path of the measurement scripts that came
    before it (``benchmarks/``, ``bench.py``, ``probes/``, ``chip_smoke.py``)."""
    for path in PACKAGE.rglob("*.py"):
        names = _imports(path)
        assert not {name.split(".")[0] for name in names} & FORBIDDEN, path
        parts = {part for name in names for part in name.split(".")}
        assert not parts & set(NOT_READ), (path, parts & set(NOT_READ))
        for text in _strings(path):
            for name in NOT_READ:
                assert f"{name}.py" not in text and f"{name}/" not in text, (path, text)


def test_the_reference_imports_nothing_of_the_port():
    for path in (PACKAGE / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "contextlib", "math", "numpy", "torch"}, (path, tops)
