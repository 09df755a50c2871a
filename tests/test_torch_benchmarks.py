"""PyTorch port, the measurement scripts (``fcn8s_tensorflow_tpu_torch/benchmarks``)
against the JAX package's ``bench.py`` and ``benchmarks/`` on the CPU.

Each script runs end to end with ``--device cpu`` at a tiny shape (a
width-1/32 model, its module constants cut), and its JSON line has the JAX
script's keys (read from the JAX source), but for the renames the port
documents. The numbers that are not times are held against JAX:

* the bench's analytic step FLOPs at full width: 10.68 TFLOP, JAX's
  ``model_summary_rows`` on ``eval_shape(init_fcn8s)``, x 6;
* the pool pair's max and gradient, JAX's ``max_pool_2x2`` VJP, exactly;
* the profile parser's totals on a hand-made Chrome trace;
* the augment and ignore-label configurations, read from the JAX scripts;
  the masked and dense losses, JAX's ``train_step`` at keep_prob 1 (fp32)
  within 1e-5;
* every overlay variant against JAX's jitted ``predict_step(overlay_lut=)``
  (the body of ``compile_predict_step``) on the same weights and images;
* the int8 wgrad, JAX's jitted ``int8_wgrad_dynamic``, within 1e-6;
* ``synth_labelid_scene``, the e2e tree and the packed tree, byte for byte.

Every script defaults to ``--device cuda`` and, without a card, raises (the
bench prints its null line and exits 1) naming ``--device cpu``; none of
them imports JAX.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.models.fcn8s import init_fcn8s as j_init  # noqa: E402
from fcn8s_tensorflow_tpu.ops.nn import max_pool_2x2 as j_pool  # noqa: E402
from fcn8s_tensorflow_tpu.parallel import steps as jsteps  # noqa: E402
from fcn8s_tensorflow_tpu.utils.summary import model_summary_rows as j_rows  # noqa: E402
from fcn8s_tensorflow_tpu_torch import benchmarks as B  # noqa: E402
from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.benchmarks import (bench, device_augment_bench,  # noqa: E402
                                                   e2e_input_bench, ignore_label_bench,
                                                   int8_closed_loop, int8_wgrad_bench,
                                                   overlay_bench, packed_input_bench,
                                                   pallas_pool_bench, profile_train_step)
from fcn8s_tensorflow_tpu_torch.parallel import steps as tsteps  # noqa: E402
from fcn8s_tensorflow_tpu_torch.tools import child_env  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "fcn8s_tensorflow_tpu_torch")
SMALL = dict(width_mult=1 / 32, fc_channels=32)
DEVICE_SCRIPTS = [device_augment_bench, e2e_input_bench, ignore_label_bench, int8_closed_loop,
                  int8_wgrad_bench, overlay_bench, pallas_pool_bench, profile_train_step]
NO_JAX_FILES = (sorted(os.path.join(PORT, "benchmarks", f)
                       for f in os.listdir(os.path.join(PORT, "benchmarks")) if f.endswith(".py"))
                + [os.path.join(PORT, "tools", "parity_harness.py"),
                   os.path.join(PORT, "tools", "tf_interop.py"),
                   os.path.join(REPO, "chip_smoke.py"),
                   os.path.join(REPO, "probes", "benchmarks_phase.py")])


@pytest.fixture
def narrow(monkeypatch):
    """Every script's model at width 1/32, fc 32 (``MODEL`` is shared by
    reference, so it is filled in place)."""
    for k, v in SMALL.items():
        monkeypatch.setitem(B.MODEL, k, v)


def _jax_script(rel):
    """The JAX package's script ``rel`` (from the repo root) as a fresh module."""
    name = "jax_script_" + rel.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source_tree(rel):
    with open(os.path.join(REPO, rel)) as f:
        return ast.parse(f.read())


def _dict_keys(node) -> set:
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def _dumped_dict_keys(rel) -> set:
    """The string keys of the dict literals a JAX script passes to
    ``json.dumps`` (directly, or through the name it assigns them to)."""
    tree = _source_tree(rel)
    assigned = {t.id: node.value for node in ast.walk(tree) if isinstance(node, ast.Assign)
                for t in node.targets if isinstance(t, ast.Name)
                and isinstance(node.value, ast.Dict)}
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args):
            arg = node.args[0]
            if isinstance(arg, ast.Name):
                arg = assigned.get(arg.id)
            if isinstance(arg, ast.Dict):
                keys |= _dict_keys(arg)
    return keys


def _call_kwargs(rel, func) -> list[dict]:
    """The literal keyword arguments of each call of ``func`` in a JAX script."""
    out = []
    for node in ast.walk(_source_tree(rel)):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == func:
            out.append({k.arg: ast.literal_eval(k.value) for k in node.keywords})
    return out


# ---------------------------------------------------------------------------
# no JAX, and the card by default
# ---------------------------------------------------------------------------


def _imports(tree) -> list:
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                     "fcn8s_tensorflow_tpu")]


@pytest.mark.parametrize("path", NO_JAX_FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_script_imports_no_jax(path):
    with open(path) as f:
        assert not _imports(ast.parse(f.read())), path


def test_importing_every_script_loads_no_jax():
    mods = [os.path.relpath(p, REPO)[:-3].replace(os.sep, ".") for p in NO_JAX_FILES
            if p.startswith(PORT)]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'fcn8s_tensorflow_tpu', 'tensorflow')]\nassert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=dict(child_env(), OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.mark.parametrize("mod", DEVICE_SCRIPTS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_script_defaults_to_the_card_and_names_device_cpu(mod, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--out", str(tmp_path / "x.json")] if mod is int8_closed_loop else []
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(argv)


def test_bench_without_a_card_prints_the_null_line():
    out = subprocess.run([sys.executable, "-m", bench.__name__],
                         env=dict(child_env(), OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["value"] is None and "--device cpu" in line["error"]
    assert line["metric"] == bench.METRIC


# ---------------------------------------------------------------------------
# bench
# ---------------------------------------------------------------------------


def _jax_bench_keys() -> tuple[set, set]:
    """(top-level keys, extras keys) of the JAX bench's result line."""
    tree = _source_tree("bench.py")
    result = next(node.value for node in ast.walk(tree) if isinstance(node, ast.Assign)
                  and getattr(node.targets[0], "id", None) == "result")
    extras = next(v for k, v in zip(result.keys, result.values) if k.value == "extras")
    mfu = next(node for node in ast.walk(tree) if isinstance(node, ast.FunctionDef)
               and node.name == "_mfu_extras")
    mfu_keys = set().union(*(_dict_keys(r.value) for r in ast.walk(mfu)
                             if isinstance(r, ast.Return) and isinstance(r.value, ast.Dict)))
    return _dict_keys(result), _dict_keys(extras) | mfu_keys


def _meta_port_tree(num_classes, **kw):
    """A port-layout tree of meta tensors with the shapes of JAX's
    ``init_fcn8s`` (no memory; the summary reads shapes only)."""
    shapes = jax.eval_shape(lambda k: j_init(k, num_classes, **kw), jax.random.PRNGKey(0))
    out = {}
    for part, layers in shapes.items():
        out[part] = {}
        for name, layer in layers.items():
            kshape = layer["kernel"].shape
            if name.endswith("_deconv"):
                entry = {"kernel": kshape}
            else:
                entry = {"weight": (kshape[3], kshape[2], kshape[0], kshape[1])}
            entry["bias"] = layer["bias"].shape
            out[part][name] = {k: torch.empty(s, device="meta") for k, s in entry.items()}
    return out, shapes


def test_bench_analytic_step_flops_equal_jax_at_full_width():
    tree, shapes = _meta_port_tree(bench.NUM_CLASSES)
    hw, batch = (bench.H, bench.W), bench.TRAIN_BATCH
    want = 3 * 2 * sum(r["macs"] for r in j_rows(shapes, input_hw=hw, batch=batch)) / 1e12
    got = bench.step_tflops(tree, hw, batch)
    assert got == want and round(got, 2) == 10.68


def test_bench_peak_table():
    assert bench.peak_bf16_tflops("NVIDIA H100 PCIe") == 756.0
    assert bench.peak_bf16_tflops("NVIDIA H100 80GB HBM3") == 989.4
    assert bench.peak_bf16_tflops("cpu") is None


def test_bench_runs_on_the_cpu_with_the_jax_keys(narrow, monkeypatch, capsys):
    for k, v in dict(H=64, W=64, TRAIN_BATCH=2, INFER_BATCH=2, ITERS=2, WARMUP=1).items():
        monkeypatch.setattr(bench, k, v)
    result = bench.main(["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result
    top, extras = _jax_bench_keys()
    assert set(result) == top
    assert set(result["extras"]) == extras | {"device"}
    ex = result["extras"]
    assert result["value"] > 0 and result["vs_baseline"] is None and ex["infer_vs_baseline"] is None
    assert ex["mfu"] is None and ex["device"] == "cpu" and ex["n_chips"] == 1
    assert ex["resolution"] == "64x64" and ex["infer_batched_batch"] == 2
    for row in ("batched", "int8", "overlay"):
        assert ex[f"infer_{row}_stats"]["reps"] == bench.INFER_REPS
    assert ex["infer_batch1_breakdown"]["payload_bytes"] == 64 * 64  # uint8 ids


# ---------------------------------------------------------------------------
# the pool pair
# ---------------------------------------------------------------------------


def _tie_free(rng, shape):
    """Values whose low two bits are the position in a 2x2 window: no
    window holds a tie; the max's position is random."""
    n, h, w, c = shape
    pos = np.zeros((h, w), np.int64)
    pos[0::2, 1::2], pos[1::2, 0::2], pos[1::2, 1::2] = 1, 2, 3
    return (rng.integers(0, 60, shape) * 4 + pos[None, :, :, None]).astype(np.float32)


def test_pool_pair_matches_jax_and_the_library():
    rng = np.random.default_rng(0)
    x = _tie_free(rng, (2, 8, 12, 64))
    dy = rng.standard_normal((2, 4, 6, 64)).astype(np.float32)
    y_j, vjp = jax.vjp(j_pool, jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(dy))
    from fcn8s_tensorflow_tpu_torch.ops.nn import nchw, nhwc

    xt, dyt = nchw(torch.from_numpy(x)), nchw(torch.from_numpy(dy))
    for pair in (pallas_pool_bench.kernel_pair, pallas_pool_bench.library_pair):
        y, dx = pair(xt, dyt)
        np.testing.assert_array_equal(nhwc(y).numpy(), np.asarray(y_j))
        np.testing.assert_array_equal(nhwc(dx).numpy(), np.asarray(dx_j))


def test_library_pool1_swaps_pool1_only():
    from fcn8s_tensorflow_tpu_torch.models import vgg16

    orig = vgg16.maxpool2x2
    with pallas_pool_bench.library_pool1():
        assert vgg16.maxpool2x2 is not orig
    assert vgg16.maxpool2x2 is orig


def test_pool_bench_runs_with_its_keys(narrow, monkeypatch):
    for k, v in dict(N=2, H=64, W=64, ITERS=1, WARMUP=1).items():
        monkeypatch.setattr(pallas_pool_bench, k, v)
    out = pallas_pool_bench.main(["--device", "cpu"])
    jax_keys = {"standalone_xla_ms", "standalone_pallas_ms", "step_default_ms",
                "step_pallas_pool1_ms", "step_delta_ms"}
    src = open(os.path.join(REPO, "benchmarks", "pallas_pool_bench.py")).read()
    assert all(f'"{k}"' in src for k in jax_keys)
    renamed = {"standalone_xla_ms": "standalone_library_ms",
               "standalone_pallas_ms": "standalone_kernel_ms",
               "step_pallas_pool1_ms": "step_library_pool1_ms"}
    assert set(out) == {renamed.get(k, k) for k in jax_keys}
    assert out["step_delta_ms"] == round(out["step_library_pool1_ms"] - out["step_default_ms"], 1)


# ---------------------------------------------------------------------------
# the profile
# ---------------------------------------------------------------------------


def test_profile_parser_totals_a_chrome_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "train_step", "ts": 0, "dur": 900},
        {"ph": "X", "cat": "user_annotation", "name": "train_step", "ts": 1000, "dur": 900},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "train_step", "ts": 0, "dur": 800},
        {"ph": "X", "cat": "kernel", "name": "conv", "ts": 1, "dur": 500.0},
        {"ph": "X", "cat": "kernel", "name": "conv", "ts": 1001, "dur": 700.0},
        {"ph": "X", "cat": "kernel", "name": "pool_kernel<1>", "ts": 2, "dur": 40.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 3, "dur": 60.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 4, "dur": 2.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 5000.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
    ]
    path = tmp_path / "trace_1_2.json"
    path.write_text(json.dumps({"traceEvents": events}))
    ranked, total, steps = profile_train_step.parse_trace(str(tmp_path), top=3)
    assert steps == 2
    assert total == pytest.approx(1.302)
    assert [r[0] for r in ranked] == ["conv", "Memcpy HtoD", "pool_kernel<1>"]
    assert ranked[0][1] == pytest.approx(1.2) and ranked[0][2] == 2
    assert profile_train_step.parse_trace(str(path), top=10)[0][-1][0] == "Memset"


def test_profile_runs_and_parses_its_own_trace(narrow, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(profile_train_step, "H", 64)
    monkeypatch.setattr(profile_train_step, "W", 64)
    out = profile_train_step.main(["--device", "cpu", "--batch", "2", "--steps", "2",
                                   "--keep-trace", str(tmp_path)])
    assert out["steps"] == 2  # the train_step spans, read from the trace
    text = capsys.readouterr().out
    assert text.startswith("device total:") and "over 2 steps" in text
    again = profile_train_step.main(["--parse-only", str(tmp_path)])
    assert again["steps"] == 2 and again["device_total_ms"] == out["device_total_ms"]


# ---------------------------------------------------------------------------
# device augment, ignore label
# ---------------------------------------------------------------------------


def test_augment_configs_are_the_jax_scripts():
    calls = _call_kwargs("benchmarks/device_augment_bench.py", "make_augment_fn")
    assert calls == [device_augment_bench.AUG, device_augment_bench.AUG_PHOTO]


def test_device_augment_bench_runs_with_the_jax_keys(narrow, monkeypatch):
    for k, v in dict(H=64, W=64, BATCH=2, ITERS=1, WARMUP=1).items():
        monkeypatch.setattr(device_augment_bench, k, v)
    out = device_augment_bench.main(["--device", "cpu"])
    assert set(out) == _dumped_dict_keys("benchmarks/device_augment_bench.py")
    assert out["shape"] == "2x64x64"


def test_ignore_label_constants_are_the_jax_scripts():
    j = _jax_script("benchmarks/ignore_label_bench.py")
    assert (j.NUM_CLASSES, j.IGNORE, j.H, j.W, j.BATCH) == (
        ignore_label_bench.NUM_CLASSES, ignore_label_bench.IGNORE, ignore_label_bench.H,
        ignore_label_bench.W, ignore_label_bench.BATCH)


@pytest.mark.parametrize("config", list(ignore_label_bench.CONFIGS)[1:])
def test_ignore_label_losses_match_jax(config):
    """The script's masked and dense configurations: the port's step loss
    equals JAX's ``train_step`` at keep_prob 1, fp32, within 1e-5 (the
    decoder redrawn so that the loss is not ln(C) to within rounding)."""
    kw = ignore_label_bench.CONFIGS[config]
    nc = ignore_label_bench.NUM_CLASSES
    rng = np.random.default_rng(0)
    labels = ignore_label_bench.labels_with_ignored(rng, (2, 64, 64))
    images = rng.integers(0, 255, (2, 64, 64, 3), np.uint8)
    mask = np.ones((2,), np.float32)
    tree = _margin_tree(nc)
    opt = jsteps.make_optimizer()
    step = jax.jit(lambda s, im, lb, mk: jsteps.train_step(
        s, im, lb, mk, jax.random.PRNGKey(0), 1e-4, 0.0, 1.0, optimizer=opt, num_classes=nc,
        compute_dtype=jnp.float32, use_pallas_ce=False, **kw))
    _, want = step(jsteps.create_train_state(jax.tree.map(jnp.asarray, tree), opt),
                   jnp.asarray(images), jnp.asarray(labels), jnp.asarray(mask))
    topt = tsteps.make_optimizer()
    state = tsteps.create_train_state(bridge.to_port(tree), topt)
    _, got = tsteps.train_step(state, torch.from_numpy(images), torch.from_numpy(labels),
                               torch.from_numpy(mask), 0, 1e-4, 0.0, 1.0, optimizer=topt,
                               num_classes=nc, compute_dtype=torch.float32, **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_ignore_label_bench_runs_with_the_jax_keys(narrow, monkeypatch):
    for k, v in dict(H=64, W=64, BATCH=2, ITERS=1, WARMUP=1).items():
        monkeypatch.setattr(ignore_label_bench, k, v)
    out = ignore_label_bench.main(["--device", "cpu"])
    assert set(out) == _dumped_dict_keys("benchmarks/ignore_label_bench.py")
    assert out["loss_rel_disagreement"] <= 1e-5


# ---------------------------------------------------------------------------
# overlay
# ---------------------------------------------------------------------------


def _margin_tree(nc, seed=0):
    """JAX's narrow init with the decoder redrawn at unit fan-in scale, so
    pixels have clear top-2 margins."""
    tree = jax.tree.map(np.array, j_init(jax.random.PRNGKey(seed), nc, **SMALL))
    rng = np.random.default_rng(seed)
    for layer in tree["decoder"].values():
        k = layer["kernel"]
        layer["kernel"] = (rng.normal(size=k.shape) / np.sqrt(np.prod(k.shape[:-1]))).astype(
            np.float32)
    return tree


def test_overlay_variants_equal_jax_predict_step():
    nc = overlay_bench.NUM_CLASSES
    lut = overlay_bench.overlay_lut()
    jmod = _jax_script("benchmarks/overlay_bench.py")
    assert (jmod.H, jmod.W, jmod.BATCH, jmod.NUM_CLASSES) == (
        overlay_bench.H, overlay_bench.W, overlay_bench.BATCH, nc)
    tree = _margin_tree(nc)
    images = np.random.default_rng(1).integers(0, 255, (2, 64, 64, 3), np.uint8)
    j_fn = jax.jit(lambda p, x: jsteps.predict_step(p, x, overlay_lut=lut,
                                                    compute_dtype=jnp.float32))
    want = np.asarray(j_fn(jax.tree.map(jnp.asarray, tree), jnp.asarray(images)))
    want_ids = np.asarray(jax.jit(lambda p, x: jsteps.predict_step(
        p, x, compute_dtype=jnp.float32))(jax.tree.map(jnp.asarray, tree), jnp.asarray(images)))
    run = bridge.cast_params(bridge.to_port(tree), torch.float32)
    x = torch.from_numpy(images)
    with torch.inference_mode():
        outs = {name: fn(run, x).numpy()
                for name, fn in overlay_bench.variants(lut, torch.float32).items()}
        own = tsteps.predict_step(run, x, overlay_lut=lut, compute_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(outs["argmax_u8"], want_ids.astype(np.uint8))
    for name in ("v0_gather4", "v1_planar", "v2_packed32", "v3_selects"):
        np.testing.assert_array_equal(outs[name], outs["v0_gather4"], err_msg=name)
        # XLA may contract the blend into one FMA: at most one level apart
        assert np.abs(outs[name].astype(int) - want.astype(int)).max() <= 1, name
    np.testing.assert_array_equal(outs["v0_gather4"], own)


def test_overlay_bench_runs_with_the_jax_keys(narrow, monkeypatch):
    for k, v in dict(H=64, W=64, BATCH=2, ITERS=1, WARMUP=1).items():
        monkeypatch.setattr(overlay_bench, k, v)
    out = overlay_bench.main(["--device", "cpu"])
    assert set(out) == _dumped_dict_keys("benchmarks/overlay_bench.py")
    assert all(out["bit_identical_vs_v0"].values()) and out["device"] == "cpu"
    assert set(out["compute_sync_ms"]) == {"argmax_u8", "v0_gather4", "v1_planar",
                                           "v2_packed32", "v3_selects"}


# ---------------------------------------------------------------------------
# int8 wgrad
# ---------------------------------------------------------------------------


def test_int8_wgrad_equals_jax():
    jmod = _jax_script("benchmarks/int8_wgrad_bench.py")
    assert (jmod.N, jmod.H, jmod.W, jmod.CI, jmod.CO, jmod.K) == (
        int8_wgrad_bench.N, int8_wgrad_bench.H, int8_wgrad_bench.W, int8_wgrad_bench.CI,
        int8_wgrad_bench.CO, int8_wgrad_bench.K)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    dy = (rng.normal(size=(2, 8, 8, 24)) * 1e-3).astype(np.float32)
    want = np.asarray(jax.jit(jmod.int8_wgrad_dynamic)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)))  # (CI, K, K, CO)
    got = int8_wgrad_bench.int8_wgrad_dynamic(torch.from_numpy(x).to(torch.bfloat16),
                                              torch.from_numpy(dy).to(torch.bfloat16)).numpy()
    want = want.transpose(1, 2, 0, 3)
    assert got.shape == want.shape == (7, 7, 16, 24)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_int8_wgrad_bench_runs(monkeypatch):
    for k, v in dict(N=2, H=8, W=8, CI=16, CO=32, ITERS=1).items():
        monkeypatch.setattr(int8_wgrad_bench, k, v)
    out = int8_wgrad_bench.main(["--device", "cpu"])
    assert out["dw_rel_err_int8"] <= 5e-2 and out["dw_rel_err_bf16"] <= 5e-3


# ---------------------------------------------------------------------------
# int8 closed loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_closed_loop():
    return _jax_script("benchmarks/int8_closed_loop.py")


@pytest.mark.parametrize("seed, h, w", [(0, 64, 128), (999, 256, 512), (3, 96, 160)])
def test_synth_labelid_scene_equals_jax(jax_closed_loop, seed, h, w):
    got = int8_closed_loop.synth_labelid_scene(np.random.default_rng(seed), h, w)
    want = jax_closed_loop.synth_labelid_scene(np.random.default_rng(seed), h, w)
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype and g.tobytes() == wnt.tobytes()


def test_closed_loop_constants_equal_jax(jax_closed_loop):
    assert int8_closed_loop.CLASS_COLORS == jax_closed_loop.CLASS_COLORS
    np.testing.assert_array_equal(int8_closed_loop.ENDURANCE_LABELID_LUT,
                                  jax_closed_loop.ENDURANCE_LABELID_LUT)


def test_closed_loop_runs_with_the_jax_keys(narrow, tmp_path, capsys):
    path = tmp_path / "cl.json"
    out = int8_closed_loop.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                                 "--resolution", "64", "128", "--val-images", "2",
                                 "--out", str(path)])
    assert json.loads(path.read_text()) == out
    tree = _source_tree("benchmarks/int8_closed_loop.py")
    out_dict = next(node.value for node in ast.walk(tree) if isinstance(node, ast.Assign)
                    and getattr(node.targets[0], "id", None) == "out"
                    and isinstance(node.value, ast.Dict))
    assert set(out) == _dict_keys(out_dict)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "bf16_miou", "int8_miou", "delta"}
    assert 0.0 <= out["bf16_miou"] <= 1.0 and 0.0 <= out["int8_miou"] <= 1.0


# ---------------------------------------------------------------------------
# the input benchmarks: their trees, byte for byte
# ---------------------------------------------------------------------------


def _decoded(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = np.asarray(Image.open(p))
    return out


def test_e2e_tree_equals_jax(tmp_path, monkeypatch):
    import cv2

    jmod = _jax_script("benchmarks/e2e_input_bench.py")
    for mod in (jmod, e2e_input_bench):
        monkeypatch.setattr(mod, "H", 512)
        monkeypatch.setattr(mod, "W", 64)
    tile, source = e2e_input_bench.tile_image()
    assert tile.shape == (256, 64, 3) and "synthetic" in source
    # the JAX script reads a photograph (BGR) and resizes it to (W, 256): here the tile
    monkeypatch.setattr(cv2, "imread", lambda path: tile[..., ::-1].copy())
    jmod.build_dataset(str(tmp_path / "jax"), n_images=3)
    e2e_input_bench.build_dataset(str(tmp_path / "port"), tile, n_images=3)
    got, want = _decoded(tmp_path / "port"), _decoded(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) == 6
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_e2e_tile_from_an_image(tmp_path):
    from fcn8s_tensorflow_tpu_torch.ops.resize_host import resize_linear_u8

    img = np.random.default_rng(2).integers(0, 255, (300, 700, 3), np.uint8)
    Image.fromarray(img).save(tmp_path / "p.png")
    tile, source = e2e_input_bench.tile_image(str(tmp_path / "p.png"))
    np.testing.assert_array_equal(tile, resize_linear_u8(img, (256, e2e_input_bench.W)))
    assert source.endswith("p.png")


def test_e2e_bench_runs_with_the_jax_keys(narrow, monkeypatch):
    for k, v in dict(H=256, W=64, BATCH=2, WARM_STEPS=1, TIMED_STEPS=1, ROUNDS=1).items():
        monkeypatch.setattr(e2e_input_bench, k, v)
    out = e2e_input_bench.main(["--device", "cpu"])
    configs = {"resident_floor", "packed_device_aug", "png_device_aug", "packed_host_aug"}
    assert set(out) == (_dumped_dict_keys("benchmarks/e2e_input_bench.py") | configs
                        | {"tile_source"})
    assert set(out["samples"]) == configs
    jmod = _jax_script("benchmarks/e2e_input_bench.py")
    assert (jmod.DEVICE_AUG, jmod.HOST_AUG) == (e2e_input_bench.DEVICE_AUG,
                                                e2e_input_bench.HOST_AUG)


def test_packed_tree_equals_jax(tmp_path, monkeypatch):
    jmod = _jax_script("benchmarks/packed_input_bench.py")
    for mod in (jmod, packed_input_bench):
        for k, v in dict(H=64, W=32, N_IMAGES=3).items():
            monkeypatch.setattr(mod, k, v)
    jmod.build_tree(str(tmp_path / "jax"))
    packed_input_bench.build_tree(str(tmp_path / "port"))

    def files(root):
        return {os.path.relpath(os.path.join(d, n), root): open(os.path.join(d, n), "rb").read()
                for d, _, ns in os.walk(root) for n in ns}

    got, want = files(tmp_path / "port"), files(tmp_path / "jax")
    assert got == want and len(got) == 6


def test_packed_bench_runs(monkeypatch, capsys):
    for k, v in dict(H=64, W=32, N_IMAGES=4, N_BATCHES=2).items():
        monkeypatch.setattr(packed_input_bench, k, v)
    out = packed_input_bench.main()
    assert set(out) == {"plain", "augmented"}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert packed_input_bench.AUG == _jax_script("benchmarks/packed_input_bench.py").AUG

