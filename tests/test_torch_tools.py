"""PyTorch port, the training-survival tools against the JAX package's on
the CPU (``fcn8s_tensorflow_tpu_torch/tools``):

* the synthetic workloads equal ``benchmarks/endurance_canonical.py``'s and
  ``benchmarks/convergence_synthetic.py``'s byte for byte, over several
  seeds and shapes, ``prepare_packed``'s files included;
* ``fingerprint`` of a JAX checkpoint loaded in the port (width 1/16, two
  Adam steps, EMA on) equals JAX's ``fingerprint`` of the JAX model;
* an endurance kill-and-resume at width 1/16 with keep_prob 0.5 and
  ``--augment full`` (the device label noise included) is bit-exact;
* no file of ``tools/`` or ``examples/`` imports JAX or the JAX package.

The tools run as subprocesses (``python -m``), as a user runs them: their
children switch on deterministic algorithms, which this process keeps off.
The multi-process tools' tests are in tests/test_torch_multihost_tools.py.
"""

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

import convergence_synthetic as jcs  # noqa: E402
import endurance_canonical as jec  # noqa: E402

from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.tools import child_env  # noqa: E402
from fcn8s_tensorflow_tpu_torch.tools import endurance_canonical as ec  # noqa: E402
from fcn8s_tensorflow_tpu_torch.tools import synthetic as syn  # noqa: E402

PORT = os.path.join(REPO, "fcn8s_tensorflow_tpu_torch")
PORT_FILES = sorted(glob.glob(os.path.join(PORT, "tools", "*.py"))
                    + glob.glob(os.path.join(PORT, "examples", "*.py")))


def _env(**extra):
    """A child's environment: the tools' own, one thread a process."""
    return dict(child_env(), OMP_NUM_THREADS="1", **extra)


# ---------------------------------------------------------------------------
# no JAX in the port's tools and examples
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, PORT))
def test_tool_and_example_files_import_no_jax(path):
    tree = ast.parse(open(path).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                    "fcn8s_tensorflow_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_importing_every_tool_and_example_loads_no_jax():
    mods = [os.path.relpath(p, REPO)[:-3].replace(os.sep, ".") for p in PORT_FILES]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'fcn8s_tensorflow_tpu')]\nassert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


# ---------------------------------------------------------------------------
# the synthetic workloads, byte for byte
# ---------------------------------------------------------------------------


def test_constants_equal_the_jax_tools():
    assert syn.CLASS_COLORS == jcs.CLASS_COLORS
    assert syn.NUM_CLASSES == jcs.NUM_CLASSES == jec.NUM_CLASSES
    assert syn.LABEL_NOISE == jec.LABEL_NOISE
    assert syn.AUGMENT_CONFIGS == jec.AUGMENT_CONFIGS


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("seed, n, h, w", [(0, 3, 32, 64), (5, 2, 48, 80), (999, 4, 64, 64)])
def test_synth_batch_equals_convergence_synthetic(seed, n, h, w):
    _same(syn.synth_batch(np.random.default_rng(seed), n, h, w),
          jcs.synth_batch(np.random.default_rng(seed), n, h, w))


@pytest.mark.parametrize("seed, n, h, w", [(3, 4, 32, 64), (7, 2, 64, 96), (11, 3, 48, 48)])
def test_synth_hard_batch_equals_endurance_canonical(seed, n, h, w):
    _same(syn.synth_hard_batch(np.random.default_rng(seed), n, h, w),
          jec.synth_hard_batch(np.random.default_rng(seed), n, h, w))


@pytest.mark.parametrize("host_noise", [True, False])
@pytest.mark.parametrize("step", [0, 1, 123, 6500])
def test_batch_for_step_equals_endurance_canonical(step, host_noise):
    images, labels = jec.synth_hard_batch(np.random.default_rng(3), 16, 32, 32)
    _same(syn.batch_for_step(images, labels, step, 8, host_noise=host_noise),
          jec.batch_for_step(images, labels, step, 8, host_noise=host_noise))


@pytest.mark.parametrize("h, w, batch, n", [(32, 64, 2, 2), (64, 32, 3, 1)])
def test_make_eval_batches_equals_endurance_canonical(h, w, batch, n):
    got, want = syn.make_eval_batches(h, w, batch, n), jec.make_eval_batches(h, w, batch, n)
    assert len(got) == len(want)
    for g, wt in zip(got, want):
        _same(g, wt)


def test_prepare_packed_writes_the_jax_files(tmp_path):
    a = jec.prepare_packed(str(tmp_path / "jax"), n=6, h=32, w=64)
    b = syn.prepare_packed(str(tmp_path / "port"), n=6, h=32, w=64)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) == ["images.npy", "index.json", "labels.npy"]
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    assert not os.path.exists(b + "_png")
    _same(syn.load_packed(b), jec.load_packed(a))
    assert syn.prepare_packed(b, n=99, h=1, w=1) == b  # an existing pack is reused


# ---------------------------------------------------------------------------
# the fingerprint, across the packages
# ---------------------------------------------------------------------------


def test_fingerprint_of_a_jax_checkpoint_equals_jax_fingerprint(tmp_path):
    import jax
    import jax.numpy as jnp

    from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s
    from fcn8s_tensorflow_tpu.parallel.mesh import create_mesh

    jm = JFCN8s(num_classes=6, width_mult=1 / 16, fc_channels=64, compute_dtype=jnp.float32,
                mesh=create_mesh(data=1, model=1, devices=jax.devices()[:1]))
    rng = np.random.default_rng(4)

    def gen():
        while True:
            yield syn.synth_batch(rng, 2, 32, 32)

    jm.train(gen(), epochs=1, steps_per_epoch=2, learning_rate_schedule=lambda s: 1e-3,
             keep_prob=1.0, record_summaries=False, ema_decay=0.9)
    want = jec.fingerprint(jm)
    path = jm.save(str(tmp_path / "ckpt"))
    jm.close()
    model = FCN8s(model_load_dir=path, device="cpu")
    assert model._ema is not None and int(model.state.step) == 2
    assert ec.fingerprint(model) == want
    # a step moves it, and a port save/load round trip keeps it
    model.train(gen(), epochs=1, steps_per_epoch=1, learning_rate_schedule=lambda s: 1e-3,
                keep_prob=1.0, record_summaries=False, ema_decay=0.9)
    moved = ec.fingerprint(model)
    assert moved != want
    again = FCN8s(model_load_dir=model.save(str(tmp_path / "port")), device="cpu")
    assert ec.fingerprint(again) == moved


# ---------------------------------------------------------------------------
# endurance: SIGKILL and a bit-exact resume, dropout and full augmentation on
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def endurance_report(tmp_path_factory):
    root = tmp_path_factory.mktemp("endurance")
    report = root / "report.json"
    cmd = [sys.executable, "-m", ec.__name__, "--device", "cpu",
           "--packed", str(root / "packed"), "--out-root", str(root / "out"),
           "--report", str(report), "--total-steps", "8", "--spe", "4", "--batch", "4",
           "--grad-accum", "2", "--height", "64", "--width", "64", "--dataset-size", "8",
           "--width-mult", "0.0625", "--fc-channels", "64", "--augment", "full",
           "--kill-at-step", "4", "--kill-delay-s", "0.3", "--poll-s", "0.1",
           "--miou-floor", "0"]
    out = subprocess.run(cmd, env=_env(ENDURANCE_THROTTLE_S="0.25"), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return json.loads(report.read_text()), out.stdout


def test_endurance_kill_and_resume_is_bit_exact(endurance_report):
    report, stdout = endurance_report
    assert report["bitexact_resume"] and report["all_losses_finite"]
    assert [e["event"] for e in report["events"]] == ["sigkill"]
    assert report["final"]["final_step"] == report["comparator"]["final_step"] == 8
    assert report["final"]["fingerprint"] == report["comparator"]["fingerprint"]
    # whatever the killed trainer logged past the restored checkpoint was
    # logged again, equal
    assert report["replay"]["match"] and not report["replay"]["missing"], report["replay"]
    assert report["replay"] == ec.replay_check(report["history"], report["events"])
    last = json.loads(stdout.strip().splitlines()[-1])
    assert last["endurance_ok"] is True and last["replay_match"] is True


def _record(step, loss, lr=1e-4, epoch=1, t=0.0):
    return {"epoch": epoch, "global_step": step, "training_loss": loss, "learning_rate": lr,
            "time": t, "eval_loss": loss / 2}


_KILL = {"event": "sigkill", "at_step": 20,
         "ckpt": "saved_model_(globalstep-10)_(trainloss-1.7866)_(eval_on_val_dataset)"}
_REPLAYS = {
    # killed after logging 10 and 20, resumed from 10: 20 logged again, equal
    # but for the wall time and the epoch count
    "equal": ([_record(10, 1.5), _record(20, 1.25, epoch=2, t=5.0), _record(20, 1.25, t=9.0),
               _record(30, 1.0, epoch=2)], True, [20], [], []),
    "a learning rate the restore lost": ([_record(10, 1.5), _record(20, 1.25),
                                          _record(20, 1.25, lr=5e-5), _record(30, 1.0)],
                                         False, [20], [20], []),
    "a loss that differs": ([_record(10, 1.5), _record(20, 1.25), _record(20, 1.2500001),
                             _record(30, 1.0)], False, [20], [20], []),
    "a replayed step never logged again": ([_record(10, 1.5), _record(20, 1.25),
                                            _record(30, 1.0)], False, [], [], [20]),
}


@pytest.mark.parametrize("case", sorted(_REPLAYS))
def test_endurance_replay_check(case):
    history, match, replayed, mismatched, missing = _REPLAYS[case]
    got = ec.replay_check(history, [_KILL])
    assert got == {"replayed_steps": replayed, "mismatched": mismatched, "missing": missing,
                   "match": match}


@pytest.mark.parametrize("recipe, replayed", [("full", [5500, 6000, 6500]), ("flip", [])])
def test_endurance_probe_reports_replay_equal(recipe, replayed):
    """The committed full-length reports: the killed trainer's records past
    the checkpoint it was resumed from equal the resumed trainer's."""
    with open(os.path.join(REPO, "probes", f"endurance_torch_{recipe}.json")) as f:
        report = json.load(f)
    got = ec.replay_check(report["history"], report["events"])
    assert got["match"] and got["replayed_steps"] == replayed, got
    assert report["bitexact_resume"] and report["all_losses_finite"]


def test_endurance_report_has_the_jax_reports_keys(endurance_report):
    report, _ = endurance_report
    want = {"config", "wall_s_train", "wall_s_total", "events", "resumes", "final",
            "comparator", "bitexact_resume", "all_losses_finite", "final_miou", "history"}
    assert want <= set(report)
    assert report["config"]["device_augment"] == json.loads(json.dumps(syn.AUGMENT_CONFIGS["full"]))
    assert report["config"]["label_noise_carrier"] == "device_post_augment"
    assert report["config"]["device"] == "cpu"
    # the CPU takes the kernels' plain twins, which count no launch
    assert set(report["final"]["launches"].values()) == {0}
    steps = [r["global_step"] for r in report["history"]]
    assert steps[-1] == 8 and all("eval_mean_iou" in r for r in report["history"])


def test_endurance_fingerprint_is_the_checkpoints(tmp_path):
    """A model's fingerprint before a save equals the restored model's,
    whose optimizer state is still staged on the host."""
    model = FCN8s(num_classes=6, width_mult=1 / 16, fc_channels=64, device="cpu")
    images, labels = syn.synth_batch(np.random.default_rng(2), 2, 32, 32)
    model.train(iter([(images, labels)] * 2), epochs=1, steps_per_epoch=2,
                learning_rate_schedule=lambda s: 1e-3, keep_prob=0.5, record_summaries=False,
                ema_decay=0.99)
    want = ec.fingerprint(model)
    restored = FCN8s(model_load_dir=model.save(str(tmp_path)), device="cpu")
    assert restored.state.opt_state is None and restored._staged_opt_state is not None
    assert ec.fingerprint(restored) == want
    fresh = FCN8s(num_classes=6, width_mult=1 / 16, fc_channels=64, device="cpu")
    assert ec.fingerprint(fresh) != want
