"""PyTorch port, the example scripts against the JAX package's on the CPU
(``fcn8s_tensorflow_tpu_torch/examples`` against ``examples/``), on a
seeded synthetic Cityscapes tree (64x128 frames, labelIds 0-33 in blocks):

* ``offline_preprocessing``: the PNG mirror and ``--packed`` write the JAX
  script's files byte for byte;
* ``benchmark_submission`` from one checkpoint, which both packages load
  (fp32, a narrow model with its decoder redrawn at unit fan-in scale): the
  same labelId PNGs wherever JAX's softmax top-2 margin exceeds ``MARGIN``,
  and the scorer's confusion matrix within two counts of each pixel whose
  id differs (the same report byte for byte where none does);
* ``serve_results`` writes the JAX script's layer files byte for byte;
* ``quickstart_synthetic``, ``train_cityscapes`` and ``train_kitti`` run
  1-2 steps with ``--device cpu`` (narrow models, one JAX device) and
  write the JAX scripts' set of files (names with losses, metrics and
  event-file stamps normalised);
* ``train_cityscapes`` under ``torch.distributed.run`` with
  ``--tensor-parallel``: two gloo ranks on a (1, 2) mesh;
* every script defaults to ``--device cuda`` and, without a card, raises
  naming ``--device cpu``.
"""

import functools
import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import fcn8s_tensorflow_tpu_torch  # noqa: E402
from fcn8s_tensorflow_tpu.engine import model as jmodel  # noqa: E402
from fcn8s_tensorflow_tpu.models.fcn8s import init_fcn8s as j_init  # noqa: E402
from fcn8s_tensorflow_tpu.parallel.mesh import create_mesh  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.examples import (benchmark_submission, offline_preprocessing,  # noqa: E402
                                                 quickstart_synthetic, serve_results,
                                                 train_cityscapes, train_kitti)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = (64, 128)
SMALL = dict(width_mult=1 / 32, fc_channels=32)
MARGIN = 1e-4  # of JAX's fp32 softmax, top-1 minus top-2
SPLITS = {"train": ("aachen",), "val": ("bonn", "koeln")}
PORT_SCRIPTS = {"quickstart_synthetic": (quickstart_synthetic, []),
                "train_cityscapes": (train_cityscapes, ["--dataset", "x"]),
                "train_kitti": (train_kitti, ["--dataset", "x"]),
                "offline_preprocessing": (offline_preprocessing, ["--dataset", "x",
                                                                  "--export", "y"]),
                "benchmark_submission": (benchmark_submission, ["--checkpoint", "c",
                                                                "--dataset", "x"]),
                "serve_results": (serve_results, ["--root", "x"])}


def _write_cityscapes(root, rng):
    """leftImg8bit/<split>/<city>/*_leftImg8bit.png and gtFine labelIds and
    instanceIds, two frames a city, piecewise-smooth images."""
    h, w = FRAME
    for split, cities in SPLITS.items():
        for city in cities:
            img_dir = root / "leftImg8bit" / split / city
            gt_dir = root / "gtFine" / split / city
            img_dir.mkdir(parents=True)
            gt_dir.mkdir(parents=True)
            for i in range(2):
                stem = f"{city}_{i:06d}_000019"
                base = rng.integers(0, 256, (8, 16, 3)).astype(np.int16)
                img = np.repeat(np.repeat(base, 8, 0), 8, 1)
                img = np.clip(img + rng.integers(-6, 7, img.shape), 0, 255).astype(np.uint8)
                Image.fromarray(img).save(img_dir / f"{stem}_leftImg8bit.png")
                ids = np.repeat(np.repeat(rng.integers(0, 34, (8, 16)), 8, 0), 8, 1)
                Image.fromarray(ids.astype(np.uint8)).save(gt_dir / f"{stem}_gtFine_labelIds.png")
                inst = ids.astype(np.uint16)  # ids < 1000: no instances, the class id
                inst[:32, :32][ids[:32, :32] == 26] = 26001  # a car instance where cars are
                Image.fromarray(inst).save(gt_dir / f"{stem}_gtFine_instanceIds.png")
    return root


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    return _write_cityscapes(tmp_path_factory.mktemp("cityscapes"), np.random.default_rng(5))


def _jax_script(name):
    """The JAX package's ``examples/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(monkeypatch, name, argv, mod=None):
    mod = mod or _jax_script(name)
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    mod.main()


def _files(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _names(root) -> set:
    """The relative paths under ``root`` with run-specific numbers
    normalised: a checkpoint's step, loss and metrics, an event file's
    stamp."""
    out = set()
    for path in _files(root):
        path = re.sub(r"\((\w+)-[-+.0-9e]+\)", r"(\1-N)", path)
        path = re.sub(r"events\.out\.tfevents\.[^/]*$", "events.out.tfevents", path)
        out.add(path)
    return out


def _one_device_jax(cls, **fixed):
    """A JAX facade subclass on one CPU device, with ``fixed`` kwargs."""
    class OneDevice(cls):
        def __init__(self, *args, **kw):
            kw.setdefault("mesh", create_mesh(data=1, model=1, devices=jax.devices()[:1]))
            super().__init__(*args, **{**kw, **fixed})

    return OneDevice


def _narrow_port(**fixed):
    class Narrow(FCN8s):
        def __init__(self, *args, **kw):
            super().__init__(*args, **{**kw, **fixed})

    return Narrow


# ---------------------------------------------------------------------------
# --device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PORT_SCRIPTS))
def test_script_defaults_to_the_card_and_names_device_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, argv = PORT_SCRIPTS[name]
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(argv)


# ---------------------------------------------------------------------------
# offline preprocessing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True], ids=["png mirror", "packed"])
def test_offline_preprocessing_writes_the_jax_files(cityscapes, tmp_path, monkeypatch, packed):
    args = ["--dataset", cityscapes, "--resolution", "32", "64"] + (["--packed"] if packed else [])
    _run_jax(monkeypatch, "offline_preprocessing", args + ["--export", tmp_path / "jax"])
    offline_preprocessing.main([str(a) for a in args]
                               + ["--export", str(tmp_path / "port"), "--device", "cpu"])
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(want) >= (6 if packed else 12)
    for path, data in want.items():
        assert got[path] == data, path


# ---------------------------------------------------------------------------
# benchmark submission and the viewer
# ---------------------------------------------------------------------------


@functools.cache
def _tree():
    """JAX-initialised numpy weights (20 classes), the decoder redrawn at
    unit fan-in scale (O(1) logits, so ids have margins)."""
    init = jax.jit(lambda key: j_init(key, 20, **SMALL))
    tree = jax.tree.map(np.array, init(jax.random.PRNGKey(8)))
    rng = np.random.default_rng(8)
    for layer in tree["decoder"].values():
        k = layer["kernel"]
        layer["kernel"] = (rng.normal(size=k.shape) / np.sqrt(np.prod(k.shape[:-1]))).astype(
            np.float32)
        layer["bias"] = rng.normal(size=layer["bias"].shape).astype(np.float32) * 0.1
    return tree


@pytest.fixture(scope="module")
def submissions(cityscapes, tmp_path_factory):
    """One fp32 checkpoint through both scripts: (results dirs, checkpoint)."""
    root = tmp_path_factory.mktemp("submission")
    model = FCN8s.from_params(_tree(), device="cpu", compute_dtype=torch.float32, **SMALL)
    ckpt = model.save(str(root / "ckpts"), force_save=True)
    model.close()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jmodel, "FCN8s", _one_device_jax(jmodel.FCN8s))
        _run_jax(mp, "benchmark_submission", ["--checkpoint", ckpt, "--dataset", cityscapes,
                                              "--results", root / "jax", "--batch-size", 2])
    finally:
        mp.undo()
    benchmark_submission.main(["--checkpoint", ckpt, "--dataset", str(cityscapes), "--results",
                               str(root / "port"), "--batch-size", "2", "--device", "cpu"])
    return root, ckpt


def test_benchmark_submission_equals_the_jax_scripts(submissions, cityscapes):
    root, _ = submissions
    want, got = _files(root / "jax"), _files(root / "port")
    assert sorted(got) == sorted(want)
    pngs = sorted(p for p in want if p.endswith(".png"))
    assert len(pngs) == 4
    jm = _one_device_jax(jmodel.FCN8s, compute_dtype=jnp.float32, **SMALL)(num_classes=20)
    jm.state = jm.state._replace(params=jax.tree.map(jnp.asarray, _tree()))
    unclear = differ = 0
    for png in pngs:
        city = png.split("_")[0]
        img = np.asarray(Image.open(cityscapes / "leftImg8bit" / "val" / city / png))
        top2 = np.sort(jm.predict(img[None], argmax=False)[0], axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > MARGIN
        unclear += int((~clear).sum())
        a = np.asarray(Image.open(root / "jax" / png))
        b = np.asarray(Image.open(root / "port" / png))
        assert a.shape == b.shape == FRAME and a.dtype == b.dtype
        np.testing.assert_array_equal(b[clear], a[clear])
        differ += int((a != b).sum())
    jm.close()
    assert differ <= unclear
    report = [p for p in want if p.endswith(".json")]
    assert report == [os.path.join("_report", "resultPixelLevelSemanticLabeling.json")]
    # each pixel whose id differs moves one count of the scorer's confusion
    # matrix to another cell; where none differs the reports are equal whole
    gap = np.abs(np.array(json.loads(got[report[0]])["confMatrix"])
                 - np.array(json.loads(want[report[0]])["confMatrix"])).sum()
    assert gap <= 2 * differ
    assert differ > 0 or got[report[0]] == want[report[0]]


def test_serve_results_writes_the_jax_layers(submissions, cityscapes, tmp_path, monkeypatch):
    """Over the val split with the submission's labelId PNGs as predictions;
    the server itself is stubbed (each script's last call)."""
    from fcn8s_tensorflow_tpu.viz import serve as jserve
    from fcn8s_tensorflow_tpu_torch.viz import serve as tserve

    served = []
    monkeypatch.setattr(jserve, "serve_viewer", lambda d, **kw: served.append(("jax", d, kw)))
    monkeypatch.setattr(tserve, "serve_viewer", lambda d, **kw: served.append(("port", d, kw)))
    root, _ = submissions
    args = ["--root", cityscapes, "--results", root / "jax", "--max-images", 3, "--port", 8123]
    _run_jax(monkeypatch, "serve_results", args + ["--out", tmp_path / "jax"])
    serve_results.main([str(a) for a in args] + ["--out", str(tmp_path / "port"),
                                                  "--device", "cpu"])
    assert served == [("jax", str(tmp_path / "jax"), {"port": 8123}),
                      ("port", str(tmp_path / "port"), {"port": 8123})]
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(want) > 3
    for path, data in want.items():
        assert got[path] == data, path


# ---------------------------------------------------------------------------
# the training scripts: one or two steps on the CPU
# ---------------------------------------------------------------------------


def test_quickstart_writes_the_jax_files(tmp_path, monkeypatch):
    mod = _jax_script("quickstart_synthetic")
    monkeypatch.setattr(mod, "FCN8s", _one_device_jax(mod.FCN8s))
    _run_jax(monkeypatch, "quickstart_synthetic", ["--steps", 2, "--out", tmp_path / "jax"], mod)
    quickstart_synthetic.main(["--steps", "2", "--out", str(tmp_path / "port"),
                               "--device", "cpu"])
    want, got = _names(tmp_path / "jax"), _names(tmp_path / "port")
    assert got == want
    assert any(p.startswith("predictions") for p in want) and "viewer/index.html" in want
    data = _files(tmp_path / "port")  # the synthetic dataset is the JAX script's, byte for byte
    for path, blob in _files(tmp_path / "jax").items():
        if path.startswith("data"):
            assert data[path] == blob, path


def test_train_cityscapes_writes_the_jax_files(cityscapes, tmp_path, monkeypatch):
    mod = _jax_script("train_cityscapes")
    monkeypatch.setattr(mod, "FCN8s", _one_device_jax(mod.FCN8s, **SMALL))
    monkeypatch.setattr(fcn8s_tensorflow_tpu_torch, "FCN8s", _narrow_port(**SMALL),
                        raising=False)
    args = ["--dataset", cityscapes, "--epochs", 2, "--batch-size", 2, "--ema-decay", 0.9]
    _run_jax(monkeypatch, "train_cityscapes", args + ["--out", tmp_path / "jax"], mod)
    train_cityscapes.main([str(a) for a in args] + ["--out", str(tmp_path / "port"),
                                                     "--device", "cpu"])
    want, got = _names(tmp_path / "jax"), _names(tmp_path / "port")
    assert got == want
    assert "train_log.jsonl" in want and any(p.startswith("checkpoints/") for p in want)
    assert "predictions_video.mp4" in want
    log = [json.loads(line) for line in open(tmp_path / "port" / "train_log.jsonl")]
    assert [r["global_step"] for r in log] == [1, 2] and "eval_mean_iou" in log[-1]


def test_train_kitti_writes_the_jax_files(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    for i in range(2):
        (tmp_path / "kitti" / "image_2").mkdir(parents=True, exist_ok=True)
        (tmp_path / "kitti" / "gt_image_2").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (48, 160, 3), dtype=np.uint8)).save(
            tmp_path / "kitti" / "image_2" / f"um_{i:06d}.png")
        gt = np.zeros((48, 160, 3), np.uint8)
        gt[..., 0] = 255
        gt[24:, :, 2] = 255
        Image.fromarray(gt).save(tmp_path / "kitti" / "gt_image_2" / f"um_road_{i:06d}.png")
    mod = _jax_script("train_kitti")
    monkeypatch.setattr(mod, "FCN8s", _one_device_jax(mod.FCN8s, **SMALL))
    monkeypatch.setattr(fcn8s_tensorflow_tpu_torch, "FCN8s", _narrow_port(**SMALL),
                        raising=False)
    args = ["--dataset", tmp_path / "kitti", "--epochs", 1, "--batch-size", 2,
            "--resolution", 64, 128]
    _run_jax(monkeypatch, "train_kitti", args + ["--out", tmp_path / "jax"], mod)
    train_kitti.main([str(a) for a in args] + ["--out", str(tmp_path / "port"),
                                                "--device", "cpu"])
    want, got = _names(tmp_path / "jax"), _names(tmp_path / "port")
    assert got == want and len([p for p in want if p.startswith("predictions/")]) == 2


def test_train_cityscapes_tensor_parallel_under_torchrun(cityscapes, tmp_path):
    """Two gloo ranks through ``torch.distributed.run``: the script builds
    the (1, 2) mesh with fc6/fc7 sharded, rank 0 writes the outputs."""
    wrapper = tmp_path / "narrow.py"
    wrapper.write_text(
        "import sys\n"
        "import fcn8s_tensorflow_tpu_torch as pkg\n"
        "from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s\n"
        "from fcn8s_tensorflow_tpu_torch.examples import train_cityscapes\n"
        "class Narrow(FCN8s):\n"
        "    def __init__(self, *a, **kw):\n"
        "        super().__init__(*a, **kw, width_mult=1 / 32, fc_channels=32)\n"
        "        assert self.mesh.shape == {'data': 1, 'model': 2} and self._tp\n"
        "pkg.FCN8s = Narrow\n"
        "train_cityscapes.main(sys.argv[1:])\n")
    path = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO] + path), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--standalone", str(wrapper), "--dataset", str(cityscapes), "--epochs", "1",
         "--batch-size", "2", "--tensor-parallel", "--out", str(tmp_path / "out"),
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    log = [json.loads(line) for line in open(tmp_path / "out" / "train_log.jsonl")]
    assert [r["global_step"] for r in log] == [1]
    assert len(os.listdir(tmp_path / "out" / "predictions")) == 2
