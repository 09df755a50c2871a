"""PyTorch port, the VGG-16 weight import without the JAX package
(``models/import_vgg16.py``) against ``tools/import_vgg16.py``'s torch path.

Nothing is downloaded: a synthetic state dict with torchvision's key names
and full VGG-16 shapes (the pattern of ``tests/test_weight_import.py``),
seeded. The port's CLI and the JAX tool write the same checkpoint byte for
byte, and ``FCN8s(vgg16_dir=...)`` of each package loads that encoder.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models import import_vgg16 as tport  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models.vgg16 import VGG16_CONV_LAYERS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import import_vgg16
    finally:
        sys.path.pop(0)
    return import_vgg16


def _state_dict(seed=7) -> dict:
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 0.01)

    sd = {}
    for (_, in_ch, out_ch), idx in zip(VGG16_CONV_LAYERS, tport._TORCH_FEATURE_IDX):
        sd[f"features.{idx}.weight"] = normal(out_ch, in_ch, 3, 3)
        sd[f"features.{idx}.bias"] = normal(out_ch)
    sd["classifier.0.weight"] = normal(4096, 512 * 7 * 7)
    sd["classifier.0.bias"] = normal(4096)
    sd["classifier.3.weight"] = normal(4096, 4096)
    sd["classifier.3.bias"] = normal(4096)
    return sd


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """The same state dict through the port's CLI and through the JAX tool."""
    root = tmp_path_factory.mktemp("vgg")
    sd_path = str(root / "vgg16.pth")
    torch.save(_state_dict(), sd_path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-m", "fcn8s_tensorflow_tpu_torch.models.import_vgg16",
                           "--torch-state-dict", sd_path, "--out", str(root / "port")],
                          cwd=str(root), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_params = sum(t.numel() for t in torch.load(sd_path).values())
    assert proc.stdout.strip().endswith(f"({n_params / 1e6:.1f}M params)"), proc.stdout
    _jax_tool().main(["--torch-state-dict", sd_path, "--out", str(root / "jax")])
    return root, sd_path


def test_cli_writes_the_jax_tools_checkpoint_byte_for_byte(imported):
    root, _ = imported
    for name in ("checkpoint.msgpack", "metadata.json"):
        with open(root / "port" / name, "rb") as f, open(root / "jax" / name, "rb") as g:
            assert f.read() == g.read(), name


def test_conversion_matches_the_jax_tool_and_folds_the_preprocessing(imported):
    _, sd_path = imported
    sd = torch.load(sd_path)
    got = tport.from_torch_state_dict(sd)
    want = _jax_tool().from_torch_state_dict(sd)
    assert got.keys() == want.keys()
    for name in want:
        for key in ("kernel", "bias"):
            assert got[name][key].dtype == np.float32
            np.testing.assert_array_equal(got[name][key], want[name][key], err_msg=name)
    # conv1_2 is a pure layout change; conv1_1 carries the /255, mean and std
    w = sd["features.2.weight"].numpy()
    np.testing.assert_array_equal(got["conv1_2"]["kernel"][1, 2], w[:, :, 1, 2].T)
    a = 1.0 / (255.0 * np.asarray(tport.TORCH_IMAGENET_STD, np.float32))
    np.testing.assert_allclose(got["conv1_1"]["kernel"],
                               sd["features.0.weight"].numpy().transpose(2, 3, 1, 0)
                               * a[None, None, :, None], rtol=1e-6)


def test_shape_checks_are_the_jax_tools():
    kernels = {name: np.zeros((3, 3, i, o), np.float32) for name, i, o in VGG16_CONV_LAYERS}
    biases = {name: np.zeros(o, np.float32) for name, _, o in VGG16_CONV_LAYERS}
    kernels["fc6"], biases["fc6"] = np.zeros((7, 7, 512, 4096), np.float32), np.zeros(4096)
    kernels["fc7"], biases["fc7"] = np.zeros((1, 1, 4096, 2048), np.float32), np.zeros(2048)
    tool = _jax_tool()
    with pytest.raises(ValueError) as want:
        tool._as_encoder_tree(kernels, biases)
    with pytest.raises(ValueError) as got:
        tport._as_encoder_tree(kernels, biases)
    assert str(got.value) == str(want.value)


def test_vgg16_dir_loads_the_same_encoder_in_both_packages(imported):
    import jax
    from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s

    root, _ = imported
    path = str(root / "port")
    model = FCN8s(num_classes=3, vgg16_dir=path, device="cpu")
    got = bridge.to_numpy(model.params)["encoder"]
    model.close()
    jm = JFCN8s(num_classes=3, vgg16_dir=path)
    want = jax.tree.map(np.asarray, jm.state.params["encoder"])
    jm.close()
    for name in want:
        for key in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][key], want[name][key], err_msg=name)
