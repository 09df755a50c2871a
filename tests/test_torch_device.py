"""PyTorch port: the facade's device and the CE kernels' tiling, on the CPU.

The facade and the metrics state run on the card unless the caller asks for
the CPU: without a card their default raises and names ``device="cpu"``;
they never carry on on the host. The CE kernels' tile and grid are a function of the shape and
dtype alone, which is what keeps K1's and K3's sums identical from run to
run.
"""

import pytest

torch = pytest.importorskip("torch")

from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import kernels as K  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.metrics import empty_metrics_state  # noqa: E402

SMALL = dict(width_mult=1 / 32, fc_channels=32, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A narrow CPU model saved once: (its JAX-layout numpy tree, the save
    directory, the checkpoint path)."""
    model = FCN8s(num_classes=3, device="cpu", **SMALL)
    root = str(tmp_path_factory.mktemp("device_ckpt"))
    path = model.save(root, force_save=True)
    return bridge.to_numpy(model.params), root, path


BUILDERS = {
    "FCN8s": lambda saved, **kw: FCN8s(num_classes=3, **SMALL, **kw),
    "from_params": lambda saved, **kw: FCN8s.from_params(saved[0], **SMALL, **kw),
    "model_load_dir": lambda saved, **kw: FCN8s(model_load_dir=saved[2], **kw),
    "resume": lambda saved, **kw: FCN8s.resume(saved[1], **kw),
}


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_default_device_without_a_card_raises_and_names_cpu(builder, saved, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        BUILDERS[builder](saved)


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_explicit_cpu_builds_a_model_on_the_cpu(builder, saved, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = BUILDERS[builder](saved, device="cpu")
    assert model.device == torch.device("cpu")
    leaves = bridge.param_leaves(model.params) + bridge.param_leaves(model._run_params)
    assert all(t.device.type == "cpu" for t in leaves)


def test_facade_entry_points_default_to_cuda():
    import inspect

    for fn in (FCN8s.__init__, FCN8s.from_params, empty_metrics_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_metrics_state_without_a_card_raises_and_names_cpu(monkeypatch):
    """The JAX call ``empty_metrics_state(C)`` builds on the default device:
    here the card, and without one it raises instead of building a CPU
    state that the card's eval step could not add to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        empty_metrics_state(4)


def test_metrics_state_on_the_cpu_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = empty_metrics_state(4, device="cpu")
    assert all(t.device.type == "cpu" for t in state.values())
    assert state["conf_matrix"].shape == (4, 4) and state["conf_matrix"].dtype == torch.int32
    assert not state["conf_matrix"].any() and float(state["loss_count"]) == 0.0


@pytest.mark.parametrize("c,dtype,rows", [(20, torch.bfloat16, 512), (20, torch.float32, 256),
                                          (3, torch.bfloat16, 1024), (150, torch.float32, 32),
                                          (150, torch.bfloat16, 64)])
def test_ce_tiling_is_a_function_of_shape_and_dtype(c, dtype, rows):
    """Whole 16-row multiples (every tile of bf16/fp32 logits and of
    uint8/int32 labels starts on a 16-byte line), at most the tile budget
    unless one 16-row step exceeds it, and the same answer on every call."""
    for p in (1, 15, 4096 * 3 + 7, 8 * 1024 * 512, 2**32 // c):
        got = K.ce_tiling(p, c, dtype)
        assert got == K.ce_tiling(p, c, dtype)
        assert got[0] == rows and rows % 16 == 0
        assert rows * c * dtype.itemsize <= max(K._CE_TILE_BYTES, 16 * c * dtype.itemsize)
        assert got[1] == min(-(-p // rows), K._CE_MAX_BLOCKS)
