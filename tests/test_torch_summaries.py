"""PyTorch port, TensorBoard summaries (``engine/summaries.py`` and
``train(record_summaries=True, ...)``) against the JAX package on the CPU.

Both packages train the same narrow fp32 model (one JAX param tree) for 2
epochs x 2 steps at keep_prob 1 with ``summaries_frequency=1`` and an
evaluation every epoch; their event files are read back with
``tensorboard``'s ``event_accumulator``. They must hold the same tags at the
same steps. Tolerances:

* at lr 0 the weights never move, so the weight histograms see the same
  values: ``min``/``max``/``num`` exact, ``sum`` within rtol 1e-5 (the
  sample's summation order); scalars within rtol 1e-5 (each package's own
  fp32 reductions), with 1e-7 of absolute slack for a mean that cancels to
  about zero;
* at lr 1e-3 the two packages' params differ by their gradients' rounding
  (tests/test_torch_train.py), so there the losses and learning rates are
  held (rtol 1e-5) and the histograms only by ``num`` and by min/max within
  4 lr-sized Adam steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tensorboard.backend.event_processing import event_accumulator  # noqa: E402

from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s  # noqa: E402
from fcn8s_tensorflow_tpu.models.fcn8s import init_fcn8s as j_init  # noqa: E402
from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine import summaries as tsum  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402

C = 3
SMALL = dict(width_mult=1 / 32, fc_channels=32)


def _tree():
    return jax.tree.map(np.array, jax.jit(lambda k: j_init(k, C, **SMALL))(jax.random.PRNGKey(3)))


def _repeat():
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (2, 32, 64, 3), dtype=np.uint8)
    labels = rng.integers(0, C, (2, 32, 64)).astype(np.uint8)
    while True:
        yield images, labels


def _read(directory):
    acc = event_accumulator.EventAccumulator(str(directory), size_guidance={
        event_accumulator.SCALARS: 0, event_accumulator.HISTOGRAMS: 0})
    acc.Reload()
    scalars = {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}
    hists = {tag: [(e.step, e.histogram_value) for e in acc.Histograms(tag)]
             for tag in acc.Tags()["histograms"]}
    return scalars, hists


@pytest.fixture(scope="module")
def event_files(tmp_path_factory):
    """{lr: {package: root}}: both packages' summaries at lr 0 and 1e-3."""
    tree = _tree()
    jm = JFCN8s(num_classes=C, compute_dtype=jnp.float32, **SMALL)
    jm.state = jm.state._replace(params=jax.tree.map(jnp.asarray, tree))
    tm = FCN8s.from_params(tree, compute_dtype=torch.float32, device="cpu", **SMALL)
    out = {}
    for lr in (0.0, 1e-3):
        out[lr] = {}
        for name, model in (("jax", jm), ("port", tm)):
            root = tmp_path_factory.mktemp(f"{name}_{lr}")
            model.train(_repeat(), epochs=2, steps_per_epoch=2,
                        learning_rate_schedule=lambda s, lr=lr: lr, keep_prob=1.0,
                        metrics={"loss", "mean_iou", "accuracy"}, eval_frequency=1,
                        summaries_frequency=1, summaries_dir=str(root), summaries_name="run")
            # the JAX facade replaces its logger on the next train() without
            # closing it, and tensorboardX may hold events until the close
            model._summary_logger.close()
            out[lr][name] = root
    return out


@pytest.mark.parametrize("stream", ["training", "evaluation"])
def test_streams_hold_jax_tags_and_steps(event_files, stream):
    jax_s, jax_h = _read(event_files[0.0]["jax"] / f"run_{stream}")
    port_s, port_h = _read(event_files[0.0]["port"] / f"run_{stream}")
    assert sorted(port_s) == sorted(jax_s) and sorted(port_h) == sorted(jax_h)
    assert jax_s  # the streams are not empty
    for tag in jax_s:
        assert [s for s, _ in port_s[tag]] == [s for s, _ in jax_s[tag]], tag
    for tag in jax_h:
        assert [s for s, _ in port_h[tag]] == [s for s, _ in jax_h[tag]], tag
    if stream == "training":
        assert [s for s, _ in jax_s["total_loss"]] == [1, 2, 3, 4]
        assert len(jax_h) == 2 * len(tsum.DEFAULT_INSTRUMENTED)
        assert [s for s, _ in jax_h["encoder/fc6/kernel/histogram"]] == [2, 4]
    else:
        assert sorted(jax_s) == ["accuracy", "loss", "mean_iou"]


@pytest.mark.parametrize("stream", ["training", "evaluation"])
def test_values_match_jax_when_the_weights_stay(event_files, stream):
    jax_s, jax_h = _read(event_files[0.0]["jax"] / f"run_{stream}")
    port_s, port_h = _read(event_files[0.0]["port"] / f"run_{stream}")
    for tag, events in jax_s.items():
        np.testing.assert_allclose([v for _, v in port_s[tag]], [v for _, v in events],
                                   rtol=1e-5, atol=1e-7, err_msg=tag)
    for tag, events in jax_h.items():
        for (_, got), (_, want) in zip(port_h[tag], events):
            assert (got.min, got.max, got.num) == (want.min, want.max, want.num), tag
            np.testing.assert_allclose(got.sum, want.sum, rtol=1e-5, atol=1e-7, err_msg=tag)
            assert list(got.bucket_limit) == list(want.bucket_limit), tag
            assert list(got.bucket) == list(want.bucket), tag


def test_losses_and_rates_match_jax_while_training(event_files):
    jax_s, jax_h = _read(event_files[1e-3]["jax"] / "run_training")
    port_s, port_h = _read(event_files[1e-3]["port"] / "run_training")
    for tag in ("total_loss", "learning_rate"):
        np.testing.assert_allclose([v for _, v in port_s[tag]], [v for _, v in jax_s[tag]],
                                   rtol=1e-5, err_msg=tag)
    assert [v for _, v in port_s["learning_rate"]] == pytest.approx([1e-3] * 4)
    for tag, events in jax_h.items():
        for (_, got), (_, want) in zip(port_h[tag], events):
            assert got.num == want.num, tag
            assert abs(got.min - want.min) <= 8e-3 and abs(got.max - want.max) <= 8e-3, tag


def test_summary_stats_sample_in_jax_layout():
    """A conv kernel (OIHW in the port) is sampled in its JAX (HWIO) order,
    every numel // 65536-th element, without copying the leaf."""
    rng = np.random.default_rng(0)
    hwio = rng.normal(size=(7, 7, 40, 48)).astype(np.float32)  # 94080 > 65536
    port = bridge.to_port({"encoder": {"fc6": {"kernel": hwio, "bias": np.zeros(48, np.float32)}}})
    view = bridge.leaf_to_jax(port["encoder"]["fc6"]["weight"], "encoder/fc6/kernel")
    stats, sample = tsum.summary_stats(view)
    np.testing.assert_array_equal(sample, hwio.reshape(-1)[::1])  # stride 94080 // 65536 = 1
    big = rng.normal(size=(3, 3, 128, 256)).astype(np.float32)  # 294912: stride 4
    view = torch.from_numpy(big).permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    stats, sample = tsum.summary_stats(view)
    np.testing.assert_array_equal(sample, big.reshape(-1)[::4])
    np.testing.assert_allclose(stats, [big.mean(), big.std(), big.min(), big.max()], rtol=1e-5)


def test_record_summaries_requires_dir():
    model = FCN8s(num_classes=C, compute_dtype=torch.float32, device="cpu", **SMALL)
    with pytest.raises(ValueError, match="summaries_dir"):
        model.train(_repeat(), 1, 1, lambda s: 1e-4)


def test_summary_stats_pull_one_copy_per_leaf(monkeypatch):
    """The statistics and the sample leave the device in one copy of 4 +
    min(numel, 65536) floats (on the CPU the copy is free, but it is the
    same one call)."""
    x = torch.randn(7, 7, 64, 128).permute(3, 2, 0, 1)  # 401408 elements, stride 6
    pulled = []
    real_cpu = torch.Tensor.cpu

    def spy(t, *a, **k):
        pulled.append(t.numel())
        return real_cpu(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    _, sample = tsum.summary_stats(x)
    monkeypatch.undo()
    assert pulled == [4 + sample.size] and sample.size == -(-x.numel() // 6)
