"""PyTorch port, the two training observers (``early_stopping``,
``reduce_lr_on_plateau``) against the JAX package on the CPU.

The observer cases of tests/test_engine.py, on the port, and each run
beside the JAX facade on the same setup: the train log's per-epoch learning
rates and the number of steps taken must be equal. The setups use lr=0 (a
constant loss) or ``min_delta=10`` (every observation stale), so the
decisions do not depend on numerics. The counters cross between the
packages in checkpoints (``train_observer``) and are continued by the first
``train`` after a restore only.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.schedules import constant  # noqa: E402

C = 3
SMALL = dict(width_mult=1 / 32, fc_channels=32)
PLATEAU = {"patience": 2, "factor": 0.5, "min_delta": 10.0}


def _batch():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, size=(2, 32, 64, 3), dtype=np.uint8)
    labels = np.zeros((2, 32, 64), np.uint8)
    labels[:, :, 21:42] = 1
    labels[:, :, 42:] = 2
    return images, labels


def _repeat():
    images, labels = _batch()
    while True:
        yield images, labels


def _port():
    return FCN8s(num_classes=C, compute_dtype=torch.float32, device="cpu", **SMALL)


def _kw(epochs, steps, lr, log, **kw):
    return dict(train_generator=_repeat(), epochs=epochs, steps_per_epoch=steps,
                learning_rate_schedule=constant(lr), keep_prob=1.0, record_summaries=False,
                train_log=str(log), **{"eval_frequency": None, **kw})


def _lrs(log):
    return [json.loads(line)["learning_rate"] for line in open(log)]


@pytest.fixture(scope="module")
def jax_model():
    return JFCN8s(num_classes=C, compute_dtype=jnp.float32, **SMALL)


def _run_both(jax_model, tmp_path, name, model=None, **kw):
    """The same ``train`` call on a port model (fresh unless given) and the
    JAX model; returns (port LRs, JAX LRs, port steps, JAX steps taken)."""
    model = model or _port()
    jstart = int(jax_model.state.step)
    tstart = int(model.state.step)
    jax_model.train(**_kw(log=tmp_path / f"{name}_jax.jsonl", **kw))
    model.train(**_kw(log=tmp_path / f"{name}_port.jsonl", **kw))
    return (_lrs(tmp_path / f"{name}_port.jsonl"), _lrs(tmp_path / f"{name}_jax.jsonl"),
            int(model.state.step) - tstart, int(jax_model.state.step) - jstart)


def test_early_stopping_on_training_loss(jax_model, tmp_path):
    """lr=0: every epoch's loss is the first's; patience=2 stops after
    epoch 3 of 10."""
    t_lrs, j_lrs, t_steps, j_steps = _run_both(jax_model, tmp_path, "es", epochs=10, steps=2,
                                               lr=0.0, early_stopping=2)
    assert t_steps == j_steps == 3 * 2
    assert t_lrs == j_lrs == [0.0] * 3


def test_early_stopping_eval_metric_and_min_delta(jax_model, tmp_path):
    """monitor='mean_iou', evaluated every epoch; lr=0 freezes it, so
    patience=1 with min_delta 0.5 stops at the second evaluation."""
    t_lrs, j_lrs, t_steps, j_steps = _run_both(
        jax_model, tmp_path, "es_eval", epochs=10, steps=2, lr=0.0, metrics={"mean_iou"},
        monitor="mean_iou", eval_frequency=1, eval_dataset="train",
        early_stopping={"patience": 1, "min_delta": 0.5})
    assert t_steps == j_steps == 2 * 2
    assert t_lrs == j_lrs


def test_early_stopping_validation():
    model = _port()
    common = dict(train_generator=_repeat(), epochs=1, steps_per_epoch=1,
                  learning_rate_schedule=constant(0.0), record_summaries=False,
                  eval_frequency=None)
    with pytest.raises(ValueError, match="patience must be >= 1"):
        model.train(early_stopping=0, **common)
    with pytest.raises(ValueError, match="unknown early_stopping keys"):
        model.train(early_stopping={"patience": 2, "typo": 1}, **common)
    with pytest.raises(ValueError, match="requires metrics"):
        model.train(early_stopping=2, monitor="mean_iou", metrics={"mean_iou"}, **common)
    model.close()


def test_reduce_lr_on_plateau(jax_model, tmp_path):
    """min_delta=10: patience=2/factor=0.5 halves the LR after epochs 3 and
    5; with min_lr the reduction is floored."""
    t_lrs, j_lrs, _, _ = _run_both(jax_model, tmp_path, "rp", epochs=6, steps=1, lr=1e-3,
                                   reduce_lr_on_plateau=PLATEAU)
    assert t_lrs == j_lrs
    np.testing.assert_allclose(t_lrs, [1e-3, 1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4])
    t_lrs, j_lrs, _, _ = _run_both(
        jax_model, tmp_path, "rp_min", epochs=4, steps=1, lr=1e-3,
        reduce_lr_on_plateau={"patience": 1, "factor": 0.5, "min_delta": 10.0, "min_lr": 6e-4})
    assert t_lrs == j_lrs
    np.testing.assert_allclose(t_lrs, [1e-3, 1e-3, 6e-4, 6e-4])

    model = _port()
    with pytest.raises(ValueError, match="factor must be in"):
        model.train(**_kw(1, 1, 1e-3, tmp_path / "x", reduce_lr_on_plateau={"patience": 1,
                                                                           "factor": 1.5}))
    with pytest.raises(ValueError, match="unknown reduce_lr_on_plateau"):
        model.train(**_kw(1, 1, 1e-3, tmp_path / "x", reduce_lr_on_plateau={"patience": 1,
                                                                           "cooldown": 2}))


def test_plateau_min_lr_does_not_floor_base_schedule(jax_model, tmp_path):
    t_lrs, j_lrs, _, _ = _run_both(jax_model, tmp_path, "floor", epochs=2, steps=1, lr=1e-6,
                                   reduce_lr_on_plateau={"patience": 10, "min_lr": 1e-4})
    assert t_lrs == j_lrs
    np.testing.assert_allclose(t_lrs, [1e-6, 1e-6])


def test_plateau_state_resumes_from_checkpoint(tmp_path):
    """Cumulative LR scale and stall counters ride the checkpoint: the first
    train() after resume continues them, the next starts fresh."""
    model = _port()
    model.train(**_kw(6, 1, 1e-3, tmp_path / "a.jsonl", reduce_lr_on_plateau=PLATEAU))
    assert model._observer_state["lr_scale"] == pytest.approx(0.25)
    model.save(str(tmp_path / "ck"), force_save=True)
    resumed = FCN8s.resume(str(tmp_path / "ck"), device="cpu")
    resumed.train(**_kw(2, 1, 1e-3, tmp_path / "r.jsonl", reduce_lr_on_plateau=PLATEAU))
    np.testing.assert_allclose(_lrs(tmp_path / "r.jsonl"), [2.5e-4, 1.25e-4])
    resumed.train(**_kw(1, 1, 1e-3, tmp_path / "f.jsonl", reduce_lr_on_plateau=PLATEAU))
    np.testing.assert_allclose(_lrs(tmp_path / "f.jsonl"), [1e-3])
    resumed.close()
    model.close()


def test_in_training_save_carries_current_epoch_observer_state(tmp_path):
    """The checkpoint saved on the epoch the plateau fires carries the
    post-fire state, so the resumed run's first epoch trains at the LR the
    uninterrupted run would use next."""
    save_dir = str(tmp_path / "ckpts")
    model = _port()
    model.train(**_kw(3, 1, 1e-3, tmp_path / "a.jsonl", reduce_lr_on_plateau=PLATEAU,
                      save_during_training=True, save_dir=save_dir, save_best_only=False,
                      save_frequency=1))
    resumed = FCN8s.resume(save_dir, device="cpu")
    staged = resumed._observer_pending
    assert staged["lr_scale"] == pytest.approx(0.5) and staged["rp_stale"] == 0
    resumed.train(**_kw(1, 1, 1e-3, tmp_path / "r.jsonl", reduce_lr_on_plateau=PLATEAU))
    np.testing.assert_allclose(_lrs(tmp_path / "r.jsonl"), [5e-4])
    resumed.close()
    model.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_observer_counters_cross_packages_and_continue(jax_model, tmp_path, writer):
    """Six epochs under both observers (min_delta 10: every observation
    after the first is stale) in one package, saved; each package restores
    the counters (lr_scale 0.25, rp_stale 1, es_stale 5) and its first
    train() continues them: epochs at 2.5e-4, then 1.25e-4 (the plateau
    fires again), and early stopping at patience 7 stops after the second
    epoch. The next train() starts fresh."""
    stale = {"min_delta": 10.0}
    first = jax_model if writer == "jax" else _port()
    first.train(**_kw(6, 1, 1e-3, tmp_path / "w.jsonl", reduce_lr_on_plateau=PLATEAU,
                      early_stopping={"patience": 10, **stale}))
    path = first.save(str(tmp_path / "ck"), force_save=True)
    want = dict(first._observer_state)
    assert want["lr_scale"] == pytest.approx(0.25) and want["rp_stale"] == 1
    assert want["es_stale"] == 5
    runs = []
    for i, reader in enumerate([FCN8s(model_load_dir=path, device="cpu"),
                                JFCN8s(model_load_dir=path)]):
        assert reader._observer_pending == want
        start = int(reader.state.step)
        reader.train(**_kw(6, 1, 1e-3, tmp_path / f"r{i}.jsonl", reduce_lr_on_plateau=PLATEAU,
                           early_stopping={"patience": 7, **stale}))
        runs.append((_lrs(tmp_path / f"r{i}.jsonl"), int(reader.state.step) - start))
        reader.train(**_kw(1, 1, 1e-3, tmp_path / f"f{i}.jsonl", reduce_lr_on_plateau=PLATEAU))
        assert _lrs(tmp_path / f"f{i}.jsonl") == [1e-3]
    assert runs[0] == runs[1]
    np.testing.assert_allclose(runs[0][0], [2.5e-4, 1.25e-4])
    assert runs[0][1] == 2
