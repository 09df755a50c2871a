"""PyTorch port, the multi-process survival tools on the CPU
(``fcn8s_tensorflow_tpu_torch/tools``): gloo groups of ranks, each a
subprocess, as a user runs them.

* fault injection on two ranks, from JAX's ``init_fcn8s(PRNGKey(0), 5,
  width_mult=1/16, fc_channels=64)``: the straight run's final params and
  EMA equal JAX's four steps on the same batches within rtol 1e-5, atol
  1e-6 (fp32; XLA:CPU and oneDNN sum in other orders), the injected death
  is detected by the exit codes (17 and a failed collective), and the
  resumed run equals the straight run byte for byte;
* the multihost smoke on 2 ranks (tensor-parallel), with sharded input
  (disjoint shards covering the epoch, the whole batch's loss on every
  rank), and at JAX's 4-process x 2-device matrix point, 8 ranks on (4, 2),
  each from JAX's ``init_fcn8s(PRNGKey(0), 20, width_mult=1/16,
  fc_channels=64)``, its loss held against JAX's on the same global batch
  (the union of the shards): within rtol 1e-5 of the cross-entropy of JAX's
  logits summed in float64, within rtol 1e-4 of JAX's ``compile_train_step``
  on the same mesh (whose fp32 sum of a position's pixels drifts).
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu_torch.tools import child_env  # noqa: E402
from fcn8s_tensorflow_tpu_torch.tools import multihost_fault_injection as fi  # noqa: E402
from fcn8s_tensorflow_tpu_torch.tools import multihost_smoke as ms  # noqa: E402



def _env(**extra):
    """A child's environment: the tools' own, one thread a process."""
    return dict(child_env(), OMP_NUM_THREADS="1", **extra)


@contextlib.contextmanager
def _one_thread_children():
    """The tools' children (which copy this environment) on one thread each."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old


# ---------------------------------------------------------------------------
# fault injection: two gloo ranks against JAX's four steps
# ---------------------------------------------------------------------------


def _jax_init_tree(num_classes):
    import jax

    from fcn8s_tensorflow_tpu.models.fcn8s import init_fcn8s

    init = jax.jit(lambda key: init_fcn8s(key, num_classes, width_mult=1 / 16,
                                          fc_channels=64))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def _jax_straight_run(tree):
    """The JAX tool's straight run in this process: a 2-position data mesh,
    fp32, the same batches, the EMA seeded at the first step."""
    import jax
    import jax.numpy as jnp

    from fcn8s_tensorflow_tpu.parallel.mesh import batch_sharding, create_mesh
    from fcn8s_tensorflow_tpu.parallel.steps import (compile_train_step, create_train_state,
                                                     make_optimizer)

    mesh = create_mesh(data=2, model=1, devices=jax.devices()[:2])
    optimizer = make_optimizer()
    state = create_train_state(jax.tree.map(jnp.asarray, tree), optimizer)
    step_fn = compile_train_step(mesh, optimizer, fi.NUM_CLASSES, tensor_parallel=False,
                                 compute_dtype=jnp.float32, example_state=state)
    sharding = batch_sharding(mesh)
    ema = None
    for step_i in range(fi.TOTAL_STEPS):
        batch = fi.batch_for(step_i, fi.GLOBAL_BATCH, fi.IMAGE_HW)
        im, lb, mk = (jax.device_put(a, sharding) for a in batch)
        state, _ = step_fn(state, im, lb, mk, jax.random.PRNGKey(7), fi.LEARNING_RATE, 0.0,
                           fi.KEEP_PROB)
        ema = (jax.tree.map(jnp.copy, state.params) if ema is None else
               jax.tree.map(lambda e, p: e * 0.9 + p * 0.1, ema, state.params))
    return jax.tree.map(np.asarray, state.params), jax.tree.map(np.asarray, ema)


@pytest.fixture(scope="module")
def fault_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("fault"))
    tree = _jax_init_tree(fi.NUM_CLASSES)
    with _one_thread_children():
        out = fi.run(work, tree, device="cpu")
    return work, tree, out


def test_fault_injection_straight_run_matches_jax(fault_run):
    work, tree, out = fault_run
    assert out["straight_ok"], out
    want_params, want_ema = _jax_straight_run(tree)
    got = fi.final_leaves(work, "straight")
    n = 0
    for what, want in (("params", want_params), ("ema", want_ema)):
        for part, layers in want.items():
            for name, layer in layers.items():
                for key, value in layer.items():
                    np.testing.assert_allclose(got[f"{what}/{part}/{name}/{key}"], value,
                                               rtol=1e-5, atol=1e-6,
                                               err_msg=f"{what}/{part}/{name}/{key}")
                    n += 1
    assert n == len(got)
    # the EMA is not the params (it was seeded at step 1 and averaged since)
    assert not np.array_equal(got["ema/decoder/fc7_1x1/kernel"],
                              got["params/decoder/fc7_1x1/kernel"])


def test_fault_injection_detects_the_death_by_exit_codes(fault_run):
    _, _, out = fault_run
    assert out["detected"], out["fault_rcs"]
    assert out["fault_rcs"][1] == fi.FAULT_EXIT and out["fault_rcs"][0] != 0
    # the survivor ran steps 0-2 and failed in step 3; the crashed rank stopped before it
    assert len(out["results"]["straight"][0]["losses"]) == fi.TOTAL_STEPS
    assert out["results"]["fault"] == [None, None]


def test_fault_injection_resume_is_bit_exact(fault_run):
    work, _, out = fault_run
    assert out["resume_ok"] and out["bitexact"] and out["ok"], out["differing_leaves"]
    straight, resume = out["results"]["straight"], out["results"]["resume"]
    for rank in range(fi.NUM_PROCESSES):
        assert resume[rank]["losses"] == straight[rank]["losses"][fi.CRASH_AFTER:]
        assert resume[rank]["backend"] == "gloo"
    assert os.path.isfile(os.path.join(work, f"ckpt_step{fi.CRASH_AFTER}", "checkpoint.msgpack"))


def test_fault_injection_cli_without_a_card_raises():
    out = subprocess.run([sys.executable, "-m", fi.__name__], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and 'device="cpu"' in out.stderr


@pytest.mark.parametrize("fn", [fi.run, fi.child, ms.run, ms.child],
                         ids=["fault_run", "fault_child", "smoke_run", "smoke_child"])
def test_tool_entry_points_default_to_the_card(fn):
    import inspect

    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_fault_injection_run_without_a_card_raises_and_names_cpu(tmp_path, monkeypatch):
    """``run``'s default device is the card: without one it raises and
    names ``device="cpu"`` before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fi.run(str(tmp_path / "work"), {})
    assert not os.path.exists(tmp_path / "work")


def test_multihost_smoke_run_without_a_card_raises_and_names_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ms.run(2, workdir=str(tmp_path))
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# the multihost smoke
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_tree():
    return _jax_init_tree(ms.NUM_CLASSES)


@pytest.fixture(scope="module")
def sharded_smoke(smoke_tree, tmp_path_factory):
    return _smoke(2, True, str(tmp_path_factory.mktemp("sharded")), smoke_tree)


def _smoke(ranks, sharded, workdir, tree):
    with _one_thread_children():
        return ms.run(ranks, "cpu", sharded, workdir=workdir, timeout_s=240, params=tree)


def _jax_losses(tree, images, labels, mesh_shape):
    """(JAX's one fp32 tensor-parallel train step (the JAX smoke's) on
    ``mesh_shape`` over this process's CPU devices: its loss; the same
    cross-entropy summed in float64 over JAX's fp32 logits)."""
    import jax
    import jax.numpy as jnp

    from fcn8s_tensorflow_tpu.models.fcn8s import apply_fcn8s
    from fcn8s_tensorflow_tpu.parallel.mesh import batch_sharding, create_mesh
    from fcn8s_tensorflow_tpu.parallel.steps import (compile_train_step, create_train_state,
                                                     make_optimizer)

    logits = np.asarray(apply_fcn8s(jax.tree.map(jnp.asarray, tree), jnp.asarray(images),
                                    compute_dtype=jnp.float32), np.float64)
    top = logits.max(-1)
    lse = np.log(np.exp(logits - top[..., None]).sum(-1)) + top
    pick = np.take_along_axis(logits, labels[..., None].astype(np.int64), -1)[..., 0]
    exact = float((lse - pick).mean())

    data, model = mesh_shape
    mesh = create_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    optimizer = make_optimizer()
    state = create_train_state(jax.tree.map(jnp.asarray, tree), optimizer)
    step = compile_train_step(mesh, optimizer, ms.NUM_CLASSES, tensor_parallel=True,
                              compute_dtype=jnp.float32, example_state=state)
    sharding = batch_sharding(mesh)
    mask = np.ones((len(images),), np.float32)
    im, lb, mk = (jax.device_put(a, sharding) for a in (images, labels, mask))
    _, loss = step(state, im, lb, mk, jax.random.PRNGKey(1), 1e-4, 0.0, 1.0)
    return float(loss), exact


def _assert_jax_loss(losses, tree, images, labels, mesh_shape):
    """Every rank's loss within rtol 1e-5 of JAX's cross-entropy summed in
    float64, and within rtol 1e-4 of JAX's step: XLA:CPU sums a data
    position's 4096-32768 pixel losses in one fp32 reduce, which drifts
    up to 7e-5 from the float64 sum (the port's stays within 1e-7)."""
    step_loss, exact = _jax_losses(tree, images, labels, mesh_shape)
    np.testing.assert_allclose(losses, [exact] * len(losses), rtol=1e-5)
    np.testing.assert_allclose(losses, [step_loss] * len(losses), rtol=1e-4)


@pytest.mark.parametrize("ranks, sharded", [(2, False), (2, True), (8, False)],
                         ids=["2 ranks TP", "2 ranks sharded input", "8 ranks (4, 2)"])
def test_multihost_smoke_ranks_agree(tmp_path, request, smoke_tree, ranks, sharded):
    out = (request.getfixturevalue("sharded_smoke") if sharded
           else _smoke(ranks, sharded, str(tmp_path), smoke_tree))
    assert out["ok"], out["output"]
    assert len(out["losses"]) == ranks and np.isfinite(out["losses"][0])
    assert out["mesh"] == ((ranks, 1) if sharded else (ranks // 2, 2))
    if sharded:
        shards = [set(out["consumed"][r]) for r in range(ranks)]
        assert not shards[0] & shards[1] and shards[0] | shards[1] == set(range(ms.N_IMAGES))
        assert len(shards[0]) == len(shards[1]) == ms.GLOBAL_BATCH // ranks
    else:
        # the global batch every rank drew, through JAX's step on the same mesh
        rng = np.random.default_rng(0)
        images = rng.integers(0, 255, (ms.GLOBAL_BATCH, *ms.IMAGE_HW, 3), np.uint8)
        labels = rng.integers(0, ms.NUM_CLASSES, (ms.GLOBAL_BATCH, *ms.IMAGE_HW), np.uint8)
        _assert_jax_loss(out["losses"], smoke_tree, images, labels, out["mesh"])


def test_multihost_smoke_sharded_loss_is_the_whole_batchs(sharded_smoke, smoke_tree):
    """Each rank feeds only its shard's rows, and every rank's loss is
    JAX's step on the union of the shards (image i: the constant pixel
    i*10 + 5, label i % 20), rank 0's rows first."""
    out = sharded_smoke
    assert out["ok"], out["output"]
    ids = out["consumed"][0] + out["consumed"][1]
    images = np.stack([np.full((64, 64, 3), i * 10 + 5, np.uint8) for i in ids])
    labels = np.stack([np.full((64, 64), i % ms.NUM_CLASSES, np.uint8) for i in ids])
    _assert_jax_loss(out["losses"], smoke_tree, images, labels, out["mesh"])
