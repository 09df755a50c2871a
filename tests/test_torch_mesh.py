"""PyTorch port, ``parallel/mesh.py``: data- and tensor-parallel steps
against the JAX package on a mesh of the same shape, on the CPU.

The port runs one process per mesh position: each test group is 2 or 4
processes of this file run as a script (``_rank_main``), joined in a gloo
group through a ``file://`` store under ``tmp_path``, each with its own
timeout on init, on every collective and on the join, so a hung group
fails its test instead of the suite. The workers import no JAX; the tests
compute JAX's side in this process, on its 8-device virtual CPU mesh
(``compile_train_step``/``compile_eval_step``/``compile_predict_step``
with the mesh of the same shape). A narrow fp32 model (``width_mult=1/16,
fc_channels=64``, as ``__graft_entry__.py``'s multichip dry run) on 64x64
inputs, ``keep_prob=1``. Tolerances, with their reasons:

* losses: rtol 1e-5 (summation order), as ``tests/test_parallel.py``;
* params after one SGD step: rtol 2e-4, atol 1e-6, as
  ``tests/test_parallel.py:91-96`` (XLA:CPU and oneDNN sum the
  convolutions in different orders; SGD keeps that difference at lr
  times the gradient's, where Adam's first step would turn a near-zero
  gradient's rounding into a sign);
* Adam, clipping on the shards and dropout at ``keep_prob=0.5`` are held
  against the port's own single-process step, with the same tolerances:
  the mesh draws the single-card masks (``models/vgg16._head_masks``);
* predicted ids: equal wherever JAX's top-2 probability margin exceeds
  1e-4, and at least 99.9% equal; confusion matrices: equal up to two
  counts per pixel with a margin under 1e-4 (each such pixel can move one
  count out of a cell and into another).
"""

import datetime
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models.fcn8s import init_fcn8s as t_init  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.metrics import (  # noqa: E402
    empty_metrics_state,
    finalize_metrics,
)
from fcn8s_tensorflow_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import steps as tsteps  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 5
HW = (64, 64)
SMALL = dict(width_mult=1 / 16, fc_channels=64)
LR, L2, SEED = 1e-3, 1e-3, 3
CLASS_WEIGHTS = (0.5, 1.0, 2.0, 0.0, 1.5)
IGNORE = 255
GROUP_TIMEOUT_S = 300  # a whole group, launch to join
COLLECTIVE_TIMEOUT_S = 120  # init and each collective inside a group
MARGIN = 1e-4


def _tree(seed: int = 0) -> dict:
    """A JAX-layout numpy tree (the port's seeded init), the decoder redrawn
    at unit fan-in scale so its gradients are not 1e-3-sigma small."""
    tree = bridge.to_numpy(bridge.to_port(t_init(torch.Generator().manual_seed(seed), C,
                                                 **SMALL)))
    rng = np.random.default_rng(seed)
    for layer in tree["decoder"].values():
        k = layer["kernel"]
        layer["kernel"] = (rng.normal(size=k.shape) / np.sqrt(np.prod(k.shape[:-1]))).astype(
            np.float32)
        layer["bias"] = (rng.normal(size=layer["bias"].shape) * 0.1).astype(np.float32)
    return tree


def _batch(n: int, seed: int, ignore_share: float = 0.0, real: int | None = None):
    """(images, labels, mask); ``real < n`` masks the last samples as
    padding (copies of the last real one, as the facades pad)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, *HW, 3), dtype=np.uint8)
    labels = rng.integers(0, C, (n, *HW)).astype(np.uint8)
    if ignore_share:
        labels[rng.random(labels.shape) < ignore_share] = IGNORE
    mask = np.ones(n, np.float32)
    if real is not None:
        images[real:], labels[real:], mask[real:] = images[real - 1], labels[real - 1], 0.0
    return images, labels, mask


BATCHES = {"b4": _batch(4, 1), "b4b": _batch(4, 2), "pad3": _batch(4, 3, real=3),
           "ign": _batch(4, 4, ignore_share=0.2)}


# ---------------------------------------------------------------------------
# the workers: one process per mesh position, no JAX
# ---------------------------------------------------------------------------


def _local(mesh, arrays, microbatches=1):
    rows = tmesh.batch_rows(arrays[0].shape[0], mesh, microbatches)
    return [torch.from_numpy(np.ascontiguousarray(a if rows is None else a[rows]))
            for a in arrays]


def _job_step(job, mesh, tree):
    tp = job.get("tp", False)
    params = bridge.to_port_shards(tree, mesh, tensor_parallel=tp)
    opt = tsteps.make_optimizer(job.get("opt", "sgd"), clip_norm=job.get("clip"))
    state = tsteps.create_train_state(params, opt)
    accum = job.get("accum", 1)
    state, loss = tsteps.train_step(
        state, *_local(mesh, BATCHES[job["batch"]], accum), SEED, LR, L2, job.get("kp", 1.0),
        optimizer=opt, num_classes=C, compute_dtype=torch.float32, grad_accum=accum,
        ignore_label=job.get("ign"), class_weights=job.get("cw"), mesh=mesh,
        tensor_parallel=tp)
    full = tmesh.gather_params(state.params, mesh, tp)
    return {"loss": float(loss), "params": bridge.to_numpy(full),
            "local": bridge.to_numpy(state.params)}


def _job_eval(job, mesh, tree):
    tp = job.get("tp", False)
    run = bridge.cast_params(bridge.to_port_shards(tree, mesh, tensor_parallel=tp),
                             torch.float32)
    state = empty_metrics_state(C, device="cpu")
    for name in job["batches"]:
        state = tsteps.eval_step(run, state, *_local(mesh, BATCHES[name]), num_classes=C,
                                 compute_dtype=torch.float32, ignore_label=job.get("ign"),
                                 class_weights=job.get("cw"), mesh=mesh, tensor_parallel=tp)
    return {"conf": state["conf_matrix"].numpy(),
            **{k: float(v) for k, v in finalize_metrics(state).items()}}


def _job_predict(job, mesh, tree):
    tp = job.get("tp", False)
    run = bridge.cast_params(bridge.to_port_shards(tree, mesh, tensor_parallel=tp),
                             torch.float32)
    images = _local(mesh, BATCHES[job["batch"]][:1])[0]
    with torch.inference_mode():
        ids = tsteps.predict_step(run, images, compute_dtype=torch.float32, mesh=mesh,
                                  tensor_parallel=tp)
    return {"ids": ids.numpy()}


def _job_facade(job, mesh, tree):
    """The facade on the mesh: ``job['calls']`` in order, each result kept
    (``test_torch_mesh_facade.py`` reads them)."""
    from fcn8s_tensorflow_tpu_torch.engine import checkpoint as ckpt
    from fcn8s_tensorflow_tpu_torch.engine.serving import InferenceService

    tp = job.get("tp", False)
    out = {}
    if job.get("load") is not None:
        model = FCN8s(model_load_dir=job["load"], mesh=mesh, tensor_parallel=tp,
                      compute_dtype=torch.float32, device="cpu")
    else:
        model = FCN8s.from_params(tree, mesh=mesh, tensor_parallel=tp, device="cpu",
                                  compute_dtype=torch.float32, optimizer=job.get("opt", "adam"),
                                  **SMALL)

    def gen(names):
        return iter([(im[:int(mk.sum())], lb[:int(mk.sum())])
                     for im, lb, mk in (BATCHES[name] for name in names)])

    def gathered():
        return bridge.to_numpy(model._gather(model.params))

    for call in job["calls"]:
        kind = call[0]
        if kind == "train":
            model.train(gen(call[1]), epochs=1, steps_per_epoch=len(call[1]),
                        learning_rate_schedule=lambda s: LR, keep_prob=1.0,
                        l2_regularization=L2, metrics=set(), record_summaries=False,
                        prefetch=0, **call[2])
            out["train_loss"] = model.training_loss
            out["params"] = gathered()
        elif kind == "lr":
            out["lr"] = model.find_learning_rate(gen(call[1]), min_lr=1e-4, max_lr=1e-2,
                                                 steps=3)
            now = gathered()
            out["lr_restored"] = all(np.array_equal(now[p][n][k], tree[p][n][k])
                                     for p in tree for n in tree[p] for k in tree[p][n])
        elif kind == "evaluate":
            out["evaluate"] = model.evaluate(gen(call[1]), len(call[1]))
            out["conf"] = model.metrics_state["conf_matrix"].numpy()
        elif kind == "predict":
            out[call[1]] = model.predict(call[2], **call[3])
        elif kind == "tta":
            out["tta"] = model.predict_tta(call[1], argmax=False, **call[2])
        elif kind == "calibrate":
            model.calibrate_quantization(call[1], batch_size=2)
        elif kind == "save":
            out["save_dir"] = model.save(call[1], force_save=True)
            if mesh.is_writer:  # the barrier is behind: the file is whole
                ckpt.load_checkpoint(out["save_dir"])
        elif kind == "predict_and_save":
            model.predict_and_save(call[1], call[2], output_format="ids", verbose=False)
        elif kind == "export":
            model.export_serving(call[1], input_hw=(32, 64))
        elif kind == "params":
            out["params"] = gathered()
        elif kind == "summaries":
            model.train(gen(call[2]), epochs=1, steps_per_epoch=len(call[2]),
                        learning_rate_schedule=lambda s: LR, keep_prob=1.0, metrics=set(),
                        record_summaries=True, summaries_dir=call[1], summaries_frequency=1,
                        prefetch=0)
        elif kind == "observers":
            model.train(gen(call[1]), epochs=len(call[1]), steps_per_epoch=1,
                        learning_rate_schedule=lambda s: 0.5, keep_prob=1.0, metrics=set(),
                        record_summaries=False, prefetch=0, early_stopping=1,
                        reduce_lr_on_plateau={"patience": 1, "factor": 0.5})
            out["observers"] = (model.g_step, model.training_loss, model._observer_state)
        elif kind == "serve":
            try:
                InferenceService(model)
                out["serve"] = "served"
            except ValueError as exc:
                out["serve"] = str(exc)
    model.close()
    return out


_JOBS = {"step": _job_step, "eval": _job_eval, "predict": _job_predict, "facade": _job_facade}


def _rank_main(rank: int, world: int, store: str, spec_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        with open(spec_path, "rb") as f:
            spec = pickle.load(f)
        meshes, results = {}, {}
        for name, job in spec["jobs"].items():
            shape = tuple(job["mesh"])
            if shape not in meshes:
                meshes[shape] = tmesh.create_mesh(*shape, devices=["cpu"] * world)
            mesh = meshes[shape]
            results[name] = _JOBS[job["kind"]](job, mesh, spec["tree"])
            results[name]["coords"] = dict(mesh.coords)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def launch(tmp_path, world: int, jobs: dict, tree=None) -> list:
    """Run ``jobs`` in a gloo group of ``world`` worker processes; returns
    each rank's results. A worker that fails or a group that outlives
    ``GROUP_TIMEOUT_S`` fails the calling test with the workers' output."""
    tmp_path = str(tmp_path)
    spec = os.path.join(tmp_path, f"spec_{world}.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"tree": _tree() if tree is None else tree, "jobs": jobs}, f)
    store = os.path.join(tmp_path, f"store_{world}_{time.monotonic_ns()}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1")
    logs = [open(os.path.join(tmp_path, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               store, spec, tmp_path], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    output = []
    for r, log in enumerate(logs):
        log.seek(0)
        output.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n{log.read()[-4000:]}")
        log.close()
    if any(p.returncode != 0 for p in procs):
        pytest.fail("mesh group failed:\n" + "\n".join(output))
    results = []
    for r in range(world):
        with open(os.path.join(tmp_path, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# JAX's side (imported inside the tests: the workers import this module)
# ---------------------------------------------------------------------------


def _jax_mesh(shape):
    import jax
    from fcn8s_tensorflow_tpu.parallel.mesh import create_mesh

    return create_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])


def _jax_step(shape, tp, batch, opt="sgd", clip=None, accum=1, cw=None, ign=None):
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.parallel import mesh as jmesh
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    mesh = _jax_mesh(shape)
    optimizer = jsteps.make_optimizer(opt, clip_norm=clip)
    state = jsteps.create_train_state(jax.tree.map(jnp.asarray, _tree()), optimizer)
    step = jsteps.compile_train_step(mesh, optimizer, C, tensor_parallel=tp,
                                     compute_dtype=jnp.float32, example_state=state,
                                     donate=False, grad_accum=accum, ignore_label=ign,
                                     class_weights=cw)
    new, loss = step(state, *jmesh.shard_batch(mesh, *BATCHES[batch]), jax.random.PRNGKey(0),
                     LR, L2, 1.0)
    return float(loss), jax.tree.map(np.asarray, new.params)


def _jax_eval(shape, tp, batches, cw=None, ign=None):
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.ops.metrics import empty_metrics_state as j_empty
    from fcn8s_tensorflow_tpu.ops.metrics import finalize_metrics as j_finalize
    from fcn8s_tensorflow_tpu.parallel import mesh as jmesh
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    mesh = _jax_mesh(shape)
    params = jax.tree.map(jnp.asarray, _tree())
    step = jsteps.compile_eval_step(mesh, C, tensor_parallel=tp, compute_dtype=jnp.float32,
                                    example_params=params, ignore_label=ign, class_weights=cw)
    state = j_empty(C)
    for name in batches:
        state = step(params, state, *jmesh.shard_batch(mesh, *BATCHES[name]))
    return {"conf": np.asarray(state["conf_matrix"]),
            **{k: float(v) for k, v in j_finalize(state).items()}}


def _jax_predict(shape, tp, batch, argmax=True):
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.parallel import mesh as jmesh
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    mesh = _jax_mesh(shape)
    params = jax.tree.map(jnp.asarray, _tree())
    step = jsteps.compile_predict_step(mesh, argmax=argmax, tensor_parallel=tp,
                                       compute_dtype=jnp.float32, example_params=params)
    return np.asarray(step(params, jmesh.shard_batch(mesh, BATCHES[batch][0])))


def unclear(probs: np.ndarray) -> np.ndarray:
    """Pixels whose top-2 probabilities lie within ``MARGIN``."""
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= MARGIN


def assert_ids_agree(got, want, probs) -> None:
    clear = ~unclear(probs)
    np.testing.assert_array_equal(got[clear], want[clear])
    assert (got == want).mean() >= 0.999


def assert_conf_agree(got, want, probs) -> None:
    assert np.abs(got.astype(np.int64) - want).sum() <= 2 * int(unclear(probs).sum())


def assert_params_close(got: dict, want: dict, rtol=2e-4, atol=1e-6) -> None:
    for part in want:
        for name in want[part]:
            for key in want[part][name]:
                np.testing.assert_allclose(got[part][name][key], want[part][name][key],
                                           rtol=rtol, atol=atol,
                                           err_msg=f"{part}/{name}/{key}")


def _port_single(**job):
    """The port's own single-process step (no mesh)."""
    tree = _tree()
    params = bridge.to_port(tree)
    opt = tsteps.make_optimizer(job.get("opt", "sgd"), clip_norm=job.get("clip"))
    state = tsteps.create_train_state(params, opt)
    im, lb, mk = (torch.from_numpy(a) for a in BATCHES[job["batch"]])
    state, loss = tsteps.train_step(state, im, lb, mk, SEED, LR, L2, job.get("kp", 1.0),
                                    optimizer=opt, num_classes=C, compute_dtype=torch.float32,
                                    grad_accum=job.get("accum", 1))
    return float(loss), bridge.to_numpy(state.params)


# ---------------------------------------------------------------------------
# the groups: every mesh job of a world size in one launch
# ---------------------------------------------------------------------------

MESHES = [(2, 1), (1, 2), (2, 2)]


def _jobs_for(shape):
    tp = shape[1] > 1
    jobs = {
        "basic": dict(kind="step", batch="b4"),
        "adam": dict(kind="step", batch="b4", opt="adam"),
        "dropout": dict(kind="step", batch="b4", opt="adam", kp=0.5),
        "eval": dict(kind="eval", batches=["b4", "pad3"]),
        "predict": dict(kind="predict", batch="b4"),
    }
    if shape[0] > 1:
        jobs["padding"] = dict(kind="step", batch="pad3")
    if shape == (2, 2):
        jobs.update(weighted=dict(kind="step", batch="ign", cw=CLASS_WEIGHTS, ign=IGNORE),
                    weighted_eval=dict(kind="eval", batches=["ign"], cw=CLASS_WEIGHTS,
                                       ign=IGNORE),
                    clip=dict(kind="step", batch="b4", opt="adam", clip=0.05),
                    accum=dict(kind="step", batch="pad3", accum=2))
    return {f"{shape[0]}x{shape[1]}/{k}": dict(v, mesh=shape, tp=tp) for k, v in jobs.items()}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Each world's results, per rank: world 2 runs the (2, 1) and (1, 2)
    meshes, world 4 the (2, 2) mesh."""
    out = {}
    for world, shapes in ((2, [(2, 1), (1, 2)]), (4, [(2, 2)])):
        jobs = {k: v for shape in shapes for k, v in _jobs_for(shape).items()}
        out[world] = launch(tmp_path_factory.mktemp(f"world{world}"), world, jobs)
    return out


def _ranks(groups, shape):
    return groups[shape[0] * shape[1]]


def _tag(shape, name):
    return f"{shape[0]}x{shape[1]}/{name}"


# ---------------------------------------------------------------------------
# the mesh module against JAX's
# ---------------------------------------------------------------------------


def test_param_spec_tree_matches_jax_rules_in_the_port_layout():
    """Every leaf's spec, read back into JAX's HWIO layout, is JAX's."""
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.parallel.mesh import param_spec_tree as j_specs

    tree = _tree()
    port = bridge.to_port(tree)
    want = j_specs(jax.tree.map(jnp.asarray, tree))
    for tp in (True, False):
        want = j_specs(jax.tree.map(jnp.asarray, tree), tensor_parallel=tp)
        got = tmesh.param_spec_tree(port, tensor_parallel=tp)
        for part, layers in port.items():
            for name, layer in layers.items():
                for key, t in layer.items():
                    spec = tuple(got[part][name][key]) + (None,) * (t.dim() - len(
                        got[part][name][key]))
                    jkey = "bias" if key == "bias" else "kernel"
                    if jkey == "kernel" and not name.endswith("_deconv"):
                        spec = tuple(spec[i] for i in (2, 3, 1, 0))  # OIHW -> HWIO
                    jspec = tuple(want[part][name][jkey])
                    jspec = jspec + (None,) * (len(spec) - len(jspec))
                    assert spec == jspec, (tp, part, name, key, spec, jspec)


@pytest.mark.parametrize("kwargs,devices", [
    (dict(data=5, model=3), 8), (dict(model=3), 8), (dict(data=2, model=4), 4)])
def test_create_mesh_errors_match_jax(kwargs, devices):
    import jax
    from fcn8s_tensorflow_tpu.parallel.mesh import create_mesh as j_create

    with pytest.raises(ValueError) as want:
        j_create(**kwargs, devices=jax.devices()[:devices])
    with pytest.raises(ValueError) as got:
        tmesh.create_mesh(**kwargs, devices=["cpu"] * devices)
    assert str(got.value) == str(want.value)


def test_create_mesh_without_a_group_is_one_position():
    mesh = tmesh.create_mesh(devices=["cpu"])
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 1}
    assert mesh.size == 1 and mesh.device_mesh is None and mesh.is_writer
    assert mesh.group("data") is None and mesh.group("model") is None
    assert tmesh.batch_spec() == tmesh.P("data") and tmesh.replicated(mesh).spec == tmesh.P()
    assert tmesh.spatial_spec() == tmesh.P("data", None, "model")
    images, labels, _ = BATCHES["pad3"]
    got = tmesh.shard_batch(mesh, images, labels)
    assert all(torch.equal(t, torch.from_numpy(a)) for t, a in zip(got, (images, labels)))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.create_mesh(data=2, devices=["cpu"])


def test_create_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tmesh.create_mesh()


def test_batch_rows_take_each_microbatch_slice():
    mesh = tmesh.Mesh(shape={"data": 2, "model": 2}, coords={"data": 1, "model": 0},
                      device=torch.device("cpu"))
    np.testing.assert_array_equal(tmesh.batch_rows(8, mesh), [4, 5, 6, 7])
    np.testing.assert_array_equal(tmesh.batch_rows(8, mesh, microbatches=2), [2, 3, 6, 7])
    with pytest.raises(ValueError, match="does not split"):
        tmesh.batch_rows(6, mesh, microbatches=2)


@pytest.mark.parametrize("tp", [True, False])
def test_shard_then_gather_is_the_whole_tree(tp):
    """``shard_params`` takes each position's block; concatenating the
    blocks of every position (what ``gather_params`` all-gathers) gives the
    tree back, and only fc6 (weight, bias) and fc7's weight split."""
    tree = bridge.to_port(_tree())
    blocks = {}
    for j in range(2):
        mesh = tmesh.Mesh(shape={"data": 1, "model": 2}, coords={"data": 0, "model": j},
                          device=torch.device("cpu"))
        blocks[j] = tmesh.shard_params(tree, mesh, tp)
    for part, layers in tree.items():
        for name, layer in layers.items():
            for key, t in layer.items():
                a, b = blocks[0][part][name][key], blocks[1][part][name][key]
                split = tp and (name == "fc6" or (name == "fc7" and key == "weight"))
                if not split:
                    assert torch.equal(a, t) and torch.equal(b, t)
                    continue
                dim = 1 if name == "fc7" else 0
                assert a.shape[dim] == t.shape[dim] // 2
                assert torch.equal(torch.cat([a, b], dim=dim), t)


def test_one_position_mesh_is_bit_equal_to_no_mesh(tmp_path):
    """``mesh=create_mesh()`` (one position) with ``tensor_parallel=True``:
    train, evaluate, predict, tiled predict and save give the mesh-less
    facade's results bit for bit."""
    mesh = tmesh.create_mesh(devices=["cpu"])
    models = [FCN8s.from_params(_tree(), device="cpu", compute_dtype=torch.float32, **SMALL,
                                **kw) for kw in ({}, dict(mesh=mesh, tensor_parallel=True))]
    images = BATCHES["b4"][0][:3, :50, :60]
    outs = []
    for i, model in enumerate(models):
        im, lb, _ = BATCHES["pad3"]
        model.train(iter([(im[:3], lb[:3])] * 2), epochs=1, steps_per_epoch=2,
                    learning_rate_schedule=lambda s: LR, keep_prob=0.5, metrics=set(),
                    record_summaries=False, prefetch=0)
        ev = model.evaluate(iter([(im[:3], lb[:3])]), 1)
        path = model.save(str(tmp_path / f"m{i}"), force_save=True)
        with open(os.path.join(path, "checkpoint.msgpack"), "rb") as f:
            payload = f.read()
        outs.append((bridge.to_numpy(model.params), model.training_loss, ev,
                     model.predict(images, argmax=False), model.predict(images, tile=(32, 32)),
                     payload))
    (p0, l0, e0, s0, t0, b0), (p1, l1, e1, s1, t1, b1) = outs
    assert l0 == l1 and e0 == e1 and b0 == b1
    np.testing.assert_array_equal(s0, s1)
    np.testing.assert_array_equal(t0, t1)
    for part in p0:
        for name in p0[part]:
            for key in p0[part][name]:
                np.testing.assert_array_equal(p0[part][name][key], p1[part][name][key])


# ---------------------------------------------------------------------------
# the gloo groups against JAX on a mesh of the same shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_train_step_matches_jax(groups, shape):
    loss, params = _jax_step(shape, shape[1] > 1, "b4")
    for rank in _ranks(groups, shape):
        got = rank[_tag(shape, "basic")]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert_params_close(got["params"], params)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_padded_batch_of_three_on_two_data_positions_matches_jax(groups, shape):
    loss, params = _jax_step(shape, shape[1] > 1, "pad3")
    got = _ranks(groups, shape)[0][_tag(shape, "padding")]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    assert_params_close(got["params"], params)


@pytest.mark.parametrize("name,kwargs", [
    ("weighted", dict(batch="ign", cw=CLASS_WEIGHTS, ign=IGNORE)),
    ("accum", dict(batch="pad3", accum=2)),
])
def test_weighted_and_accumulated_steps_match_jax(groups, name, kwargs):
    shape = (2, 2)
    loss, params = _jax_step(shape, True, **kwargs)
    for rank in _ranks(groups, shape):
        got = rank[_tag(shape, name)]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert_params_close(got["params"], params)


def test_clip_norm_on_shards_matches_jax(groups):
    """A clip that binds (the global norm exceeds 0.05): JAX's clipped SGD
    step, and the port's clipped Adam step against its single process."""
    shape = (2, 2)
    loss, params = _jax_step(shape, True, "b4", clip=0.05)
    got_sgd = _port_single(batch="b4", clip=0.05)
    np.testing.assert_allclose(got_sgd[0], loss, rtol=1e-5)
    assert_params_close(got_sgd[1], params)
    single = _port_single(batch="b4", opt="adam", clip=0.05)
    for rank in _ranks(groups, shape):
        got = rank[_tag(shape, "clip")]
        np.testing.assert_allclose(got["loss"], single[0], rtol=1e-5)
        assert_params_close(got["params"], single[1])


@pytest.mark.parametrize("shape", MESHES)
def test_adam_on_shards_matches_the_single_process_step(groups, shape):
    loss, params = _port_single(batch="b4", opt="adam")
    for rank in _ranks(groups, shape):
        got = rank[_tag(shape, "adam")]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert_params_close(got["params"], params)


@pytest.mark.parametrize("shape", MESHES)
def test_dropout_draws_the_single_card_masks(groups, shape):
    """keep_prob 0.5: the mesh step equals the single-process step (each
    rank keeps its block of the single-card masks), and the leaves that are
    replicated over 'model' stay equal across its ranks."""
    loss, params = _port_single(batch="b4", opt="adam", kp=0.5)
    ranks = _ranks(groups, shape)
    for rank in ranks:
        got = rank[_tag(shape, "dropout")]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert_params_close(got["params"], params)
    if shape[1] > 1:
        for d in range(shape[0]):
            a, b = (ranks[d * shape[1] + j][_tag(shape, "dropout")]["local"] for j in (0, 1))
            for part in a:
                for name in a[part]:
                    for key in a[part][name]:
                        if name == "fc6" or (name == "fc7" and key == "kernel"):
                            continue
                        np.testing.assert_array_equal(a[part][name][key], b[part][name][key])


@pytest.mark.parametrize("shape", MESHES)
def test_eval_step_matches_jax(groups, shape):
    want = _jax_eval(shape, shape[1] > 1, ["b4", "pad3"])
    probs = np.concatenate([_jax_predict(shape, shape[1] > 1, b, argmax=False)
                            for b in ("b4",)] + [_jax_predict(shape, shape[1] > 1, "pad3",
                                                              argmax=False)[:3]])
    for rank in _ranks(groups, shape):
        got = rank[_tag(shape, "eval")]
        assert_conf_agree(got["conf"], want["conf"], probs)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-3)


def test_weighted_eval_step_matches_jax(groups):
    shape = (2, 2)
    want = _jax_eval(shape, True, ["ign"], cw=CLASS_WEIGHTS, ign=IGNORE)
    probs = _jax_predict(shape, True, "ign", argmax=False)
    for rank in _ranks(groups, shape):
        got = rank[_tag(shape, "weighted_eval")]
        assert_conf_agree(got["conf"], want["conf"], probs)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_predict_step_matches_jax(groups, shape):
    want = _jax_predict(shape, shape[1] > 1, "b4")
    probs = _jax_predict(shape, shape[1] > 1, "b4", argmax=False)
    for rank in _ranks(groups, shape):
        got = rank[_tag(shape, "predict")]["ids"]
        assert got.shape == want.shape
        assert_ids_agree(got, want, probs)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
