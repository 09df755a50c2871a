"""PyTorch port, spatial partitioning: the width split over the mesh's
'model' axis, with the hand halo exchange at every conv and deconv, against
the JAX package's ``compile_*_step(spatial_partition=True)`` on a mesh of
the same shape, on the CPU.

The group runner is ``test_torch_mesh.py``'s (gloo groups, a timeout on
init, on each collective and on the join; the workers import no JAX), run
with this file's jobs: one group of 2 processes for the (1, 2) mesh and one
of 4 for the (1, 4) and (2, 2) meshes. JAX's side runs in this process on
its 8-device virtual CPU mesh. The narrow fp32 model of that file
(``width_mult=1/16, fc_channels=64``, its ``_tree`` weights), on 32-row
images: W=96 on 2 'model' positions (an uneven 64 + 32 split, so a
normaliser that counts one rank's pixels fails the loss) and W=128 on 4
(one stride-32 column a rank, so fc6's 3-column halo reaches three ranks
away). Tolerances, with their reasons (``test_torch_mesh.py``'s):

* losses: rtol 1e-5 (summation order);
* params after one SGD step: rtol 2e-4, atol 1e-6 (XLA:CPU and oneDNN sum
  the convolutions in different orders; SGD keeps that difference at lr
  times the gradient's);
* probabilities: rtol 1e-4, atol 1e-5 (fp32 convolutions in another
  order); ids equal wherever JAX's top-2 probability margin exceeds 1e-4,
  and at least 99.9% equal; confusion matrices equal up to two counts per
  pixel inside that margin;
* dropout at keep_prob 0.5, device augmentation on (1, m), Adam and remat
  are held against the port's own single-process step, with the same
  tolerances (the mesh draws the single-card masks, and augments the whole
  rows before it keeps its columns);
* the halo exchange alone, against the unsharded convolution in fp64:
  forward and ``torch.autograd.grad`` within 1e-12.
"""

import os
import sys
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.augment_device import make_augment_fn  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.metrics import (  # noqa: E402
    empty_metrics_state,
    finalize_metrics,
)
from fcn8s_tensorflow_tpu_torch.ops.nn import conv2d  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.quantize import quantize_fcn8s_params  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import collectives as tcoll  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import steps as tsteps  # noqa: E402
from tests.test_torch_mesh import (  # noqa: E402
    C,
    CLASS_WEIGHTS,
    IGNORE,
    L2,
    LR,
    SEED,
    SMALL,
    _rank_main,
    _tree,
    assert_conf_agree,
    assert_ids_agree,
    assert_params_close,
    launch,
)

ROWS = 32
WIDTH = {(1, 2): 96, (1, 4): 128, (2, 2): 96}
AUGMENT = dict(flip=0.5, brightness=(0.8, 1.2, 0.5))
HALO_LEVELS = (1, 8, 32)  # the strides at which the halo tests split the width
EMA = 0.9
F32 = torch.float32


def _batch(w: int, seed: int, n: int = 4, ignore_share: float = 0.0, real: int | None = None):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, ROWS, w, 3), dtype=np.uint8)
    labels = rng.integers(0, C, (n, ROWS, w)).astype(np.uint8)
    if ignore_share:
        labels[rng.random(labels.shape) < ignore_share] = IGNORE
    mask = np.ones(n, np.float32)
    if real is not None:
        images[real:], labels[real:], mask[real:] = images[real - 1], labels[real - 1], 0.0
    return images, labels, mask


BATCHES = {(name, w): fn(w) for w in (96, 128) for name, fn in (
    ("b", lambda w: _batch(w, 1)), ("b2", lambda w: _batch(w, 2)),
    ("pad", lambda w: _batch(w, 3, real=3)), ("ign", lambda w: _batch(w, 4, ignore_share=0.2)))}


# ---------------------------------------------------------------------------
# the workers: one process per mesh position, no JAX
# ---------------------------------------------------------------------------


def _rows(mesh, arrays, microbatches=1):
    """This rank's rows of a host batch, at the full width."""
    rows = tmesh.batch_rows(arrays[0].shape[0], mesh, microbatches)
    return [torch.from_numpy(np.ascontiguousarray(a if rows is None else a[rows]))
            for a in arrays]


def _halo_inputs(w: int, k: int, seed: int):
    """fp64 (x, weight, output gradient) of a k x k conv on a width-``w`` map."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, 3, 5, w))).contiguous(
        memory_format=torch.channels_last)
    weight = torch.from_numpy(rng.normal(size=(4, 3, k, k)))
    gy = torch.from_numpy(rng.normal(size=(2, 4, 5, w)))
    return x, weight, gy


def _job_halo(job, mesh, tree):
    """``halo_exchange`` + a width-unpadded conv on this rank's columns at
    each level of ``HALO_LEVELS``, for 3x3 and 7x7: the output block and the
    gradients of the block and the weight (this rank's part)."""
    width = WIDTH[tuple(job["mesh"])]
    split = tmesh.width_split(width, mesh)
    out = {}
    for s in HALO_LEVELS:
        for k in (3, 7):
            x, weight, gy = _halo_inputs(width // s, k, seed=s * 10 + k)
            lo, hi = split.lo // s, split.hi // s
            xl = x[..., lo:hi].contiguous(memory_format=torch.channels_last).requires_grad_(True)
            wl = weight.clone().requires_grad_(True)
            y = conv2d(tcoll.halo_exchange(xl, k // 2, split), wl, halo=True)
            gx, gw = torch.autograd.grad(y, (xl, wl), gy[..., lo:hi])
            out[(s, k)] = {"y": y.detach().numpy(), "gx": gx.numpy(), "gw": gw.numpy(),
                           "cols": (lo, hi)}
    return out


def _job_step(job, mesh, tree):
    params = bridge.to_port(tree)
    opt = tsteps.make_optimizer(job.get("opt", "sgd"))
    state = tsteps.create_train_state(params, opt)
    accum = job.get("accum", 1)
    augment = make_augment_fn(**AUGMENT) if job.get("augment") else None
    state, loss = tsteps.train_step(
        state, *_rows(mesh, BATCHES[job["batch"]], accum), SEED, LR, L2, job.get("kp", 1.0),
        optimizer=opt, num_classes=C, compute_dtype=F32, grad_accum=accum,
        ignore_label=job.get("ign"), class_weights=job.get("cw"), augment_fn=augment,
        remat=job.get("remat", False), mesh=mesh, spatial_partition=True)
    return {"loss": float(loss), "params": bridge.to_numpy(state.params)}


def _job_eval(job, mesh, tree):
    run = bridge.cast_params(bridge.to_port(tree), F32)
    state = empty_metrics_state(C, device="cpu")
    for name in job["batches"]:
        state = tsteps.eval_step(run, state, *_rows(mesh, BATCHES[name]), num_classes=C,
                                 compute_dtype=F32, ignore_label=job.get("ign"),
                                 class_weights=job.get("cw"), mesh=mesh, spatial_partition=True)
    return {"conf": state["conf_matrix"].numpy(),
            **{k: float(v) for k, v in finalize_metrics(state).items()}}


def _job_predict(job, mesh, tree):
    run = bridge.cast_params(bridge.to_port(tree), F32)
    images = _rows(mesh, BATCHES[job["batch"]][:1])[0]
    lut = np.array([[255, 0, 0, 127], [0, 255, 0, 255], [10, 20, 30, 0], [0, 0, 0, 255],
                    [200, 100, 50, 60]], np.float32)
    with torch.inference_mode():
        kw = dict(compute_dtype=F32, mesh=mesh, spatial_partition=True)
        out = {"ids": tsteps.predict_step(run, images, **kw).numpy(),
               "probs": tsteps.predict_step(run, images, argmax=False, **kw).numpy(),
               "overlay": tsteps.predict_step(run, images, overlay_lut=lut, **kw).numpy()}
        qrun = quantize_fcn8s_params(bridge.to_port(tree), compute_dtype=F32)
        out["int8_probs"] = tsteps.predict_step(qrun, images, argmax=False, quantized=True,
                                                **kw).numpy()
        out["int8_ids"] = tsteps.predict_step(qrun, images, quantized=True, **kw).numpy()
    out["lut"] = lut
    return out


def _job_facade(job, mesh, tree):
    """``FCN8s(mesh=...)`` trained with ``spatial_partition=True``, an EMA
    and the periodic evaluation on the train stream, then predict with and
    without the split, with ``use_ema``, and (off TP) a spatial evaluate."""
    tp = job.get("tp", False)
    model = FCN8s.from_params(tree, mesh=mesh, tensor_parallel=tp, device="cpu",
                              compute_dtype=F32, optimizer="sgd", **SMALL)
    images, labels, _ = BATCHES[("b", job["width"])]
    images2, labels2, _ = BATCHES[("b2", job["width"])]
    stream = iter([(images, labels), (images2, labels2)] * 2)
    model.train(stream, epochs=1, steps_per_epoch=2, learning_rate_schedule=lambda s: LR,
                keep_prob=1.0, l2_regularization=L2, metrics={"loss", "accuracy"},
                eval_frequency=1, eval_dataset="train", record_summaries=False, prefetch=0,
                spatial_partition=True, ema_decay=EMA)
    crop = images[:3, :, :70]
    out = {"train_loss": model.training_loss, "metrics": list(model.metric_values),
           "params": bridge.to_numpy(model._gather(model.params)),
           "sharded": [tuple(t.shape) for t in bridge.param_leaves(model.params)],
           "probs": model.predict(crop, argmax=False),
           "probs_spatial": model.predict(crop, argmax=False, spatial_partition=True),
           "ema": model.predict(crop, argmax=False, use_ema=True),
           "ema_spatial": model.predict(crop, argmax=False, use_ema=True,
                                        spatial_partition=True)}
    if not tp:
        out["evaluate"] = model.evaluate(iter([(images2[:3], labels2[:3])]), 1,
                                         spatial_partition=True)
    model.close()
    return out


_SPATIAL_JOBS = {"halo": _job_halo, "step": _job_step, "eval": _job_eval,
                 "predict": _job_predict, "facade": _job_facade}


# ---------------------------------------------------------------------------
# the groups
# ---------------------------------------------------------------------------


def _key(shape, name):
    return f"{shape[0]}x{shape[1]}/{name}"


def _jobs_for(shape):
    w = WIDTH[shape]
    jobs = {
        "halo": dict(kind="halo"),
        "step": dict(kind="step", batch=("b", w)),
        "adam": dict(kind="step", batch=("b", w), opt="adam"),
        "dropout": dict(kind="step", batch=("b", w), kp=0.5),
        "eval": dict(kind="eval", batches=[("b", w), ("pad", w)]),
        "predict": dict(kind="predict", batch=("b", w)),
    }
    if shape[0] == 1:
        jobs["augment"] = dict(kind="step", batch=("b", w), augment=True)
    if shape in ((1, 2), (2, 2)):
        jobs["accum"] = dict(kind="step", batch=("pad", w), accum=2)
    if shape == (1, 2):
        jobs.update(ignore=dict(kind="step", batch=("ign", w), ign=IGNORE),
                    facade_tp=dict(kind="facade", width=w, tp=True))
    if shape == (1, 4):
        jobs.update(weighted=dict(kind="step", batch=("ign", w), cw=CLASS_WEIGHTS, ign=IGNORE),
                    weighted_eval=dict(kind="eval", batches=[("ign", w)], cw=CLASS_WEIGHTS,
                                       ign=IGNORE),
                    remat=dict(kind="step", batch=("b", w), kp=0.5, remat=True))
    if shape == (2, 2):
        jobs["facade"] = dict(kind="facade", width=w)
    return {_key(shape, k): dict(v, mesh=shape) for k, v in jobs.items()}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Each world's results, per rank: world 2 runs the (1, 2) mesh, world 4
    the (1, 4) and (2, 2) meshes."""
    out = {}
    for world, shapes in ((2, [(1, 2)]), (4, [(1, 4), (2, 2)])):
        jobs = {k: v for shape in shapes for k, v in _jobs_for(shape).items()}
        out[world] = launch(tmp_path_factory.mktemp(f"spatial{world}"), world, jobs,
                            script=os.path.abspath(__file__))
    return out


def _ranks(groups, shape):
    return groups[shape[0] * shape[1]]


# ---------------------------------------------------------------------------
# JAX's side (imported inside the functions: the workers import this module)
# ---------------------------------------------------------------------------


def _jax_mesh(shape):
    import jax
    from fcn8s_tensorflow_tpu.parallel.mesh import create_mesh

    return create_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])


def _jax_put(mesh, images, labels=None, mask=None):
    """JAX's spatial layout: images and labels width-sharded, the mask
    batch-sharded."""
    import jax
    from jax.sharding import NamedSharding
    from fcn8s_tensorflow_tpu.parallel.mesh import batch_sharding, spatial_spec

    sp = NamedSharding(mesh, spatial_spec())
    out = [jax.device_put(images, sp)]
    if labels is not None:
        out += [jax.device_put(labels, sp), jax.device_put(mask, batch_sharding(mesh))]
    return out


@lru_cache(maxsize=None)
def _jax_step(shape, batch, accum=1, cw=None, ign=None):
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    mesh = _jax_mesh(shape)
    optimizer = jsteps.make_optimizer("sgd")
    state = jsteps.create_train_state(jax.tree.map(jnp.asarray, _tree()), optimizer)
    step = jsteps.compile_train_step(mesh, optimizer, C, tensor_parallel=False,
                                     compute_dtype=jnp.float32, example_state=state,
                                     donate=False, grad_accum=accum, ignore_label=ign,
                                     class_weights=cw, spatial_partition=True)
    new, loss = step(state, *_jax_put(mesh, *BATCHES[batch]), jax.random.PRNGKey(0), LR, L2,
                     1.0)
    return float(loss), jax.tree.map(np.asarray, new.params)


@lru_cache(maxsize=None)
def _jax_eval(shape, batches, cw=None, ign=None):
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.ops.metrics import empty_metrics_state as j_empty
    from fcn8s_tensorflow_tpu.ops.metrics import finalize_metrics as j_finalize
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    mesh = _jax_mesh(shape)
    params = jax.tree.map(jnp.asarray, _tree())
    step = jsteps.compile_eval_step(mesh, C, tensor_parallel=False, compute_dtype=jnp.float32,
                                    example_params=params, ignore_label=ign, class_weights=cw,
                                    spatial_partition=True)
    state = j_empty(C)
    for name in batches:
        state = step(params, state, *_jax_put(mesh, *BATCHES[name]))
    return {"conf": np.asarray(state["conf_matrix"]),
            **{k: float(v) for k, v in j_finalize(state).items()}}


@lru_cache(maxsize=None)
def _jax_probs(shape, batch, quantized=False, spatial=True):
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.ops.quantize import quantize_fcn8s_params as j_quantize
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    mesh = _jax_mesh(shape)
    params = jax.tree.map(jnp.asarray, _tree())
    if quantized:
        params = jax.jit(j_quantize)(params, None)
    step = jsteps.compile_predict_step(mesh, argmax=False, tensor_parallel=False,
                                       compute_dtype=jnp.float32, example_params=params,
                                       spatial_partition=spatial, quantized=quantized)
    images = BATCHES[batch][0]
    if spatial:
        (images,) = _jax_put(mesh, images)
    return np.asarray(step(params, images))


def _port_single(batch, opt="sgd", kp=1.0, augment=False):
    """The port's own single-process step (no mesh)."""
    params = bridge.to_port(_tree())
    optimizer = tsteps.make_optimizer(opt)
    state = tsteps.create_train_state(params, optimizer)
    im, lb, mk = (torch.from_numpy(a) for a in BATCHES[batch])
    state, loss = tsteps.train_step(state, im, lb, mk, SEED, LR, L2, kp, optimizer=optimizer,
                                    num_classes=C, compute_dtype=F32,
                                    augment_fn=make_augment_fn(**AUGMENT) if augment else None)
    return float(loss), bridge.to_numpy(state.params)


def _assert_step(groups, shape, name, want):
    loss, params = want
    for rank in _ranks(groups, shape):
        got = rank[_key(shape, name)]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert_params_close(got["params"], params)


MESHES = list(WIDTH)


# ---------------------------------------------------------------------------
# the width split and the errors (no group)
# ---------------------------------------------------------------------------


def test_width_bounds_split_in_units_of_32():
    assert tmesh.width_bounds(96, 2) == [(0, 64), (64, 96)]
    assert tmesh.width_bounds(128, 4) == [(0, 32), (32, 64), (64, 96), (96, 128)]
    assert tmesh.width_bounds(160, 3) == [(0, 64), (64, 128), (128, 160)]
    assert tmesh.width_bounds(64, 1) == [(0, 64)]
    mesh = tmesh.Mesh(shape={"data": 1, "model": 3}, coords={"data": 0, "model": 1},
                      device=torch.device("cpu"))
    assert tmesh.width_range(160, mesh) == (64, 128)
    split = tmesh.width_split(160, mesh)
    assert (split.lo, split.hi, split.width) == (64, 128, 160)
    assert split.widths(2) == [2, 2, 1] and split.stride(2) == 32
    assert tmesh.width_split(160, tmesh.create_mesh(devices=["cpu"])) is None


@pytest.mark.parametrize("width,model", [(100, 2), (64, 4), (32, 2)])
def test_width_split_rejects_what_does_not_split_in_units_of_32(width, model):
    with pytest.raises(ValueError, match="units of 32 columns"):
        tmesh.width_bounds(width, model)


@pytest.mark.parametrize("kind", ["predict", "eval", "train"])
def test_steps_raise_where_the_width_does_not_split(kind):
    """W // 32 < model raises before any collective, in every step."""
    mesh = tmesh.Mesh(shape={"data": 1, "model": 4}, coords={"data": 0, "model": 0},
                      device=torch.device("cpu"))
    images, labels, mask = BATCHES[("b", 96)]
    images, labels = torch.from_numpy(images[:, :, :64]), torch.from_numpy(labels[:, :, :64])
    mask = torch.from_numpy(mask)
    params = bridge.to_port(_tree())
    kw = dict(mesh=mesh, spatial_partition=True, compute_dtype=F32)
    with pytest.raises(ValueError, match="does not split over 4 positions"):
        if kind == "predict":
            tsteps.predict_step(bridge.cast_params(params, F32), images, **kw)
        elif kind == "eval":
            tsteps.eval_step(bridge.cast_params(params, F32), empty_metrics_state(C, "cpu"),
                             images, labels, mask, num_classes=C, **kw)
        else:
            opt = tsteps.make_optimizer("sgd")
            tsteps.train_step(tsteps.create_train_state(params, opt), images, labels, mask,
                              SEED, LR, L2, 1.0, optimizer=opt, num_classes=C, **kw)


@pytest.mark.parametrize("kind", ["predict", "eval", "train"])
def test_spatial_and_tensor_parallel_exclude_each_other_as_in_jax(kind):
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    jmesh = _jax_mesh((1, 2))
    jparams = jax.tree.map(jnp.asarray, _tree())
    with pytest.raises(ValueError) as want:
        if kind == "predict":
            jsteps.compile_predict_step(jmesh, example_params=jparams, tensor_parallel=True,
                                        spatial_partition=True)
        elif kind == "eval":
            jsteps.compile_eval_step(jmesh, C, example_params=jparams, tensor_parallel=True,
                                     spatial_partition=True)
        else:
            opt = jsteps.make_optimizer("sgd")
            jsteps.compile_train_step(jmesh, opt, C, tensor_parallel=True,
                                      example_state=jsteps.create_train_state(jparams, opt),
                                      spatial_partition=True)
    images, labels, mask = (torch.from_numpy(a) for a in BATCHES[("b", 96)])
    params = bridge.to_port(_tree())
    kw = dict(mesh=tmesh.create_mesh(devices=["cpu"]), tensor_parallel=True,
              spatial_partition=True)
    with pytest.raises(ValueError) as got:
        if kind == "predict":
            tsteps.predict_step(bridge.cast_params(params, F32), images, **kw)
        elif kind == "eval":
            tsteps.eval_step(bridge.cast_params(params, F32), empty_metrics_state(C, "cpu"),
                             images, labels, mask, num_classes=C, **kw)
        else:
            opt = tsteps.make_optimizer("sgd")
            tsteps.train_step(tsteps.create_train_state(params, opt), images, labels, mask,
                              SEED, LR, L2, 1.0, optimizer=opt, num_classes=C, **kw)
    assert str(got.value) == str(want.value)


def test_tile_and_spatial_exclude_each_other_in_predict():
    model = FCN8s.from_params(_tree(), device="cpu", compute_dtype=F32, **SMALL)
    with pytest.raises(ValueError, match="tile and spatial_partition are mutually exclusive"):
        model.predict(BATCHES[("b", 96)][0], tile=(32, 32), spatial_partition=True)


def test_decoder_without_subpixel_rejects_a_split():
    from fcn8s_tensorflow_tpu_torch.models.fcn8s import apply_fcn8s_decoder

    mesh = tmesh.Mesh(shape={"data": 1, "model": 2}, coords={"data": 0, "model": 0},
                      device=torch.device("cpu"))
    with pytest.raises(ValueError, match="subpixel=True"):
        apply_fcn8s_decoder({}, None, None, None, subpixel=False,
                            split=tmesh.width_split(96, mesh))


# ---------------------------------------------------------------------------
# the halo exchange alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("level", HALO_LEVELS)
def test_halo_exchange_conv_equals_the_unsharded_conv(groups, shape, k, level):
    """Each rank's block of ``conv2d(halo_exchange(x))`` and of the input's
    gradient is the unsharded conv's, and the weight gradients summed over
    the ranks are its weight gradient, forward and backward. At level 32 on
    (1, 4) each block is one column, so a 7x7's halo spans three ranks."""
    width = WIDTH[shape] // level
    x, weight, gy = _halo_inputs(width, k, seed=level * 10 + k)
    xr, wr = x.clone().requires_grad_(True), weight.clone().requires_grad_(True)
    y = conv2d(xr, wr)
    gx, gw = torch.autograd.grad(y, (xr, wr), gy)
    ranks = _ranks(groups, shape)
    gw_sum = 0
    for rank in ranks:
        got = rank[_key(shape, "halo")][(level, k)]
        lo, hi = got["cols"]
        np.testing.assert_allclose(got["y"], y.detach().numpy()[..., lo:hi], rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["gx"], gx.numpy()[..., lo:hi], rtol=0, atol=1e-12)
        gw_sum = gw_sum + got["gw"]
    # every 'data' position computed the whole batch: its ranks' sum is the gradient
    np.testing.assert_allclose(gw_sum / shape[0], gw.numpy(), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the steps against JAX's spatial steps on a mesh of the same shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_predict_step_matches_jax(groups, shape):
    """Softmax, ids and the overlay (composited from the ids) of a spatial
    predict: JAX's probabilities, ids where its margin is clear."""
    batch = ("b", WIDTH[shape])
    probs = _jax_probs(shape, batch)
    want_ids = probs.argmax(-1)
    for rank in _ranks(groups, shape):
        got = rank[_key(shape, "predict")]
        np.testing.assert_allclose(got["probs"], probs, rtol=1e-4, atol=1e-5)
        assert got["ids"].shape == want_ids.shape
        assert_ids_agree(got["ids"], want_ids, probs)
        lut, images = got["lut"], BATCHES[batch][0].astype(np.float32)
        alpha = lut[got["ids"], 3:] / 255.0
        want = np.floor(images * (1.0 - alpha) + lut[got["ids"], :3] * alpha)
        np.testing.assert_array_equal(got["overlay"], want.astype(np.uint8))


@pytest.mark.parametrize("shape", MESHES)
def test_int8_predict_matches_jax(groups, shape):
    """``predict_step(quantized=True, spatial_partition=True)`` against
    JAX's ``compile_predict_step(quantized=True, spatial_partition=True)``:
    the dynamic scales are the whole batch's, over both axes. On (1, 4) at
    W=128 JAX's int8 spatial predict does not compile (XLA's verifier
    rejects the s8 pad its partitioner emits where fc6's halo spans
    several shards), so the port is held there against JAX's int8 predict
    without the split, the same computation."""
    batch = ("b", WIDTH[shape])
    probs = _jax_probs(shape, batch, quantized=True, spatial=shape != (1, 4))
    for rank in _ranks(groups, shape):
        got = rank[_key(shape, "predict")]
        np.testing.assert_allclose(got["int8_probs"], probs, rtol=1e-4, atol=1e-4)
        assert_ids_agree(got["int8_ids"], probs.argmax(-1), probs)


@pytest.mark.parametrize("shape", MESHES)
def test_eval_step_matches_jax(groups, shape):
    w = WIDTH[shape]
    want = _jax_eval(shape, (("b", w), ("pad", w)))
    probs = np.concatenate([_jax_probs(shape, ("b", w)), _jax_probs(shape, ("pad", w))[:3]])
    for rank in _ranks(groups, shape):
        got = rank[_key(shape, "eval")]
        assert_conf_agree(got["conf"], want["conf"], probs)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-3)


def test_weighted_eval_step_matches_jax(groups):
    shape = (1, 4)
    batch = ("ign", WIDTH[shape])
    want = _jax_eval(shape, (batch,), cw=CLASS_WEIGHTS, ign=IGNORE)
    probs = _jax_probs(shape, batch)
    for rank in _ranks(groups, shape):
        got = rank[_key(shape, "weighted_eval")]
        assert_conf_agree(got["conf"], want["conf"], probs)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_train_step_matches_jax(groups, shape):
    """One SGD step; on (1, 2) and (2, 2) the width splits 64 + 32, so a
    loss normalised by one rank's pixel count would miss by a third."""
    _assert_step(groups, shape, "step", _jax_step(shape, ("b", WIDTH[shape])))


@pytest.mark.parametrize("shape,name,kwargs", [
    ((1, 2), "ignore", dict(ign=IGNORE)),
    ((1, 4), "weighted", dict(cw=CLASS_WEIGHTS, ign=IGNORE)),
])
def test_weighted_and_ignore_label_steps_match_jax(groups, shape, name, kwargs):
    _assert_step(groups, shape, name, _jax_step(shape, ("ign", WIDTH[shape]), **kwargs))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_grad_accum_with_spatial_matches_jax(groups, shape):
    """grad_accum=2 with a padded sample in the batch. On (2, 2) JAX's
    spatial step with grad_accum=2 is off (its loss 2.4206 against 1.6906
    without accumulation, which the single card and (1, 2) give), so the
    port is held there against JAX's spatial step without accumulation:
    the same gradient."""
    batch = ("pad", WIDTH[shape])
    want = _jax_step(shape, batch, accum=2 if shape == (1, 2) else 1)
    _assert_step(groups, shape, "accum", want)


# ---------------------------------------------------------------------------
# against the port's own single-process step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_adam_with_spatial_matches_the_single_process_step(groups, shape):
    _assert_step(groups, shape, "adam", _port_single(("b", WIDTH[shape]), opt="adam"))


@pytest.mark.parametrize("shape", MESHES)
def test_dropout_with_spatial_draws_the_single_card_masks(groups, shape):
    """keep_prob 0.5 under SGD, whose step is linear in the gradient (Adam's
    first step turns a near-zero gradient's summation order into a
    relative difference above the tolerance; Adam is held at keep_prob 1)."""
    _assert_step(groups, shape, "dropout", _port_single(("b", WIDTH[shape]), kp=0.5))


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_augmented_spatial_step_matches_the_single_process_step(groups, shape):
    """The device augmentation runs on the whole rows before the width is
    split, so on (1, m) it is the single-card draw."""
    _assert_step(groups, shape, "augment", _port_single(("b", WIDTH[shape]), augment=True))


def test_remat_with_spatial_recomputes_the_halos(groups):
    """remat=True on (1, 4): the recomputed blocks exchange their halos
    again, on every rank in the same order, and the step is the plain one."""
    shape = (1, 4)
    _assert_step(groups, shape, "remat", _port_single(("b", WIDTH[shape]), kp=0.5))


# ---------------------------------------------------------------------------
# the facade against the JAX facade on a mesh of the same shape
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _jax_facade(shape, tp):
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s

    w = WIDTH[shape]
    mesh = _jax_mesh(shape)
    jm = JFCN8s(num_classes=C, mesh=mesh, tensor_parallel=tp, compute_dtype=jnp.float32,
                optimizer="sgd", **SMALL)
    jm.state = jm.state._replace(params=jax.tree.map(jnp.asarray, _tree()))
    images, labels, _ = BATCHES[("b", w)]
    images2, labels2, _ = BATCHES[("b2", w)]
    jm.train(iter([(images, labels), (images2, labels2)] * 2), epochs=1, steps_per_epoch=2,
             learning_rate_schedule=lambda s: LR, keep_prob=1.0, l2_regularization=L2,
             metrics={"loss", "accuracy"}, eval_frequency=1, eval_dataset="train",
             record_summaries=False, prefetch=0, spatial_partition=True, ema_decay=EMA)
    crop = images[:3, :, :70]
    out = {"train_loss": jm.training_loss, "metrics": list(jm.metric_values),
           "params": jax.tree.map(np.asarray, jm.state.params),
           "probs_spatial": jm.predict(crop, argmax=False, spatial_partition=True)}
    # JAX's TP facade cannot predict without the split after a spatial train
    # (its params stay replicated, and the TP step's shardings reject them);
    # the split one is the same computation
    out["probs"] = out["probs_spatial"] if tp else jm.predict(crop, argmax=False)
    if not tp:
        out["ema_spatial"] = jm.predict(crop, argmax=False, use_ema=True, spatial_partition=True)
    if not tp:
        out["evaluate"] = jm.evaluate(iter([(images2[:3], labels2[:3])]), 1,
                                      spatial_partition=True)
    jm.close()
    return out


@pytest.mark.parametrize("shape,tp", [((1, 2), True), ((2, 2), False)])
def test_facade_spatial_train_eval_predict_match_jax(groups, shape, tp):
    """``train(spatial_partition=True, eval_dataset="train", ema_decay=0.9)``
    with the periodic evaluation on the train stream, then ``predict`` with
    and without the split, with ``use_ema`` (and, off TP, a spatial
    ``evaluate``), against the JAX facade doing the same. The TP model
    trains on gathered params and holds its fc6/fc7 shards again after the
    call."""
    want = _jax_facade(shape, tp)
    name = "facade_tp" if tp else "facade"
    for rank in _ranks(groups, shape):
        got = rank[_key(shape, name)]
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(got["metrics"][0], want["metrics"][0], rtol=1e-5)
        np.testing.assert_allclose(got["metrics"][1], want["metrics"][1], atol=1e-3)
        assert_params_close(got["params"], want["params"])
        for key in ("probs", "probs_spatial"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5)
        # use_ema: the split EMA predict is the unsplit one, and JAX's (off TP)
        np.testing.assert_allclose(got["ema_spatial"], got["ema"], rtol=1e-4, atol=1e-5)
        if not tp:
            np.testing.assert_allclose(got["ema_spatial"], want["ema_spatial"], rtol=1e-4,
                                       atol=1e-5)
        if tp:  # fc6's weight is split on its output channels again
            fc6 = got["params"]["encoder"]["fc6"]["kernel"]
            assert (fc6.shape[3] // shape[1], fc6.shape[2], 7, 7) in got["sharded"]
        else:
            for key in want["evaluate"]:
                tol = dict(rtol=1e-5) if key == "loss" else dict(atol=1e-3)
                np.testing.assert_allclose(got["evaluate"][key], want["evaluate"][key], **tol)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
               jobs=_SPATIAL_JOBS)
