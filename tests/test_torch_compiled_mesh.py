"""PyTorch port, the compiled steps on a mesh of more than one position, on
the CPU: ``compile_*_step(mesh=...)`` with tensor parallelism and with
``spatial_partition``, whose capture is cut at the step's collectives
(``parallel/graphs.py`` ``Segments``). On the CPU, which the workers ask
for, the cut plan runs without graphs: the body's stretches and its
collectives in the order a replay issues them, a backward's collectives
handed from its own thread to the thread that runs the body.

The groups are ``test_torch_mesh.py``'s (gloo, a timeout on init, on each
collective and on the join; the workers import no JAX), run with this
file's jobs: one group of 2 processes for the (2, 1) data-parallel, the
(1, 2) tensor-parallel and the (1, 2) spatial meshes, one of 4 for (2, 2)
with tensor parallelism and (2, 2) spatial. The narrow fp32 models and
batches of those two files; JAX's compiled steps on its 8-device virtual
CPU mesh in this process. Tolerances, theirs:

* against JAX: losses rtol 1e-5; params after one SGD step rtol 2e-4, atol
  1e-6 (XLA:CPU and oneDNN sum the convolutions in other orders); ids
  equal wherever JAX's top-2 probability margin exceeds 1e-4 (and on at
  least 99.9% of pixels); confusion matrices up to two counts per pixel
  inside that margin; spatial probabilities rtol 1e-4, atol 1e-5;
* against the port's eager mesh steps on the same rank: bit for bit, for
  one SGD step, two Adam steps with a binding clip, keep_prob 0.5,
  ``grad_accum=2``, ``ignore_label`` and class weights (with device
  augmentation off the spatial meshes), eval, predict (ids, softmax,
  dynamic int8) and TTA; ``compile_multi_train_step`` at S=2 against two
  compiled single steps;
* the collectives a compiled call issues are those of the eager step, in
  order (``dist.all_reduce``/``dist.all_gather`` as each call makes them,
  ``collectives.describe_call``), and the capture's plan lists them.

Run as a script, this file is a gloo rank of ``test_torch_mesh.launch``.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.augment_device import make_augment_fn  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.metrics import (  # noqa: E402
    empty_metrics_state,
    finalize_metrics,
)
from fcn8s_tensorflow_tpu_torch.ops.quantize import quantize_fcn8s_params  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import collectives as tcoll  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import graphs as G  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import steps as tsteps  # noqa: E402
from tests import test_torch_mesh as TM  # noqa: E402
from tests import test_torch_spatial as TS  # noqa: E402
from tests.test_torch_mesh import (  # noqa: E402
    C,
    CLASS_WEIGHTS,
    IGNORE,
    L2,
    LR,
    SEED,
    _rank_main,
    assert_conf_agree,
    assert_ids_agree,
    assert_params_close,
    launch,
)

F32 = torch.float32
CPU = dict(device="cpu")
AUG = dict(flip=0.5, brightness=(0.8, 1.2, 0.5))
# (mesh, layout): 'dp' plain, 'tp' tensor-parallel, 'sp' spatial_partition
CASES = [((2, 1), "dp"), ((1, 2), "tp"), ((1, 2), "sp"), ((2, 2), "tp"), ((2, 2), "sp")]


def _key(shape, layout):
    return f"{shape[0]}x{shape[1]}/{layout}"


# ---------------------------------------------------------------------------
# the workers: one process per mesh position, no JAX
# ---------------------------------------------------------------------------


class _DistLog:
    """Every ``dist.all_reduce``/``dist.all_gather`` this process makes,
    described as ``collectives.describe_call`` describes it."""

    def __init__(self):
        import torch.distributed as dist

        self.calls, self._dist = [], dist
        self._real = dist.all_reduce, dist.all_gather

        def all_reduce(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
            self.calls.append(tcoll.describe_call("all_reduce", t, group, op))
            return self._real[0](t, op=op, group=group, async_op=async_op)

        def all_gather(parts, t, group=None, async_op=False):
            self.calls.append(tcoll.describe_call("all_gather", t, group))
            return self._real[1](parts, t, group=group, async_op=async_op)

        dist.all_reduce, dist.all_gather = all_reduce, all_gather

    def since(self, start: int) -> list:
        return self.calls[start:]


def _copy(state):
    params = {part: {name: {k: t.detach().clone().requires_grad_(True) for k, t in layer.items()}
                     for name, layer in layers.items()} for part, layers in state.params.items()}
    return tsteps.TrainState(step=state.step, params=params,
                             opt_state=state.opt_state.to("cpu", copy=True))


def _same_state(a, b) -> bool:
    inner_a, inner_b = a.opt_state.inner, b.opt_state.inner
    tensors = [(x, y) for x, y in zip(bridge.param_leaves(a.params), bridge.param_leaves(b.params))]
    if isinstance(inner_a, tsteps.ScaleByAdamTF1State):
        tensors += list(zip(inner_a.mu + inner_a.nu, inner_b.mu + inner_b.nu))
    return (a.step == b.step and a.opt_state.count == b.opt_state.count
            and all(torch.equal(x, y) for x, y in tensors))


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def _job_compiled(job, mesh, tree):
    """The compiled steps on this rank against its eager steps (bit for
    bit), what JAX's side needs, and the collectives of both."""
    layout = job["layout"]
    tp, spatial = layout == "tp", layout == "sp"
    ckw = dict(tensor_parallel=tp)  # the compiled steps take the mesh first
    if spatial:
        ckw["spatial_partition"] = True
        w = TS.WIDTH[tuple(job["mesh"])]
        names = {"b": ("b", w), "pad": ("pad", w), "ign": ("ign", w)}
        batches, rows = TS.BATCHES, TS._rows
    else:
        names = {"b": "b4", "pad": "pad3", "ign": "ign"}
        batches, rows = TM.BATCHES, TM._local
    kw = dict(ckw, mesh=mesh)
    log = _DistLog()
    out, equal = {}, {}

    def params():
        if spatial:
            return bridge.to_port(tree)
        return bridge.to_port_shards(tree, mesh, tensor_parallel=tp)

    def local(name, accum=1):
        return rows(mesh, batches[names[name]], accum)

    # (1) one SGD step at keep_prob 1: JAX's, and the eager step's bits and collectives
    opt = tsteps.make_optimizer("sgd")
    state = tsteps.create_train_state(params(), opt)
    eager = _copy(state)
    at = len(log.calls)
    _, eager_loss = tsteps.train_step(eager, *local("b"), SEED, LR, L2, 1.0, optimizer=opt,
                                      num_classes=C, compute_dtype=F32, **kw)
    eager_calls = log.since(at)
    step = tsteps.compile_train_step(mesh, opt, C, compute_dtype=F32, **ckw, **CPU)
    at = len(log.calls)
    _, loss = step(state, *local("b"), SEED, LR, L2, 1.0)
    compiled_calls = log.since(at)
    captured = step.captures.values()[0].captured
    out["sgd"] = {"loss": float(loss), "params": bridge.to_numpy(
        state.params if spatial else tmesh.gather_params(state.params, mesh, tp))}
    equal["sgd"] = _same_state(state, eager) and torch.equal(loss, eager_loss)
    out["collectives"] = {"eager": eager_calls, "compiled": compiled_calls,
                          "plan": list(captured.issued), "segments": captured.segments}

    # (2) two Adam steps: clip, keep_prob 0.5, grad_accum 2, ignore_label, class weights
    opt = tsteps.make_optimizer("adam", clip_norm=0.05)
    feat = dict(compute_dtype=F32, grad_accum=2, ignore_label=IGNORE,
                class_weights=CLASS_WEIGHTS, **ckw)
    augment = None if spatial else make_augment_fn(**AUG)
    state = tsteps.create_train_state(params(), opt)
    eager = _copy(state)
    step = tsteps.compile_train_step(mesh, opt, C, augment_fn=augment, **feat, **CPU)
    losses = []
    for name in ("ign", "b"):
        _, a = step(state, *local(name, 2), SEED, LR, L2, 0.5)
        _, b = tsteps.train_step(eager, *local(name, 2), SEED, LR, L2, 0.5, optimizer=opt,
                                 num_classes=C, augment_fn=augment, mesh=mesh, **feat)
        losses.append(torch.equal(a, b))
    equal["adam"] = _same_state(state, eager) and all(losses)

    # (3) compile_multi_train_step at S=2 against two compiled single steps
    if not spatial:
        multi_state, singles_state = _copy(state), _copy(state)
        del feat["grad_accum"]
        single = tsteps.compile_train_step(mesh, opt, C, augment_fn=augment, **feat, **CPU)
        singles = [single(singles_state, *local(name), SEED, LR, L2, 0.5)[1]
                   for name in ("b", "ign")]
        multi = tsteps.compile_multi_train_step(mesh, opt, C, steps_per_dispatch=2,
                                                augment_fn=augment, **feat, **CPU)
        stacked = [torch.stack([a, b]) for a, b in zip(local("b"), local("ign"))]
        _, multi_losses = multi(multi_state, *stacked, SEED, LR, L2, 0.5)
        equal["multi"] = (_same_state(multi_state, singles_state)
                          and torch.equal(multi_losses, torch.stack(singles)))
        out["multi_segments"] = (single.captures.values()[0].captured.segments,
                                 multi.captures.values()[0].captured.segments)

    # (4) eval over two batches
    run = bridge.cast_params(params(), F32)
    ev = tsteps.compile_eval_step(mesh, C, compute_dtype=F32, **ckw, **CPU)
    got, want = empty_metrics_state(C, **CPU), empty_metrics_state(C, **CPU)
    for name in ("b", "pad"):
        ev(run, got, *local(name))
        tsteps.eval_step(run, want, *local(name), num_classes=C, compute_dtype=F32, **kw)
    equal["eval"] = _equal(got, want)
    out["eval"] = {"conf": got["conf_matrix"].numpy(),
                   **{k: float(v) for k, v in finalize_metrics(got).items()}}

    # (5) predict: ids, softmax, dynamic int8; (6) TTA
    images = local("b")[0]
    qrun = quantize_fcn8s_params(params() if spatial else bridge.to_port(tree),
                                 compute_dtype=F32)
    with torch.inference_mode():
        for name, tree_, pkw in (("ids", run, {}), ("softmax", run, dict(argmax=False)),
                                 ("int8", qrun, dict(quantized=True))):
            step = tsteps.compile_predict_step(mesh, compute_dtype=F32, **pkw, **ckw, **CPU)
            got = step(tree_, images)
            equal[name] = _equal(got, tsteps.predict_step(tree_, images, compute_dtype=F32,
                                                          **pkw, **kw))
            out[name] = got.numpy()
        if not spatial:
            step = tsteps.compile_tta_step(mesh, scale_hw=(96, 96), compute_dtype=F32, **ckw,
                                           **CPU)
            equal["tta"] = _equal(step(run, images), tsteps.tta_step(
                run, images, scale_hw=(96, 96), compute_dtype=F32, **kw))
    out["equal"] = equal
    return out


# ---------------------------------------------------------------------------
# the groups
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Each case's results, per rank: world 2 runs (2, 1), (1, 2) TP and
    (1, 2) spatial, world 4 the (2, 2) meshes."""
    out = {}
    for world in (2, 4):
        jobs = {_key(shape, layout): dict(kind="compiled", mesh=shape, layout=layout)
                for shape, layout in CASES if shape[0] * shape[1] == world}
        ranks = launch(tmp_path_factory.mktemp(f"compiled{world}"), world, jobs,
                       script=os.path.abspath(__file__))
        for key in jobs:
            out[key] = [rank[key] for rank in ranks]
    return out


def _ids(cases=CASES):
    return [_key(shape, layout) for shape, layout in cases]


# ---------------------------------------------------------------------------
# against JAX's compiled steps on a mesh of the same shape
# ---------------------------------------------------------------------------


def _jax_step(shape, layout):
    if layout == "sp":
        return TS._jax_step(shape, ("b", TS.WIDTH[shape]))
    return TM._jax_step(shape, layout == "tp", "b4")


def _jax_probs(shape, layout):
    if layout == "sp":
        return TS._jax_probs(shape, ("b", TS.WIDTH[shape]))
    return TM._jax_predict(shape, layout == "tp", "b4", argmax=False)


@pytest.mark.parametrize("shape,layout", CASES, ids=_ids())
def test_compiled_train_step_matches_jax(groups, shape, layout):
    loss, params = _jax_step(shape, layout)
    for rank in groups[_key(shape, layout)]:
        np.testing.assert_allclose(rank["sgd"]["loss"], loss, rtol=1e-5)
        assert_params_close(rank["sgd"]["params"], params)


@pytest.mark.parametrize("shape,layout", CASES, ids=_ids())
def test_compiled_eval_step_matches_jax(groups, shape, layout):
    if layout == "sp":
        w = TS.WIDTH[shape]
        want = TS._jax_eval(shape, (("b", w), ("pad", w)))
        probs = np.concatenate([TS._jax_probs(shape, ("b", w)),
                                TS._jax_probs(shape, ("pad", w))[:3]])
    else:
        tp = layout == "tp"
        want = TM._jax_eval(shape, tp, ["b4", "pad3"])
        probs = np.concatenate([TM._jax_predict(shape, tp, "b4", argmax=False),
                                TM._jax_predict(shape, tp, "pad3", argmax=False)[:3]])
    for rank in groups[_key(shape, layout)]:
        got = rank["eval"]
        assert_conf_agree(got["conf"], want["conf"], probs)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


@pytest.mark.parametrize("shape,layout", CASES, ids=_ids())
def test_compiled_predict_step_matches_jax(groups, shape, layout):
    probs = _jax_probs(shape, layout)
    for rank in groups[_key(shape, layout)]:
        assert rank["ids"].shape == probs.shape[:-1]
        assert_ids_agree(rank["ids"], probs.argmax(-1), probs)
        if layout == "sp":
            np.testing.assert_allclose(rank["softmax"], probs, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# against the port's eager mesh steps on the same rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what", ["sgd", "adam", "eval", "ids", "softmax", "int8"])
@pytest.mark.parametrize("shape,layout", CASES, ids=_ids())
def test_compiled_equals_the_eager_mesh_step_bit_for_bit(groups, shape, layout, what):
    for rank in groups[_key(shape, layout)]:
        assert rank["equal"][what], f"rank at {rank['coords']}: compiled {what} differs"


@pytest.mark.parametrize("shape,layout", [c for c in CASES if c[1] != "sp"],
                         ids=_ids([c for c in CASES if c[1] != "sp"]))
def test_compiled_tta_equals_the_eager_mesh_step(groups, shape, layout):
    for rank in groups[_key(shape, layout)]:
        assert rank["equal"]["tta"]


@pytest.mark.parametrize("shape,layout", [((2, 1), "dp"), ((1, 2), "tp"), ((2, 2), "tp")],
                         ids=_ids([((2, 1), "dp"), ((1, 2), "tp"), ((2, 2), "tp")]))
def test_multi_train_step_at_two_equals_two_compiled_steps(groups, shape, layout):
    for rank in groups[_key(shape, layout)]:
        assert rank["equal"]["multi"]
        single, multi = rank["multi_segments"]
        assert multi == 2 * (single - 1) + 1  # the two steps' cuts in turn


@pytest.mark.parametrize("shape,layout", CASES, ids=_ids())
def test_a_replay_issues_the_collectives_of_the_eager_step(groups, shape, layout):
    """The compiled call's collectives (two warm-ups, then the plan run) are
    the eager step's three times over, in order; the plan lists them once,
    and its segments are one more."""
    for rank in groups[_key(shape, layout)]:
        calls = rank["collectives"]
        assert calls["eager"], "the eager mesh step issued no collective"
        assert calls["compiled"] == calls["eager"] * (G.WARMUP + 1)
        assert calls["plan"] == calls["eager"]
        assert calls["segments"] == len(calls["eager"]) + 1


@pytest.mark.parametrize("shape,layout", CASES, ids=_ids())
def test_the_train_step_cuts_where_its_layout_communicates(groups, shape, layout):
    """An SGD step's cuts, by layout: over 'data', the sample counts, the
    loss and the flat gradients; tensor parallelism adds the Megatron pair
    (fc7's sum forward, fc6's input gradient backward); the width split
    adds an all-gather per halo'd conv or deconv forward (the thirteen 3x3
    convs, fc6 and the three deconvs) and one backward but at conv1_1,
    whose input (the image) takes no gradient, and sums the loss and the
    gradients over the whole mesh."""
    data = shape[0] > 1
    want = {"dp": (3, 0), "tp": (2 + 3 * data, 0), "sp": (2 + data, 17 + 16)}[layout]
    for rank in groups[_key(shape, layout)]:
        kinds = [call[0] for call in rank["collectives"]["plan"]]
        assert (kinds.count("all_reduce"), kinds.count("all_gather")) == want


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
               jobs={"compiled": _job_compiled})
