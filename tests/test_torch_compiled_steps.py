"""PyTorch port, the compiled steps (``parallel/steps.py``'s ``compile_*_step``,
``parallel/graphs.py``) on the CPU, where the caller asks for
``device="cpu"`` and the captured body runs without a capture.

* Against the JAX package's ``compile_*_step`` on a one-device CPU mesh,
  three calls each, with the narrow fp32 model and batches of
  tests/test_torch_mesh.py and its tolerances: losses rtol 1e-5; params
  rtol 2e-4, atol 1e-6 after SGD steps (XLA:CPU and oneDNN sum the
  convolutions in different orders); ids equal wherever JAX's top-2
  probability margin exceeds 1e-4 (and on at least 99.9% of pixels);
  confusion matrices up to two counts per pixel under that margin;
  softmax and TTA probabilities rtol 1e-4, atol 1e-6, as
  tests/test_torch_tta.py holds them.
* Against the port's own eager steps, bit for bit: train steps at
  keep_prob 0.5 with device augmentation, ``grad_accum=2`` and
  ``ignore_label`` under each optimizer (Adam held only here, since its
  first step turns a near-zero gradient's rounding into a sign), and eval,
  predict (ids, overlay, softmax, int8) and TTA.
* ``compile_multi_train_step(S=3)`` against three compiled single steps
  (bit for bit) and against JAX's; distinct dropout draws per step.
* The errors, a state swap, the launch accounting of a replay, and the
  capture-safety test: the captured bodies run once under a
  ``TorchDispatchMode`` that fails on a host sync
  (``aten._local_scalar_dense``, ``aten.nonzero``), on a host tensor of
  more than one element made inside the body (on the card, a copy from
  the host), and on any Python float or fresh host tensor carrying the
  learning rate, the L2 rate, keep_prob, 1/keep_prob or Adam's
  ``lr_scale``: values a graph would bake in at capture. The kernels'
  plain twins stand for one kernel launch each and are not looked into.
"""

import inspect
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import kernels as K  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import pool as P  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops import quantize as Q  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.augment_device import make_augment_fn  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.metrics import empty_metrics_state  # noqa: E402
from fcn8s_tensorflow_tpu_torch.ops.nn import dropout, dropout_mask  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import graphs as G  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from fcn8s_tensorflow_tpu_torch.parallel import steps as tsteps  # noqa: E402
from tests.test_torch_mesh import (BATCHES, C, CLASS_WEIGHTS, IGNORE, L2, LR,  # noqa: E402
                                   SEED, _tree, assert_conf_agree, assert_ids_agree,
                                   assert_params_close)

CPU = dict(device="cpu")
F32 = dict(compute_dtype=torch.float32)
THREE = ("b4", "b4b", "pad3")
TTA_HW = (96, 96)
AUG = dict(flip=0.5, brightness=(0.8, 1.2, 0.5), translate=(8, 4, 0.5))
# distinctive values for the capture-safety test (no constant of the model equals them)
SAFE_LR, SAFE_L2, SAFE_KP = 3.17e-4, 2.71e-3, 0.6173
COMPILED = ("compile_train_step", "compile_multi_train_step", "compile_eval_step",
            "compile_predict_step", "compile_tta_step")


def _state(opt):
    return tsteps.create_train_state(bridge.to_port(_tree()), opt)


def _batch(name, ign=False):
    images, labels, mask = BATCHES[name]
    labels = labels.copy()
    if ign:  # a share of ignored pixels
        labels[np.random.default_rng(7).random(labels.shape) < 0.2] = IGNORE
    return [torch.from_numpy(a) for a in (images, labels, mask)]


def _run(tree=None):
    return bridge.cast_params(bridge.to_port(_tree() if tree is None else tree), torch.float32)


def _same_state(a, b) -> None:
    assert a.step == b.step
    assert (a.opt_state.count, a.opt_state.learning_rate) == (b.opt_state.count,
                                                               b.opt_state.learning_rate)
    for x, y in zip(bridge.param_leaves(a.params), bridge.param_leaves(b.params)):
        assert torch.equal(x, y)
    ia, ib = a.opt_state.inner, b.opt_state.inner
    if isinstance(ia, tsteps.ScaleByAdamTF1State):
        assert ia.count == ib.count
        ia, ib = ia.mu + ia.nu, ib.mu + ib.nu
    for x, y in zip(G.tensors_of(ia), G.tensors_of(ib)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the call forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", COMPILED)
def test_signature_is_jax_plus_device(name):
    """JAX's positional and keyword names, kinds and order, then ``device``."""
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    want = list(inspect.signature(getattr(jsteps, name)).parameters.values())
    got = list(inspect.signature(getattr(tsteps, name)).parameters.values())
    assert [(p.name, p.kind) for p in got[:-1]] == [(p.name, p.kind) for p in want]
    assert got[-1].name == "device" and got[-1].default == "cuda"


def test_errors():
    """JAX's argument errors, and what is no error any more: a mesh of more
    than one position and ``spatial_partition`` are taken (their capture is
    cut at the collectives, ``tests/test_torch_compiled_mesh.py``)."""
    opt = tsteps.make_optimizer("sgd")
    two = types.SimpleNamespace(size=2)
    steps = [tsteps.compile_train_step(two, opt, C, **CPU),
             tsteps.compile_multi_train_step(two, opt, C, steps_per_dispatch=2, **CPU),
             tsteps.compile_eval_step(two, C, **CPU), tsteps.compile_predict_step(two, **CPU),
             tsteps.compile_tta_step(two, **CPU),
             tsteps.compile_train_step(None, opt, C, tensor_parallel=False,
                                       spatial_partition=True, **CPU)]
    assert all(step.captures_made == 0 for step in steps)
    for fn, args in ((tsteps.compile_train_step, (opt, C)), (tsteps.compile_eval_step, (C,)),
                     (tsteps.compile_predict_step, ())):
        with pytest.raises(ValueError, match="mutually exclusive"):  # JAX's check
            fn(None, *args, spatial_partition=True, **CPU)  # tensor_parallel defaults to True
    with pytest.raises(TypeError, match="spatial_partition"):  # JAX's have no such argument
        tsteps.compile_multi_train_step(None, opt, C, steps_per_dispatch=2,
                                        spatial_partition=True, **CPU)
    with pytest.raises(TypeError, match="spatial_partition"):
        tsteps.compile_tta_step(None, spatial_partition=True, **CPU)
    for s in (0, -1):
        with pytest.raises(ValueError, match="steps_per_dispatch must be >= 1"):
            tsteps.compile_multi_train_step(None, opt, C, steps_per_dispatch=s, **CPU)


@pytest.mark.parametrize("name", COMPILED)
def test_no_card_raises_and_names_device_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = tsteps.make_optimizer()
    args = {"compile_train_step": (None, opt, C), "compile_multi_train_step": (None, opt, C),
            "compile_eval_step": (None, C)}.get(name, (None,))
    kw = dict(steps_per_dispatch=2) if name == "compile_multi_train_step" else {}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(tsteps, name)(*args, **kw)


def test_one_position_mesh_is_accepted():
    mesh = tmesh.create_mesh(devices=["cpu"])
    opt = tsteps.make_optimizer("sgd")
    a, b = _state(opt), _state(opt)
    step = tsteps.compile_train_step(mesh, opt, C, compute_dtype=torch.float32, **CPU)
    plain = tsteps.compile_train_step(None, opt, C, compute_dtype=torch.float32, **CPU)
    step(a, *_batch("b4"), SEED, LR, L2, 1.0)
    plain(b, *_batch("b4"), SEED, LR, L2, 1.0)
    _same_state(a, b)


# ---------------------------------------------------------------------------
# against JAX's compiled steps on a one-device mesh
# ---------------------------------------------------------------------------


def _jax_mesh():
    import jax
    from fcn8s_tensorflow_tpu.parallel.mesh import create_mesh

    return create_mesh(1, 1, devices=jax.devices()[:1])


def _jax_state(optimizer):
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    return jsteps.create_train_state(jax.tree.map(jnp.asarray, _tree()), optimizer)


TRAIN_CASES = {"plain": {}, "weighted": dict(ign=True, class_weights=CLASS_WEIGHTS,
                                             ignore_label=IGNORE),
               "accum": dict(grad_accum=2)}


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_step_matches_jax_for_three_steps(case):
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    kw = dict(TRAIN_CASES[case])
    ign = kw.pop("ign", False)
    mesh = _jax_mesh()
    jopt = jsteps.make_optimizer("sgd")
    jstate = _jax_state(jopt)
    jstep = jsteps.compile_train_step(mesh, jopt, C, tensor_parallel=False,
                                      compute_dtype=jnp.float32, example_state=jstate,
                                      donate=False, **kw)
    opt = tsteps.make_optimizer("sgd")
    state = _state(opt)
    step = tsteps.compile_train_step(tmesh.create_mesh(devices=["cpu"]), opt, C, **F32, **kw,
                                     **CPU)
    for name in THREE:
        batch = _batch(name, ign)
        jstate, jloss = jstep(jstate, *[b.numpy() for b in batch], jax.random.PRNGKey(0), LR, L2,
                              1.0)
        state, loss = step(state, *batch, SEED, LR, L2, 1.0)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.step == int(jstate.step) == 3
    assert_params_close(bridge.to_numpy(state.params), jax.tree.map(np.asarray, jstate.params))


def test_multi_train_step_matches_jax_and_three_compiled_steps():
    """S=3 steps in one dispatch: JAX's ``compile_multi_train_step`` within
    the tolerances, three compiled single steps of the port bit for bit."""
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    stacked = [np.stack([BATCHES[n][i] for n in THREE]) for i in range(3)]
    jopt = jsteps.make_optimizer("sgd")
    jstate = _jax_state(jopt)
    jmulti = jsteps.compile_multi_train_step(_jax_mesh(), jopt, C, steps_per_dispatch=3,
                                             tensor_parallel=False, compute_dtype=jnp.float32,
                                             example_state=jstate, donate=False)
    jstate, jlosses = jmulti(jstate, *stacked, jax.random.PRNGKey(0), LR, L2, 1.0)

    opt = tsteps.make_optimizer("sgd")
    multi_state, single_state = _state(opt), _state(opt)
    multi = tsteps.compile_multi_train_step(None, opt, C, steps_per_dispatch=3, **F32, **CPU)
    multi_state, losses = multi(multi_state, *[torch.from_numpy(a) for a in stacked], SEED, LR,
                                L2, 1.0)
    assert losses.shape == (3,) and multi_state.step == int(jstate.step) == 3
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    assert_params_close(bridge.to_numpy(multi_state.params),
                        jax.tree.map(np.asarray, jstate.params))

    single = tsteps.compile_train_step(None, opt, C, **F32, **CPU)
    singles = [single(single_state, *_batch(n), SEED, LR, L2, 1.0)[1] for n in THREE]
    assert torch.equal(losses, torch.stack(singles))
    _same_state(multi_state, single_state)


def test_multi_train_step_draws_distinct_dropout_per_step():
    """Two steps in one dispatch on IDENTICAL data at lr 0 and keep_prob
    0.5: different losses, since each step draws its own masks."""
    opt = tsteps.make_optimizer("sgd")
    state = _state(opt)
    im, lb, mk = _batch("b4")
    multi = tsteps.compile_multi_train_step(None, opt, C, steps_per_dispatch=2, **F32, **CPU)
    _, losses = multi(state, torch.stack([im, im]), torch.stack([lb, lb]), torch.stack([mk, mk]),
                      SEED, 0.0, 0.0, 0.5)
    assert torch.isfinite(losses).all() and losses[0] != losses[1]


def _jax_probs(names, params):
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    step = jsteps.compile_predict_step(_jax_mesh(), argmax=False, tensor_parallel=False,
                                       compute_dtype=jnp.float32, example_params=params)
    return [np.asarray(step(params, BATCHES[n][0])) for n in names]


def test_eval_step_matches_jax_over_three_batches():
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.ops.metrics import empty_metrics_state as j_empty
    from fcn8s_tensorflow_tpu.ops.metrics import finalize_metrics as j_finalize
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    from fcn8s_tensorflow_tpu_torch.ops.metrics import finalize_metrics

    params = jax.tree.map(jnp.asarray, _tree())
    jstep = jsteps.compile_eval_step(_jax_mesh(), C, tensor_parallel=False,
                                     compute_dtype=jnp.float32, example_params=params)
    jstate = j_empty(C)
    step = tsteps.compile_eval_step(None, C, **F32, **CPU)
    state, run = empty_metrics_state(C, **CPU), _run()
    for name in THREE:
        jstate = jstep(params, jstate, *BATCHES[name])
        assert step(run, state, *_batch(name)) is state
    probs = np.concatenate(_jax_probs(THREE, params))
    assert_conf_agree(state["conf_matrix"].numpy(), np.asarray(jstate["conf_matrix"]), probs)
    assert float(state["loss_count"]) == 3.0
    np.testing.assert_allclose(float(finalize_metrics(state)["loss"]),
                               float(j_finalize(jstate)["loss"]), rtol=1e-5)


@pytest.mark.parametrize("argmax", [True, False])
def test_predict_step_matches_jax_for_three_calls(argmax):
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    params = jax.tree.map(jnp.asarray, _tree())
    jstep = jsteps.compile_predict_step(_jax_mesh(), argmax=argmax, tensor_parallel=False,
                                        compute_dtype=jnp.float32, example_params=params)
    step = tsteps.compile_predict_step(None, argmax=argmax, **F32, **CPU)
    run = _run()
    for name, probs in zip(THREE, _jax_probs(THREE, params)):
        want = np.asarray(jstep(params, BATCHES[name][0]))
        got = step(run, _batch(name)[0]).numpy()
        assert got.shape == want.shape
        if argmax:
            assert_ids_agree(got, want, probs)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_tta_step_matches_jax_for_three_calls():
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.parallel import steps as jsteps

    params = jax.tree.map(jnp.asarray, _tree())
    jstep = jsteps.compile_tta_step(_jax_mesh(), scale_hw=TTA_HW, flip=True,
                                    tensor_parallel=False, compute_dtype=jnp.float32,
                                    example_params=params)
    step = tsteps.compile_tta_step(None, scale_hw=TTA_HW, flip=True, **F32, **CPU)
    run = _run()
    for name in THREE:
        want = np.asarray(jstep(params, BATCHES[name][0]))
        got = step(run, _batch(name)[0]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# against the port's eager steps, bit for bit
# ---------------------------------------------------------------------------

OPTIMIZERS = {"adam": ("adam", None, {}), "adamw": ("adamw", None, dict(weight_decay=1e-3)),
              "momentum": ("momentum", None, dict(nesterov=True)), "sgd_clip": ("sgd", 0.05, {})}


@pytest.mark.parametrize("opt_case,dtype", [(k, torch.float32) for k in OPTIMIZERS]
                         + [("adam", torch.bfloat16)])
def test_train_step_equals_the_eager_step(opt_case, dtype):
    """keep_prob 0.5, device augmentation, grad_accum=2, ignore_label:
    three steps give the eager steps' losses, params, moments and counters
    bit for bit (the warm-up trains nothing)."""
    name, clip, hyper = OPTIMIZERS[opt_case]
    opt = tsteps.make_optimizer(name, clip_norm=clip, **hyper)
    kw = dict(compute_dtype=dtype, grad_accum=2, ignore_label=IGNORE,
              augment_fn=make_augment_fn(**AUG))
    eager, comp = _state(opt), _state(opt)
    step = tsteps.compile_train_step(None, opt, C, **kw, **CPU)
    for i, batch in enumerate(THREE):
        lr = LR * (1 + i)  # a schedule: the scalar changes between replays
        _, want = tsteps.train_step(eager, *_batch(batch, True), SEED, lr, L2, 0.5,
                                    optimizer=opt, num_classes=C, **kw)
        _, got = step(comp, *_batch(batch, True), SEED, lr, L2, 0.5)
        assert torch.equal(got, want)
    _same_state(comp, eager)
    assert len(step.captures) == 1


def test_keep_prob_regimes_are_captured_apart():
    """A keep_prob of 1 after one below 1 takes its own capture, and each
    gives the eager step's result."""
    opt = tsteps.make_optimizer("sgd")
    eager, comp = _state(opt), _state(opt)
    step = tsteps.compile_train_step(None, opt, C, **F32, **CPU)
    for kp in (0.5, 1.0, 0.7):
        _, want = tsteps.train_step(eager, *_batch("b4"), SEED, LR, L2, kp, optimizer=opt,
                                    num_classes=C, **F32)
        _, got = step(comp, *_batch("b4"), SEED, LR, L2, kp)
        assert torch.equal(got, want)
    _same_state(comp, eager)
    assert len(step.captures) == 2


def test_a_swapped_state_is_captured_anew():
    """A second state gets its own capture beside the first one's, which
    it leaves untouched; the first state then replays its own again."""
    opt = tsteps.make_optimizer("adam")
    first, second, eager = _state(opt), _state(opt), _state(opt)
    step = tsteps.compile_train_step(None, opt, C, **F32, **CPU)
    step(first, *_batch("b4"), SEED, LR, L2, 0.5)
    old, = step.captures.values()
    kept = [t.clone() for t in bridge.param_leaves(first.params)]
    _, got = step(second, *_batch("b4b"), SEED, LR, L2, 0.5)
    assert len(step.captures) == 2 and step.captures_made == 2
    new = step.captures.values()[-1]
    assert new is not old and new.captured is not old.captured
    for a, b in zip(bridge.param_leaves(first.params), kept):
        assert torch.equal(a, b)
    _, want = tsteps.train_step(eager, *_batch("b4b"), SEED, LR, L2, 0.5, optimizer=opt,
                                num_classes=C, **F32)
    assert torch.equal(got, want)
    _same_state(second, eager)
    step(first, *_batch("b4"), SEED, LR, L2, 0.5)
    assert step.captures_made == 2 and step.captures.values()[-1] is old


def test_eval_step_equals_the_eager_step():
    run = _run()
    step = tsteps.compile_eval_step(None, C, ignore_label=IGNORE, class_weights=CLASS_WEIGHTS,
                                    **F32, **CPU)
    got, want = empty_metrics_state(C, **CPU), empty_metrics_state(C, **CPU)
    for name in THREE:
        batch = _batch(name, True)
        tsteps.eval_step(run, want, *batch, num_classes=C, ignore_label=IGNORE,
                         class_weights=CLASS_WEIGHTS, **F32)
        step(run, got, *batch)
    for k in want:
        assert torch.equal(got[k], want[k])


PREDICT_CASES = {"ids": dict(id_dtype=torch.uint8), "softmax": dict(argmax=False),
                 "overlay": dict(overlay_lut=np.array([[255, 0, 0, 128], [0, 255, 0, 0],
                                                       [0, 0, 255, 255], [9, 9, 9, 77],
                                                       [0, 0, 0, 200]], np.float32)),
                 "int8": dict(quantized=True)}


@pytest.mark.parametrize("case", PREDICT_CASES)
def test_predict_step_equals_the_eager_step(case):
    kw = PREDICT_CASES[case]
    params = (Q.quantize_fcn8s_params(bridge.to_port(_tree()), compute_dtype=torch.float32)
              if kw.get("quantized") else _run())
    step = tsteps.compile_predict_step(None, **kw, **F32, **CPU)
    for name in THREE:
        images = _batch(name)[0]
        assert torch.equal(step(params, images),
                           tsteps.predict_step(params, images, **kw, **F32))


@pytest.mark.parametrize("flip,scale_hw", [(True, TTA_HW), (False, None)])
def test_tta_step_equals_the_eager_step(flip, scale_hw):
    run = _run()
    step = tsteps.compile_tta_step(None, scale_hw=scale_hw, flip=flip, **F32, **CPU)
    for name in THREE:
        images = _batch(name)[0]
        assert torch.equal(step(run, images),
                           tsteps.tta_step(run, images, scale_hw=scale_hw, flip=flip, **F32))


def test_dropout_takes_a_device_keep_prob_bit_for_bit():
    x = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    for kp in (0.5, 0.6173, 0.9):
        t = torch.tensor(kp, dtype=torch.float32)
        m = dropout_mask(x.shape, kp, torch.Generator().manual_seed(1))
        assert torch.equal(m, dropout_mask(x.shape, t, torch.Generator().manual_seed(1)))
        assert torch.equal(dropout(x, kp, m), dropout(x, t, m))
    assert dropout(x, 1.0, None) is x


# ---------------------------------------------------------------------------
# the capture machinery
# ---------------------------------------------------------------------------


def test_fixed_generators_draw_what_fresh_ones_draw():
    gens = G.FixedGenerators("cpu")
    for seed in (3, 11):
        gens.reseed(lambda site: seed * 100 + site)
        got = [torch.rand(5, generator=gens.get(site)) for site in (1, 2)]
        want = [torch.rand(5, generator=torch.Generator().manual_seed(seed * 100 + site))
                for site in (1, 2)]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(gens.all()) == 2


def test_a_replay_adds_the_recorded_launches():
    """``Captured.run`` replays and adds each wrapper's recorded count, so
    the counters count a kernel recorded in a graph at every replay."""
    replays = []
    recorded = [i + 1 for i in range(len(G.KERNEL_WRAPPERS))]
    cap = G.Captured(None, types.SimpleNamespace(replay=lambda: replays.append(1)), "out",
                     recorded)
    before = [fn.launches for fn in G.KERNEL_WRAPPERS]
    try:
        assert cap.run() == "out" and cap.run() == "out"
        assert replays == [1, 1]
        assert [fn.launches - b for fn, b in zip(G.KERNEL_WRAPPERS, before)] == \
            [2 * n for n in recorded]
    finally:
        for fn, b in zip(G.KERNEL_WRAPPERS, before):
            fn.launches = b


def test_the_warm_up_leaves_the_state_as_it_found_it():
    t = torch.zeros(3)
    calls = []

    def body():
        calls.append(1)
        t.add_(1.0)
        return t

    cap = G.capture(body, torch.device("cpu"), restore=[t])
    assert len(calls) == G.WARMUP and torch.equal(t, torch.zeros(3))
    cap.run()
    assert torch.equal(t, torch.ones(3))


class _HostValueGuard(TorchDispatchMode):
    """Records the ops of a captured body that would sync with the host, copy
    from it, or take one of ``values`` as a number fixed at capture."""

    SYNCS = ("aten._local_scalar_dense", "aten.nonzero", "aten.item")

    def __init__(self, values):
        super().__init__()
        self.values, self.found, self.muted = values, [], 0

    def _is_value(self, x) -> bool:
        return isinstance(x, float) and any(math.isclose(abs(x), v, rel_tol=1e-6)
                                            for v in self.values)

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.muted:
            return out
        name = str(func.overloadpacket)
        flat = torch.utils._pytree.tree_leaves((args, kwargs))
        if name.startswith(self.SYNCS):
            self.found.append(f"{func}: a host sync")
        if any(self._is_value(x) for x in flat):
            found = [x for x in flat if self._is_value(x)]
            self.found.append(f"{func} takes a host scalar: {found}")
        if name == "aten.lift_fresh":
            made = args[0]
            if made.numel() > 1:
                self.found.append(f"{func}: a host tensor of {tuple(made.shape)} made in the body")
            elif made.is_floating_point() and self._is_value(float(made)):
                self.found.append(f"{func}: a host tensor of {float(made)}")
        return out


TWINS = [(K, "ce_sum_per_sample_plain"), (K, "ce_sum_weighted_plain"), (K, "ce_grad_plain"),
         (K, "confusion_matrix_accumulate_plain"), (P, "maxpool2x2_code_plain"),
         (P, "maxpool2x2_bwd_plain"), (P, "max_pool_2x2"), (Q, "conv2d_int8_reference")]


def _mute_twins(monkeypatch, guard):
    """Each kernel's plain twin stands for one launch of its kernel on the
    card: its own ops are not looked into."""
    for mod, name in TWINS:
        twin = getattr(mod, name)

        def muted(*a, _twin=twin, **k):
            guard.muted += 1
            try:
                return _twin(*a, **k)
            finally:
                guard.muted -= 1

        monkeypatch.setattr(mod, name, muted)


def _captured_train(multi: bool):
    opt = tsteps.make_optimizer("adam", clip_norm=10.0)
    state = _state(opt)
    kw = dict(compute_dtype=torch.float32, grad_accum=2, ignore_label=IGNORE,
              class_weights=CLASS_WEIGHTS, augment_fn=make_augment_fn(resize=(64, 64), **AUG))
    batch = _batch("b4", True)
    if multi:
        step = tsteps.compile_multi_train_step(None, opt, C, steps_per_dispatch=2, **kw, **CPU)
        batch = [torch.stack([b, b]) for b in batch]
    else:
        step = tsteps.compile_train_step(None, opt, C, **kw, **CPU)
    step(state, *batch, SEED, SAFE_LR, SAFE_L2, SAFE_KP)
    scales = [opt.lr_scale(t) for t in range(1, 6)]
    return step, (state.params, state.opt_state), [SAFE_LR, SAFE_L2, SAFE_KP,
                                                   1.0 / SAFE_KP] + scales


def _captured_forward(kind: str):
    run = _run()
    batch = _batch("b4", True)
    if kind == "eval":
        step = tsteps.compile_eval_step(None, C, ignore_label=IGNORE, class_weights=CLASS_WEIGHTS,
                                        **F32, **CPU)
        step(run, empty_metrics_state(C, **CPU), *batch)
    elif kind == "predict":
        lut = PREDICT_CASES["overlay"]["overlay_lut"]
        step = tsteps.compile_predict_step(None, overlay_lut=lut, **F32, **CPU)
        step(run, batch[0])
    elif kind == "int8":
        step = tsteps.compile_predict_step(None, quantized=True, **F32, **CPU)
        run = Q.quantize_fcn8s_params(bridge.to_port(_tree()), compute_dtype=torch.float32)
        step(run, batch[0])
    else:
        step = tsteps.compile_tta_step(None, scale_hw=TTA_HW, **F32, **CPU)
        step(run, batch[0])
    return step, (run,), []


@pytest.mark.parametrize("kind", ["train", "multi", "eval", "predict", "int8", "tta"])
def test_captured_bodies_are_capture_safe(kind, monkeypatch):
    step, args, values = (_captured_train(kind == "multi") if kind in ("train", "multi")
                          else _captured_forward(kind))
    entry, = step.captures.values()
    guard = _HostValueGuard(values)
    _mute_twins(monkeypatch, guard)
    with guard:
        entry.captured.run(*args)
    assert not guard.found, guard.found


def test_the_guard_sees_what_it_guards_against(monkeypatch):
    """The eager step computes Adam's lr_scale with a read-back and takes
    the learning rate and keep_prob as numbers: the guard reports them."""
    opt = tsteps.make_optimizer("adam")
    state = _state(opt)
    guard = _HostValueGuard([SAFE_LR, SAFE_KP, 1.0 / SAFE_KP, SAFE_L2])
    _mute_twins(monkeypatch, guard)
    with guard:
        tsteps.train_step(state, *_batch("b4"), SEED, SAFE_LR, SAFE_L2, SAFE_KP, optimizer=opt,
                          num_classes=C, **F32)
    text = "\n".join(guard.found)
    assert "_local_scalar_dense" in text and "host scalar" in text and "host tensor" in text
