"""PyTorch port, SegFormer on the CPU: the port against its plain reference.

A tiny MiT (widths 8/16/32/32, heads 1/2/2/4, depths 1/1/2/1, the published
reduction ratios 8/4/2/1, a 32-channel head, 5 classes) on 64x64 scenes,
seeded random weights. The port (``models/segformer.py`` through
``parallel/steps.py`` and the ``FCN8s`` facade) is held against
``reference/segformer.py`` (plain fp32 torch): logits in fp32 and bf16,
each leaf's first gradient, three AdamW steps with the per-leaf
multipliers, BatchNorm's running statistics; the compiled facade against
its eager steps bit for bit; a checkpoint round trip; the paths SegFormer
refuses; and the benchmark's copy of the reference against this one.

Each tolerance says why it is what it is. A control that rounds every
product's inputs to float8 (``precision='fp8'``) must fail at least one of
the bf16 tolerances, so they tell bf16 from the step below it.

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of the gradient and step comparisons (``_moving``): the
biases that feed BatchNorm's input (``linear_c*``, through the fuse, and
``norm4``'s) and the keys' bias have no gradient at all (BatchNorm and the
softmax remove a constant), so what moves them is round-off, and Adam
turns round-off into steps of the learning rate's size.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models.segformer import (apply_segformer,  # noqa: E402
                                                         init_segformer, is_segformer)
from fcn8s_tensorflow_tpu_torch.parallel import steps as S  # noqa: E402
from fcn8s_tensorflow_tpu_torch.reference import segformer as ref  # noqa: E402

C = 5
HW = (64, 64)
SEED = 7  # the dropout draws' seed
TINY = dict(widths=(8, 16, 32, 32), heads=(1, 2, 2, 4), depths=(1, 1, 2, 1),
            sr_ratios=(8, 4, 2, 1), embed_dim=32)
CUSTOM_KEYS = {"decoder": {"lr_mult": 10.0}, "norm": {"decay_mult": 0.0}}
CFG = {
    "encoder": {"widths": [8, 16, 32, 32], "heads": [1, 2, 2, 4], "depths": [1, 1, 2, 1],
                "sr_ratios": [8, 4, 2, 1], "patches": [[7, 4], [3, 2], [3, 2], [3, 2]],
                "mlp_ratio": 4},
    "decoder": {"embed_dim": 32, "bn_eps": 1e-5, "bn_momentum": 0.1},
    "normalize": {"mean": [123.675, 116.28, 103.53], "std": [58.395, 57.12, 57.375]},
    "keep_prob": 0.9,
    "optimizer": {"learning_rate": 6e-5, "b1": 0.9, "b2": 0.999, "eps": 1e-8,
                  "weight_decay": 0.01, "custom_keys": CUSTOM_KEYS},
}
OPT_KW = dict(weight_decay=0.01, custom_keys=CUSTOM_KEYS)

# fp32 port against the fp32 reference: the same arithmetic in another order
# (observed <= 3.3e-7 of the largest logit, <= 2.4e-6 on gradients)
TOL_FP32 = 1e-5
# bf16 port against the fp32 reference, each above what bf16 gave on the
# seeds below and under what the fp8 control gives (observed, bf16 / fp8):
TOL_LOGITS = 0.03  # largest logit error over the largest logit: 0.008 / 0.09
TOL_GRAD = 0.05  # worst moving leaf's first-gradient norm gap: 0.022 / >= 0.09
TOL_HEAD = 0.1  # worst decoder kernel's first gradient, as a vector: 0.051 / >= 0.18
TOL_DELTA = 0.08  # worst moving leaf's three-step change norm gap: 0.048 / >= 0.097
TOL_VAR = 3e-4  # running variance's three-step change, as a vector: 8e-5 / >= 7.5e-4


def tiny_tree(seed: int) -> dict:
    """The tiny model's JAX-layout tree; the class prediction's kernel at
    He scale, so random-weight logits spread and each pixel's loss depends
    on its label."""
    tree = init_segformer(torch.Generator().manual_seed(seed), C, **TINY)
    pred = tree["decoder"]["linear_pred"]
    gen = torch.Generator().manual_seed(seed + 1)
    pred["kernel"] = torch.randn(pred["kernel"].shape, generator=gen) * (2 / 32) ** 0.5
    return tree


def scenes(seed: int, n: int = 2):
    """``n`` uint8 images and trainId maps that follow the red channel."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, *HW, 3), dtype=np.uint8)
    return images, (images[..., 0] // 52 % C).astype(np.uint8)


def _paths(p):
    return bridge.jax_leaf_paths(p)


def _moving(ref_grads: dict) -> set:
    med = float(np.median(list(ref_grads.values())))
    return {k for k, g in ref_grads.items() if g >= 1e-3 * med}


def _norm_gap(prog: dict, want: dict, keep) -> float:
    med = float(np.median(list(want.values())))
    return max(abs(prog[k] - want[k]) / max(want[k], med) for k in keep)


def _vec_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def port_train(tree, batches, dtype, steps=3):
    """The port's first gradient (by JAX path, JAX layout), its ``steps``
    losses, each leaf's change and the running statistics, through
    ``loss_and_grads`` and ``train_step``."""
    p = bridge.to_port(tree)
    opt = S.make_optimizer("adamw", **OPT_KW)
    state = S.create_train_state(p, opt)
    im, lb = (torch.from_numpy(x) for x in batches[0])
    saved = [t.clone() for t in bridge.state_leaves(p)]
    _, grads = S.loss_and_grads(p, im, lb, torch.ones(2), seed=SEED, step=0, l2_rate=0.0,
                                keep_prob=CFG["keep_prob"], compute_dtype=dtype)
    for t, s in zip(bridge.state_leaves(p), saved):  # that forward moved them
        t.copy_(s)
    out = {"grad1": {path: bridge.leaf_to_jax(g, path).detach()
                     for g, path in zip(grads, _paths(p))}, "losses": []}
    for k in range(steps):
        im, lb = (torch.from_numpy(x) for x in batches[k])
        state, loss = S.train_step(state, im, lb, torch.ones(2), SEED, 6e-5, 0.0,
                                   CFG["keep_prob"], optimizer=opt, num_classes=C,
                                   compute_dtype=dtype)
        out["losses"].append(float(loss))
    start = bridge.to_port(tree)
    out["delta"] = {path: float((a.detach() - b).norm()) for a, b, path in
                    zip(bridge.param_leaves(p), bridge.param_leaves(start), _paths(p))}
    out["stats"] = {k: t.detach().numpy() for k, t in p["batch_stats"]["linear_fuse_bn"].items()}
    return out


def ref_gradients(tree, batch) -> dict:
    """The reference's first gradient of every trained leaf, by path."""
    params = {part: {name: {k: t.detach().clone().requires_grad_(part != "batch_stats")
                            for k, t in layer.items()} for name, layer in layers.items()}
              for part, layers in tree.items()}
    stats = params["batch_stats"]["linear_fuse_bn"]
    images, labels = (torch.from_numpy(x) for x in batch)
    logits = ref.forward(params, stats, images, CFG, ref.draws(CFG, SEED, 0, 2, "cpu"))
    loss = torch.nn.functional.cross_entropy(logits, labels.long(), reduction="sum") / labels.numel()
    paths = ref.leaf_paths(tree)
    leaves = [params[p.split("/")[0]][p.split("/")[1]][p.split("/")[2]] for p in paths]
    return {p: g.numpy() for p, g in zip(paths, torch.autograd.grad(loss, leaves))}


def gaps(prog: dict, want: dict) -> dict:
    """The bf16 readings of a run (the port's, or a control's in the
    reference's form) against the fp32 reference."""
    ref_g = dict(zip(want["paths"], want["grad1"]))
    keep = _moving(ref_g)
    heads = [p for p in want["paths"] if p.startswith("decoder/") and p.endswith("/kernel")]
    if "paths" in prog:  # a reference run
        grads = dict(zip(prog["paths"], prog["grad1"]))
        head = prog["grad1_head"]
        delta = dict(zip(prog["paths"], prog["delta"]))
    else:
        grads = {k: float(v.norm()) for k, v in prog["grad1"].items()}
        head = [prog["grad1"][p].numpy() for p in heads]
        delta = prog["delta"]
    return {"grad": _norm_gap(grads, ref_g, keep),
            "head": max(_vec_gap(a, b) for a, b in zip(head, want["grad1_head"])),
            "delta": _norm_gap(delta, dict(zip(want["paths"], want["delta"])), keep),
            "var": _vec_gap(prog["stats"]["var"] - 1.0, want["stats"]["var"] - 1.0)}


@pytest.fixture(scope="module", params=[0, 1])
def case(request):
    seed = request.param
    tree = tiny_tree(seed)
    batches = [scenes(10 * seed + k) for k in range(3)]
    with ref.exact_fp32():
        want = ref.train(tree, batches, CFG, SEED, 3)
    return tree, batches, want


def test_tree_is_told_apart_and_its_layout_read():
    tree = tiny_tree(0)
    assert is_segformer(tree) and is_segformer(bridge.to_port(tree))
    p = bridge.to_port(tree)
    assert bridge.state_paths(p) == ["batch_stats/linear_fuse_bn/mean",
                                     "batch_stats/linear_fuse_bn/var"]
    assert all(not path.startswith("batch_stats") for path in _paths(p))
    # to_port and to_numpy round-trip every leaf, the state's too
    back = bridge.to_numpy(p)
    for part, layers in tree.items():
        for name, layer in layers.items():
            for key, t in layer.items():
                assert np.array_equal(back[part][name][key], t.numpy()), (part, name, key)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_logits_match_the_reference(dtype):
    tree = tiny_tree(0)
    images = torch.from_numpy(scenes(3)[0])
    run_dtype = torch.float32 if dtype == "fp32" else torch.bfloat16
    with torch.no_grad():
        got = apply_segformer(bridge.cast_params(bridge.to_port(tree), run_dtype), images,
                              compute_dtype=run_dtype)
        stats = {k: t.clone() for k, t in tree["batch_stats"]["linear_fuse_bn"].items()}
        want = ref.forward(tree, stats, images, CFG, bn="eval").permute(0, 2, 3, 1)
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert err <= (TOL_FP32 if dtype == "fp32" else TOL_LOGITS)


def test_fp8_control_fails_the_logit_tolerance():
    tree = tiny_tree(0)
    images = torch.from_numpy(scenes(3)[0])
    with torch.no_grad():
        stats = {k: t.clone() for k, t in tree["batch_stats"]["linear_fuse_bn"].items()}
        want = ref.forward(tree, stats, images, CFG, bn="eval")
        fp8 = ref.forward(tree, stats, images, CFG, bn="eval", precision="fp8")
    assert float((fp8 - want).abs().max() / want.abs().max()) > TOL_LOGITS


def test_fp32_gradients_and_steps_match_the_reference(case):
    tree, batches, want = case
    got = port_train(tree, batches, torch.float32)
    assert abs(got["losses"][0] - want["losses"][0]) <= TOL_FP32 * want["losses"][0]
    ref_g = dict(zip(want["paths"], want["grad1"]))
    assert set(got["grad1"]) == set(ref_g)
    keep = _moving(ref_g)
    assert _norm_gap({k: float(v.norm()) for k, v in got["grad1"].items()}, ref_g, keep) \
        <= TOL_FP32 * 10  # norms of sums over 4096 pixels: a few ulps more
    # each moving leaf's gradient as a vector, against the reference's
    with ref.exact_fp32():
        grads = ref_gradients(tree, batches[0])
    worst = max(_vec_gap(got["grad1"][k].numpy(), grads[k]) for k in keep)
    assert worst <= TOL_FP32 * 10
    # three steps: Adam divides by sqrt(v), so an fp32 ulp of a gradient
    # moves a step by as much relative to it; the variance's change is exact
    # to a few ulps of the batch statistics
    assert gaps(got, want)["delta"] <= 1e-3
    assert gaps(got, want)["var"] <= 1e-5


def test_bf16_gradients_steps_and_statistics_match_the_reference(case):
    tree, batches, want = case
    got = gaps(port_train(tree, batches, torch.bfloat16), want)
    assert got["grad"] <= TOL_GRAD
    assert got["head"] <= TOL_HEAD
    assert got["delta"] <= TOL_DELTA
    assert got["var"] <= TOL_VAR


def test_fp8_control_fails_the_training_tolerances(case):
    tree, batches, want = case
    with ref.exact_fp32():
        fp8 = gaps(ref.train(tree, batches, CFG, SEED, 3, precision="fp8"), want)
    failed = [fp8["grad"] > TOL_GRAD, fp8["head"] > TOL_HEAD, fp8["delta"] > TOL_DELTA,
              fp8["var"] > TOL_VAR]
    assert sum(failed) >= 2, fp8


def test_batch_norm_left_in_eval_mode_fails_the_statistics(case):
    tree, batches, want = case
    with ref.exact_fp32():
        frozen = gaps(ref.train(tree, batches, CFG, SEED, 3, bn="eval"), want)
    assert frozen["var"] > 100 * TOL_VAR and frozen["grad"] > TOL_GRAD


def test_half_of_the_batch_left_out_fails_the_training_tolerances(case):
    """The benchmark's third control: each step on the first of the two
    rows alone (its draws, BatchNorm's statistics over it)."""
    tree, batches, want = case
    with ref.exact_fp32():
        half = gaps(ref.train(tree, batches, CFG, SEED, 3, batch_rows=range(1)), want)
    assert half["head"] > TOL_HEAD and half["var"] > TOL_VAR, half


def test_optimizer_multipliers_follow_mmcv_and_leave_defaults_alone():
    p = bridge.to_port(tiny_tree(0))
    mults = dict(zip(_paths(p), S.make_optimizer("adamw", **OPT_KW).multipliers(p)))
    assert mults["decoder/linear_fuse_bn/scale"] == (10.0, 1.0)  # 'decoder' is tried first
    assert mults["encoder/block1_0_norm1/scale"] == (1.0, 0.0)
    assert mults["encoder/block3_1_sr_norm/bias"] == (1.0, 0.0)
    assert mults["encoder/block1_0_fc1/kernel"] == (1.0, 1.0)
    assert S.make_optimizer("adamw", weight_decay=0.01).multipliers(p) is None
    assert S.make_optimizer("adamw", weight_decay=0.01, custom_keys={}).multipliers(p) is None
    with pytest.raises(ValueError, match="lr_mult and decay_mult"):
        S.make_optimizer("adamw", custom_keys={"norm": {"decay": 0.0}})
    for name in ("adam", "momentum", "sgd"):  # adamw's alone
        with pytest.raises(ValueError, match="custom_keys"):
            S.make_optimizer(name, custom_keys=CUSTOM_KEYS)
    with pytest.raises(ValueError, match="foreach"):  # one update path, no switch
        S.make_optimizer("adamw", foreach=True)


def test_cast_into_writes_a_new_casts_bits_in_place_and_leaves_fcn_to_the_full_cast():
    from fcn8s_tensorflow_tpu_torch.models.fcn8s import init_fcn8s

    p = bridge.to_port(tiny_tree(0))
    run = bridge.cast_params(p, torch.bfloat16)
    kept = [id(t) for t in bridge.param_leaves(run)]
    with torch.no_grad():
        for t in bridge.param_leaves(p):
            t.add_(0.25)
    assert bridge.cast_into(run, p)
    assert [id(t) for t in bridge.param_leaves(run)] == kept
    want = bridge.cast_params(p, torch.bfloat16)
    assert all(torch.equal(a, b) and a.stride() == b.stride()
               for a, b in zip(bridge.param_leaves(run), bridge.param_leaves(want)))
    fcn = bridge.to_port(init_fcn8s(torch.Generator().manual_seed(0), C, width_mult=1 / 32,
                                    fc_channels=32))
    assert not bridge.cast_into(bridge.cast_params(fcn, torch.bfloat16), fcn)  # deconvs derive


@pytest.mark.parametrize("name, kw, model", [("adamw", OPT_KW, "segformer"),
                                             ("adamw", dict(weight_decay=0.01), "segformer"),
                                             ("adam", {}, "segformer"), ("adam", {}, "fcn8s")])
def test_multi_tensor_update_is_the_per_leaf_rule_bit_for_bit(name, kw, model):
    """The optimizer's multi-tensor update gives TF1 Adam's per-leaf loop
    (``tests/per_leaf_adam.py``, the rule FCN ran leaf by leaf) bit for
    bit: three steps give the same params and moments, with and without
    multipliers, on SegFormer and on FCN-8s (channels_last gradients)."""
    from fcn8s_tensorflow_tpu_torch.models.fcn8s import init_fcn8s
    from tests.per_leaf_adam import PerLeafAdam

    runs = []
    for opt in (PerLeafAdam(name, **kw), S.make_optimizer(name, **kw)):
        p = bridge.to_port(tiny_tree(0) if model == "segformer" else init_fcn8s(
            torch.Generator().manual_seed(0), C, width_mult=1 / 32, fc_channels=32))
        state = S.create_train_state(p, opt)
        for k in range(3):
            im, lb = (torch.from_numpy(x) for x in scenes(k))
            state, _ = S.train_step(state, im, lb, torch.ones(2), SEED, 6e-5, 0.0, 0.9,
                                    optimizer=opt, num_classes=C, compute_dtype=torch.float32)
        runs.append(bridge.param_leaves(p) + state.opt_state.inner.mu + state.opt_state.inner.nu)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_multiplied_learning_rate_is_one_fp32_rounding_for_floats_and_tensors():
    lr = 6.1e-5
    assert S._scaled_lr(lr, 10.0) == float((torch.tensor(lr) * 10.0).item())


def _models(tree, **kw):
    eager = FCN8s.from_params(tree, device="cpu", compute_dtype=torch.float32, seed=3,
                              optimizer="adamw", optimizer_kwargs=OPT_KW, **kw)
    eager._eager_steps = True
    comp = FCN8s.from_params(tree, device="cpu", compute_dtype=torch.float32, seed=3,
                             optimizer="adamw", optimizer_kwargs=OPT_KW, **kw)
    return eager, comp


def _feed(seed):
    k = 0
    while True:
        yield scenes(100 * seed + k)
        k += 1


def _all(model) -> list:
    inner = model.state.opt_state.inner
    return (bridge.param_leaves(model.params) + bridge.state_leaves(model.params)
            + inner.mu + inner.nu)


def test_compiled_facade_equals_its_eager_steps_bit_for_bit():
    """Training (keep_prob 0.9: DropPath and channel dropout drawn), BatchNorm's
    in-place statistics, evaluate and predict: the captured bodies give the
    eager steps' results bit for bit."""
    eager, comp = _models(tiny_tree(2))
    for m in (eager, comp):
        m.train(_feed(1), 1, 3, lambda s: 6e-5, keep_prob=0.9, record_summaries=False)
    assert comp.capture_counts()["train"] == 1 and eager.capture_counts()["train"] == 0
    assert eager.training_loss == comp.training_loss
    assert all(torch.equal(a, b) for a, b in zip(_all(eager), _all(comp)))
    assert eager.evaluate(_feed(2), 2) == comp.evaluate(_feed(2), 2)
    images = scenes(5)[0]
    assert np.array_equal(eager.predict(images), comp.predict(images))
    assert np.array_equal(eager.predict(images, argmax=False), comp.predict(images, argmax=False))


def test_attention_calls_are_counted_per_call_and_per_replay():
    from fcn8s_tensorflow_tpu_torch.ops.nn import attention

    counter = attention.calls
    eager, comp = _models(tiny_tree(2))
    for m in (eager, comp):
        m.train(_feed(1), 1, 1, lambda s: 6e-5, keep_prob=0.9, record_summaries=False)
    before = counter.copy()
    for m in (eager, comp):
        m.train(_feed(1), 1, 2, lambda s: 6e-5, keep_prob=0.9, record_summaries=False)
    added = counter - before
    # 5 blocks a forward; 2 steps of each model; stage 1: 16x16 tokens, 2x2 keys
    assert sum(added.values()) == 2 * 2 * 5
    assert added[(2, 1, 256, 4, 8)] == 4 and added[(2, 4, 4, 4, 8)] == 4


def test_segformer_spans_are_recorded():
    p = bridge.cast_params(bridge.to_port(tiny_tree(0)), torch.float32)
    images = torch.from_numpy(scenes(0)[0])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            apply_segformer(p, images, compute_dtype=torch.float32)
    names = {e.name for e in prof.events()}
    assert {f"segformer.stage{i}" for i in range(1, 5)} | {"segformer.head"} <= names


def test_checkpoint_round_trip_keeps_the_statistics_and_resumes_bit_for_bit(tmp_path):
    model = FCN8s.from_params(tiny_tree(3), device="cpu", compute_dtype=torch.float32, seed=3,
                              optimizer="adamw", optimizer_kwargs=OPT_KW)
    model.train(_feed(4), 1, 2, lambda s: 6e-5, keep_prob=0.9, record_summaries=False)
    path = model.save(str(tmp_path))
    loaded = FCN8s(model_load_dir=path, device="cpu", seed=3)
    assert loaded.variant == "segformer" and loaded.state.step == 2
    want, got = bridge.to_numpy(model.params), bridge.to_numpy(loaded.params)
    assert want.keys() == got.keys() == {"encoder", "decoder", "batch_stats"}
    for part in want:
        for name in want[part]:
            for key in want[part][name]:
                assert np.array_equal(want[part][name][key], got[part][name][key])
    assert not np.array_equal(want["batch_stats"]["linear_fuse_bn"]["var"],
                              np.ones_like(want["batch_stats"]["linear_fuse_bn"]["var"]))
    for m in (model, loaded):
        m.train(_feed(5), 1, 1, lambda s: 6e-5, keep_prob=0.9, record_summaries=False)
    assert model.training_loss == loaded.training_loss
    want, got = bridge.to_numpy(model.params), bridge.to_numpy(loaded.params)
    assert all(np.array_equal(want[p][n][k], got[p][n][k])
               for p in want for n in want[p] for k in want[p][n])


@pytest.mark.parametrize("call", ["quantized", "tta", "spatial", "service", "calibrate"])
def test_untaken_paths_raise_and_name_segformer(call):
    from fcn8s_tensorflow_tpu_torch.engine.serving import InferenceService

    model = FCN8s.from_params(tiny_tree(0), device="cpu", compute_dtype=torch.float32)
    images = scenes(0)[0]
    run = {"quantized": lambda: model.predict(images, quantized=True),
           "tta": lambda: model.predict_tta(images),
           "spatial": lambda: model.predict(images, spatial_partition=True),
           "service": lambda: InferenceService(model),
           "calibrate": lambda: model.calibrate_quantization(images)}[call]
    with pytest.raises(ValueError, match="SegFormer"):
        run()


def test_tensor_parallel_and_remat_raise():
    run = bridge.cast_params(bridge.to_port(tiny_tree(0)), torch.float32)
    images = torch.from_numpy(scenes(0)[0])
    with pytest.raises(ValueError, match="remat"):
        S.apply_model(run, images, remat=True, compute_dtype=torch.float32)


def test_benchmark_reference_equals_the_repo_reference(case):
    """``portbench/reference/segformer.py`` is the benchmark's own copy:
    on the tiny model it gives this reference's readings exactly."""
    from portbench.reference import segformer as bench_ref

    tree, batches, want = case
    with bench_ref.exact_fp32():
        got = bench_ref.train(tree, batches, CFG, SEED, 3)
    assert got["paths"] == want["paths"]
    for key in ("losses", "grad1", "delta"):
        assert got[key] == want[key], key
    assert all(np.array_equal(a, b) for a, b in zip(got["grad1_head"], want["grad1_head"]))
    assert all(np.array_equal(got["stats"][k], want["stats"][k]) for k in want["stats"])


def _job_dp(job, mesh, tree):
    """A gloo rank: SegFormer on a (2, 1) data-parallel mesh, compiled and
    on its eager steps, from the same weights."""
    out = {}
    for name in ("compiled", "eager"):
        model = FCN8s.from_params(tree, mesh=mesh, device="cpu", compute_dtype=torch.float32,
                                  seed=3, optimizer="adamw", optimizer_kwargs=OPT_KW)
        model._eager_steps = name == "eager"
        model.train(_feed(6), epochs=1, steps_per_epoch=2, learning_rate_schedule=lambda s: 6e-5,
                    keep_prob=0.9, record_summaries=False, prefetch=0)
        out[name] = {"loss": model.training_loss, "params": bridge.to_numpy(model.params),
                     "predict": model.predict(scenes(7)[0])}
        model.close()
    return out


def test_a_data_parallel_mesh_trains_it_with_local_batch_norm(tmp_path):
    """Two gloo ranks, one row each: the gradients are summed, so both
    ranks hold the same weights; each BatchNorm normalises by its own row,
    so the running statistics are each rank's own; the compiled steps give
    the eager ones' results bit for bit."""
    import os

    from tests.test_torch_mesh import launch

    ranks = launch(tmp_path, 2, {"m": dict(kind="dp", mesh=(2, 1))}, tree=tiny_tree(4),
                   script=os.path.abspath(__file__))
    runs = [rank["m"] for rank in ranks]
    for run in runs:
        got, want = run["compiled"], run["eager"]
        assert got["loss"] == want["loss"] and np.array_equal(got["predict"], want["predict"])
        assert all(np.array_equal(got["params"][p][n][k], want["params"][p][n][k])
                   for p in got["params"] for n in got["params"][p] for k in got["params"][p][n])
    a, b = (run["compiled"]["params"] for run in runs)
    assert all(np.array_equal(a[p][n][k], b[p][n][k])
               for p in ("encoder", "decoder") for n in a[p] for k in a[p][n])
    assert not np.array_equal(a["batch_stats"]["linear_fuse_bn"]["mean"],
                              b["batch_stats"]["linear_fuse_bn"]["mean"])


if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tests.test_torch_mesh import _rank_main

    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
               jobs={"dp": _job_dp})
