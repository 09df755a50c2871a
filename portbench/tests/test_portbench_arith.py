"""The yardstick's arithmetic, each held against the port's own function
or a hand-worked case at a small size."""

from __future__ import annotations

import types

import pytest
import torch

from portbench import harness, weights
from portbench.metrics.arith import busy, flops, kernels, peaks

CONFIGS = ("fcn8s-vgg16-cityscapes", "fcn32s-vgg16-cityscapes")


def _config(name):
    return harness._json(harness.PACKAGE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("width", [None, {"mult": 1 / 16, "fc": 32}])
def test_forward_macs_match_the_ports_summary(name, width):
    from fcn8s_tensorflow_tpu_torch import bridge
    from fcn8s_tensorflow_tpu_torch.utils.summary import model_summary_rows

    cfg = _config(name)
    tree = weights.make_tree(cfg, 5, "cpu", width) if width else _shapes_only(cfg)
    rows = model_summary_rows(bridge.to_port(tree), input_hw=(64, 128), batch=3)
    widths = weights.scaled(cfg, width) if width else None
    assert 3 * flops.forward_macs(cfg, (64, 128), widths) == sum(r["macs"] for r in rows)


def _shapes_only(cfg):
    """A full-width tree of empty tensors (the summary reads shapes only)."""
    tree = {"encoder": {}, "decoder": {}}
    for part, name, shape, _ in weights.layer_specs(cfg):
        tree[part][name] = {"kernel": torch.empty(shape), "bias": torch.empty(shape[3])}
    return tree


def test_train_step_flops_are_the_benchs():
    """bench.py's 10.7 TFLOP step at 8 x 512x1024 (PERF.md): 3 x 2 x MACs."""
    cfg = _config("fcn8s-vgg16-cityscapes")
    step = 8 * flops.train_flops_per_image(cfg, (512, 1024))
    assert step == 6 * 1780160135168  # chip_smoke's SUMMARY_TOTALS macs at batch 8


def test_peaks_are_the_benchs_table():
    assert peaks.bf16_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert peaks.bf16_flops("NVIDIA H100 PCIe") == 756.0e12
    assert peaks.hbm_bytes("NVIDIA H100 80GB HBM3") == 3.35e12
    assert peaks.bf16_flops("NVIDIA A100-SXM4-80GB") is None


def test_busy_is_the_ports_device_busy():
    """The union against the port's ``device_busy`` on the same events."""
    from fcn8s_tensorflow_tpu_torch.utils.profiling import device_busy

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]

    def event(start, end, kind):
        return types.SimpleNamespace(name="k", device_type=kind,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    prof = types.SimpleNamespace(events=lambda: [event(0, 50, cpu)] +
                                 [event(a, b, cuda) for a, b in spans])
    assert busy.busy(spans, 0, 50) == device_busy(prof)["busy_us"] == 23
    assert busy.gaps(spans, 0, 50) == [(12, 20), (30, 40), (41, 50)]
    assert busy.busy(spans, 8, 22) == 6  # clipped to the window


def test_hand_kernel_bytes_at_the_chip_smoke_shapes():
    """PERF.md's kernel table: K4f 1,279 MB and K4a/K4b 1,407 MB over the
    five pools at 8 x 512x1024; K1 172 MB; the CE grad with every row live."""
    cfg = _config("fcn8s-vgg16-cityscapes")
    train = kernels.step_bytes(cfg, 8, (512, 1024), "train")
    predict = kernels.step_bytes(cfg, 8, (512, 1024), "predict")
    assert predict["K4f"] == (5, 1_279_262_720)
    assert train["K4a"] == train["K4b"] == (5, 1_407_188_992)
    pixels = 8 * 512 * 1024
    assert train["K1"] == (1, pixels * 41 + 36)
    assert train["CEgrad"] == (1, pixels * 41 + 36 + pixels * 40)


@pytest.mark.parametrize("name, kernel", [
    ("void fcn8s::(anonymous namespace)::pool_kernel<(fcn8s::(anonymous namespace)::Mode)0, "
     "__nv_bfloat16, 8, unsigned int>(...)", "K4f"),
    ("void fcn8s::(anonymous namespace)::pool_kernel<(fcn8s::(anonymous namespace)::Mode)1, "
     "__nv_bfloat16, 8, unsigned int>(...)", "K4a"),
    ("void fcn8s::(anonymous namespace)::pool_kernel<(fcn8s::(anonymous namespace)::Mode)2, "
     "float, 1, long>(...)", "K4b"),
    ("void fcn8s::ce_partial_kernel<__nv_bfloat16, unsigned char, 0>(...)", "K1"),
    ("void fcn8s::ce_final_kernel(float const*, int, float*)", "K1.final"),
    ("void fcn8s::ce_grad_kernel<__nv_bfloat16, unsigned char, 0>(...)", "CEgrad"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", None),
])
def test_kernel_names(name, kernel):
    assert kernels.kernel_of(name) == kernel


def test_roofline_counts_each_call_at_its_mean_bytes():
    per_step = {"K4a": (5, 5_000), "K1": (1, 2_000)}
    trace = {"pool_kernel<(Mode)1, bf16>": [10, 4e-9], "ce_partial_kernel<x>": [2, 1e-9],
             "ce_final_kernel": [2, 1e-9], "sm90_conv": [100, 1.0]}
    # bound: 10 x 1000 + 2 x 2000 bytes at 1e12 bytes/s = 1.4e-8 s over 6e-9 s of kernels
    assert kernels.roofline(trace, per_step, 1e12) == pytest.approx(1.4e-8 / 6e-9)
    assert kernels.roofline({"sm90_conv": [1, 1.0]}, per_step, 1e12) is None
