"""PyTorch port, KB (the conv1_2-core calibration kernel) against the
TPU kernel on the CPU.

The Pallas body of ``benchmarks/conv1_block_calibration.py`` (``kernel``,
the body of ``kernel2`` with the halo inside its block) runs in interpret
mode on halo tiles gathered as ``kernel2``'s two BlockSpecs feed them: tile
i's 8 rows, then the first 2 rows of tile (i + 1) mod TILES. The port's
``conv1_core`` takes its plain twin on CPU tensors. Tolerance: one bf16
rounding step of the result, ``|port - jax| <= 2^-7 |jax| + 2^-7``: both
sum bf16 products in fp32, in different orders, and round once to bf16.
The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from jax.experimental import pallas as pl  # noqa: E402

from fcn8s_tensorflow_tpu_torch.ops import conv1_core as KB  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILES, W, C = 3, 16, 64


@pytest.fixture
def calibration(monkeypatch):
    """The calibration script, loaded from its path, with W = 16 (its body
    reads the module global)."""
    spec = importlib.util.spec_from_file_location(
        "conv1_block_calibration", os.path.join(REPO, "benchmarks", "conv1_block_calibration.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "W", W)
    return mod


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((TILES * 8, W, C)), jnp.bfloat16)
    w128 = jnp.asarray(rng.standard_normal((3, 2 * C, C)), jnp.bfloat16)
    w64 = jnp.asarray(rng.standard_normal((3, C, C)), jnp.bfloat16)
    return x, w128, w64


def _pallas(mod, x, w128, w64):
    """``kernel`` over halo tiles gathered as ``kernel2``'s BlockSpecs give
    them, in interpret mode."""
    th = mod.TH
    halo = jnp.concatenate([jnp.concatenate([x[i * th:(i + 1) * th],
                                             x[((i + 1) % TILES) * th:][:2]], axis=0)
                            for i in range(TILES)], axis=0)  # (TILES * (TH + 2), W, C)
    fn = pl.pallas_call(
        mod.kernel,
        out_shape=jax.ShapeDtypeStruct((TILES * th, W, C), jnp.bfloat16),
        grid=(TILES,),
        in_specs=[pl.BlockSpec((th + 2, W, C), lambda i: (i, 0, 0)),
                  pl.BlockSpec((3, 2 * C, C), lambda i: (0, 0, 0)),
                  pl.BlockSpec((3, C, C), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((th, W, C), lambda i: (i, 0, 0)),
        interpret=True)
    return np.array(fn(halo, w128, w64).astype(jnp.float32))


def _port(x, w128, w64):
    def t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return KB.conv1_core(t(x), t(w128), t(w64))


def test_conv1_core_matches_the_pallas_kernel(calibration):
    x, w128, w64 = _inputs()
    want = _pallas(calibration, x, w128, w64)
    got = _port(x, w128, w64)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (TILES * 8, W, C)
    err, ok = KB.within_one_bf16_step(got, torch.from_numpy(want))
    assert ok, err
    assert np.abs(want).max() > 10  # a real signal, not a row of zeros
    assert (want == 0).mean() > 0.3  # the ReLU cut about half


def test_conv1_core_halo_wraps_to_rows_0_and_1(calibration):
    """The last tile reads rows 0 and 1: changing them changes exactly the
    output rows whose three taps reach them (R-2, R-1, 0, 1), in the Pallas
    kernel and in the port alike, and the port's last tile still matches."""
    x, w128, w64 = _inputs(1)
    x2 = x.at[0:2].set(-x[0:2])
    rows = TILES * 8
    for run in (lambda a: _pallas(calibration, a, w128, w64),
                lambda a: _port(a, w128, w64).float().numpy()):
        before, after = run(x), run(x2)
        changed = sorted(np.nonzero(np.any(before != after, axis=(1, 2)))[0].tolist())
        assert changed == [0, 1, rows - 2, rows - 1]
    err, ok = KB.within_one_bf16_step(_port(x2, w128, w64)[-8:],
                                      torch.from_numpy(_pallas(calibration, x2, w128, w64)[-8:]))
    assert ok, err


def test_conv1_core_twin_is_the_formula_and_takes_any_width():
    """The twin on W = 5 (no multiple of 16) equals the formula written out
    per row in float64, rounded once to bf16, within one bf16 step; the
    wrapper counts no launch for a CPU tensor."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((16, 5, C), generator=g).to(torch.bfloat16)
    w128 = torch.randn((3, 2 * C, C), generator=g).to(torch.bfloat16)
    w64 = torch.randn((3, C, C), generator=g).to(torch.bfloat16)
    launches = KB.conv1_core.launches
    got = KB.conv1_core(x, w128, w64)
    assert KB.conv1_core.launches == launches
    xd, w128d, w64d = x.double(), w128.double(), w64.double()
    want = torch.zeros((16, 5, C), dtype=torch.float64)
    for r in range(16):
        for ky in range(3):
            a = xd[(r + ky) % 16]
            want[r] += torch.cat([a, a], -1) @ w128d[ky] + a @ w64d[ky]
    err, ok = KB.within_one_bf16_step(got, torch.relu(want).to(torch.bfloat16))
    assert ok, err


def test_calibration_flop_counts_are_the_scripts(calibration):
    """``kb_flops`` and ``conv_flops`` at the script's shapes are its own
    counts (`:88`, `:106`): 309 GFLOP each."""
    mod = calibration
    assert KB.CAL_TILES == mod.TILES and KB.TH == mod.TH and KB.C == mod.C and KB.CAL_W == 512
    assert KB.kb_flops(KB.CAL_TILES * KB.TH, KB.CAL_W) == (
        mod.TILES * (mod.TH * 512) * (3 * 128 * mod.C + 3 * mod.C * mod.C) * 2)
    assert KB.conv_flops() == 8 * 1024 * 512 * 9 * mod.C * mod.C * 2
    assert round(KB.kb_flops(8192, 512) / 1e9) == 309


def test_conv1_core_calibrate_refuses_the_cpu():
    with pytest.raises(ValueError, match="card"):
        KB.calibrate("cpu")


def _work_items(rows, width, sms):
    """KB's work items as the kernel decodes them (item = run * strips +
    strip): (first pixel, end pixel, first output row, end output row, the
    input rows it loads, in order)."""
    strips, run_rows, runs = KB.work_split(rows, width, sms)
    for item in range(strips * runs):
        w0, r0 = item % strips * KB.STRIP, item // strips * run_rows
        r1 = min(r0 + run_rows, rows)
        yield (w0, min(w0 + KB.STRIP, width), r0, r1,
               [(r0 + j) % rows for j in range(r1 - r0 + 2)])


@pytest.mark.parametrize("rows,width,sms", [(8192, 512, 132), (8, 3, 132), (16, 64, 132),
                                            (64, 1000, 132), (24, 45, 132), (16, 45, 4),
                                            (64, 20000, 132), (8, 129, 1)])
def test_conv1_core_work_split_covers_every_output_once(rows, width, sms):
    """The kernel's work items cover every (output row, pixel) exactly once;
    each loads its output rows and the two after, mod R, once; at most one
    item per SM when the shape allows; and at the calibration's shape the
    halo re-reads stay under 1% of the input."""
    covered = np.zeros((rows, width), np.int32)
    loads = 0
    items = list(_work_items(rows, width, sms))
    for w0, w1, r0, r1, inputs in items:
        assert w0 % KB.STRIP == 0 and 0 < w1 - w0 <= KB.STRIP and 0 <= r0 < r1 <= rows
        covered[r0:r1, w0:w1] += 1
        assert inputs == [r % rows for r in range(r0, r1 + 2)]
        loads += len(inputs)
    assert (covered == 1).all()
    strips, run_rows, runs = KB.work_split(rows, width, sms)
    assert len(items) == strips * runs and runs == -(-rows // run_rows)
    if strips <= sms:
        assert len(items) <= sms
    assert loads == strips * (rows + 2 * runs)
    if (rows, width, sms) == (8192, 512, 132):
        assert (strips, runs) == (4, 33) and loads / (strips * rows) - 1 < 0.01
