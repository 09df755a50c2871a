"""Subpixel (conv + depth-to-space) form of the model's transposed convs.

Port of ``fcn8s_tensorflow_tpu/ops/subpixel.py``. For a deconv with kernel
k = 2s and stride s under TF-SAME semantics the fractionally strided
convolution is exactly a stride-1 3x3 convolution with s*s*C output channels
followed by a depth-to-space:

    out[s*y + py, s*x + px, c] =
        sum_{dy,dx in {-1,0,1}} x[y+dy, x+dx] . K[(k-1-crop) + s*dy - py,
                                                  (k-1-crop) + s*dx - px]

with crop = ceil(s/2) and taps outside [0, 2s) zero. ``subpixel_weight``
does that tap algebra with views, flips and slice copies, so it is
differentiable and moves nothing through the host: ``bridge.cast_params``
runs it once for inference and, under autograd, on every train step (as
JAX derives the kernel on every call). The forward is one cuDNN convolution.
``nn.ConvTranspose2d`` is deliberately not used: it is the adjoint of a
convolution, so its kernel is the spatial flip of JAX's lhs-dilated
cross-correlation (``fcn8s_tensorflow_tpu/ops/nn.py::conv2d_transpose``).
"""

from __future__ import annotations

import numpy as np
import torch

from .nn import nchw, nhwc


def _subpixel_kernel(kernel: torch.Tensor, s: int) -> torch.Tensor:
    """Rearrange an HWIO (2s, 2s, I, O) deconv kernel into the equivalent
    (3, 3, I, s*s*O) stride-1 HWIO kernel, output channels ordered
    (py, px, O) to match a depth-to-space that expands H then W."""
    k = kernel.shape[0]
    if k != 2 * s or kernel.shape[1] != k:
        raise ValueError(f"subpixel path requires kernel 2s x 2s, got {tuple(kernel.shape)} for s={s}")
    in_ch, out_ch = kernel.shape[2], kernel.shape[3]
    crop = s // 2 + (s % 2)  # crop_lo = ceil((k - s) / 2) = ceil(s / 2)
    new = kernel.new_zeros((3, 3, in_ch, s, s, out_ch))
    phase = np.arange(s)
    for dy in (-1, 0, 1):
        iy = (k - 1 - crop) + s * dy - phase
        sel_y = np.nonzero((iy >= 0) & (iy < k))[0]
        for dx in (-1, 0, 1):
            ix = (k - 1 - crop) + s * dx - phase
            sel_x = np.nonzero((ix >= 0) & (ix < k))[0]
            if sel_y.size == 0 or sel_x.size == 0:
                continue
            # iy and ix fall by one per phase, so the selected taps are a
            # reversed slice of the kernel
            iy_sel, ix_sel = iy[sel_y], ix[sel_x]
            block = kernel[iy_sel[-1]:iy_sel[0] + 1].flip(0)[:, ix_sel[-1]:ix_sel[0] + 1].flip(1)
            new[dy + 1, dx + 1][:, sel_y[0]:sel_y[-1] + 1, sel_x[0]:sel_x[-1] + 1] = (
                block.permute(2, 0, 1, 3))
    return new.reshape(3, 3, in_ch, s * s * out_ch)


def subpixel_weight(kernel: torch.Tensor, bias: torch.Tensor | None, s: int):
    """(OIHW 3x3 weight with s*s*O outputs, bias repeated per phase or None)
    for the stride-``s`` deconv ``kernel`` (HWIO, 2s x 2s)."""
    weight = _subpixel_kernel(kernel, s).permute(3, 2, 0, 1).contiguous()
    return weight, None if bias is None else bias.repeat(s * s)


def conv2d_transpose_subpixel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                              *, stride: int, packed: bool = False,
                              halo: bool = False) -> torch.Tensor:
    """The stride-``stride`` deconv of NCHW (channels_last) ``x``, given the
    ``subpixel_weight`` form of its kernel and bias.

    Returns NCHW channels_last ``(n, O, h*s, w*s)``, or with ``packed=True``
    the depth-to-space skipped: ``(n, h, w, s, s, O)``, where output pixel
    ``(s*y+py, s*x+px)`` lives at ``[n, y, x, py, px]`` (JAX's packed layout).
    The repeated bias is added in the convolution's accumulator, where JAX
    adds it after the reshape; the two agree exactly in fp32.

    ``halo=True``: ``x`` is a width block extended by one column on each
    side (``parallel.collectives.halo_exchange``): the 3x3 convolution pads
    only the height, and the output covers the block's columns."""
    s = stride
    n, _, h, w = x.shape
    if halo:
        w -= 2
    out_ch = weight.shape[0] // (s * s)
    conv = torch.nn.functional.conv2d(x, weight.to(x.dtype),
                                      None if bias is None else bias.to(x.dtype),
                                      padding=(1, 0) if halo else 1)
    out = nhwc(conv).reshape(n, h, w, s, s, out_ch)  # a view: conv is channels_last
    if packed:
        return out
    full = out.permute(0, 1, 3, 2, 4, 5).reshape(n, h * s, w * s, out_ch)
    return nchw(full)


def space_to_depth_labels(labels: torch.Tensor, s: int) -> torch.Tensor:
    """(N, H, W) targets in the packed layout of
    ``conv2d_transpose_subpixel(packed=True)``: (N, H/s, W/s, s, s) with
    ``out[n, y, x, py, px] == labels[n, s*y+py, s*x+px]`` (a view)."""
    n, h_full, w_full = labels.shape
    h, w = h_full // s, w_full // s
    return labels.reshape(n, h, s, w, s).permute(0, 1, 3, 2, 4)
