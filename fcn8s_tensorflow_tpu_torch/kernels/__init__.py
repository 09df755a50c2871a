"""Build, load and launch helpers for the CUDA kernels in ``csrc/``."""

from __future__ import annotations

import torch

from . import build

_DTYPE_CODES = {
    torch.float32: build.FLOAT32,
    torch.bfloat16: build.BFLOAT16,
    torch.uint8: build.UINT8,
    torch.int32: build.INT32,
}


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' code for ``t.dtype`` (csrc/common.cuh)."""
    return _DTYPE_CODES[t.dtype]


def require(cond: bool, msg: str) -> None:
    """A wrapper's input check: raise instead of converting or falling back."""
    if not cond:
        raise ValueError(msg)


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device; returns it. Called after the shape,
    dtype and layout checks, so those raise the same way for any device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"kernel needs CUDA tensors on one device, got {[str(t.device) for t in tensors]}")
    return dev


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream
