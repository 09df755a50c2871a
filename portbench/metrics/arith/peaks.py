"""Published dense peaks by card name (NVIDIA's data sheets, SXM parts at
their full power limit): bf16 tensor-core FLOP/s and HBM bytes/s. The bf16
figures are the port's ``benchmarks/bench.py`` table; an unknown card gives
None, never a guess."""

from __future__ import annotations

# (substring of torch.cuda.get_device_name(), bf16 FLOP/s, bytes/s); first match wins
PEAKS = (
    ("H100 PCIe", 756.0e12, 2.0e12),
    ("H100", 989.4e12, 3.35e12),
)


def bf16_flops(device_name: str) -> float | None:
    return next((f for key, f, _ in PEAKS if key in device_name), None)


def hbm_bytes(device_name: str) -> float | None:
    return next((b for key, _, b in PEAKS if key in device_name), None)
