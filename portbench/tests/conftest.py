"""Fixtures of the benchmark's tests: whether a card is there, decided
inside the fixture, never at import."""

from __future__ import annotations

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")
