"""Fixtures of the benchmark's own tests; the tests marked ``cuda`` run
on the card and skip without one."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)
