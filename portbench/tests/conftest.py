"""Shared fixtures of the benchmark's tests."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# A CPU rehearsal's frame size: SSIMULACRA2 keeps five scales, MS-SSIM three,
# and the float gaps stay inside the 1080p limits.
CPU_SIZE = (160, 96)
SEED = 2**31 + 11


@pytest.fixture
def card():
    """The CUDA device for tests marked ``card``; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")
