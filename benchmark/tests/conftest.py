"""The benchmark's own tests (run: ``python -m pytest benchmark/tests -q``
from the repository root). The benchmark's modules and the program are
imported from the checkout."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided when the test
    runs, never when its module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
