"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of a checkout. They run on the CPU; a test marked ``cuda`` needs a
card and skips without one."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
