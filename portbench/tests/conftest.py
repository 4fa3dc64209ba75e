"""The benchmark's own tests: `python -m pytest portbench/tests -q`. Tests
marked `cuda` run on an NVIDIA card and skip without one."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"
