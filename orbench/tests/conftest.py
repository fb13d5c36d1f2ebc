import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures the port on the "
                    "card only")
    return "cuda"
