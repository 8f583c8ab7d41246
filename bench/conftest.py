"""The benchmark's tests import its modules by name (``stack``,
``drivers``, ``reference``...) and the port from ``src``."""

import os
import sys

import pytest

_here = os.path.dirname(os.path.abspath(__file__))
for _p in (_here, os.path.join(os.path.dirname(_here), "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels of the "
        "PyTorch port); skipped without a card")


@pytest.fixture
def card():
    """The card, for a ``cuda`` test; decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA "
                    "kernels at full width")
    return "cuda"
