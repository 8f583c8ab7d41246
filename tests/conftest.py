import os
import sys

# Tests import the graph zoo as a plain module.
sys.path.insert(0, os.path.dirname(__file__))

# Smoke tests and benches must see the single real CPU device — the 512-way
# host-platform override belongs ONLY to launch/dryrun.py (see DESIGN.md).
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels of the "
        "PyTorch port); skipped without a card")
