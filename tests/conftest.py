import os
import sys

# Tests see the default single CPU device (the dry-run sets its own 512-device
# flag in-process; SPMD equivalence tests run via subprocess).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the PyTorch port's kernels); "
        "skips elsewhere"
    )
