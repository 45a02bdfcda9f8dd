"""Tests of the benchmark harness: all on the CPU at tiny sizes."""
import sys
from pathlib import Path

import pytest

_SRC = str(Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:  # the port, as the benchmark's command finds it
    sys.path.insert(0, _SRC)


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the rehearsal's windows are wall-clock seconds,
    and several test workers share the machine's cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
