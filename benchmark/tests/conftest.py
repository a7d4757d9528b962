"""The benchmark's own tests (run with ``python -m pytest benchmark/tests``).

CPU tests run the harness at tiny sizes on the port's plain versions; tests
that need the card carry the ``card`` marker and skip without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(Path(__file__).resolve().parent)]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
