"""The benchmark's own tests: `python -m pytest proverbench/tests -q` from
the checkout's root (about two minutes on the CPU; the card's test skips
without a CUDA device)."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def small_cell():
    """fibonacci.short10 as the benchmark runs it: fib(100), 717 cycles a
    job, small enough for the CPU."""
    import torch

    import spec

    torch.set_num_threads(2)
    return spec.cell(spec.benchmark(), "fibonacci.short10")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's runs need the card")
