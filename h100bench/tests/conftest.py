"""The benchmark's own tests. They run on the CPU at small sizes; a test
that needs the card takes the ``card`` fixture, which skips without one
(decided when the test runs, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True)
def _threads():
    import torch

    torch.set_num_threads(2)
    yield


TINY = {
    "tiger_prefix.train_b1024": {"students": 48, "batch": 16, "warmup_steps": 4,
                                 "trace_steps": 1},
    "tiger.recommend_b4096": {"pool": 96, "batch": 32, "sample_students": 12,
                              "trace_batches": 1},
}


@pytest.fixture
def tiny():
    """Traffic overrides that make each cell small enough for the CPU."""
    return TINY
