"""Tests of the benchmark's yardstick.  Run from the checkout's root:

    python -m pytest -q bench/tests

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which decides inside the test whether a card is there
and skips without one."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def bench_run():
    """``bench/run.py`` as a module (its name is not importable as such)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("bench_run_main", BENCH / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
