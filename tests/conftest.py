"""Shared test fixtures.

NOTE: XLA_FLAGS device-count forcing is deliberately NOT set here — smoke
tests and benchmarks must see the single real CPU device. Tests that need a
multi-device mesh live in tests/multidevice/ which has its own conftest
setting 8 fake devices via an early os.environ write.
"""
import importlib.util
import pathlib
import sys

if importlib.util.find_spec("hypothesis") is None:
    # container image without hypothesis: register the deterministic stub
    # (tests/_hypothesis_stub.py) so `from hypothesis import ...` works.
    # Loaded by path — the `tests` package itself is not importable under
    # the bare `pytest` entry point (no __init__.py, repo root off sys.path).
    _stub_path = pathlib.Path(__file__).parent / "_hypothesis_stub.py"
    _spec = importlib.util.spec_from_file_location("hypothesis", _stub_path)
    _hypothesis_stub = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_hypothesis_stub)
    sys.modules["hypothesis"] = _hypothesis_stub
    sys.modules["hypothesis.strategies"] = _hypothesis_stub.strategies

import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute subprocess compile tests (deselect with "
        "-m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels); "
        "skips without one — run on the card with -m cuda")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def key():
    return jax.random.key(0)
