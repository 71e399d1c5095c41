"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches see
the single real CPU device; multi-device tests spawn via the mesh8 fixture
module (tests/test_distributed.py sets the flag at import, isolated by
running in its own process when needed)."""
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _engine_stats_reset():
    """Path-mix counters in repro.serving.engine / event_core are module
    globals; reset them around every test so mix assertions cannot be
    contaminated by test order."""
    try:
        from repro.serving import engine
    except ImportError:  # collection of non-serving subsets without src
        yield
        return
    engine.stats_reset()
    yield
    engine.stats_reset()


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")
