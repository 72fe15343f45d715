"""The benchmark's own tests (run with ``python -m pytest benchmark/tests``).
Tests marked ``card`` need a CUDA card and skip without one; the decision
is taken inside the ``card`` fixture, never at import."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
