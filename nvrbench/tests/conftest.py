"""The benchmark's tests: ``python -m pytest nvrbench/tests -q`` on the CPU;
those marked ``card`` run on an NVIDIA card and skip elsewhere, deciding
inside a fixture."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")
