"""The marker for the tests that need the card; whether there is one is
decided inside the ``card`` fixture, never while a module is imported."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one); run on the card with "
        "`python3 -m pytest pvg_bench/tests -m chip`")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs measure the card only")
    return torch.device("cuda", 0)
