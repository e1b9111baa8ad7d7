"""The benchmark's own tests: ``python -m pytest portbench`` on the CPU;
the tests marked ``card`` run only where CUDA is (``python -m pytest
portbench -m card`` on the card machine) and skip elsewhere."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
