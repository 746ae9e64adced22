"""Settings of the benchmark's own tests (``python -m pytest gpubench/tests
-q``). Tests that need the card carry the ``card`` marker and take the
``card`` fixture, which skips them where no CUDA device is present."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skipped without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this host has none")
    return torch.device("cuda", 0)
