"""The benchmark's own tests: ``python -m pytest chanbench/tests -o
addopts=""`` from the repo root (``pytest tests/`` does not collect them).
Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which skips them where there is none; ``-m card`` on the card
runs them alone."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the cell on the card")
    return torch.device("cuda", 0)
