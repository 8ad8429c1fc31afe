"""The harness's tests: ``python3 -m pytest dhtbench/tests -q`` from the
root of the repository.  They rehearse every cell on the CPU at a small
size; the tests marked ``card`` need the CUDA card and skip without it."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skip the test unless a CUDA card is present (decided here, at run
    time, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the check at the cell's size runs on the "
                    "card")
