"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the
checkout's root.  Tests marked ``card`` need an NVIDIA GPU; each decides
inside the test whether there is one, and skips on the host."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the control's precision exists only on the card)")
    return "cuda"
