"""Fixtures of the benchmark's own tests (CPU unless marked ``cuda``).
Run them with ``python -m pytest benchmark/tests``; the card's tests with
``python -m pytest -m cuda -s benchmark/tests`` on a machine with an
NVIDIA GPU."""

import pytest


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
