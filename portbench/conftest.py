"""Pytest settings of the benchmark's own tests (``python -m pytest portbench/tests``).

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them where ``torch.cuda`` sees no device; the decision is
made when the test runs, never when its module is imported.
"""

from __future__ import annotations

import pytest


def pytest_configure(config) -> None:
    config.addinivalue_line("markers", "card: needs an NVIDIA card (the benchmark's own runs)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest portbench/tests -m card)")
    return torch.device("cuda")
