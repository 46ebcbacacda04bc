"""Shared pieces of the benchmark's CPU tests.

Run them from the root of the repository:
``python -m pytest sdbench/tests -q``.  Tests marked ``cuda`` need an
NVIDIA card; the ``card`` fixture skips them elsewhere.
"""

from __future__ import annotations

import pytest
import torch



def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this machine")
