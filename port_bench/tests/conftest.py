"""Tests of the port's benchmark. Run from the checkout's root:

    python -m pytest port_bench/tests -q

Tests marked ``card`` run a cell on a CUDA card and skip without one (the
``card`` fixture decides, at run time)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs a cell on the card")
    return torch.cuda.get_device_name()
