"""The benchmark's own tests (not collected by ``pytest tests/``):

    python -m pytest bench_port/tests -q          # CPU, a few minutes
    python -m pytest bench_port/tests -q -m cuda  # on the card

Tests marked ``cuda`` take the ``card`` fixture, which skips without one.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
