"""Tests of the benchmark harness (``python -m pytest pcdbench/tests``).

They run on the CPU at level 0; the ones marked ``gpu`` need a card and
decide inside the ``card`` fixture whether one is there."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
