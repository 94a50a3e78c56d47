"""The benchmark's own tests (``python -m pytest benchmark/tests``).

Tests marked ``cuda`` need a CUDA card and skip without one; whether a
card exists is decided inside the ``card`` fixture, never at import.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
