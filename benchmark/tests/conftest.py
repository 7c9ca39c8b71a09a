"""Tests of the benchmark harness. Run from the repository's root:

    python -m pytest benchmark/tests -q

Tests marked `cuda` (the repository's marker for tests that need the card)
skip without one, decided inside the `cuda_device` fixture, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
