"""The benchmark's own CPU tests: the repository root on the import path,
and the card's presence decided inside a fixture, never at import."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    """Skips a test that needs an NVIDIA GPU where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda)")
    return torch.device("cuda:0")
