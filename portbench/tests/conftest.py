import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ("wd_criteo.fit", "kmeans_sift1m.fit")


@pytest.fixture
def card():
    """Skips the test where PyTorch sees no CUDA card (decided here, when
    the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "`python -m pytest portbench/tests -m cuda`")
    return torch.device("cuda")
