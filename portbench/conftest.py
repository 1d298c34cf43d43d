"""pytest settings of the benchmark's own tests (``portbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which skips them, with the reason, where there is none.
Whether there is a card is decided inside the fixture, never while a
module is imported, so every worker collects the same tests. Run them on
the card with ``python3 -m pytest portbench/tests -m card``.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test measures on the card")
    return torch.device("cuda", 0)
