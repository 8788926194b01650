"""pytest settings of the benchmark's own tests (``bench/tests``).

Tests marked ``card`` need an NVIDIA card; whether one is present is
decided inside the ``card`` fixture, never while a module is imported, so
every worker collects the same tests.  On the card they run with
``python3 -m pytest -q bench/tests -m card``."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
