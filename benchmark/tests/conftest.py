"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``.

Tests that need a card carry the ``card`` marker and skip, deciding inside
the test, where ``torch.cuda.is_available()`` is false."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")
