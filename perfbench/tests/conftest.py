"""The benchmark's CPU tests: ``python -m pytest perfbench/tests -q``.
A test that needs a card carries the ``cuda`` marker and decides inside a
fixture or its body whether one is present (none needs one now)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device (skips without one)")

