"""The benchmark's own tests: ``python -m pytest zkbench/tests -q`` on the
CPU; the tests marked ``card`` run on an NVIDIA card and skip without one
(``python -m pytest zkbench/tests -q -m card`` on the chip)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips inside the test without one")
