"""pytest settings of the benchmark's own tests (run from the repository
root: `python -m pytest efbench -q`): the checkout root on the path and the
`card` marker of tests that need a CUDA card (they skip without one)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (decided in the test)")
