"""Test settings of the benchmark's own tests (``tadoc_bench/tests``).

``card``: a test that needs a CUDA card; it skips elsewhere, deciding in
the ``cuda`` fixture, never at import time.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")
