"""The benchmark's own tests: ``python -m pytest perfbench/tests -q``
from the root of the repo.  Tests that need the card carry the ``chip``
marker and skip without one (decided inside the test)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'chip: needs a CUDA device; skips without one')
