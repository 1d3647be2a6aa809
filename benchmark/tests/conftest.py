"""The benchmark's own tests: CPU tests of its generators, cost arithmetic,
reference, comparisons and harness, at tiny sizes; those marked `card`
skip here (decided inside each test) and run on a machine with a card:

    python3 -m pytest benchmark/tests -q
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
