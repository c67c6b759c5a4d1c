"""Puts the benchmark's harness and the program on the path of its tests.

    python -m pytest -q portbench/tests
"""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
