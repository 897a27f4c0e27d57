"""The benchmark's tests: ``python -m pytest perfbench/tests`` from the
root of the repository (the CPU; tests marked ``cuda`` skip without a
card)."""
import os
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
sys.path.insert(0, os.path.abspath(ROOT))
sys.path.insert(0, os.path.abspath(os.path.join(ROOT, "src")))
