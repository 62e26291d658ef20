"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the repository (the CPU ones), ``python -m pytest -m cuda
portbench/tests`` on a machine with the card."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
