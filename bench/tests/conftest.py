"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
root of a checkout (CPU); the ``cuda`` ones run on a card."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
