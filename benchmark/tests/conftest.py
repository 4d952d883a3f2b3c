"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
root of the repo. Tests marked `cuda` run a cell on the card and skip
elsewhere; each decides inside the test whether a card is present."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
