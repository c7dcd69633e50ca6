"""The harness's own tests, on the CPU:

    python -m pytest bench_torch/tests -q

They import the harness as ``run.py`` does (``bench_torch/`` and the
checkout's root on the path)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
