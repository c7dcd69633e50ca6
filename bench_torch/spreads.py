"""The spread of a cell's end-to-end metrics over sets of runs, from which
its bounds are set:

    python3 bench_torch/spreads.py --set A1.out ... A6.out --set B1.out ...

Each file holds a run's output, its result the last line. For each metric:
each set's median and spread (the quartile distance over the median,
``harness.stats.spread``), five times the widest set spread, the spread
of all runs together, the mean spread of the sets with each set's run
farthest from its median left out, and the last set's median over the
first's.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness.stats import spread  # noqa: E402


def metrics(path: str) -> dict:
    line = Path(path).read_text().strip().split("\n")[-1]
    return {k: v["value"] for k, v in json.loads(line)["metrics"].items()}


def trimmed(values):
    med = statistics.median(values)
    return sorted(values, key=lambda v: abs(v - med))[:-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--set", nargs="+", action="append", required=True)
    sets = [[metrics(f) for f in files] for files in ap.parse_args(argv).set]
    for name in sets[0][0]:
        runs = [[r[name] for r in s] for s in sets]
        each = [(statistics.median(v), spread(v)) for v in runs]
        widest = max(s for _m, s in each)
        print(json.dumps({
            "metric": name,
            "sets": [{"median": m, "spread": s} for m, s in each],
            "five_times_widest": 5 * widest,
            "all_runs_spread": spread([v for r in runs for v in r]),
            "trimmed_mean_spread": statistics.mean(
                spread(trimmed(v)) for v in runs),
            "last_over_first_median": each[-1][0] / each[0][0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
