"""The port's own breakdown of a cell's traced window, beside ``run.py``:

    python3 bench_torch/program_trace.py --workload <cell> --seed <n>
        [--seconds 51] [--turns 3] [--export PATH]

One process on the card: the port's recorder (``sparsebench_tpu_torch.
profiler``) switched on before the cell is built, so that the set-up's
spans (the kernel libraries' loads, the matrix build) are kept too; the
cell prepared as ``run.py`` prepares it; then ``--turns`` windows of the
mix's ``trace_seconds`` in a cycle of three: traced with the recorder
on, traced with it off (the two give the recorder's cost in turns on one
card), and untraced with it on (the spans' host time without the
profiler's own cost in the CUDA runtime). One JSON line a turn: the
operations, the window's seconds; traced, the busy seconds, the idle
share and the cell's per-layer metrics; with the recorder on,
``program``: each span name's mean duration (``mean_us``) and self time
(``self_s``), the window's counters (``counts``) and, traced, the
window's idle time put down to the innermost span open on the host
(``idle_by_span``). The first line also has the set-up's spans. No
comparison with the reference is made: ``run.py`` is the benchmark.
"""

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

# (window, recorder) of the turns, in a cycle
KINDS = (("traced", "on"), ("traced", "off"), ("untraced", "on"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--export", default=None,
                    help="write the recorder's spans and counters here")
    args = ap.parse_args(argv)

    import torch

    from harness import spans as sp
    from harness.cell import Cell
    from harness.spec import Spec
    from harness.trace import read_metrics
    from run import power_limit
    from sparsebench_tpu_torch import profiler

    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA card; no result", file=sys.stderr)
        return 2
    spec = Spec()
    profiler.set_mode("on")
    cell = Cell(spec, args.workload, torch.device("cuda", 0))
    cell.prepare(args.seed)
    setup = defaultdict(float)
    for s in profiler.spans():
        if s.parent is None:
            setup[s.name] += (s.end_ns - s.start_ns) * 1e-9
    seconds = min(args.seconds, cell.traffic["trace_seconds"])
    for turn in range(args.turns):
        kind, mode = KINDS[turn % len(KINDS)]
        profiler.set_mode(mode)
        first, before = len(profiler.spans()), profiler.counts()
        w, ctx = cell.window(args.seed + turn, seconds, kind == "traced")
        new = profiler.spans()[first:]
        row = {"workload": args.workload, "turn": turn, "kind": kind,
               "recorder": mode, "ops": w.ops, "failed": w.failed,
               "window_s": w.seconds,
               "device": torch.cuda.get_device_name(0)}
        if ctx is not None:
            row.update(busy_s=ctx.busy_s, idle_pct=100 * (
                ctx.window_s - ctx.busy_s) / ctx.window_s, metrics={
                k: v["value"] for k, v in
                read_metrics(spec, args.workload, ctx).items()})
        if new:
            program = {"mean_us": sp.mean_us(new), "counts": {
                k: n - before.get(k, 0) for k, n in profiler.counts().items()
                if n != before.get(k, 0)}}
            if ctx is not None:
                program.update(sp.breakdown(ctx, new))
            else:
                program["self_s"] = sp.self_s(sp.timeline(
                    new, new[0].start_ns, max(s.end_ns for s in new)))
            row["program"] = program
        if turn == 0:
            row["setup_spans_s"] = dict(setup)
            row["power_limit"] = power_limit()
        print(json.dumps(row), flush=True)
    profiler.set_mode("auto")
    if args.export:
        profiler.export(args.export)
    return 0


if __name__ == "__main__":
    sys.exit(main())
