"""The readings that a cell's limits are set from (``limits/<cell>.json``):

    python3 bench_torch/readings.py --workload <cell> --seconds 2
        --seeds 101 ... 112 --control-seeds 201 202 203

In one process on the card: the program as the configuration states it
on each of ``--seeds``, then the control (the program's own path one
precision down, ``control_vectors``) on each of ``--control-seeds``;
each a short window at the cell's own load and the same comparison as a
run of ``run.py``. One JSON line a seed, then the summary: the largest
reading of the program (the lower reading) and the smallest of the
control (the upper one) of each number. The benchmark's own runs never
run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def readings(spec, workload, seeds, control, seconds, device):
    from harness import check
    from harness.cell import Cell

    cell = Cell(spec, workload, device, control=control)
    out = []
    for seed in seeds:
        cell.prepare(seed)
        w, _ = cell.window(seed, seconds, False)
        t0 = time.perf_counter()
        numbers = check.compare(cell.traffic, cell.cfg, cell.pool, w.samples)
        row = {"workload": workload, "control": control, "seed": seed,
               "ops": w.ops, "failed": w.failed, "numbers": numbers,
               "reference_s": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch

    from harness.spec import Spec

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    spec, device = Spec(), torch.device("cuda", 0)
    program = readings(spec, args.workload, args.seeds, False, args.seconds,
                       device)
    control = readings(spec, args.workload, args.control_seeds, True,
                       args.seconds, device)
    summary = {}
    for name in program[0]["numbers"]:
        lower = max(r["numbers"][name] for r in program)
        upper = (min(r["numbers"][name] for r in control)
                 if control else None)
        summary[name] = {"lower": lower, "upper": upper,
                         "seeds": len(program), "control_seeds": len(control)}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "failed": sum(r["failed"] for r in program)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
