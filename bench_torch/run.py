"""The benchmark of the PyTorch/CUDA port, one run of one cell:

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. It builds the cell's matrix on the card, makes the inputs from
the seed, warms up, runs the traffic mix in a closed loop for the
window, then compares a sample of the window's answers, drawn by the
seed, with the plain f64 reference. Its last line on standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics,
read from a profiler trace of a window of the mix's ``trace_seconds``),
``device``, with ``--trace 1`` ``breakdown``, the benchmark's set-up
``spans`` and, last, ``checks``: each number compared beside its limit,
which are also the last lines on standard error.

``run(..., control=True)`` runs the program's own path one precision
down (the configuration's ``control_vectors``), whose numbers must fail
their limits: ``readings.py`` reads it on the card, the harness's tests on
the CPU; the benchmark's own runs never take it.

Without the cards it asks for it prints no result and exits 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit():
    """The first card's power limit as nvidia-smi gives it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.split("\n")[0].strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None


def run(spec, workload: str, seed: int, seconds: float, trace: bool,
        device, control: bool = False, config: dict | None = None,
        t0: float = T0) -> dict:
    """One run of ``workload`` on ``device`` as a result dict. Metrics and
    device figures are written only for a CUDA device: a run on the CPU
    (the harness's own tests) gives ``correct``, the counts and
    ``checks``."""
    import torch

    from harness.cell import Cell
    from harness.stats import window_metrics
    from harness.trace import read_metrics

    cell = Cell(spec, workload, device, control=control, config=config)
    cell.prepare(seed)
    setup_s = time.perf_counter() - t0
    w, ctx = cell.window(seed, seconds, trace)
    cuda = device.type == "cuda"
    result = {"correct": False, "attempted": w.ops, "failed": w.failed,
              "metrics": {}, "device": {}}
    if cuda:
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device),
            "power_limit": power_limit()}
        if trace:
            result["metrics"] = read_metrics(spec, workload, ctx)
            result["device"].update(busy_s=ctx.busy_s, window_s=ctx.window_s)
            result["breakdown"] = ctx.breakdown()
        else:
            stats = window_metrics(w.seconds, w.ops,
                                   cell.traffic.get("rhs", 1), w.op_s)
            stats["setup_s"] = setup_s
            names = dict(cell.traffic["end_to_end"], setup_s="setup_s")
            units = {m["name"]: m["unit"] for m in spec.end_to_end(workload)}
            result["metrics"] = {name: {"value": stats[names[name]],
                                        "unit": unit}
                                 for name, unit in units.items()}
    result["spans"] = dict(cell.spans, window=w.seconds)
    cell.release()
    del ctx
    result["correct"], result["checks"] = cell.compare(w.samples, w.failed)
    return result


def finite(obj):
    """``obj`` with each NaN or infinite float as its string, so that the
    line stays JSON."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and obj - obj != 0:
        return str(obj)
    return obj


def main(argv=None) -> int:
    args = parse(argv)
    from harness.spec import Spec

    spec = Spec()
    chips = spec.cell(args.workload)["chips"]
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"bench_torch: {args.workload} needs {chips} CUDA card(s), "
              f"found {found}; no result", file=sys.stderr)
        return 2
    result = run(spec, args.workload, args.seed, args.seconds,
                 bool(args.trace), torch.device("cuda", 0))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
