"""Where the time of one CG solve goes, on a CUDA card.

    python -m sparsebench_tpu_torch.profile_cg [-n 100 200] [-i 150]

For each grid size n (n^3 stencil, f32 vectors, bf16 diagonals, the DIA
kernel) it prints:

* the wall of one ``cg_loop``: host clock ending in a synchronise, best of
  3, without the profiler;
* under ``torch.profiler``: the device-busy time and its share of that wall,
  the SpMV kernel's share of device time, device kernels per iteration and
  the heaviest kernels;
* the wall of one CUDA-graph replay of the same loop, which drops the host's
  launch overhead, and whether its history equals the eager one.

Every time line carries the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.dia import DiaMatrix
from sparsebench_tpu_torch.solvers.cg import cg_loop, init_vectors


def _best_wall(fn, reps: int = 3) -> float:
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return min(walls)


def profile_size(n: int, itermax: int, gpu: str) -> None:
    dev = torch.device("cuda")
    A, counts = DiaMatrix.from_stencil(
        n, n, n, device=dev, policy=DTypePolicy.from_names("f32"),
        impl="kernel")
    _x, b, _xe = init_vectors(dtype=np.float32, row_lengths=counts)
    b = torch.from_numpy(b).to(dev)
    x0 = torch.zeros_like(b)
    eps = torch.tensor(0.0, device=dev)

    def run():
        return cg_loop(A, b, x0, itermax, eps)

    run()
    torch.cuda.synchronize()
    wall = _best_wall(run)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _x, _k, hist = run()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time for e in evs) * 1e-6
    spmv = sum(e.device_time for e in evs if "dia_spmv" in e.name) * 1e-6
    print(f"{n}^3 x{itermax}: wall {wall:.6f} s; device busy {busy:.6f} s "
          f"({busy / wall * 100:.1f} % of wall); SpMV {spmv:.6f} s "
          f"({spmv / busy * 100:.1f} % of device); "
          f"{len(evs) / itermax:.1f} device kernels per iteration | {gpu}")
    by_name: dict = {}
    for e in evs:
        t, c = by_name.get(e.name[:90], (0.0, 0))
        by_name[e.name[:90]] = (t + e.device_time, c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {t * 1e-3:10.3f} ms {c:6d}x  {name}")

    # one CUDA graph of the whole masked loop (warm-up on a side stream)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _xg, _kg, hist_g = run()
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(torch.nan_to_num(hist_g, nan=-1.0),
                       torch.nan_to_num(hist, nan=-1.0))
    print(f"{n}^3 x{itermax}: CUDA-graph replay {_best_wall(graph.replay):.6f}"
          f" s, history equal to eager: {same} | {gpu}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sparsebench_tpu_torch.profile_cg")
    ap.add_argument("-n", type=int, nargs="+", default=[100, 200],
                    help="grid sizes (n^3); default 100 200")
    ap.add_argument("-i", type=int, default=150, dest="itermax",
                    help="CG iterations; default 150")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_cg needs a CUDA card")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} | {gpu}")
    for n in args.n:
        profile_size(n, args.itermax, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
