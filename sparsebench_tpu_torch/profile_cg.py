"""Where the time of one CG solve goes, on a CUDA card.

    python -m sparsebench_tpu_torch.profile_cg [-n 100 200] [-i 150]
        [--fmt dia|stencil] [--variant standard|cs|fused|vmem]

For each grid size n (n^3 generated stencil, f32 vectors; DIA with bf16
diagonals and the K1 kernel, or the matrix-free stencil operator with
K2-K5) it prints:

* the wall of one solve loop (``CG_LOOPS[variant]``): host clock
  ending in a synchronise, best of 3, without the profiler;
* under ``torch.profiler``: the device-busy time and its share of that
  wall, the port's own kernels' share of device time and each of their
  device times and launch counts by name, device kernels per iteration
  and the heaviest kernels;
* the wall of one CUDA-graph replay of the same loop, which drops the host's
  launch overhead, and whether its history equals the eager one (not for
  ``vmem``, which is one cooperative launch).

``SB_FUSED_CS=1`` in the environment selects the fused ``cs`` body, as it
does for the CLI. Every time line carries the card's name and power limit
from nvidia-smi.
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
from sparsebench_tpu_torch.formats.stencil import StencilOperator
from sparsebench_tpu_torch.solvers.cg import CG_LOOPS, init_vectors

# the port's kernels, by the names their device events carry
KERNELS = ("dia_spmv_kernel", "stencil_apply_kernel",
           "stencil_axpy_apply_dots_kernel", "cs_update_kernel",
           "stencil_cg_vmem_kernel")


def _best_wall(fn, reps: int = 3) -> float:
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return min(walls)


def profile_size(n: int, itermax: int, fmt: str, variant: str,
                 gpu: str) -> None:
    dev = torch.device("cuda")
    build = StencilOperator if fmt == "stencil" else DiaMatrix
    A, counts = build.from_stencil(
        n, n, n, device=dev, policy=DTypePolicy.from_names("f32"),
        impl="kernel")
    _x, b, _xe = init_vectors(dtype=np.float32, row_lengths=counts)
    b = torch.from_numpy(b).to(dev)
    x0 = torch.zeros_like(b)
    eps = torch.tensor(0.0, device=dev)
    loop = CG_LOOPS[variant]
    tag = f"{n}^3 {fmt}/{variant} x{itermax}"

    def run():
        return loop(A, b, x0, itermax, eps)

    run()
    torch.cuda.synchronize()
    wall = _best_wall(run)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _x, _k, hist = run()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time for e in evs) * 1e-6
    ours = {}
    for e in evs:
        for name in KERNELS:
            if name in e.name:
                t, c = ours.get(name, (0.0, 0))
                ours[name] = (t + e.device_time * 1e-6, c + 1)
    own = sum(t for t, _c in ours.values())
    print(f"{tag}: wall {wall:.6f} s; device busy {busy:.6f} s "
          f"({busy / wall * 100:.1f} % of wall); port kernels {own:.6f} s "
          f"({own / busy * 100:.1f} % of device); "
          f"{len(evs) / itermax:.1f} device kernels per iteration | {gpu}")
    for name, (t, c) in sorted(ours.items()):
        print(f"    kernel {name}: {t:.6f} s device, {c} launches")
    by_name: dict = {}
    for e in evs:
        t, c = by_name.get(e.name[:90], (0.0, 0))
        by_name[e.name[:90]] = (t + e.device_time, c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {t * 1e-3:10.3f} ms {c:6d}x  {name}")

    if variant == "vmem":
        return
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
    print(f"{tag}: CUDA-graph replay {_best_wall(graph.replay):.6f}"
          f" s, history equal to eager: {same} | {gpu}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sparsebench_tpu_torch.profile_cg")
    ap.add_argument("-n", type=int, nargs="+", default=[100, 200],
                    help="grid sizes (n^3); default 100 200")
    ap.add_argument("-i", type=int, default=150, dest="itermax",
                    help="CG iterations; default 150")
    ap.add_argument("--fmt", default="dia", choices=["dia", "stencil"],
                    help="operator; default dia")
    ap.add_argument("--variant", default="standard",
                    choices=list(CG_LOOPS),
                    help="CG variant; default standard")
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
        profile_size(n, args.itermax, args.fmt, args.variant, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
