"""SpMV benchmark (reference -t spmv path, src/main.c:200-216; counterpart of
``bench_spmv`` in sparsebench_tpu/solvers/profiled.py).

The profiled CG solve of the JAX package (``solve_cg_profiled``, --profile)
is not ported yet (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import time

import torch

from sparsebench_tpu_torch.config import synchronize
from sparsebench_tpu_torch.profiler import Profiler, Region


def bench_spmv(
    A,
    prof: Profiler,
    *,
    dtype: torch.dtype,
    itermax: int = 150,
    verbose: bool = True,
    fused_reps: int = 0,
) -> float:
    """x = 1 and ``itermax - 1`` timed SpMVs (``A.spmv``: the DIA kernel K1,
    K2's apply for ``--fmt stencil``, the bslab kernel K6 or K7, or the
    plain gathers of SELL, ELL and CRS), each closed by a device
    synchronise, into the SPMVM region. x has ``dtype``, the policy's value
    dtype that CG's vectors have, so this times the SpMV that CG runs. (The
    JAX package gives x the stored dtype, bf16 under the f32 policy, where
    XLA fuses the casts; here each cast would be a kernel of its own.)

    Returns the best per-iteration seconds. With ``fused_reps`` > 0 a run
    of that many chained SpMVs (y fed back as x), timed with CUDA events
    on the card (the host clock on the CPU), refines the time below the
    per-call synchronise; it needs a square matrix and is skipped for
    another.
    """
    device = A.device
    x = torch.ones(A.nc, dtype=dtype, device=device)
    y = A.spmv(x)  # warm-up: kernel build and load
    synchronize(device)

    for _ in range(1, itermax):
        t0 = time.perf_counter()
        y = A.spmv(x)
        synchronize(device)
        prof.add(Region.SPMVM, time.perf_counter() - t0)
    del y

    iters = max(itermax - 1, 1)
    per_iter = prof.times[Region.SPMVM] / iters

    if fused_reps > 0 and A.nr == A.nc:
        def chained(v):
            for _ in range(fused_reps):
                v = A.spmv(v)  # square operators: y has x's length
            return v

        chained(x)
        synchronize(device)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chained(x)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            chained(x)
            seconds = time.perf_counter() - t0
        per_iter = min(per_iter, seconds / fused_reps)

    if verbose:
        print(f"spMVM best per-iteration time: {per_iter * 1e3:.3f} ms")
    return per_iter
