"""Profiled solver drivers: per-region timing like the reference PROFILE
macro (src/profiler.h:17-22 around every call site in src/CGSolver.c:94-128
and src/main.c:213-215); counterpart of sparsebench_tpu/solvers/profiled.py.

``solve_cg_profiled`` (``--profile``) runs the CG iteration as a host loop
over its region operations, each closed by a device synchronise, into the
regions of a :class:`Profiler`; ``bench_spmv`` is the ``-t spmv`` timing
loop. The masked loop of ``solvers/cg.py`` is the fast path and the one the
headline numbers come from; this one pays a synchronise per operation, as
the reference pays for its PROFILE instrumentation.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from sparsebench_tpu_torch.config import synchronize
from sparsebench_tpu_torch.ops.blas1 import ddot, waxpby
from sparsebench_tpu_torch.profiler import Profiler, Region
from sparsebench_tpu_torch.solvers.cg import CGResult
from sparsebench_tpu_torch.utils import elapsed_seconds

_identity = lambda v: v  # noqa: E731


def solve_cg_profiled(
    A,
    b,
    prof: Profiler,
    *,
    itermax: int = 150,
    eps: float = 0.0,
    exchange: Callable = _identity,
    allsum: Callable = _identity,
    verbose: bool = True,
) -> CGResult:
    """CG with per-region attribution (reference solveCG,
    src/CGSolver.c:62; JAX ``solve_cg_profiled``).

    ``rtrans`` and ``pAp`` are host floats; the first iteration takes p = r;
    the x and r updates are timed together into WAXPBY. ``A.spmv`` is the
    format's own product (K1, K2's apply, K6 or K7 on the card). A format
    with ``permuted_output`` solves in its permuted order, and a matrix
    with more columns than rows (``nc > nr``) takes its vectors widened by
    zeros. ``exchange`` (halo exchange, COMM) and ``allsum`` (the global
    sum of a dot) are the distributed layer's hooks; the identity here.
    One untimed product first keeps the kernel's build and load out of the
    table."""
    device = A.device
    permuted = getattr(A, "permuted_output", False)
    spmv = A.spmv_permuted if permuted else A.spmv
    b_in = torch.as_tensor(b, device=device)
    if permuted:
        b_in = A.permute_vector(b_in)
    nr = b_in.shape[0]
    nc = A.nc
    vdt = b_in.dtype

    def timed(region: Region, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        synchronize(device)
        prof.add(region, time.perf_counter() - t0)
        return out

    def dot(u, v):
        return allsum(ddot(u, v))

    def widen(v):
        if nc == nr:
            return v
        return torch.cat([v, torch.zeros(nc - nr, dtype=vdt, device=device)])

    x = torch.zeros_like(b_in)
    spmv(widen(x))  # warm-up: first-use costs stay out of the regions
    synchronize(device)
    # init sequence (src/CGSolver.c:94-98)
    p = timed(Region.WAXPBY, waxpby, 1.0, widen(x), 0.0, widen(x))
    p = timed(Region.COMM, exchange, p)
    Ap = timed(Region.SPMVM, spmv, p)
    r = timed(Region.WAXPBY, waxpby, 1.0, b_in, -1.0, Ap)
    rtrans = float(timed(Region.DDOT, dot, r, r))
    normr = np.sqrt(rtrans)
    if verbose:
        print(f"Initial Residual = {normr:E}")

    print_freq = min(max(itermax // 10, 1), 50)
    hist = [normr]
    t_start = time.perf_counter()
    k = 1
    while k < itermax and normr > eps:
        if k == 1:
            p = timed(Region.WAXPBY, waxpby, 1.0, widen(r), 0.0, p)
        else:
            oldrtrans = rtrans
            rtrans = float(timed(Region.DDOT, dot, r, r))
            beta = rtrans / oldrtrans
            p = timed(Region.WAXPBY, waxpby, 1.0, widen(r), beta, p)
        normr = np.sqrt(rtrans)
        hist.append(normr)
        if verbose and (k % print_freq == 0 or k + 1 == itermax):
            print(f"Iteration = {k} Residual = {normr:E}")

        p = timed(Region.COMM, exchange, p)
        Ap = timed(Region.SPMVM, spmv, p)
        pAp = float(timed(Region.DDOT, dot, p[:nr], Ap))
        alpha = rtrans / pAp if pAp != 0 else 0.0

        def update(x, r):
            return (waxpby(1.0, x, alpha, p[:nr]),
                    waxpby(1.0, r, -alpha, Ap))

        # the reference times each (src/CGSolver.c:127-128); one
        # synchronise closes both here
        x, r = timed(Region.WAXPBY, update, x, r)
        k += 1
    solve_seconds = time.perf_counter() - t_start

    if verbose:
        print(f"Solution performed {k} iterations and took "
              f"{solve_seconds:.2f}s")
    if permuted:
        x = A.unpermute_vector(x)
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)  # numpy has no bf16; exact widening
    return CGResult(
        x=x.cpu().numpy(),
        iterations=k,
        residual_history=np.asarray(hist),
        final_normr=float(normr),
        solve_seconds=solve_seconds,
    )


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
    K2's apply for ``--fmt stencil``, the bslab kernel K6 or K7, the CRS
    kernel K14, or the plain gathers of SELL, ELL and CRS), each closed by
    a device synchronise, into the SPMVM region. x has ``dtype``, the
    policy's value dtype that CG's vectors have, so this times the SpMV
    that CG runs. (The JAX package gives x the stored dtype, bf16 under
    the f32 policy, where XLA fuses the casts; here each cast would be a
    kernel of its own.)

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
        seconds = elapsed_seconds(lambda: chained(x), device)
        per_iter = min(per_iter, seconds / fused_reps)

    if verbose:
        print(f"spMVM best per-iteration time: {per_iter * 1e3:.3f} ms")
    return per_iter
