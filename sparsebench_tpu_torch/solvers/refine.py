"""Mixed-precision iterative-refinement CG (counterpart of
sparsebench_tpu/solvers/refine.py; the reference fixes one precision a
build, src/util.h:35-53).

The outer loop computes the true residual in working precision and an
inner CG solves for the correction one precision down (f64 -> f32,
f32 -> bf16), where the matrix and vectors stream half the bytes:

    repeat:  r = b - A_hi x          (working precision, true residual)
             d ~= A_lo^-1 r          (low-precision CG to 0.05 ||r||)
             x += d

until ||r|| <= eps, ``outer_max`` sweeps, or a sweep that shrinks ||r|| by
less than ``stall_factor`` (the low precision's floor).

The inner solve is ``cg_loop`` (masked fixed trip, no host read). The
JAX package runs the sweeps as one ``while_loop`` too; here the host reads
one flag a sweep (the sweep loop's exit test) instead of issuing
``outer_max`` masked inner solves of ``inner_iters`` bodies each.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from sparsebench_tpu_torch.config import DTypePolicy, synchronize
from sparsebench_tpu_torch.solvers.cg import (
    CGResult,
    cg_loop,
    default_acc_dtype,
    matvec,
)


def refine_lo_dtype(hi_dtype: torch.dtype) -> torch.dtype:
    """The one-step-down dtype of the inner solve: f64 -> f32, f32 -> bf16;
    bf16 has no headroom below it."""
    if hi_dtype == torch.float64:
        return torch.float32
    if hi_dtype == torch.float32:
        return torch.bfloat16
    raise ValueError(
        "iterative refinement needs precision headroom below "
        f"{str(hi_dtype).removeprefix('torch.')}; run the inner precision "
        "directly instead"
    )


def refine_lo_policy(policy: DTypePolicy):
    """(lo_policy, lo_name) one value dtype down from ``policy``, the index
    dtype unchanged."""
    lo = refine_lo_dtype(policy.value)
    name = "f32" if lo == torch.float32 else "bf16"
    idx = "i64" if policy.index == torch.int64 else "i32"
    return DTypePolicy.from_names(name, idx), name


def cg_refine_loop(A_hi, A_lo, b: torch.Tensor, x0: torch.Tensor,
                   outer_max: int, inner_iters: int, eps,
                   acc_dtype: Optional[torch.dtype] = None,
                   inner_eps_factor: float = 0.05,
                   stall_factor: float = 0.9):
    """IR-CG on ``A_hi``/``A_lo``, the same matrix in working and low
    precision in the same row order. Returns (x, sweeps, total_inner,
    hist) with hist[j] the true residual norm entering sweep j (hist[0]
    the initial one) and total_inner the inner iterations of all
    sweeps."""
    vdt = b.dtype
    ldt = refine_lo_dtype(vdt)
    sdt = default_acc_dtype(vdt, acc_dtype)
    inner_acc = torch.float32 if ldt == torch.bfloat16 else None
    spmv = matvec(A_hi)
    device = b.device

    def true_normr(x):
        r = (b - spmv(x)).to(vdt)
        rr = torch.sum(r.to(sdt) * r.to(sdt))
        return r, torch.sqrt(torch.clamp(rr, min=0))

    eps = torch.as_tensor(eps, device=device)
    x = x0
    r, normr = true_normr(x0)
    hist = torch.full((outer_max + 1,), float("nan"), dtype=sdt,
                      device=device)
    hist[0] = normr
    zeros_lo = torch.zeros(b.shape[0], dtype=ldt, device=device)
    total_inner = torch.zeros((), dtype=torch.int64, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    sweep = 0
    while sweep < outer_max and bool((normr > eps) & ~done):
        eps_inner = (inner_eps_factor * normr).to(inner_acc or ldt)
        d_lo, k_in, _h = cg_loop(A_lo, r.to(ldt), zeros_lo, inner_iters,
                                 eps_inner, acc_dtype=inner_acc)
        x = x + d_lo.to(vdt)
        r, normr_new = true_normr(x)
        hist[sweep + 1] = normr_new
        # stagnation: the inner precision's floor
        done = normr_new >= normr * stall_factor
        normr = normr_new
        total_inner = total_inner + k_in
        sweep += 1
    return x, sweep, total_inner, hist


def solve_cg_refine(A_hi, b, *, A_lo=None, outer_max: int = 12,
                    inner_iters: int = 100, eps: float = 0.0,
                    acc_dtype: Optional[torch.dtype] = None,
                    verbose: bool = True) -> CGResult:
    """Host-side solve from x = 0: permutation, a warm-up solve, the timed
    solve and the per-sweep residual lines. ``A_lo`` defaults to ``A_hi``,
    right for the matrix-free stencil, whose apply adopts the vectors'
    dtype; a stored format passes its low-precision build. ``eps == 0``
    runs to the stagnation floor."""
    if A_lo is None:
        A_lo = A_hi
    device = A_hi.device
    b = torch.as_tensor(b, device=device)
    if b.dtype == torch.bfloat16:
        raise ValueError("iterative refinement needs b in f32/f64 — the "
                         "low precision is derived one step down")
    x0 = torch.zeros_like(b)
    permuted = getattr(A_hi, "permuted_output", False)
    if permuted != getattr(A_lo, "permuted_output", False):
        raise ValueError("A_hi and A_lo must share row order")
    if permuted:
        b, x0 = A_hi.permute_vector(b), A_hi.permute_vector(x0)
    eps_t = torch.tensor(eps, dtype=acc_dtype or b.dtype, device=device)

    def run():
        return cg_refine_loop(A_hi, A_lo, b, x0, outer_max, inner_iters,
                              eps_t, acc_dtype)

    run()  # warm-up
    t0 = time.perf_counter()
    x_dev, sweeps, ti_dev, hist_dev = run()
    synchronize(device)
    t1 = time.perf_counter()
    if permuted:
        x_dev = A_hi.unpermute_vector(x_dev)
    total_inner = int(ti_dev)
    hist = hist_dev.cpu().numpy()
    if verbose:
        print(f"Initial Residual = {hist[0]:E}")
        for j in range(1, sweeps + 1):
            print(f"Refinement sweep = {j} Residual = {hist[j]:E}")
        print(f"Solution performed {sweeps} sweeps / {total_inner} "
              f"low-precision iterations and took {t1 - t0:.2f}s")
    final = hist[sweeps] if sweeps > 0 else hist[0]
    return CGResult(
        x=x_dev.cpu().numpy(),
        iterations=total_inner,
        residual_history=hist[: sweeps + 1],
        final_normr=float(final),
        solve_seconds=t1 - t0,
    )
