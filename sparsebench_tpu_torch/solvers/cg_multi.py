"""Simultaneous (multi-RHS) CG: k independent systems with one A
(counterpart of sparsebench_tpu/solvers/cg_multi.py; the reference solves
one right-hand side, src/CGSolver.c).

The SpMV is bound by memory and the matrix is its largest stream. Solving
k right-hand sides in one loop reads the matrix once an iteration for all
k columns (DIA: K8, ``ops/dia_spmm.py``), so the matrix traffic per
right-hand side drops k-fold, and the loop issues one set of launches an
iteration for all k.

Layout: the public API takes (nr, k) column blocks; inside the loop every
slab is (k, n), slab-major, each column contiguous (the JAX package's
layout, and the one K8 reads coalesced).

Each column runs the reference iteration (src/CGSolver.c:94-129) on its
own, with (k,)-vectors of alpha, beta and the dots; it is not block CG
with a shared Krylov space, so column c matches a single-RHS ``cg_loop``
on that column to reduction order (bit for bit on DIA, where row c of K8
is K1 on column c). A column that converges (normr <= eps) or breaks down
freezes (alpha = 0) while the others go on.

Masked fixed trip like ``solvers/cg.py``: the host issues ``itermax - 1``
bodies. Every body keeps its frozen columns exactly (P held with
``where``, alpha 0), so the bodies after the JAX loop's exit (all columns
frozen) change nothing, and the history, the per-column counts and X come
out as the JAX ``while_loop``'s. The body index is the iteration index,
known on the host.

While the program's recorder records (``profiler.py``), a solve is a span
``cg_multi.solve`` (``rhs``, ``itermax``, ``n``) holding ``cg_multi.init``
and one ``cg_multi.body`` a body; ``cg_multi.bodies`` counts the bodies.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.config import synchronize
from sparsebench_tpu_torch.solvers.cg import (
    CGResult,
    default_acc_dtype,
    matvec,
    print_residual_history,
    safe_div,
)


def make_spmm_kn(A) -> Callable[[torch.Tensor], torch.Tensor]:
    """(k, nc) -> (k, nr) slab-major multi-RHS apply.

    A format with a native ``spmm_kn`` (DIA: K8 or its plain version) uses
    it. Every other format sends the k rows through its single-vector
    product one by one (``matvec``: SELL in its permuted space) and stacks
    the results: the JAX package ``vmap``s the product instead, which a
    ctypes kernel cannot be, so on bslab this is k launches of K6 an
    apply, the matrix read k times — the cost the JAX package's docstring
    accepts for those formats, whose time goes to gathers that every
    column needs anyway."""
    if hasattr(A, "spmm_kn"):
        return A.spmm_kn
    spmv = matvec(A)
    return lambda X: torch.stack([spmv(x) for x in X])


def cg_multi_loop(A, B: torch.Tensor, X0: torch.Tensor, itermax: int, eps,
                  acc_dtype: Optional[torch.dtype] = None):
    """Simultaneous CG over the rows of ``B`` (k, nr), in the format's row
    order. Returns (X (k, nr), iters (k,) per-column iteration counts,
    hist (itermax, k), NaN where a column had stopped)."""
    k_rhs = B.shape[0]
    vdt = B.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    device = B.device
    spmm = make_spmm_kn(A)

    def dots(U, V):
        # one sum per column, at the accumulation dtype
        return torch.sum(U.to(sdt) * V.to(sdt), dim=1)

    span = profiler.span_fn()
    with span("cg_multi.solve", rhs=k_rhs, itermax=itermax,
              n=B.shape[1]):
        with span("cg_multi.init"):
            eps = torch.as_tensor(eps, device=device).to(sdt)
            X = X0
            R = B - spmm(X0)
            rtrans = dots(R, R)
            normr = torch.sqrt(rtrans)
            hist = torch.full((itermax, k_rhs), float("nan"), dtype=sdt,
                              device=device)
            hist[0] = normr
            active = normr > eps
            P = torch.zeros_like(B)
            iters = torch.ones(k_rhs, dtype=torch.int32, device=device)
        for it in range(1, itermax):
            with span("cg_multi.body"):
                if it == 1:
                    new_rtrans = rtrans
                    beta = torch.zeros_like(rtrans)
                else:
                    new_rtrans = dots(R, R)
                    beta = safe_div(new_rtrans, rtrans)
                P = torch.where(active[:, None], R + beta[:, None].to(vdt) * P, P)
                normr_k = torch.sqrt(new_rtrans)
                hist[it] = torch.where(active, normr_k, float("nan"))
                AP = spmm(P)
                pAp = dots(P, AP)
                # per-column breakdown guard (cg_run's): freeze that column
                breakdown = pAp <= new_rtrans * 1e-30
                step = active & ~breakdown
                alpha = torch.where(step, safe_div(new_rtrans, pAp), 0).to(vdt)
                X = X + alpha[:, None] * P
                R = R - alpha[:, None] * AP
                iters = iters + active.to(torch.int32)
                active = step & (normr_k > eps)
                rtrans = new_rtrans
    profiler.count("cg_multi.bodies", max(itermax - 1, 0))
    return X, iters, hist


def solve_cg_multi(A, B, *, itermax: int = 150, eps: float = 0.0,
                   acc_dtype: Optional[torch.dtype] = None,
                   verbose: bool = True) -> CGResult:
    """Host-side blocked solve from X = 0: ``B`` (nr, k) in
    original row order; the result's ``x`` is the (nr, k) solution,
    ``iterations`` the largest per-column count and ``residual_history``
    the (iters, k) history. A warm-up solve, then the timed one."""
    device = A.device
    B = torch.as_tensor(B, device=device)
    if B.dim() != 2:
        raise ValueError(f"B must be (nr, k), got shape {tuple(B.shape)}")
    B_in = B.t().contiguous()
    permuted = getattr(A, "permuted_output", False)
    if permuted:
        B_in = torch.stack([A.permute_vector(v) for v in B_in])
    X0_in = torch.zeros_like(B_in)
    eps_t = torch.tensor(eps, dtype=acc_dtype or B.dtype, device=device)

    int(cg_multi_loop(A, B_in, X0_in, itermax, eps_t, acc_dtype)[1][0])
    t0 = time.perf_counter()
    X_dev, iters_dev, hist_dev = cg_multi_loop(A, B_in, X0_in, itermax,
                                               eps_t, acc_dtype)
    synchronize(device)
    t1 = time.perf_counter()
    iters = iters_dev.cpu().numpy()
    if permuted:
        X_dev = torch.stack([A.unpermute_vector(v) for v in X_dev])
    if X_dev.dtype == torch.bfloat16:
        X_dev = X_dev.to(torch.float32)
    hist = hist_dev.cpu().numpy()
    k = int(iters.max())
    if verbose:
        print(f"[cg-multi] {B.shape[1]} right-hand sides, per-column "
              f"iterations {iters.min()}..{iters.max()}")
        print_residual_history(hist[:, 0], int(iters[0]), itermax)
        print(f"Solution performed {k} iterations and took {t1 - t0:.2f}s")
    finals = hist[np.maximum(iters - 1, 0), np.arange(hist.shape[1])]
    return CGResult(
        x=X_dev.cpu().numpy().T,
        iterations=k,
        residual_history=hist[:k],
        final_normr=float(np.nanmax(finals)),
        solve_seconds=t1 - t0,
    )
