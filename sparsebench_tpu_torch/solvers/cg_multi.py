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
with a shared Krylov space. A column that converges (normr <= eps) or
breaks down freezes (alpha = 0, P kept) while the others go on.

Which body runs where (``cg_multi_body.body_kind``, the rule of the
single-RHS loop, and ``cg_multi_body.takes``): on a CUDA card, with f32 or
f64 vectors accumulated in the same dtype and an SpMV whose product is a
contiguous (k, n) slab of that dtype, 16-byte aligned, a body is the three
kernels K15 around the SpMV (``ops/cg_multi_body.py``), one launch a stage
for all k columns, each column's masks and scalars on the card. The
single-RHS loop runs the same kernels at k = 1, and the run starts from
each column's r.r as ``cg_init`` takes it, so on the card column c equals
the single-RHS ``cg_loop`` on that column bit for bit (x, history, count)
wherever row c of the blocked product is the single-vector product of
column c: on DIA (row c of K8 is K1 on column c) and on every format that
stacks its single-vector products. Everywhere else (the CPU, bf16 vectors, mixed
dtypes, another product) the body is the eager loop (``plain_bodies``),
whose dots sum a (k, n) product along its rows (``torch.sum(..., dim=1)``):
column c then matches the single-RHS loop to reduction order only.

Masked fixed trip like ``solvers/cg.py``: the host issues ``itermax - 1``
bodies. Every body keeps its frozen columns exactly (P held, alpha 0), so
the bodies after the JAX loop's exit (all columns frozen) change nothing,
and the history, the per-column counts and X come out as the JAX
``while_loop``'s. The body index is the iteration index, known on the host.

While the program's recorder records (``profiler.py``), a solve is a span
``cg_multi.solve`` (``rhs``, ``itermax``, ``n``; ``body``: ``kernel`` or
``torch``) holding ``cg_multi.init`` and one ``cg_multi.body`` a body;
``cg_multi.bodies`` counts the bodies and ``cg_multi.kernel_bodies`` those
of them run as K15.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.config import synchronize
from sparsebench_tpu_torch.ops import cg_multi_body
from sparsebench_tpu_torch.ops.blas1 import ddot
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
    hist (itermax, k), NaN where a column had stopped). ``eps`` is one
    value or one a column."""
    sdt = default_acc_dtype(B.dtype, acc_dtype)
    spmm = make_spmm_kn(A)
    span = profiler.span_fn()
    with span("cg_multi.solve", rhs=B.shape[0], itermax=itermax,
              n=B.shape[1]):
        with span("cg_multi.init"):
            kind, state = multi_init(spmm, B, X0, itermax, eps, sdt)
        profiler.annotate(body=kind)
        if kind == "kernel":
            X, iters, hist = kernel_bodies(spmm, *state, span=span)
            profiler.count("cg_multi.kernel_bodies", max(itermax - 1, 0))
        else:
            X, iters, hist = plain_bodies(spmm, B, *state, sdt, span=span)
    profiler.count("cg_multi.bodies", max(itermax - 1, 0))
    return X, iters, hist


def _dots(U, V, sdt):
    # one sum per column, at the accumulation dtype
    return torch.sum(U.to(sdt) * V.to(sdt), dim=1)


def multi_init(spmm, B, X0, itermax: int, eps, sdt):
    """The loop's init and its choice of body: (kind, (X0, R, rtrans,
    normr, hist, eps)), ``kind`` ``"kernel"`` where K15 runs the bodies
    (``cg_multi_body.body_kind`` and ``cg_multi_body.takes`` of the first
    product), else ``"torch"``. The kernels start from each column's r.r
    as ``cg_init`` takes it, the eager loop from its row sums."""
    device = B.device
    kind = cg_multi_body.body_kind(device.type, B.dtype, sdt, False)
    eps = torch.as_tensor(eps, device=device).to(sdt)
    AX = spmm(X0)
    if kind == "kernel" and not cg_multi_body.takes(AX, B.dtype,
                                                    tuple(B.shape)):
        kind = "torch"
    R = B - AX
    if kind == "kernel":
        rtrans = torch.stack([ddot(r, r, acc_dtype=sdt) for r in R])
    else:
        rtrans = _dots(R, R, sdt)
    normr = torch.sqrt(rtrans)
    hist = torch.full((itermax, B.shape[0]), float("nan"), dtype=sdt,
                      device=device)
    hist[0] = normr
    return kind, (X0, R, rtrans, normr, hist, eps)


def plain_bodies(spmm, B, X0, R, rtrans, normr, hist, eps, sdt,
                 span=contextlib.nullcontext):
    """The eager loop (the plain version of K15): ``len(hist) - 1`` bodies
    from ``multi_init``'s state, each in ``span("cg_multi.body")``;
    (X, iters, hist) after them."""
    vdt = B.dtype
    X = X0
    active = normr > eps
    P = torch.zeros_like(B)
    iters = torch.ones(B.shape[0], dtype=torch.int32, device=B.device)
    for it in range(1, hist.shape[0]):
        with span("cg_multi.body"):
            if it == 1:
                new_rtrans = rtrans
                beta = torch.zeros_like(rtrans)
            else:
                new_rtrans = _dots(R, R, sdt)
                beta = safe_div(new_rtrans, rtrans)
            P = torch.where(active[:, None], R + beta[:, None].to(vdt) * P, P)
            normr_k = torch.sqrt(new_rtrans)
            hist[it] = torch.where(active, normr_k, float("nan"))
            AP = spmm(P)
            pAp = _dots(P, AP, sdt)
            # per-column breakdown guard (cg_run's): freeze that column
            breakdown = pAp <= new_rtrans * 1e-30
            step = active & ~breakdown
            alpha = torch.where(step, safe_div(new_rtrans, pAp), 0).to(vdt)
            X = X + alpha[:, None] * P
            R = R - alpha[:, None] * AP
            iters = iters + active.to(torch.int32)
            active = step & (normr_k > eps)
            rtrans = new_rtrans
    return X, iters, hist


def kernel_run(X0, R, rtrans, normr, hist, eps) -> cg_multi_body.Run:
    """A run of K15 from ``multi_init``'s state: P = 0, every count 1, no
    column done. It takes R and the history as its own, and a copy of X0.
    Set up inside ``torch.cuda.device`` of the slabs."""
    k = R.shape[0]
    return cg_multi_body.Run(
        X0.clone(memory_format=torch.contiguous_format), R,
        torch.zeros_like(R), rtrans, normr, hist,
        torch.broadcast_to(eps, (k,)).to(torch.float64).contiguous(),
        torch.ones(k, dtype=torch.int32, device=R.device),
        torch.zeros(k, dtype=torch.bool, device=R.device), hist.shape[0])


def kernel_bodies(spmm, X0, R, rtrans, normr, hist, eps,
                  span=contextlib.nullcontext):
    """``len(hist) - 1`` bodies of K15 around ``spmm`` from
    ``multi_init``'s state (``kernel_run``), each in
    ``span("cg_multi.body")``; (X, iters, hist) after them, the run's own
    tensors."""
    with torch.cuda.device(R.device):
        run = kernel_run(X0, R, rtrans, normr, hist, eps)
        for _ in range(1, hist.shape[0]):
            with span("cg_multi.body"):
                cg_multi_body.body_p(run)
                AP = spmm(run.P)
                cg_multi_body.body_pap(run, AP)
                cg_multi_body.body_xr(run, AP)
    return run.X, run.count, run.hist


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
