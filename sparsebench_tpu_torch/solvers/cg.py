"""Conjugate-Gradient solver (reference src/CGSolver.c; counterpart of
sparsebench_tpu/solvers/cg.py).

Unpreconditioned HPCG-style CG with the reference's iteration structure
(src/CGSolver.c:94-129):

    init:  p = x0; Ap = A p; r = b - Ap; rtrans = r.r
    k = 1 .. itermax-1 while normr > eps:
        k == 1:  p = r
        else:    rtrans, old = r.r, rtrans; beta = rtrans/old; p = r + beta p
        normr = sqrt(rtrans)
        Ap = A p
        alpha = rtrans / (p . Ap)
        x += alpha p;  r -= alpha Ap

What carries over from the JAX package exactly:
  * the exit test reads the ``normr`` of the previous body;
  * the first body takes p = r and keeps the initial ``rtrans``;
  * breakdown (p.Ap <= rtrans * 1e-30, machine-zero residual) sets alpha
    to 0 and ends the solve instead of NaN-poisoning x;
  * the history has ``itermax`` entries, NaN where the solve never got to;
  * dots are sum(u*v) at the accumulation dtype; bf16 vectors accumulate
    in f32.

No host round trip per iteration: the JAX loop is one ``lax.while_loop``;
here the host issues a fixed ``itermax - 1`` bodies and a device-side
``active`` flag, (k < k_end) & (normr > eps) & ~done, masks each body's
updates (alpha = 0, history written and k advanced only while active). So
``k``, the history and x come out as JAX's without reading ``normr`` back
each iteration; the price is that a solve ending early (eps > 0 or
breakdown) still runs the remaining bodies, masked. On a card, f32 or f64
and unpreconditioned, a body is three kernels around the SpMV that carry
the masks and scalars on the device (``ops/cg_multi_body.py``, K15 at
k = 1); elsewhere it is the same three stages in plain torch
(``ops/cg_body.py``).

The variants ``cs`` (single-reduction CG, ``cg_cs_loop``), ``fused``
(p-update, apply and p.Ap in one kernel, ``cg_fused_loop``) and ``vmem``
(the whole solve in one kernel, ``cg_vmem_loop``) are ported with the same
masked fixed-trip design; ``sstep`` (``solvers/cg_sstep.py``) and ``pipe``
(``solvers/cg_pipe.py``) read one flag a step on the host instead (their
modules say why). ``resolve_cg_loop`` maps a name to its loop.
``inv_diag`` (Jacobi) and ``precond`` (``solvers/precond.ChebPrecond``)
precondition ``standard``, ``cs`` and ``pipe``; ``sstep`` takes Jacobi.

While the program's recorder records (``profiler.py``), each solve of a
loop of ``CG_LOOPS`` is a span ``cg.solve`` (``variant``, ``itermax``,
``n``) holding a span ``cg.init`` and, in the eager loops, one span
``cg.body`` a body, in ``vmem`` one span ``stencil.cg_vmem`` (``kernel``
K5 or torch, ``n``, ``itermax``; on a card K5's plan: ``r``, ``tz``,
``blocks``); ``cg.bodies`` counts the bodies run, and
``cg.kernel_bodies`` those of them fused (``cg_run``). The loops read the
recorder's switch once a solve.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.config import synchronize
from sparsebench_tpu_torch.ops import cg_body, cg_multi_body
from sparsebench_tpu_torch.ops.blas1 import ddot, safe_div
from sparsebench_tpu_torch.ops.cg_fused import cs_update
from sparsebench_tpu_torch.ops.stencil_cg_vmem import (
    stencil_cg_vmem,
    stencil_cg_vmem_torch,
)
from sparsebench_tpu_torch.solvers.precond import resolve_apply_m


def default_acc_dtype(vdt: torch.dtype, acc_dtype: Optional[torch.dtype]):
    """Accumulation dtype for the solver's scalars (dots, residual
    history): bf16 vectors accumulate in f32, others in their own dtype."""
    if acc_dtype is not None:
        return acc_dtype
    if vdt == torch.bfloat16:
        return torch.float32
    return vdt


def print_residual_history(hist: np.ndarray, k: int, itermax: int) -> None:
    """The reference's residual print block (printFreq semantics,
    src/CGSolver.c:85-91,118-120)."""
    print(f"Initial Residual = {hist[0]:E}")
    print_freq = min(max(itermax // 10, 1), 50)
    for j in range(1, k):
        if (j % print_freq == 0 or j + 1 == itermax) and not np.isnan(
            hist[j]
        ):
            print(f"Iteration = {j} Residual = {hist[j]:E}")


@dataclasses.dataclass
class CGResult:
    x: np.ndarray                    # solution
    iterations: int                  # reference's returned k (CGSolver.c:138)
    residual_history: np.ndarray     # normr per iteration; [0] = initial
    final_normr: float
    solve_seconds: float


def matvec(A):
    """The operator's product in the space the solve runs in: a
    row-permuting format (SELL on its gather path) solves in permuted
    order (``solve_cg`` permutes b and x0 in and x out)."""
    return A.spmv_permuted if getattr(A, "permuted_output", False) else A.spmv


def _eps_tensor(eps, sdt, device):
    return eps if torch.is_tensor(eps) else torch.tensor(eps, dtype=sdt,
                                                         device=device)


def cg_init(A, b: torch.Tensor, x0: torch.Tensor, itermax: int,
            acc_dtype: Optional[torch.dtype] = None, inv_diag=None,
            precond=None):
    """Initial CG state (reference src/CGSolver.c:94-104): the tuple
    (k, x, p, r, rtrans, normr, hist, done) of device tensors, the JAX
    package's checkpointable state. With ``inv_diag`` (Jacobi) or
    ``precond`` (ChebPrecond) the ``rtrans`` slot carries r.z, z = M^-1 r,
    while ``normr`` and the history keep the true ||r||."""
    sdt = default_acc_dtype(b.dtype, acc_dtype)
    spmv = matvec(A)
    apply_m = resolve_apply_m(precond, inv_diag, spmv, b.dtype)
    p = x0
    r = b - spmv(p)
    if apply_m is None:
        rtrans = ddot(r, r, acc_dtype=sdt)
        normr = torch.sqrt(rtrans)
    else:
        rtrans = ddot(r, apply_m(r), acc_dtype=sdt)
        normr = torch.sqrt(ddot(r, r, acc_dtype=sdt))
    hist = torch.full((itermax,), float("nan"), dtype=sdt, device=b.device)
    hist[0] = normr
    k = torch.ones((), dtype=torch.int64, device=b.device)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    return k, x0, p, r, rtrans, normr, hist, done


def cg_run(A, state, k_end: int, eps, acc_dtype: Optional[torch.dtype] = None,
           inv_diag=None, precond=None, k_start: Optional[int] = None):
    """Advance CG from ``state`` until k == k_end, convergence or breakdown
    (reference hot loop, src/CGSolver.c:107-129), as masked bodies:
    ``k_end - k_start`` of them when the caller knows the state's k on the
    host (``k_start``, as the checkpointed solve does), else ``k_end - 1``
    (k >= 1 in any state, so that many always suffice). An inactive body
    changes no state entry, so two segments give the bits of one run.
    ``inv_diag``/``precond`` as in ``cg_init``.

    A body is three stages around the SpMV: the kernels K15 at k = 1
    where ``cg_multi_body.body_kind`` says so (f32/f32 or f64/f64,
    unpreconditioned, on a card) and the SpMV's product is a vector they
    read (``cg_multi_body.takes``), with the run's own copies of x, p and
    r updated in place, else the plain stages of ``ops/cg_body.py``. The
    kind is the attribute ``body`` of the innermost open span
    (``cg.solve`` under ``cg_loop``); ``cg.kernel_bodies`` counts the
    fused bodies beside ``cg.bodies``."""
    r = state[3]
    vdt = r.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    eps = _eps_tensor(eps, sdt, r.device)
    spmv = matvec(A)
    apply_m = resolve_apply_m(precond, inv_diag, spmv, vdt)
    span = profiler.span_fn()
    bodies = max(k_end - (1 if k_start is None else k_start), 0)
    kind = cg_multi_body.body_kind(r.device.type, vdt, sdt,
                                   apply_m is not None)
    if kind == "kernel":
        fused = _fused_bodies(spmv, state, bodies, k_end, eps, span)
        if fused is None:
            kind = "torch"
        else:
            state = fused
            profiler.count("cg.kernel_bodies", bodies)
    if kind == "torch":
        state = cg_body.plain_bodies(spmv, state, bodies, k_end, eps, sdt,
                                     apply_m, span)
    profiler.annotate(body=kind)
    profiler.count("cg.bodies", bodies)
    return state


def kernel_run(state, k_end: int, eps) -> cg_multi_body.Run:
    """A run of K15 at k = 1 from the CG state ``state`` to ``k_end``, on
    (1, n) views of its own copies of x, r and p, the history and the
    count, so that it never writes into ``state``. ``eps`` is a tensor,
    compared in f64. Set up inside ``torch.cuda.device`` of the
    vectors."""
    k, x, p, r, rtrans, normr, hist, done = state
    same = torch.contiguous_format
    return cg_multi_body.Run(
        *(v.reshape(1, -1).clone(memory_format=same) for v in (x, r, p)),
        rtrans.reshape(1), normr.reshape(1),
        hist.reshape(-1, 1).clone(memory_format=same),
        eps.to(device=r.device, dtype=torch.float64).reshape(1),
        k.reshape(1).to(torch.int32, copy=True), done.reshape(1), k_end)


def _fused_bodies(spmv, state, bodies: int, k_end: int, eps, span):
    """``bodies`` fused bodies from ``state`` (``kernel_run``, K15 at k = 1
    around the SpMV): the state after them, in the dtypes and shapes of
    ``cg_init``'s. None where the first body's SpMV gives a product the
    kernels do not read (``cg_multi_body.takes``, asked before B and C
    launch): ``state`` is as it was, for the plain body to run from, which
    takes torch's type promotion."""
    with torch.cuda.device(state[3].device):
        run = kernel_run(state, k_end, eps)
        # the state carries no r.r: a continuing body reads this one
        cg_multi_body.body_rr(run)
        for i in range(bodies):
            with span("cg.body"):
                cg_multi_body.body_p(run)
                ap = spmv(run.P[0]).unsqueeze(0)
                if i == 0 and not cg_multi_body.takes(ap, run.dtype,
                                                      run.shape):
                    return None
                cg_multi_body.body_pap(run, ap)
                cg_multi_body.body_xr(run, ap)
    # the state's dtypes: the count and done (the flags' third row) cast
    return (run.count.reshape(()).to(torch.int64), run.X[0], run.P[0],
            run.R[0], run.s[0, 0], run.s[1, 0], run.hist[:, 0],
            run.flags[2, 0].to(torch.bool))


def _solve_span(variant: str):
    """Decorate a loop of ``CG_LOOPS``: a solve is a span ``cg.solve``
    while the recorder records."""
    def wrap(loop):
        @functools.wraps(loop)
        def solve(A, b, x0, itermax, eps, *args, **kw):
            with profiler.span("cg.solve", variant=variant, itermax=itermax,
                               n=b.numel()):
                return loop(A, b, x0, itermax, eps, *args, **kw)
        return solve
    return wrap


@_solve_span("standard")
def cg_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
            acc_dtype: Optional[torch.dtype] = None, inv_diag=None,
            precond=None):
    """CG from x0: returns (x, k, history[itermax]) as device tensors, with
    history[j] = normr at iteration j (NaN where not reached)."""
    with profiler.span("cg.init"):
        state = cg_init(A, b, x0, itermax, acc_dtype, inv_diag, precond)
    k, x, _p, _r, _rtrans, _normr, hist, _done = cg_run(
        A, state, itermax, eps, acc_dtype, inv_diag, precond
    )
    return x, k, hist


@_solve_span("cs")
def cg_cs_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
               acc_dtype: Optional[torch.dtype] = None, inv_diag=None,
               precond=None):
    """Single-reduction CG (Chronopoulos & Gear 1989; JAX ``cg_cs_loop``).
    The same Krylov iterates as standard CG, with the dots of an iteration
    taken together after one apply:

        u = M^-1 r, w = A u;  gamma = r.u, delta = w.u  (+ r.r under M)
        beta  = gamma/gamma_old;  alpha = gamma / (delta - beta*gamma/alpha_old)
        p = u + beta p;  s = w + beta s  (s carries A p)
        x += alpha p;  r -= alpha s

    M = I unpreconditioned (u = r); ``inv_diag``/``precond`` as in
    ``cg_init``, the history then the true ||r||. With ``SB_FUSED_CS`` set
    in the environment, no preconditioner, an operator with
    ``supports_fused_cs`` (the stencil) and f32 accumulation, the apply
    returns the dots itself (K2's dots form) and the four updates are one
    kernel (K4, ``ops/cg_fused.cs_update``): the JAX package's switch, read
    the same way and kept only for parity with it (the fused body ran
    faster on the H100; ROADMAP.md Queue 1 item 6 has its removal). Masked
    like ``cg_run``: ``itermax - 1`` bodies; once
    inactive, alpha is 0 (x and r keep their bits, so u, w and the dots
    recompute to theirs) and the other state is held with ``where``."""
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    device = b.device
    spmv = matvec(A)
    apply_m = resolve_apply_m(precond, inv_diag, spmv, vdt)
    has_m = apply_m is not None
    fused = (not has_m
             and bool(os.environ.get("SB_FUSED_CS"))
             and getattr(A, "supports_fused_cs", False)
             and sdt == torch.float32)

    def spmv_dots(r, u):
        # (w = A u, [gamma = r.u, delta = w.u] (+ [r.r] under M))
        if fused:
            return A.spmv_permuted_dots(u)
        w = spmv(u)
        parts = [ddot(r, u, acc_dtype=sdt), ddot(w, u, acc_dtype=sdt)]
        if has_m:
            parts.append(ddot(r, r, acc_dtype=sdt))
        return w, torch.stack(parts)

    span = profiler.span_fn()
    with span("cg.init"):
        eps = _eps_tensor(eps, sdt, device)
        r = b - spmv(x0)
        u = apply_m(r) if has_m else r
        w, gd = spmv_dots(r, u)
        gamma = gd[0]
        rr = gd[2] if has_m else gamma
        alpha = safe_div(gamma, gd[1])
        normr = torch.sqrt(rr)
        hist = torch.full((itermax,), float("nan"), dtype=sdt, device=device)
        hist[0] = normr
        x = x0
        p = torch.zeros_like(b)
        s = torch.zeros_like(b)
        beta = torch.zeros((), dtype=sdt, device=device)
        k = torch.ones((), dtype=torch.int64, device=device)
        done = torch.zeros((), dtype=torch.bool, device=device)
        steps = torch.arange(itermax, device=device)
    for _ in range(itermax - 1):
        with span("cg.body"):
            active = (k < itermax) & (normr > eps) & ~done
            normr_new = torch.sqrt(rr)
            hist = torch.where(active & (steps == k), normr_new, hist)
            a = torch.where(active, alpha, 0)
            if fused:
                p_new, s_new, x, r = cs_update(u, p, w, s, x, r, a, beta)
            else:
                b_v = beta.to(vdt)
                p_new = u + b_v * p
                s_new = w + b_v * s
                a_v = a.to(vdt)
                x = x + a_v * p_new
                r = r - a_v * s_new
            u = apply_m(r) if has_m else r
            w, gd = spmv_dots(r, u)
            g_new, d_new = gd[0], gd[1]
            rr_new = gd[2] if has_m else g_new
            beta_new = safe_div(g_new, gamma)
            denom = d_new - beta_new * safe_div(g_new, alpha)
            # denom is p.Ap in disguise: the same positivity guard as cg_run
            breakdown = denom <= g_new * 1e-30
            alpha_new = torch.where(breakdown, 0, safe_div(g_new, denom))

            p = torch.where(active, p_new, p)
            s = torch.where(active, s_new, s)
            gamma = torch.where(active, g_new, gamma)
            rr = torch.where(active, rr_new, rr)
            alpha = torch.where(active, alpha_new, alpha)
            beta = torch.where(active, beta_new, beta)
            normr = torch.where(active, normr_new, normr)
            done = done | (active & breakdown)
            k = k + active.to(k.dtype)
    profiler.count("cg.bodies", itermax - 1)
    return x, k, hist


def _unpreconditioned(variant: str, inv_diag, precond) -> None:
    if inv_diag is not None or precond is not None:
        raise ValueError(
            f"variant {variant!r} is unpreconditioned; use 'standard'/'cs' "
            "with inv_diag/precond"
        )


@_solve_span("fused")
def cg_fused_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
                  acc_dtype: Optional[torch.dtype] = None, inv_diag=None,
                  precond=None):
    """Standard-CG iterates with the front half of each iteration in one
    kernel (JAX ``cg_fused_loop``): ``A.axpy_spmv_dots(r, p, beta)`` gives
    p = r + beta p, w = A p and delta = p.w in one pass (K3). The back half
    (x += alpha p, r -= alpha w, r.r) is plain torch. Masked like
    ``cg_run``; unpreconditioned."""
    _unpreconditioned("fused", inv_diag, precond)
    if not getattr(A, "supports_fused_pw", False):
        raise ValueError(
            "variant 'fused' needs a format with axpy_spmv_dots (the "
            "stencil operator); use --fmt stencil or another cg variant"
        )
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    device = b.device
    span = profiler.span_fn()
    with span("cg.init"):
        eps = _eps_tensor(eps, sdt, device)
        r = b - A.spmv(x0)
        rtrans = ddot(r, r, acc_dtype=sdt)
        rtrans_prev = rtrans
        normr = torch.sqrt(rtrans)
        hist = torch.full((itermax,), float("nan"), dtype=sdt, device=device)
        hist[0] = normr
        x = x0
        p = torch.zeros_like(b)
        k = torch.ones((), dtype=torch.int64, device=device)
        done = torch.zeros((), dtype=torch.bool, device=device)
        steps = torch.arange(itermax, device=device)
    for _ in range(itermax - 1):
        with span("cg.body"):
            active = (k < itermax) & (normr > eps) & ~done
            normr_new = torch.sqrt(rtrans)
            hist = torch.where(active & (steps == k), normr_new, hist)
            beta = torch.where(k == 1, 0, safe_div(rtrans, rtrans_prev))
            p_new, w, dpart = A.axpy_spmv_dots(r, p, beta)
            pAp = dpart.to(sdt)
            breakdown = pAp <= rtrans * 1e-30
            alpha = torch.where(breakdown | ~active, 0,
                                safe_div(rtrans, pAp)).to(vdt)
            x = x + alpha * p_new
            r = r - alpha * w
            new_rtrans = ddot(r, r, acc_dtype=sdt)

            p = torch.where(active, p_new, p)
            rtrans_prev = torch.where(active, rtrans, rtrans_prev)
            rtrans = torch.where(active, new_rtrans, rtrans)
            normr = torch.where(active, normr_new, normr)
            done = done | (active & breakdown)
            k = k + active.to(k.dtype)
    profiler.count("cg.bodies", itermax - 1)
    return x, k, hist


@_solve_span("vmem")
def cg_vmem_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
                 acc_dtype: Optional[torch.dtype] = None, inv_diag=None,
                 precond=None):
    """The whole solve in one launch (JAX ``cg_vmem_loop``, K5): the same
    recurrence, history and breakdown as ``cg_fused_loop``, iterates equal
    to reduction-order rounding. r0 = b - A x0 goes through the operator's
    apply (K2). bf16 vectors run in f32: the kernel computes in its
    vectors' dtype, and a bf16 recurrence would diverge from every other
    variant's f32 accumulation. Raises unless ``A.supports_vmem_cg``; the
    kernel's wrapper alone decides whether the grid is viable
    (ops/stencil_cg_vmem.vmem_cg_viable), at the vectors' real width, and
    raises before launching if not.
    Unpreconditioned."""
    _unpreconditioned("vmem", inv_diag, precond)
    if not getattr(A, "supports_vmem_cg", False):
        raise ValueError(
            "variant 'vmem' needs the stencil operator (the whole solve in "
            "one launch, ops/stencil_cg_vmem); use --fmt stencil or another "
            "cg variant"
        )
    vdt = b.dtype
    with profiler.span("cg.init"):
        if vdt == torch.bfloat16:
            b = b.to(torch.float32)
            x0 = x0.to(torch.float32)
        r0 = b - A.spmv(x0)
    kernel = A.impl == "kernel"
    fn = stencil_cg_vmem if kernel else stencil_cg_vmem_torch
    with profiler.span("stencil.cg_vmem", kernel="K5" if kernel else "torch",
                       n=r0.numel(), itermax=itermax):
        x, hist = fn(r0, x0, eps, A.nx, A.ny, A.nz, itermax, A.use_7pt)
    k = torch.sum(~torch.isnan(hist))
    return x.to(vdt), k, hist.to(default_acc_dtype(vdt, acc_dtype))


# the CG variants: the one place their names live. CG_LOOPS are the
# masked fixed-trip ones, which a CUDA graph can capture; sstep and pipe
# read a flag a step on the host.
CG_LOOPS = {"standard": cg_loop, "cs": cg_cs_loop, "fused": cg_fused_loop,
            "vmem": cg_vmem_loop}
CG_VARIANTS = ("standard", "cs", "sstep", "pipe", "fused", "vmem")


def resolve_cg_loop(variant: str, sstep: int = 4):
    """The loop function of a CG variant name (``sstep``: the basis size of
    the s-step variant). An unknown name raises ValueError, never a silent
    fall back to standard CG."""
    if variant == "sstep":
        from sparsebench_tpu_torch.solvers.cg_sstep import cg_sstep_loop

        return functools.partial(cg_sstep_loop, s=sstep)
    if variant == "pipe":
        from sparsebench_tpu_torch.solvers.cg_pipe import cg_pipe_loop

        return cg_pipe_loop
    if variant in CG_LOOPS:
        return CG_LOOPS[variant]
    raise ValueError(
        "variant must be 'standard', 'cs', 'sstep', 'pipe', 'fused' or "
        f"'vmem', got {variant!r}"
    )


def solve_cg(
    A,
    b,
    *,
    x0=None,
    itermax: int = 150,
    eps: float = 0.0,
    acc_dtype: Optional[torch.dtype] = None,
    inv_diag=None,
    precond=None,
    variant: str = "standard",
    sstep: int = 4,
    verbose: bool = True,
) -> CGResult:
    """Host-side solve of ``variant`` (``resolve_cg_loop``): a warm-up
    solve, then the timed solve (closed by ``torch.cuda.synchronize`` on
    CUDA), then the residual print.

    ``b`` (and ``x0``) are tensors or numpy arrays in the original row
    order, as is the returned x; they move to the matrix's device and keep
    their dtype, which is the vectors' dtype. A format with
    ``permuted_output`` solves in its permuted order (JAX ``solve_cg``).
    ``inv_diag`` (1/diag(A), original row order) gives Jacobi PCG,
    ``precond`` (``ChebPrecond``, bounds for A, or for D^-1 A with
    ``inv_diag``) polynomial PCG; ``sstep`` is the basis size of
    ``variant="sstep"``.
    """
    loop = resolve_cg_loop(variant, sstep)
    if precond is not None and variant not in ("standard", "cs", "pipe"):
        raise ValueError(
            "operator preconditioning (precond=) supports cg variants "
            f"'standard', 'cs' and 'pipe' only, not {variant!r}"
        )
    device = A.device
    b = torch.as_tensor(b, device=device)
    if x0 is None:
        x0 = torch.zeros_like(b)  # reference initVectors: x = 0
    else:
        x0 = torch.as_tensor(x0, dtype=b.dtype, device=device)
    if inv_diag is not None:
        inv_diag = torch.as_tensor(inv_diag, device=device).to(b.dtype)
    eps_t = torch.tensor(eps, dtype=acc_dtype or b.dtype, device=device)
    permuted = getattr(A, "permuted_output", False)
    if permuted:
        b, x0 = A.permute_vector(b), A.permute_vector(x0)
        if inv_diag is not None:
            inv_diag = A.permute_vector(inv_diag)
    kw = {"inv_diag": inv_diag, "precond": precond}

    # warm-up: first-use costs (kernel build and load, allocator growth)
    # stay outside the timed solve
    _x, k_dev, _hist = loop(A, b, x0, itermax, eps_t, acc_dtype, **kw)
    int(k_dev)

    t0 = time.perf_counter()
    x_dev, k_dev, hist_dev = loop(A, b, x0, itermax, eps_t, acc_dtype, **kw)
    synchronize(device)
    t1 = time.perf_counter()
    k = int(k_dev)
    if permuted:
        x_dev = A.unpermute_vector(x_dev)

    hist = hist_dev.cpu().numpy()
    if verbose:
        print_residual_history(hist, k, itermax)
        print(f"Solution performed {k} iterations and took {t1 - t0:.2f}s")

    if x_dev.dtype == torch.bfloat16:
        x_dev = x_dev.to(torch.float32)  # numpy has no bf16; exact widening
    final = hist[k - 1] if k > 1 else hist[0]
    return CGResult(
        x=x_dev.cpu().numpy(),
        iterations=k,
        residual_history=hist[:k],
        final_normr=float(final),
        solve_seconds=t1 - t0,
    )


def check_residual(x: np.ndarray, xexact: np.ndarray) -> float:
    """max|x - xexact| (reference solverCheckResidual, src/CGSolver.c:40-60)."""
    return float(np.max(np.abs(np.asarray(x) - np.asarray(xexact))))


def init_vectors(csr=None, dtype=np.float64, generated: bool = True,
                 row_lengths: Optional[np.ndarray] = None):
    """Reference initVectors (src/CGSolver.c:19-38): x=0; for generated
    problems b = 27 - (nnzrow - 1) with exact solution x == 1, else b = 1.
    Host numpy arrays; ``row_lengths`` stands in for the CSR of the
    analytic stencil build."""
    nnzrow = row_lengths if row_lengths is not None else csr.row_lengths
    nr = nnzrow.shape[0]
    x = np.zeros(nr, dtype=dtype)
    if generated:
        b = (27.0 - (nnzrow - 1)).astype(dtype)
        xexact = np.ones(nr, dtype=dtype)
    else:
        b = np.ones(nr, dtype=dtype)
        xexact = None
    return x, b, xexact
