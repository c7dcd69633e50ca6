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
breakdown) still runs the remaining bodies, masked.

The variants ``cs`` (single-reduction CG, ``cg_cs_loop``), ``fused``
(p-update, apply and p.Ap in one kernel, ``cg_fused_loop``) and ``vmem``
(the whole solve in one kernel, ``cg_vmem_loop``) are ported with the same
masked fixed-trip design; ``resolve_cg_loop`` maps a name to its loop.
``sstep``, ``pipe`` and preconditioning raise and name their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from sparsebench_tpu_torch.config import synchronize
from sparsebench_tpu_torch.ops.blas1 import ddot
from sparsebench_tpu_torch.ops.cg_fused import cs_update
from sparsebench_tpu_torch.ops.stencil_cg_vmem import (
    stencil_cg_vmem,
    stencil_cg_vmem_torch,
)

CG_VARIANTS_NOT_PORTED = {
    "sstep": "Queue 1 item 9",
    "pipe": "Queue 1 item 9",
}


def safe_div(num, den):
    """num/den with 0 where den == 0 (exact-convergence guard)."""
    return torch.where(den != 0, num / torch.where(den != 0, den, 1), 0)


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


def _eps_tensor(eps, sdt, device):
    return eps if torch.is_tensor(eps) else torch.tensor(eps, dtype=sdt,
                                                         device=device)


def cg_init(A, b: torch.Tensor, x0: torch.Tensor, itermax: int,
            acc_dtype: Optional[torch.dtype] = None):
    """Initial CG state (reference src/CGSolver.c:94-104): the tuple
    (k, x, p, r, rtrans, normr, hist, done) of device tensors."""
    sdt = default_acc_dtype(b.dtype, acc_dtype)
    p = x0
    r = b - A.spmv(p)
    rtrans = ddot(r, r, acc_dtype=sdt)
    normr = torch.sqrt(rtrans)
    hist = torch.full((itermax,), float("nan"), dtype=sdt, device=b.device)
    hist[0] = normr
    k = torch.ones((), dtype=torch.int64, device=b.device)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    return k, x0, p, r, rtrans, normr, hist, done


def cg_run(A, state, k_end: int, eps, acc_dtype: Optional[torch.dtype] = None):
    """Advance CG from ``state`` until k == k_end, convergence or breakdown
    (reference hot loop, src/CGSolver.c:107-129), as ``k_end - 1`` masked
    bodies (k >= 1 in any state, so that many always suffice)."""
    k, x, p, r, rtrans, normr, hist, done = state
    vdt = r.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    eps = _eps_tensor(eps, sdt, r.device)
    steps = torch.arange(hist.numel(), device=r.device)
    for _ in range(k_end - 1):
        active = (k < k_end) & (normr > eps) & ~done
        first = k == 1
        new_rtrans = ddot(r, r, acc_dtype=sdt)
        rt = torch.where(first, rtrans, new_rtrans)
        # first body: p = r (beta = 0; x0 is finite, so r + 0*p == r)
        beta = torch.where(first, 0, safe_div(new_rtrans, rtrans)).to(vdt)
        p_new = r + beta * p
        normr_new = torch.sqrt(rt)
        hist = torch.where(active & (steps == k), normr_new, hist)

        Ap = A.spmv(p_new)
        pAp = ddot(p_new, Ap, acc_dtype=sdt)
        breakdown = pAp <= rt * 1e-30
        alpha = torch.where(breakdown | ~active, 0, safe_div(rt, pAp)).to(vdt)
        x = x + alpha * p_new
        r = r - alpha * Ap

        p = torch.where(active, p_new, p)
        rtrans = torch.where(active, rt, rtrans)
        normr = torch.where(active, normr_new, normr)
        done = done | (active & breakdown)
        k = k + active.to(k.dtype)
    return k, x, p, r, rtrans, normr, hist, done


def cg_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
            acc_dtype: Optional[torch.dtype] = None):
    """CG from x0: returns (x, k, history[itermax]) as device tensors, with
    history[j] = normr at iteration j (NaN where not reached)."""
    state = cg_init(A, b, x0, itermax, acc_dtype)
    k, x, _p, _r, _rtrans, _normr, hist, _done = cg_run(
        A, state, itermax, eps, acc_dtype
    )
    return x, k, hist


def cg_cs_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
               acc_dtype: Optional[torch.dtype] = None):
    """Single-reduction CG (Chronopoulos & Gear 1989; JAX ``cg_cs_loop``,
    unpreconditioned). The same Krylov iterates as standard CG, with the
    two dots of an iteration taken together after one apply:

        gamma = r.r, delta = w.r   (w = A r)
        beta  = gamma/gamma_old;  alpha = gamma / (delta - beta*gamma/alpha_old)
        p = r + beta p;  s = w + beta s  (s carries A p)
        x += alpha p;  r -= alpha s;  w = A r

    With ``SB_FUSED_CS`` set in the environment, an operator with
    ``supports_fused_cs`` (the stencil) and f32 accumulation, the apply
    returns the dots itself (K2's dots form) and the four updates are one
    kernel (K4, ``ops/cg_fused.cs_update``): the JAX package's switch, read
    the same way and kept only for parity with it (the fused body ran
    faster on the H100; ROADMAP.md Queue 1 item 6 has its removal). Masked
    like ``cg_run``: ``itermax - 1`` bodies; once
    inactive, alpha is 0 (x and r keep their bits, so w and the dots
    recompute to theirs) and the other state is held with ``where``."""
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    device = b.device
    fused = (bool(os.environ.get("SB_FUSED_CS"))
             and getattr(A, "supports_fused_cs", False)
             and sdt == torch.float32)

    def spmv_dots(u):
        # (w = A u, [gamma = u.u, delta = w.u])
        if fused:
            return A.spmv_permuted_dots(u)
        w = A.spmv(u)
        return w, torch.stack([ddot(u, u, acc_dtype=sdt),
                               ddot(w, u, acc_dtype=sdt)])

    eps = _eps_tensor(eps, sdt, device)
    r = b - A.spmv(x0)
    w, gd = spmv_dots(r)
    gamma = gd[0]
    alpha = safe_div(gamma, gd[1])
    normr = torch.sqrt(gamma)
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
        active = (k < itermax) & (normr > eps) & ~done
        normr_new = torch.sqrt(gamma)
        hist = torch.where(active & (steps == k), normr_new, hist)
        a = torch.where(active, alpha, 0)
        if fused:
            p_new, s_new, x, r = cs_update(r, p, w, s, x, r, a, beta)
        else:
            b_v = beta.to(vdt)
            p_new = r + b_v * p
            s_new = w + b_v * s
            a_v = a.to(vdt)
            x = x + a_v * p_new
            r = r - a_v * s_new
        w, gd = spmv_dots(r)
        g_new, d_new = gd[0], gd[1]
        beta_new = safe_div(g_new, gamma)
        denom = d_new - beta_new * safe_div(g_new, alpha)
        # denom is p.Ap in disguise: the same positivity guard as cg_run
        breakdown = denom <= g_new * 1e-30
        alpha_new = torch.where(breakdown, 0, safe_div(g_new, denom))

        p = torch.where(active, p_new, p)
        s = torch.where(active, s_new, s)
        gamma = torch.where(active, g_new, gamma)
        alpha = torch.where(active, alpha_new, alpha)
        beta = torch.where(active, beta_new, beta)
        normr = torch.where(active, normr_new, normr)
        done = done | (active & breakdown)
        k = k + active.to(k.dtype)
    return x, k, hist


def cg_fused_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
                  acc_dtype: Optional[torch.dtype] = None):
    """Standard-CG iterates with the front half of each iteration in one
    kernel (JAX ``cg_fused_loop``): ``A.axpy_spmv_dots(r, p, beta)`` gives
    p = r + beta p, w = A p and delta = p.w in one pass (K3). The back half
    (x += alpha p, r -= alpha w, r.r) is plain torch. Masked like
    ``cg_run``."""
    if not getattr(A, "supports_fused_pw", False):
        raise ValueError(
            "variant 'fused' needs a format with axpy_spmv_dots (the "
            "stencil operator); use --fmt stencil or another cg variant"
        )
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    device = b.device
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
    return x, k, hist


def cg_vmem_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
                 acc_dtype: Optional[torch.dtype] = None):
    """The whole solve in one launch (JAX ``cg_vmem_loop``, K5): the same
    recurrence, history and breakdown as ``cg_fused_loop``, iterates equal
    to reduction-order rounding. r0 = b - A x0 goes through the operator's
    apply (K2). bf16 vectors run in f32: the kernel computes in its
    vectors' dtype, and a bf16 recurrence would diverge from every other
    variant's f32 accumulation. Raises unless ``A.supports_vmem_cg``; the
    kernel's wrapper alone decides whether r and p fit its L2 plan, at the
    vectors' real width, and raises before launching if not."""
    if not getattr(A, "supports_vmem_cg", False):
        raise ValueError(
            "variant 'vmem' needs the stencil operator (the whole solve in "
            "one launch, ops/stencil_cg_vmem); use --fmt stencil or another "
            "cg variant"
        )
    vdt = b.dtype
    if vdt == torch.bfloat16:
        b = b.to(torch.float32)
        x0 = x0.to(torch.float32)
    r0 = b - A.spmv(x0)
    fn = stencil_cg_vmem if A.impl == "kernel" else stencil_cg_vmem_torch
    x, hist = fn(r0, x0, eps, A.nx, A.ny, A.nz, itermax, A.use_7pt)
    k = torch.sum(~torch.isnan(hist))
    return x.to(vdt), k, hist.to(default_acc_dtype(vdt, acc_dtype))


# the ported CG variants: the one place their names live
CG_LOOPS = {"standard": cg_loop, "cs": cg_cs_loop, "fused": cg_fused_loop,
            "vmem": cg_vmem_loop}


def resolve_cg_loop(variant: str):
    """The loop function of a CG variant name. An unported variant raises
    NotImplementedError and names its ROADMAP item; an unknown one raises
    ValueError (never a silent fall back to standard CG)."""
    if variant in CG_LOOPS:
        return CG_LOOPS[variant]
    if variant in CG_VARIANTS_NOT_PORTED:
        raise NotImplementedError(
            f"cg variant {variant!r} is not ported yet "
            f"(ROADMAP.md {CG_VARIANTS_NOT_PORTED[variant]})"
        )
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
    verbose: bool = True,
) -> CGResult:
    """Host-side solve of ``variant`` (``resolve_cg_loop``): a warm-up
    solve, then the timed solve (closed by ``torch.cuda.synchronize`` on
    CUDA), then the residual print.

    ``b`` (and ``x0``) are tensors or numpy arrays; they move to the
    matrix's device and keep their dtype, which is the vectors' dtype.
    """
    loop = resolve_cg_loop(variant)
    if inv_diag is not None or precond is not None:
        raise NotImplementedError(
            "preconditioned CG is not ported yet (ROADMAP.md Queue 1 item 9)"
        )
    device = A.device
    b = torch.as_tensor(b, device=device)
    if x0 is None:
        x0 = torch.zeros_like(b)  # reference initVectors: x = 0
    else:
        x0 = torch.as_tensor(x0, dtype=b.dtype, device=device)
    eps_t = torch.tensor(eps, dtype=acc_dtype or b.dtype, device=device)

    # warm-up: first-use costs (kernel build and load, allocator growth)
    # stay outside the timed solve
    _x, k_dev, _hist = loop(A, b, x0, itermax, eps_t, acc_dtype)
    int(k_dev)

    t0 = time.perf_counter()
    x_dev, k_dev, hist_dev = loop(A, b, x0, itermax, eps_t, acc_dtype)
    synchronize(device)
    t1 = time.perf_counter()
    k = int(k_dev)

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
