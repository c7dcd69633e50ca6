"""BiCGStab (van der Vorst 1992; counterpart of
sparsebench_tpu/solvers/bicgstab.py): the short-recurrence method for
non-symmetric systems, 2 matvecs and 3 reductions (two fused) an
iteration, right preconditioning via ``inv_diag`` (Jacobi) or ``precond``
(ChebPrecond) so that the residual stays the true one:

    [rho' = <rhat, r>, ||r||^2]
    beta = (rho'/rho)(alpha/omega);  p = r + beta (p - omega v)
    v = A M^-1 p;  alpha = rho' / <rhat, v>;  s = r - alpha v
    t = A M^-1 s;  omega = <t, s> / <t, t>
    x += alpha M^-1 p + omega M^-1 s;  r = s - omega t

The residual norm comes from the r vector at the start of an iteration
(``cg_run``'s history semantics). Breakdowns (rho' ~ 0, <rhat, v> ~ 0) zero
the step lengths and end the solve.

Masked fixed trip like ``solvers/cg.py``: ``itermax - 1`` bodies, each
masked by (k < itermax) & (normr > eps) & ~done; an inactive body keeps
every state entry with ``torch.where``, so ``k``, x and the NaN-padded
history come out as the JAX ``while_loop``'s with no host read per
iteration.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from sparsebench_tpu_torch.config import synchronize
from sparsebench_tpu_torch.solvers.cg import (
    CGResult,
    default_acc_dtype,
    matvec,
    print_residual_history,
    safe_div,
)
from sparsebench_tpu_torch.solvers.precond import resolve_apply_m


def _dot(u, v, sdt):
    return torch.sum(u.to(sdt) * v.to(sdt))


def bicgstab_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
                  acc_dtype: Optional[torch.dtype] = None, inv_diag=None,
                  precond=None):
    """BiCGStab; the contract of ``cg_loop`` (returns (x, k, history))."""
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    device = b.device
    spmv = matvec(A)

    def apply_a(v):
        return spmv(v).to(vdt)

    apply_m = resolve_apply_m(precond, inv_diag, apply_a, vdt)

    def apply_minv(v):
        return apply_m(v) if apply_m is not None else v

    eps = torch.as_tensor(eps, device=device)
    r = (b - spmv(x0)).to(vdt)
    rhat = r  # the fixed shadow residual
    normr = torch.sqrt(torch.clamp(_dot(r, r, sdt), min=0))
    hist = torch.full((itermax,), float("nan"), dtype=sdt, device=device)
    hist[0] = normr
    x = x0
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=sdt, device=device)
    rho, alpha, omega = one, one, one
    tiny = torch.full((), 1e-30, dtype=sdt, device=device)
    k = torch.ones((), dtype=torch.int64, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    steps = torch.arange(itermax, device=device)
    for _ in range(itermax - 1):
        active = (k < itermax) & (normr > eps) & ~done
        rho_new = _dot(rhat, r, sdt)
        normr_new = torch.sqrt(torch.clamp(_dot(r, r, sdt), min=0))
        hist = torch.where(active & (steps == k), normr_new, hist)
        brk_rho = torch.abs(rho_new) <= tiny * torch.abs(rho)
        beta = safe_div(rho_new * alpha, rho * omega)
        p_new = r + beta.to(vdt) * (p - omega.to(vdt) * v)
        v_new = apply_a(apply_minv(p_new))
        rv = _dot(rhat, v_new, sdt)
        bad = brk_rho | (torch.abs(rv) <= tiny * torch.abs(rho_new))
        alpha_new = torch.where(bad, 0, safe_div(rho_new, rv))
        a_v = alpha_new.to(vdt)
        s = r - a_v * v_new
        t = apply_a(apply_minv(s))
        omega_new = torch.where(bad, 0, safe_div(_dot(t, s, sdt),
                                                 _dot(t, t, sdt)))
        o_v = omega_new.to(vdt)
        x = torch.where(active, x + a_v * apply_minv(p_new)
                        + o_v * apply_minv(s), x)
        r = torch.where(active, s - o_v * t, r)
        p = torch.where(active, p_new, p)
        v = torch.where(active, v_new, v)
        rho = torch.where(active, rho_new, rho)
        alpha = torch.where(active, alpha_new, alpha)
        omega = torch.where(active, omega_new, omega)
        normr = torch.where(active, normr_new, normr)
        done = done | (active & bad)
        k = k + active.to(k.dtype)
    return x, k, hist


def _solve_masked(loop, A, b, itermax, eps, acc_dtype, inv_diag, verbose,
                  **kw) -> CGResult:
    """The host-side solve shared by BiCGStab and MINRES (JAX ``solve_bicgstab``
    and ``solve_minres``), from x = 0: bf16 vectors run in f32,
    permutation in and out, a warm-up solve, the timed solve, the residual
    print."""
    device = A.device
    b = torch.as_tensor(b, device=device)
    if b.dtype == torch.bfloat16:
        b = b.to(torch.float32)
    x0 = torch.zeros_like(b)
    if inv_diag is not None:
        inv_diag = torch.as_tensor(inv_diag, device=device).to(b.dtype)
    eps_t = torch.tensor(eps, dtype=acc_dtype or b.dtype, device=device)
    permuted = getattr(A, "permuted_output", False)
    if permuted:
        b, x0 = A.permute_vector(b), A.permute_vector(x0)
        if inv_diag is not None:
            inv_diag = A.permute_vector(inv_diag)

    def run():
        return loop(A, b, x0, itermax, eps_t, acc_dtype, inv_diag=inv_diag,
                    **kw)

    int(run()[1])  # warm-up
    t0 = time.perf_counter()
    x_dev, k_dev, hist_dev = run()
    synchronize(device)
    t1 = time.perf_counter()
    k = int(k_dev)
    if permuted:
        x_dev = A.unpermute_vector(x_dev)
    hist = hist_dev.cpu().numpy()
    if verbose:
        print_residual_history(hist, k, itermax)
        print(f"Solution performed {k} iterations and took {t1 - t0:.2f}s")
    final = hist[k - 1] if k > 1 else hist[0]
    return CGResult(
        x=x_dev.cpu().numpy(),
        iterations=k,
        residual_history=hist[:k],
        final_normr=float(final),
        solve_seconds=t1 - t0,
    )


def solve_bicgstab(A, b, *, itermax: int = 150, eps: float = 0.0,
                   inv_diag=None, precond=None,
                   acc_dtype: Optional[torch.dtype] = None,
                   verbose: bool = True) -> CGResult:
    """Host-side solve of ``bicgstab_loop`` (``b`` and ``inv_diag`` in
    original row order)."""
    return _solve_masked(bicgstab_loop, A, b, itermax, eps, acc_dtype,
                         inv_diag, verbose, precond=precond)
