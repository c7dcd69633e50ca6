"""MINRES (Paige & Saunders 1975; counterpart of
sparsebench_tpu/solvers/minres.py): the three-term Lanczos recurrence with
a QR-minimised residual, for symmetric indefinite systems where CG's p.Ap
steps break down. Per iteration: 1 matvec and 2 reductions; the Givens
update is scalar work.

Preconditioning is Jacobi only (``inv_diag``), which MINRES needs to be
SPD: ``solve_minres`` refuses a diagonal that is not positive. A Chebyshev
polynomial of an indefinite A is not SPD, so it is not offered.

The recorded residual is the recurrence norm phibar (the M^-1/2 norm of
r; the 2-norm unpreconditioned), after each update, hist[0] = ||r_0||.
Masked fixed trip like ``solvers/bicgstab.py``: ``itermax - 1`` bodies,
each masked by (k < itermax) & (normr > eps) & ~done.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparsebench_tpu_torch.solvers.bicgstab import _dot, _solve_masked
from sparsebench_tpu_torch.solvers.cg import (
    CGResult,
    default_acc_dtype,
    matvec,
    safe_div,
)


def minres_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
                acc_dtype: Optional[torch.dtype] = None, inv_diag=None):
    """MINRES; the contract of ``cg_loop`` (returns (x, k, history)). The
    Lanczos vectors ride unnormalised as (r1, r2) with their norms in
    scalar state (Paige-Saunders' six-vector form). beta == 0 means the
    Krylov space is exhausted: the solve freezes and ends."""
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    device = b.device
    spmv = matvec(A)

    def apply_a(v):
        return spmv(v).to(vdt)

    def apply_minv(v):
        return (inv_diag * v).to(vdt) if inv_diag is not None else v

    eps = torch.as_tensor(eps, device=device)
    r0 = (b - spmv(x0)).to(vdt)
    y = apply_minv(r0)
    beta = torch.sqrt(torch.clamp(_dot(r0, y, sdt), min=0))
    hist = torch.full((itermax,), float("nan"), dtype=sdt, device=device)
    hist[0] = beta
    szero = torch.zeros((), dtype=sdt, device=device)
    sone = torch.ones((), dtype=sdt, device=device)
    tiny = torch.full((), torch.finfo(sdt).tiny, dtype=sdt, device=device)
    x, r1, r2 = x0, r0, r0
    w = torch.zeros_like(b)
    w2 = torch.zeros_like(b)
    oldb, dbar, epsln, phibar = sone, szero, szero, beta
    cs, sn = -sone, szero
    normr = beta
    done = beta == 0
    k = torch.ones((), dtype=torch.int64, device=device)
    steps = torch.arange(itermax, device=device)
    for j in range(1, itermax):
        active = (k < itermax) & (normr > eps) & ~done
        # Lanczos step on M^-1 A; the first has no k-1 term (the host
        # knows the index: an inactive body changes nothing, so body j
        # runs at k == j while the solve is active)
        v = safe_div(sone, beta).to(vdt) * y
        ynew = apply_a(v)
        c_prev = safe_div(beta, oldb) if j > 1 else szero
        ynew = ynew - c_prev.to(vdt) * r1
        alfa = _dot(v, ynew, sdt)
        ynew = ynew - safe_div(alfa, beta).to(vdt) * r2
        yn = apply_minv(ynew)
        beta_n = torch.sqrt(torch.clamp(_dot(ynew, yn, sdt), min=0))
        # Givens QR of the tridiagonal, one rotation an iteration
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * beta_n
        dbar_n = -cs * beta_n
        gamma = torch.maximum(torch.sqrt(gbar * gbar + beta_n * beta_n), tiny)
        cs_n = gbar / gamma
        sn_n = beta_n / gamma
        phi = cs_n * phibar
        phibar_n = sn_n * phibar
        # the solution update along the newest conjugate direction
        wn = (v - epsln.to(vdt) * w2 - delta.to(vdt) * w) / gamma.to(vdt)
        normr_n = torch.abs(phibar_n)
        hist = torch.where(active & (steps == k), normr_n, hist)

        def keep(new, old):
            return torch.where(active, new, old)

        x = keep(x + phi.to(vdt) * wn, x)
        r1, r2 = keep(r2, r1), keep(ynew, r2)
        y = keep(yn, y)
        w, w2 = keep(wn, w), keep(w, w2)
        oldb, beta = keep(beta, oldb), keep(beta_n, beta)
        dbar, epsln, phibar = (keep(dbar_n, dbar), keep(epsln_n, epsln),
                               keep(phibar_n, phibar))
        cs, sn = keep(cs_n, cs), keep(sn_n, sn)
        normr = keep(normr_n, normr)
        done = done | (active & (beta_n == 0))
        k = k + active.to(k.dtype)
    return x, k, hist


def solve_minres(A, b, *, itermax: int = 150, eps: float = 0.0,
                 inv_diag=None, acc_dtype: Optional[torch.dtype] = None,
                 verbose: bool = True) -> CGResult:
    """Host-side solve of ``minres_loop``. ``inv_diag`` = Jacobi; MINRES needs
    M SPD, so every entry must be positive."""
    if inv_diag is not None:
        inv_np = torch.as_tensor(inv_diag).double().cpu().numpy()
        if not np.all(inv_np > 0):
            raise ValueError(
                "MINRES Jacobi preconditioning requires a positive "
                "diagonal (M must be SPD); this matrix has "
                f"min(diag^-1) = {inv_np.min():g}"
            )
    return _solve_masked(minres_loop, A, b, itermax, eps, acc_dtype,
                         inv_diag, verbose)
