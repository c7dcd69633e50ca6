"""s-step (communication-avoiding) CG on a Chebyshev basis (Chronopoulos &
Gear 1989; Hoemmen 2010; Carson & Demmel 2014): counterpart of
sparsebench_tpu/solvers/cg_sstep.py. One fused reduction (a (2s+1)^2 gram)
and one scalar reduction serve s CG iterations.

Per outer step (= s iterations), M = I or Jacobi, A_hat = M^-1 A:

    V = [T_0(S)u, ..., T_s(S)u],  S = (2/theta) A_hat - I   s matvecs
    G = [V, W_prev]^T M [V, W_prev]                          one gram
    C = W_prev^T M R;  B = -D_prev^-1 C;  R = V[0:s]
    P = R + P_prev B;  W = V Tmat + W_prev B   (A_hat R = V Tmat, exact)
    D = G[0:s, 0:s+1] Tmat + C^T B + B^T C + B^T D_prev B
    a = D^-1 g,  g = G[0:s, 0];  x += P a;  u -= W a
    rr = ||r_new||^2

theta is a padded power-method estimate of lambda_max(A_hat), so that
every basis column stays bounded by about ||u|| whatever s and the
conditioning (a monomial basis diverges in f32 at 100^3). The gram and
the basis products are ``torch.matmul`` in full precision (the JAX package
asks XLA for HIGHEST; PyTorch's default f32 matmul on CUDA does not use
TF32 unless asked to, and nothing in the port asks); the s x s solves are
``torch.linalg.solve_ex``, which returns inf/nan for a singular D as
``jnp.linalg.solve`` does instead of raising.

Drift repair: when the recurrence ||r||^2 rises ``DRIFT_FACTOR`` times
above its best, the next outer step replaces u with the true M^-1 (b - A x)
and restarts the conjugacy block (one extra matvec on that step, never two
steps in a row); the best iterate is kept and returned where the last one
is worse. Whether to replace is decided on the device, and, as in
``solvers/cg_pipe.py``, the loop reads one flag pair a step on the host
([the exit test, need_rep]) instead of computing the replacement every
step: here that is one read per s iterations, and the loop stops where the
JAX ``while_loop`` does. The history holds the residual entering each
outer step (k = 1, 1+s, ...) and the final one at slot k-1; other slots
stay NaN.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparsebench_tpu_torch.solvers.cg import default_acc_dtype, matvec
from sparsebench_tpu_torch.solvers.cg_pipe import DRIFT_FACTOR, _flags

POWER_ITERS = 6  # power-method steps of the basis scale theta


def _cheb_basis_change(s: int) -> np.ndarray:
    """C[(s+1), s] with A_hat v_j = theta * sum_i C[i, j] v_i for the
    Chebyshev basis v_j = T_j(S) u (the JAX package's)."""
    C = np.zeros((s + 1, s))
    C[0, 0] += 0.5
    C[1, 0] += 0.5
    for j in range(1, s):
        C[j, j] += 0.5
        C[j + 1, j] += 0.25
        C[j - 1, j] += 0.25
    return C


def _gram(U, wvec, sdt):
    """G[i,j] = sum_n U[i,n] w[n] U[j,n] in sdt."""
    Us = U.to(sdt)
    Uw = Us if wvec is None else Us * wvec.to(sdt)[None, :]
    return Uw @ Us.T


def cg_sstep_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
                  acc_dtype: Optional[torch.dtype] = None, inv_diag=None,
                  precond=None, s: int = 4):
    """s-step CG; the contract of ``cg_loop`` (returns (x, k, history)).
    ``inv_diag`` switches to the M-inner-product (Jacobi) formulation; an
    operator preconditioner is refused (``solve_cg`` says so first)."""
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    if precond is not None:
        raise ValueError("the sstep variant takes Jacobi (inv_diag) only")
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    device = b.device
    spmv = matvec(A)
    jacobi = inv_diag is not None
    wvec = None
    if jacobi:
        inv_diag = inv_diag.to(vdt)
        wvec = torch.where(
            inv_diag != 0,
            1.0 / torch.where(inv_diag != 0, inv_diag, torch.ones_like(inv_diag)),
            torch.zeros_like(inv_diag))

    def mv(v):
        Av = spmv(v)
        return (inv_diag * Av).to(vdt) if jacobi else Av

    def wdot(u, v):
        vv = v.to(sdt)
        if wvec is not None:
            vv = vv * wvec.to(sdt)
        return torch.sum(u.to(sdt) * vv)

    def true_rr(u):
        us = u.to(sdt)
        if wvec is not None:
            us = us * wvec.to(sdt)
        return torch.sum(us * us)

    def residual_u(x):
        r = b - spmv(x)
        return ((inv_diag * r) if jacobi else r).to(vdt)

    eps = torch.as_tensor(eps, device=device)
    u = residual_u(x0)
    rr = true_rr(u)
    normr = torch.sqrt(rr)

    # basis scale theta ~ ||A_hat||_M by a few power iterations
    q = u / torch.where(normr > 0, normr, 1).to(vdt)
    theta = torch.ones((), dtype=sdt, device=device)
    for _ in range(POWER_ITERS):
        zq = mv(q)
        theta = torch.sqrt(wdot(zq, zq))
        q = (zq / torch.where(theta > 0, theta, 1).to(vdt)).to(vdt)
    theta = torch.where((theta > 0) & torch.isfinite(theta), theta, 1)
    theta = 1.05 * theta
    two_over_theta = (2.0 / theta).to(vdt)
    Tmat = theta * torch.as_tensor(_cheb_basis_change(s), dtype=sdt,
                                   device=device)  # (s+1, s)
    Tmat_v = Tmat.to(vdt)

    hist = torch.full((itermax,), float("nan"), dtype=sdt, device=device)
    hist[0] = normr
    eye = torch.eye(s, dtype=sdt, device=device)
    nr = b.shape[0]
    x, x_best = x0, x0
    Pprev = torch.zeros((s, nr), dtype=vdt, device=device)
    Wprev = torch.zeros_like(Pprev)
    Dprev = eye
    rr_best = rr
    need_rep = torch.zeros((), dtype=torch.bool, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)

    def s_apply(v):
        return (mv(v) * two_over_theta).to(vdt) - v

    k = 1
    while k < itermax:
        go, rep = _flags((normr > eps) & ~done, need_rep)
        if not go:
            break
        hist[k] = torch.sqrt(rr)
        if rep:
            u = residual_u(x)
            Pprev = torch.zeros_like(Pprev)
            Wprev = torch.zeros_like(Wprev)
            Dprev = eye

        vs = [u, s_apply(u)]
        for _ in range(2, s + 1):
            vs.append(2.0 * s_apply(vs[-1]) - vs[-2])
        V = torch.stack(vs)                           # (s+1, nr)
        G = _gram(torch.cat([V, Wprev]), wvec, sdt)   # (2s+1, 2s+1)

        C = G[s + 1:, 0:s]                            # W_prev^T M R
        B = -torch.linalg.solve_ex(Dprev, C)[0]
        Bv = B.to(vdt)
        P = V[0:s] + Bv.T @ Pprev
        W = Tmat_v.T @ V + Bv.T @ Wprev               # A_hat R + W_prev B
        Gh = G[0:s, 0:s + 1] @ Tmat                   # R^T M A_hat R
        D = Gh + C.T @ B + B.T @ C + B.T @ Dprev @ B
        D = 0.5 * (D + D.T)
        a = torch.linalg.solve_ex(D, G[0:s, 0])[0]
        # breakdown (cg_run's alpha freeze, one level up): a collapsed D
        # gives inf/nan; freeze the converged state and exit
        bad = ~torch.all(torch.isfinite(a))
        a = torch.where(bad, 0, a)
        av = a.to(vdt)

        x = x + av @ P
        u = u - av @ W
        rr_new = true_rr(u)
        bad = bad | ~torch.isfinite(rr_new)
        normr = torch.sqrt(torch.clamp(rr_new, min=0))
        # replace next step on drift, never twice in a row
        need_rep = (rr_new > DRIFT_FACTOR * rr_best) & (not rep)
        x_best = torch.where(rr_new < rr_best, x, x_best)
        rr_best = torch.minimum(rr_best, rr_new)
        Pprev, Wprev, Dprev, rr = P, W, D, rr_new
        done = done | bad
        k += s
    k = min(k, itermax)
    # hand back the best iterate when the last one is worse, with its norm
    pick_best = rr > rr_best
    x = torch.where(pick_best, x_best, x)
    normr = torch.where(pick_best, torch.sqrt(rr_best), normr)
    hist[k - 1] = normr
    return x, k, hist
