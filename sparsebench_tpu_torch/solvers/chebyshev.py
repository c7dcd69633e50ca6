"""Chebyshev semi-iteration solver, the reference's CHEBFD bench type
(counterpart of sparsebench_tpu/solvers/chebyshev.py; the reference lists
CHEBFD in its bench enum but implements nothing, src/main.c:22).

Chebyshev iteration takes no inner products beyond the residual norm it
reports. It needs spectral bounds [lmin, lmax]; without them a short
Lanczos process estimates them (``estimate_bounds``: device matvecs, a tiny
tridiagonal eigensolve on the host) with safety margins.

Both loops keep the masked fixed-trip design of ``solvers/cg.py``: the
Lanczos recurrence runs its ``steps`` bodies with a device-side ``active``
flag (breakdown masks the rest) and the host reads the valid count once;
``cheby_loop`` runs ``itermax - 1`` bodies, each masked by
(k < itermax) & (normr > eps), so ``k`` and the NaN-padded history come out
as the JAX ``while_loop``'s without a host read per iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import numpy as np
import torch

from sparsebench_tpu_torch.config import synchronize
from sparsebench_tpu_torch.solvers.cg import matvec as solve_space_matvec

_NP_DT = {torch.float32: np.float32, torch.float64: np.float64}
LANCZOS_STEPS = 25


@dataclasses.dataclass
class ChebyshevResult:
    x: np.ndarray
    iterations: int
    residual_history: np.ndarray
    final_normr: float
    solve_seconds: float
    bounds: Tuple[float, float]


def lanczos_tridiag(A, v0: torch.Tensor, steps: int, inv_diag=None):
    """The ``steps``-step Lanczos recurrence from v0: returns (alphas,
    betas, count) with entries past a breakdown (beta < 1e-12) masked out
    and ``count`` the number of valid ones (a device tensor).

    With ``inv_diag`` the recurrence runs on M^-1 A (M = diag(A)), which is
    self-adjoint in the M-inner product: the dots are M-weighted and the
    tridiagonal's eigenvalues estimate spec(M^-1 A)."""
    dtype = v0.dtype
    device = v0.device
    spmv = solve_space_matvec(A)
    if inv_diag is not None:
        inv_diag = inv_diag.to(dtype)
        wvec = torch.where(
            inv_diag != 0,
            1.0 / torch.where(inv_diag != 0, inv_diag, torch.ones_like(inv_diag)),
            torch.zeros_like(inv_diag))
    else:
        wvec = None

    def matvec(v):
        Av = spmv(v).to(dtype)
        return (inv_diag * Av).to(dtype) if inv_diag is not None else Av

    def wdot(u, v):
        return torch.sum(u * (v if wvec is None else wvec * v))

    v = v0 / torch.sqrt(wdot(v0, v0))
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=dtype, device=device)
    alphas = torch.zeros(steps, dtype=dtype, device=device)
    betas = torch.zeros(steps, dtype=dtype, device=device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    active = torch.ones((), dtype=torch.bool, device=device)
    for i in range(steps):
        w = matvec(v)
        alpha = wdot(v, w)
        w = w - alpha * v - beta * v_prev
        beta_new = torch.sqrt(wdot(w, w))
        alphas[i] = torch.where(active, alpha, alphas[i])
        betas[i] = torch.where(active, beta_new, betas[i])
        count = count + active.to(torch.int32)
        go_on = active & (beta_new >= 1e-12)
        safe = torch.where(beta_new > 0, beta_new, torch.ones_like(beta_new))
        v_prev = torch.where(go_on, v, v_prev)
        v = torch.where(go_on, w / safe, v)
        beta = torch.where(go_on, beta_new, beta)
        active = go_on
    return alphas, betas, count


def bounds_from_tridiag(alphas, betas, count: int,
                        mode: str = "solver") -> Tuple[float, float]:
    """Host tridiagonal eigensolve with multiplicative margins (the JAX
    package's, solvers/chebyshev.py:106-142): below lmin the scaled
    polynomial still contracts, above lmax it does not, so only lmax gets a
    cushion against Lanczos' underestimate of the top Ritz value. Precond
    mode: [0.9 lmin, 1.1 lmax]; solver mode: [0.5 lmin, 1.05 lmax]; lmin
    floored at 1e-10 lmax."""
    alphas = np.asarray(alphas, dtype=np.float64)[:count]
    betas = np.asarray(betas, dtype=np.float64)[:count]
    T = np.diag(alphas)
    off = betas[: len(alphas) - 1]
    T += np.diag(off, 1) + np.diag(off, -1)
    ev = np.linalg.eigvalsh(T)
    lmin, lmax = float(ev[0]), float(ev[-1])
    if mode == "precond":
        return max(lmin * 0.9, 1e-10 * lmax), lmax * 1.1
    return max(lmin * 0.5, 1e-10 * lmax), lmax * 1.05


def estimate_bounds(A, nr: int, dtype, permute=None, inv_diag=None,
                    mode: str = "solver") -> Tuple[float, float]:
    """Lanczos extreme-eigenvalue estimate, LANCZOS_STEPS steps, with
    safety margins. The seed vector is
    ``np.random.default_rng(0).standard_normal(nr)`` in
    ``dtype`` (f32 or f64, a torch or numpy dtype), the JAX package's, so
    both packages probe from the same vector. ``permute`` lifts the seed
    (and ``inv_diag``, original row order) into a permuted operator's
    space."""
    np_dt = _NP_DT.get(dtype, dtype)
    rng = np.random.default_rng(0)
    v0 = torch.from_numpy(rng.standard_normal(nr).astype(np_dt)).to(A.device)
    if inv_diag is not None:
        inv_diag = torch.as_tensor(inv_diag, device=A.device)
    if permute is not None:
        v0 = permute(v0)
        if inv_diag is not None:
            inv_diag = permute(inv_diag)
    alphas, betas, count = lanczos_tridiag(A, v0, min(LANCZOS_STEPS, nr),
                                           inv_diag=inv_diag)
    return bounds_from_tridiag(alphas.cpu().numpy(), betas.cpu().numpy(),
                               int(count), mode=mode)


def cheby_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
               lmin: float, lmax: float, inv_diag=None):
    """Chebyshev iteration (three-term recurrence), masked fixed trip; with
    ``inv_diag`` on the Jacobi-preconditioned operator (bounds then for
    spec(M^-1 A)). The recorded residual is the true-recurrence ||r||, in
    the vectors' dtype. Returns (x, k, history[itermax])."""
    vdt = b.dtype
    device = b.device
    spmv = solve_space_matvec(A)
    if inv_diag is not None:
        inv_diag = inv_diag.to(vdt)

    def apply_m(r):
        return (inv_diag * r).to(vdt) if inv_diag is not None else r

    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta
    eps = torch.as_tensor(eps, dtype=vdt, device=device)

    r0 = b - spmv(x0)
    normr = torch.sqrt(torch.sum(r0 * r0))
    hist = torch.full((itermax,), float("nan"), dtype=vdt, device=device)
    hist[0] = normr
    p = apply_m(r0) / theta
    x = x0 + p
    r = r0 - spmv(p)
    rho = torch.full((), 1.0 / sigma1, dtype=vdt, device=device)
    k = torch.ones((), dtype=torch.int64, device=device)
    steps = torch.arange(itermax, device=device)
    for _ in range(itermax - 1):
        active = (k < itermax) & (normr > eps)
        normr_new = torch.sqrt(torch.sum(r * r))
        hist = torch.where(active & (steps == k), normr_new, hist)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        p_new = rho_new * rho * p + (2.0 * rho_new / delta) * apply_m(r)
        x = torch.where(active, x + p_new, x)
        r = torch.where(active, r - spmv(p_new), r)
        p = torch.where(active, p_new, p)
        rho = torch.where(active, rho_new, rho)
        normr = torch.where(active, normr_new, normr)
        k = k + active.to(k.dtype)
    return x, k, hist


def solve_chebyshev(A, b, *, itermax: int = 150, eps: float = 0.0,
                    inv_diag=None, verbose: bool = True) -> ChebyshevResult:
    """Host-side solve from x = 0: the estimated bounds, a warm-up solve, the
    timed solve, the result line. ``b`` in original row order; bf16
    vectors run in f32 (the matrix keeps its storage). ``inv_diag``
    (1/diag(A), original row order) enables Jacobi preconditioning."""
    device = A.device
    b = torch.as_tensor(b, device=device)
    if b.dtype == torch.bfloat16:
        b = b.to(torch.float32)
    x0 = torch.zeros_like(b)
    inv_diag_orig = (torch.as_tensor(inv_diag, device=device).to(b.dtype)
                     if inv_diag is not None else None)
    permuted = getattr(A, "permuted_output", False)
    if permuted:
        b_in, x0_in = A.permute_vector(b), A.permute_vector(x0)
        inv_diag = (A.permute_vector(inv_diag_orig)
                    if inv_diag_orig is not None else None)
    else:
        b_in, x0_in, inv_diag = b, x0, inv_diag_orig

    lmin, lmax = estimate_bounds(
        A, b.shape[0], b.dtype,
        permute=A.permute_vector if permuted else None,
        inv_diag=inv_diag_orig,
    )
    if verbose:
        print(f"Chebyshev bounds: lmin = {lmin:.4e} lmax = {lmax:.4e}")

    def run():
        return cheby_loop(A, b_in, x0_in, itermax, eps, float(lmin),
                          float(lmax), inv_diag=inv_diag)

    _x, k_dev, _h = run()
    int(k_dev)  # warm-up
    t0 = time.perf_counter()
    x_dev, k_dev, h_dev = run()
    synchronize(device)
    t1 = time.perf_counter()
    k = int(k_dev)
    if permuted:
        x_dev = A.unpermute_vector(x_dev)
    hist = h_dev.cpu().numpy()[:k]
    if verbose:
        print(f"Chebyshev performed {k} iterations and took {t1 - t0:.2f}s "
              f"(final residual {hist[-1]:E})")
    return ChebyshevResult(
        x=x_dev.cpu().numpy(),
        iterations=k,
        residual_history=hist,
        final_normr=float(hist[-1]),
        solve_seconds=t1 - t0,
        bounds=(lmin, lmax),
    )
