"""Restarted GMRES(m) (counterpart of sparsebench_tpu/solvers/gmres.py; the
reference reserves the bench type and implements nothing, src/main.c:22,
217-222). It covers the non-symmetric systems CG cannot.

One restart cycle:

* m Arnoldi steps on the device, issued by the host with no read back:
  the Krylov basis is a dense (m+1, n) tensor; step j projects the new
  vector against rows 0..j of it in one product (``orth="cgs"``), or twice
  (``"cgs2"``, reorthogonalized classical Gram-Schmidt), and stores the raw
  Hessenberg column. The projections are ``torch.matmul`` in the vectors'
  dtype at full precision (no TF32: the port never asks for it).
* One read of the (m+1, m) Hessenberg on the host, where the Givens
  rotations, the per-step residual estimates |g[j+1]|, the inner count k
  (the first step whose estimate meets ``eps``, else m), the breakdown flag
  (a zero on the rotated diagonal within the first k columns) and the
  triangular solve (``torch.linalg.solve_triangular`` on the leading k x k
  block, the rest masked to identity) run in the vectors' dtype, in the JAX
  package's order of operations. The JAX package computes the rotations
  inside its jitted step instead; the arithmetic is the same, and here the
  O(m^2) scalar recurrence costs no device launches.
* x_new = x0 + M^-1 (y V[:m]) on the device.

Restarts are a host loop with one read a cycle, as in the JAX package.
``inv_diag`` (Jacobi) or ``precond`` (ChebPrecond) give right
preconditioning: the Arnoldi process runs on A M^-1 and the residual stays
the true one.
"""

from __future__ import annotations

import dataclasses
import time
import numpy as np
import torch

from sparsebench_tpu_torch.config import synchronize
from sparsebench_tpu_torch.solvers.cg import matvec
from sparsebench_tpu_torch.solvers.precond import resolve_apply_m


@dataclasses.dataclass
class GMRESResult:
    x: np.ndarray
    iterations: int          # total inner iterations performed
    residual_history: np.ndarray  # one entry per restart cycle
    final_normr: float
    solve_seconds: float
    breakdown: bool = False  # H went singular before convergence


def _least_squares(Hraw: np.ndarray, beta, m: int, eps: float):
    """Givens QR of the raw (m+1, m) Hessenberg ``Hraw`` with rhs
    beta e_1, in Hraw's dtype, in the JAX package's order: returns (y,
    normr, k, breakdown) with y of length m (zero beyond k)."""
    dt = Hraw.dtype.type
    zero, one = dt(0), dt(1)
    H = np.zeros((m + 1, m), dtype=Hraw.dtype)
    cs = np.zeros(m, dtype=Hraw.dtype)
    sn = np.zeros(m, dtype=Hraw.dtype)
    g = np.zeros(m + 1, dtype=Hraw.dtype)
    g[0] = beta
    res = np.full(m, np.inf, dtype=Hraw.dtype)
    for j in range(m):
        h = Hraw[:, j].copy()
        for i in range(j):
            hi, hi1 = h[i], h[i + 1]
            h[i] = cs[i] * hi + sn[i] * hi1
            h[i + 1] = -sn[i] * hi + cs[i] * hi1
        denom = np.sqrt(h[j] ** 2 + h[j + 1] ** 2)
        c = h[j] / denom if denom > 0 else one
        s = h[j + 1] / denom if denom > 0 else zero
        h[j] = c * h[j] + s * h[j + 1]
        h[j + 1] = zero
        cs[j], sn[j] = c, s
        g[j + 1] = -s * g[j]
        g[j] = c * g[j]
        H[:, j] = h
        res[j] = abs(g[j + 1])
    conv = res <= eps
    k = int(np.argmax(conv)) + 1 if conv.any() else m
    if beta <= eps:
        k = 0
    active = np.arange(m) < k
    breakdown = bool(np.any(active & (np.diag(H[:m, :m]) == 0)))
    both = active[:, None] & active[None, :]
    Hm = np.where(both, H[:m, :m], np.eye(m, dtype=Hraw.dtype))
    y = torch.linalg.solve_triangular(
        torch.from_numpy(Hm), torch.from_numpy(g[:m] * active)[:, None],
        upper=True)[:, 0]
    normr = res[max(k - 1, 0)] if k > 0 else beta
    return y, normr, k, breakdown


def gmres_cycle(A, b: torch.Tensor, x0: torch.Tensor, m: int,
                eps: float = 0.0, orth: str = "cgs", inv_diag=None,
                precond=None):
    """One GMRES(m) cycle from x0 (module docstring). Returns (x_new,
    normr, k_inner, breakdown) with the last three on the host."""
    vdt = b.dtype
    spmv = matvec(A)
    apply_m = resolve_apply_m(precond, inv_diag, spmv, vdt)

    def apply_minv(v):
        return apply_m(v) if apply_m is not None else v

    r = b - spmv(x0)
    beta = torch.sqrt(torch.sum(r * r))
    inv_beta = torch.where(beta > 0, 1.0 / torch.where(beta > 0, beta, 1.0), 0.0)
    V = torch.zeros((m + 1, b.shape[0]), dtype=vdt, device=b.device)
    V[0] = r * inv_beta
    Hraw = torch.zeros((m + 1, m), dtype=vdt, device=b.device)
    for j in range(m):
        w = spmv(apply_minv(V[j]))
        basis = V[: j + 1]
        h = basis @ w
        w = w - h @ basis
        if orth == "cgs2":
            # "twice is enough" (Giraud et al. 2005): a second projection
            # restores the orthogonality CGS loses on ill-conditioned bases
            h2 = basis @ w
            w = w - h2 @ basis
            h = h + h2
        h_last = torch.sqrt(torch.sum(w * w))
        Hraw[: j + 1, j] = h
        Hraw[j + 1, j] = h_last
        V[j + 1] = w * torch.where(
            h_last > 0, 1.0 / torch.where(h_last > 0, h_last, 1.0), 0.0)
    Hh = Hraw.cpu().numpy()
    beta_h = Hh.dtype.type(beta.item())
    y, normr, k, breakdown = _least_squares(Hh, beta_h, m, eps)
    x_new = x0 + apply_minv(y.to(b.device) @ V[:m])
    return x_new, float(normr), k, breakdown


def solve_gmres(A, b, *, itermax: int = 150, eps: float = 0.0,
                restart: int = 30, orth: str = "cgs", inv_diag=None,
                precond=None, verbose: bool = True) -> GMRESResult:
    """Restarted GMRES from x = 0: a warm-up cycle, then the timed
    cycles, each printing its line. bf16 vectors run in f32 (an 8-bit
    mantissa cannot hold a basis together; the matrix keeps its
    storage). ``inv_diag`` (original row order) / ``precond``: right
    preconditioning."""
    if orth not in ("cgs", "cgs2"):
        raise ValueError(f"orth must be 'cgs' or 'cgs2', got {orth!r}")
    device = A.device
    b = torch.as_tensor(b, device=device)
    if b.dtype == torch.bfloat16:
        b = b.to(torch.float32)
    x = torch.zeros_like(b)
    if inv_diag is not None:
        inv_diag = torch.as_tensor(inv_diag, device=device).to(b.dtype)
    permuted = getattr(A, "permuted_output", False)
    if permuted:
        b, x = A.permute_vector(b), A.permute_vector(x)
        if inv_diag is not None:
            inv_diag = A.permute_vector(inv_diag)
    m = min(restart, itermax)

    def cycle(x_in):
        return gmres_cycle(A, b, x_in, m, float(eps), orth, inv_diag,
                           precond)

    cycle(x)  # warm-up; its result is discarded

    hist = []
    iters = 0
    normr = np.inf
    broke_down = False
    t0 = time.perf_counter()
    while iters < itermax:
        x_new, normr_h, k_h, brk = cycle(x)
        if brk:
            # singular H before convergence: keep the last good iterate
            broke_down = True
            break
        x = x_new
        normr = normr_h
        hist.append(normr)
        iters += k_h
        if verbose:
            print(f"GMRES cycle {len(hist)}: iterations = {iters} "
                  f"Residual = {normr:E}")
        if normr <= eps or not np.isfinite(normr) or k_h < m:
            break
    synchronize(device)
    solve_seconds = time.perf_counter() - t0
    if permuted:
        x = A.unpermute_vector(x)
    return GMRESResult(
        x=x.cpu().numpy(),
        iterations=min(iters, itermax),
        residual_history=np.asarray(hist),
        final_normr=normr,
        solve_seconds=solve_seconds,
        breakdown=broke_down,
    )
