"""Pipelined CG (Ghysels & Vanroose 2014; counterpart of
sparsebench_tpu/solvers/cg_pipe.py).

The single fused reduction of an iteration is independent of its one
matvec, so on a mesh the two can overlap. Formulated in the preconditioned
space (A_hat = M^-1 A, u = M^-1 r, self-adjoint in <a,b>_M = a^T M b; M = I
unpreconditioned or Jacobi):

    u = M^-1 (b - A x);  w = A_hat u
    loop:
        gamma = <u, u>_M,  delta = <w, u>_M   } one fused reduction
        q = A_hat w                           } independent matvec
        beta  = gamma / gamma_old        (0 on a fresh start)
        alpha = gamma / (delta - beta * gamma / alpha_old)
        z = q + beta z;  c = w + beta c;  p = u + beta p
        x += alpha p;  u -= alpha c;  w -= alpha z

A polynomial preconditioner (``ChebPrecond``) has no cheap M apply, so it
takes the r-space form (``_pipe_prec_loop``), which carries r and the
direction s explicitly. The recurrently maintained vectors drift earlier
than standard CG's residual; a drift-triggered replacement restart repairs
them (recompute them from x when <u,u>_M rises ``DRIFT_FACTOR`` times above
its best, or on a positivity breakdown, never two in a row).

**The replacement branch reads one flag a step on the host.** Whether the
next iteration replaces is decided on the device (``need_rep``), and the
JAX package branches on it inside its jitted loop (``lax.cond``). Eager
torch cannot branch on a device value without reading it. Computing both
branches and selecting with ``torch.where`` would add two matvecs to every
iteration (three a step where the method needs one); reading the flag
costs one small device-to-host copy a step and the host's lead over the
device. This module reads it: each iteration starts with one read of
[the loop's exit test, need_rep], so the loop also stops where the JAX
``while_loop`` does, and the iteration index is known on the host (the
first step's ``beta = 0`` branches there). The replacement is never
skipped.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparsebench_tpu_torch.solvers.cg import default_acc_dtype, matvec, safe_div
from sparsebench_tpu_torch.solvers.precond import resolve_apply_m

# replace when the recurrence's ||r||^2 rises this far above its best
# (16x in ||r||: above CG's transient spikes, below the drift past the floor)
DRIFT_FACTOR = 256.0


def _flags(go: torch.Tensor, need_rep: torch.Tensor):
    """(go, need_rep) on the host: one device-to-host read."""
    return (bool(v) for v in torch.stack([go, need_rep]).tolist())


def _zeros_like4(v):
    return tuple(torch.zeros_like(v) for _ in range(4))


def cg_pipe_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
                 acc_dtype: Optional[torch.dtype] = None, inv_diag=None,
                 precond=None):
    """Pipelined CG; the contract of ``cg_loop`` (returns (x, k,
    history[itermax])). ``inv_diag`` enables Jacobi preconditioning (the
    M-inner products are elementwise-weighted sums); ``precond`` switches
    to the r-space form ``_pipe_prec_loop``."""
    if precond is not None:
        return _pipe_prec_loop(A, b, x0, itermax, eps, acc_dtype, inv_diag,
                               precond)
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    device = b.device
    spmv = matvec(A)
    jacobi = inv_diag is not None
    if jacobi:
        inv_diag = inv_diag.to(vdt)
        wvec = torch.where(
            inv_diag != 0,
            1.0 / torch.where(inv_diag != 0, inv_diag, torch.ones_like(inv_diag)),
            torch.zeros_like(inv_diag))

    def mv(v):
        Av = spmv(v)
        return ((inv_diag * Av) if jacobi else Av).to(vdt)

    def fused_dots(u, w):
        # [gamma = <u,u>_M, delta = <w,u>_M] (+ ||M u||^2 = true ||r||^2
        # under Jacobi)
        us, ws = u.to(sdt), w.to(sdt)
        if jacobi:
            uw = us * wvec.to(sdt)
            parts = [torch.sum(us * uw), torch.sum(ws * uw),
                     torch.sum(uw * uw)]
        else:
            parts = [torch.sum(us * us), torch.sum(ws * us)]
        return torch.stack(parts)

    def fresh_uw(x):
        r = (b - spmv(x)).to(vdt)
        u = (inv_diag * r).to(vdt) if jacobi else r
        return u, mv(u)

    eps = torch.as_tensor(eps, device=device)
    x = x0
    u, w = fresh_uw(x0)
    gd0 = fused_dots(u, w)
    gamma = gd0[0]
    rr_best = gd0[2] if jacobi else gamma
    normr = torch.sqrt(torch.clamp(rr_best, min=0))
    hist = torch.full((itermax,), float("nan"), dtype=sdt, device=device)
    hist[0] = normr
    p, c, z, _ = _zeros_like4(b)
    alpha = torch.zeros((), dtype=sdt, device=device)
    need_rep = torch.zeros((), dtype=torch.bool, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    k = 1
    while k < itermax:
        go, rep = _flags((normr > eps) & ~done, need_rep)
        if not go:
            break
        if rep:
            # replacement restart: u, w from x, the directions zeroed
            u, w = fresh_uw(x)
            p, c, z, _ = _zeros_like4(b)
        gd = fused_dots(u, w)
        q = mv(w)
        g_new, delta = gd[0], gd[1]
        rr_new = gd[2] if jacobi else g_new
        normr = torch.sqrt(torch.clamp(rr_new, min=0))
        hist[k] = normr
        if k == 1 or rep:
            beta = torch.zeros_like(g_new)
            denom = delta
        else:
            beta = safe_div(g_new, gamma)
            denom = delta - beta * safe_div(g_new, alpha)
        # denom is p.Ap in disguise: positivity breakdown as cg_cs_loop
        breakdown = denom <= g_new * 1e-30
        alpha = torch.where(breakdown, 0, safe_div(g_new, denom))
        b_v, a_v = beta.to(vdt), alpha.to(vdt)
        z = q + b_v * z
        c = w + b_v * c
        p = u + b_v * p
        x = x + a_v * p
        u = u - a_v * c
        w = w - a_v * z
        # replace next step on drift or breakdown, never twice in a row;
        # a breakdown right after a replacement is the floor: stop
        need_rep = (breakdown | (rr_new > DRIFT_FACTOR * rr_best)) & (not rep)
        if rep:
            done = done | breakdown
        rr_best = torch.minimum(rr_best, rr_new)
        gamma = g_new
        k += 1
    return x, k, hist


def _pipe_prec_loop(A, b: torch.Tensor, x0: torch.Tensor, itermax: int, eps,
                    acc_dtype=None, inv_diag=None, precond=None):
    """Preconditioned pipelined CG for a general operator M^-1 (Ghysels &
    Vanroose 2014, Alg. 4; JAX ``_pipe_prec_loop``):

        r = b - A x;  u = M^-1 r;  w = A u
        loop:
            gamma = <r, u>, delta = <w, u>, rr = <r, r>  } one reduction
            m = M^-1 w;  n = A m                         } independent
            beta, alpha as in cg_pipe_loop
            z = n + beta z;  q = m + beta q;  s = w + beta s;  p = u + beta p
            x += alpha p;  r -= alpha s;  u -= alpha q;  w -= alpha z

    The same replacement (r, u, w refreshed from x), read on the host."""
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    device = b.device
    spmv = matvec(A)

    def mv(v):
        return spmv(v).to(vdt)

    apply_m = resolve_apply_m(precond, inv_diag, mv, vdt)

    def fused_dots(r, u, w):
        rs, us = r.to(sdt), u.to(sdt)
        return torch.stack([torch.sum(rs * us), torch.sum(w.to(sdt) * us),
                            torch.sum(rs * rs)])

    def fresh_ruw(x):
        r = (b - mv(x)).to(vdt)
        u = apply_m(r)
        return r, u, mv(u)

    eps = torch.as_tensor(eps, device=device)
    x = x0
    r, u, w = fresh_ruw(x0)
    gd0 = fused_dots(r, u, w)
    gamma, rr_best = gd0[0], gd0[2]
    normr = torch.sqrt(torch.clamp(rr_best, min=0))
    hist = torch.full((itermax,), float("nan"), dtype=sdt, device=device)
    hist[0] = normr
    p, s, q, z = _zeros_like4(b)
    alpha = torch.zeros((), dtype=sdt, device=device)
    need_rep = torch.zeros((), dtype=torch.bool, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    k = 1
    while k < itermax:
        go, rep = _flags((normr > eps) & ~done, need_rep)
        if not go:
            break
        if rep:
            r, u, w = fresh_ruw(x)
            p, s, q, z = _zeros_like4(b)
        gd = fused_dots(r, u, w)
        m = apply_m(w)
        n = mv(m)
        g_new, delta, rr_new = gd[0], gd[1], gd[2]
        normr = torch.sqrt(torch.clamp(rr_new, min=0))
        hist[k] = normr
        if k == 1 or rep:
            beta = torch.zeros_like(g_new)
            denom = delta
        else:
            beta = safe_div(g_new, gamma)
            denom = delta - beta * safe_div(g_new, alpha)
        breakdown = denom <= g_new * 1e-30
        alpha = torch.where(breakdown, 0, safe_div(g_new, denom))
        b_v, a_v = beta.to(vdt), alpha.to(vdt)
        z = n + b_v * z
        q = m + b_v * q
        s = w + b_v * s
        p = u + b_v * p
        x = x + a_v * p
        r = r - a_v * s
        u = u - a_v * q
        w = w - a_v * z
        # replace next step on drift or breakdown, never twice in a row;
        # a breakdown right after a replacement is the floor: stop
        need_rep = (breakdown | (rr_new > DRIFT_FACTOR * rr_best)) & (not rep)
        if rep:
            done = done | breakdown
        rr_best = torch.minimum(rr_best, rr_new)
        gamma = g_new
        k += 1
    return x, k, hist
