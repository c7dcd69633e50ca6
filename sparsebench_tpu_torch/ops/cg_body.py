"""The body of standard CG in three stages around the SpMV, as plain
PyTorch: the body of ``solvers/cg.py cg_run`` wherever the fused kernels
(K15 at k = 1, ``ops/cg_multi_body.py``) do not engage. A body is

    A  p-update    active, first, beta; p = r + beta p; hist[k] = sqrt(rt)
       SpMV        Ap = A p (the format's own kernel, K1 on DIA)
    B  p.Ap        alpha, breakdown; commit k, rtrans, normr, done
    C  x/r-update  x += alpha p; r -= alpha Ap; r.r for the next body

* ``body_p_torch``, ``body_pap_torch``, ``body_xr_torch``: the three
  stages as torch operations in the order the eager body has always run
  them (r.r is taken at the start of A here, where the kernels take it at
  the end of the previous C: the same r, summed in another order), each
  mirroring a step of the kernels' recurrence. ``plain_bodies`` runs them
  around the SpMV; ``cg_run`` runs it on the CPU, for bf16 vectors, for
  PCG and where the SpMV's product is not one the kernels read, and the
  JAX-parity tests hold it to the JAX package's body.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from sparsebench_tpu_torch.ops.blas1 import ddot, safe_div


class PStage(NamedTuple):
    """What A leaves for the rest of a plain body."""
    active: torch.Tensor
    rt: torch.Tensor
    p_new: torch.Tensor
    normr_new: torch.Tensor
    hist: torch.Tensor


def body_p_torch(state, k_end: int, eps, steps, sdt, apply_m=None) -> PStage:
    """Plain A: the body's flags and scalars, p_new and the history.
    ``apply_m`` (PCG): p_new = z + beta p, z = M^-1 r, with rtrans carrying
    r.z and the history the true ||r||."""
    k, _x, p, r, rtrans, normr, hist, done = state
    vdt = r.dtype
    active = (k < k_end) & (normr > eps) & ~done
    first = k == 1
    if apply_m is None:
        new_rtrans = ddot(r, r, acc_dtype=sdt)
        rt = torch.where(first, rtrans, new_rtrans)
        # first body: p = r (beta = 0; x0 is finite, so r + 0*p == r)
        beta = torch.where(first, 0, safe_div(new_rtrans, rtrans)).to(vdt)
        p_new = r + beta * p
        normr_new = torch.sqrt(rt)
    else:
        z = apply_m(r)
        rz = ddot(r, z, acc_dtype=sdt)
        rt = torch.where(first, rtrans, rz)
        beta = torch.where(first, 0, safe_div(rz, rtrans)).to(vdt)
        p_new = z + beta * p
        normr_new = torch.sqrt(ddot(r, r, acc_dtype=sdt))
    hist = torch.where(active & (steps == k), normr_new, hist)
    return PStage(active, rt, p_new, normr_new, hist)


def body_pap_torch(a: PStage, ap: torch.Tensor, sdt):
    """Plain B: (breakdown, alpha) from p.Ap; alpha is 0 on a breakdown
    and in an inactive body."""
    pap = ddot(a.p_new, ap, acc_dtype=sdt)
    breakdown = pap <= a.rt * 1e-30
    alpha = torch.where(breakdown | ~a.active, 0,
                        safe_div(a.rt, pap)).to(a.p_new.dtype)
    return breakdown, alpha


def body_xr_torch(state, a: PStage, ap: torch.Tensor, b):
    """Plain C: the state after the body; an inactive body keeps every
    entry but x and r, which take alpha = 0."""
    k, x, p, r, rtrans, normr, _hist, done = state
    breakdown, alpha = b
    x = x + alpha * a.p_new
    r = r - alpha * ap
    p = torch.where(a.active, a.p_new, p)
    rtrans = torch.where(a.active, a.rt, rtrans)
    normr = torch.where(a.active, a.normr_new, normr)
    done = done | (a.active & breakdown)
    k = k + a.active.to(k.dtype)
    return k, x, p, r, rtrans, normr, a.hist, done


def plain_bodies(spmv, state, bodies: int, k_end: int, eps, sdt,
                 apply_m=None, span=contextlib.nullcontext):
    """``bodies`` plain bodies from ``state``, each in ``span("cg.body")``:
    the state after them. ``eps`` is a tensor of the scalars' dtype ``sdt``
    on the vectors' device."""
    steps = torch.arange(state[6].numel(), device=state[3].device)
    for _ in range(bodies):
        with span("cg.body"):
            a = body_p_torch(state, k_end, eps, steps, sdt, apply_m)
            ap = spmv(a.p_new)
            state = body_xr_torch(state, a, ap, body_pap_torch(a, ap, sdt))
    return state
