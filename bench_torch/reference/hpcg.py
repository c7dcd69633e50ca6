"""The plain reference of the HPCG-style problem, in plain torch and f64.

It follows the reference SparseBench (RRZE-HPC/SparseBench): the matrix of
``src/matrix.c`` generateMatrix on an nx x ny x nz grid, row
``ix + nx * (iy + ny * iz)``, with ``diagonal`` on the diagonal and
``off_diagonal`` at every neighbour that lies inside the grid; and the CG
of ``src/CGSolver.c``:

    init:  r = b - A x0; rtrans = r.r; normr = sqrt(rtrans); hist[0] = normr
    for k = 1 .. itermax - 1 while normr > eps:
        k == 1: p = r
        else:   old = rtrans; rtrans = r.r; p = r + (rtrans / old) p
        normr = sqrt(rtrans); hist[k] = normr
        Ap = A p; alpha = rtrans / (p.Ap); x += alpha p; r -= alpha Ap

The operator is applied by shifts of the zero-padded grid, one per
stencil point; no stored matrix, no index and nothing of the measured
program. ``cg`` runs a block of columns at once, each with its own
scalars, so one call is k independent solves.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F


def stencil_points(points: int):
    """The (dz, dy, dx) neighbours of a point, itself included: all 27 of
    the cube, or the centre and its six faces."""
    cube = itertools.product((-1, 0, 1), repeat=3)
    if points == 27:
        return list(cube)
    if points == 7:
        return [s for s in cube if sum(abs(v) for v in s) <= 1]
    raise ValueError(f"a stencil has 7 or 27 points, not {points}")


def apply(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """y = A x for x of shape (..., nx*ny*nz), in x's dtype."""
    nx, ny, nz = cfg["nx"], cfg["ny"], cfg["nz"]
    lead = x.shape[:-1]
    g = x.reshape(-1, nz, ny, nx)
    xp = F.pad(g, (1, 1, 1, 1, 1, 1))
    y = g * cfg["diagonal"]
    for dz, dy, dx in stencil_points(cfg["stencil_points"]):
        if (dz, dy, dx) == (0, 0, 0):
            continue
        y.add_(xp[:, 1 + dz:1 + dz + nz, 1 + dy:1 + dy + ny,
                  1 + dx:1 + dx + nx], alpha=cfg["off_diagonal"])
    return y.reshape(*lead, nx * ny * nz)


def cg(B: torch.Tensor, cfg: dict, X0: torch.Tensor | None = None):
    """CG on each row of B (k, n), from X0 (zeros by default), for the
    configuration's ``itermax`` and ``eps``. Returns (X (k, n), iterations
    (k,) as the reference returns k, history (itermax, k), NaN where a
    column never got to)."""
    itermax, eps = cfg["itermax"], cfg["eps"]
    kcols = B.shape[0]
    X = torch.zeros_like(B) if X0 is None else X0.clone()
    R = B - apply(X, cfg)
    rtrans = (R * R).sum(dim=1)
    normr = rtrans.sqrt()
    hist = torch.full((itermax, kcols), float("nan"), dtype=B.dtype,
                      device=B.device)
    hist[0] = normr
    iters = torch.ones(kcols, dtype=torch.int64, device=B.device)
    P = torch.zeros_like(B)
    for k in range(1, itermax):
        active = normr > eps
        if not bool(active.any()):
            break
        if k == 1:
            P = torch.where(active[:, None], R, P)
        else:
            new = (R * R).sum(dim=1)
            beta = new / rtrans
            rtrans = torch.where(active, new, rtrans)
            P = torch.where(active[:, None], R + beta[:, None] * P, P)
        normr = torch.where(active, rtrans.sqrt(), normr)
        hist[k] = torch.where(active, normr, hist[k])
        AP = apply(P, cfg)
        alpha = torch.where(active, rtrans / (P * AP).sum(dim=1), 0.0)
        X = X + alpha[:, None] * P
        R = R - alpha[:, None] * AP
        iters = iters + active.to(iters.dtype)
    return X, iters, hist
