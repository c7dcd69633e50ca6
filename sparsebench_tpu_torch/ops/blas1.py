"""BLAS-1 streaming operations (reference src/solver.c:16-62; counterpart of
sparsebench_tpu/ops/blas1.py). Plain PyTorch: the JAX package has no kernel
here either.

``ddot`` holds no global reduction (the reference fuses MPI_Allreduce into
ddot, src/solver.c:60); a distributed solver applies its own.
"""

from __future__ import annotations

from typing import Optional

import torch


def waxpby(alpha, x: torch.Tensor, beta, y: torch.Tensor) -> torch.Tensor:
    """w = alpha*x + beta*y (reference src/solver.c:16-39)."""
    return alpha * x + beta * y


def ddot(x: torch.Tensor, y: torch.Tensor, *,
         acc_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Local dot product (reference src/solver.c:41-59, minus the
    allreduce), as ``sum(x*y)`` at ``acc_dtype`` — an elementwise product
    and a tree sum, like the JAX package, not a library dot."""
    if acc_dtype is not None:
        x = x.to(acc_dtype)
        y = y.to(acc_dtype)
    return torch.sum(x * y)
