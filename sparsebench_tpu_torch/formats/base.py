"""Device matrix format protocol (counterpart of sparsebench_tpu/formats/base.py).

A format is a small dataclass holding its stored tensors on one device,
with ``from_csr(csr, policy, *, device, ...)`` (the reference's
``convertMatrix``, src/matrix.h:56) and ``spmv(x)`` (``spMVM``,
src/matrix.h:57). ``x`` has length ``nc``; the result has length ``nr``.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparsebench_tpu_torch.config import DTypePolicy


def default_policy(policy: Optional[DTypePolicy]) -> DTypePolicy:
    return policy if policy is not None else DTypePolicy.from_names("f64", "i32")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def physical_spmv_bytes(A, x_bytes: int = 4) -> int:
    """Bytes PHYSICALLY streamed per SpMV: every stored tensor of the
    format (padding included, at its stored dtype; tensors in tuples too)
    + one read of x + one write of y. A bridged SELL matrix counts only its
    ``fast`` delegate's tensors: its SpMV never reads the SELL layout. The
    reference's byte model ((value_bytes + index_bytes) * nnz,
    src/main.c:187-189) is the profiler's "effective" count instead."""
    fast = getattr(A, "fast", None)
    if fast is not None:
        return physical_spmv_bytes(fast, x_bytes)
    tensors = [t for v in vars(A).values()
               for t in (v if isinstance(v, tuple) else (v,))
               if isinstance(t, torch.Tensor)]
    mat = sum(t.numel() * t.element_size() for t in tensors)
    return mat + (A.nc + A.nr) * x_bytes
