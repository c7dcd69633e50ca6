"""Matrix-free operator for the generated 27/7-point stencil problem
(counterpart of sparsebench_tpu/formats/stencil.py).

The reference's generator (src/matrix.c:30-121) emits 27 on the diagonal
and -1 for every in-domain neighbour of the tensor-product stencil, so with
S_a the zero-boundary 3-point sum along axis a

    27-point:  A x = 28 x - Sz Sy Sx x
    7-point:   A x = 30 x - (Sx + Sy + Sz) x

and the operator stores nothing: an SpMV streams x and y only
(``physical_spmv_bytes`` counts x + y). It exists only for generated
problems (``filename = generate|generate7P``, ``--fmt stencil``); ``from_csr``
raises, and it is serial only.

The vectors keep the generator's natural row order with no padding, and CG
runs on length-nr vectors. (The JAX package's Pallas form runs in a padded
(nz+2, nyp, nxp) space for the TPU's lane and sublane tiles, behind its
``permuted_output`` hooks; the port's kernels mask the domain edges
instead, so there is no permutation.)

``impl`` is ``kernel`` (the CUDA kernels of ops/stencil.py,
ops/stencil_cg_vmem.py and, in the solver, ops/cg_fused.py) or ``torch``
(their plain versions); ``auto`` is ``kernel`` on CUDA and ``torch`` on the
CPU, and ``kernel`` on the CPU raises (formats/dia.py ``resolve_impl``).
``impl`` is the one choice between kernel and plain version, and it is
made here: ``torch`` runs the plain version on either device (``--impl
torch`` on the card). The operator calls a wrapper only with ``kernel``,
hence only with CUDA tensors; a wrapper's own device check serves its
direct callers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.dia import resolve_impl
from sparsebench_tpu_torch.formats.registry import register_format
from sparsebench_tpu_torch.ops.stencil import (
    stencil_apply,
    stencil_apply_dots,
    stencil_apply_dots_torch,
    stencil_apply_torch,
    stencil_axpy_apply_dots,
    stencil_axpy_apply_dots_torch,
)


def _axis_counts(n: int) -> np.ndarray:
    """Per-position count of in-domain {-1,0,+1} offsets along one axis."""
    c = np.full(n, 3, dtype=np.int64)
    if n >= 1:
        c[0] = min(2, n)
        c[-1] = min(2, n)
    if n == 1:
        c[0] = 1
    return c


def stencil_row_counts(nx: int, ny: int, nz: int,
                       use_7pt: bool = False) -> np.ndarray:
    """Row lengths of the generated matrix (incl. the diagonal), flattened
    in the generator's row order (x fastest — src/matrix.c:42-47). Feeds
    the b = 27 - (nnzrow - 1) exact-solution setup (src/CGSolver.c:25-36)."""
    cx, cy, cz = _axis_counts(nx), _axis_counts(ny), _axis_counts(nz)
    if use_7pt:
        counts = (cz[:, None, None] + cy[None, :, None] + cx[None, None, :]
                  - 2)
    else:
        counts = cz[:, None, None] * cy[None, :, None] * cx[None, None, :]
    return counts.reshape(-1)


@register_format("stencil")
@dataclasses.dataclass
class StencilOperator:
    nx: int
    ny: int
    nz: int
    use_7pt: bool
    nr: int
    nc: int
    nnz: int
    device: torch.device
    impl: str = "torch"  # "kernel" | "torch"
    total_nr: int = 0
    total_nnz: int = 0

    @classmethod
    def from_csr(cls, csr, policy=None, **_opts):
        raise ValueError(
            "the stencil format is matrix-free and only applies to "
            "generated problems (filename = generate|generate7P); use a "
            "storing format (dia/bslab/...) for ingested matrices"
        )

    @classmethod
    def from_stencil(
        cls,
        nx: int,
        ny: int,
        nz: int,
        *,
        device: Union[str, torch.device],
        rank: int = 0,
        size: int = 1,
        use_7pt: bool = False,
        policy: Optional[DTypePolicy] = None,
        impl: str = "auto",
    ) -> Tuple["StencilOperator", np.ndarray]:
        """The operator and the generator's row counts. ``policy`` is
        accepted for the format protocol; the operator stores nothing and
        adopts the vectors' dtype."""
        del policy
        if size != 1 or rank != 0:
            raise ValueError(
                "the matrix-free stencil operator is serial-only; the "
                "z-stacked multi-rank problem needs halo columns — use "
                "--fmt dia under --shards"
            )
        device = torch.device(device)
        impl = resolve_impl(impl, device)
        nr = nx * ny * nz
        counts = stencil_row_counts(nx, ny, nz, use_7pt)
        nnz = int(counts.sum())
        return (
            cls(nx=nx, ny=ny, nz=nz, use_7pt=use_7pt, nr=nr, nc=nr, nnz=nnz,
                device=device, impl=impl, total_nr=nr, total_nnz=nnz),
            counts,
        )

    def _dims(self):
        return self.nx, self.ny, self.nz, self.use_7pt

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x (K2, or its plain version)."""
        fn = stencil_apply if self.impl == "kernel" else stencil_apply_torch
        return fn(x, *self._dims())

    # ------------------------------------------- fused single-reduction CG
    supports_fused_cs = True

    def spmv_permuted_dots(self, x: torch.Tensor):
        """(w, f32 [x.x, w.x]) with w = A x in one kernel (K2's dots form):
        the whole reduction of ``cg_cs_loop`` rides the apply. The name is
        the JAX package's; here the space is not permuted."""
        fn = (stencil_apply_dots if self.impl == "kernel"
              else stencil_apply_dots_torch)
        return fn(x, *self._dims())

    # -------------------------------------------------- fused CG stage A
    supports_fused_pw = True

    def axpy_spmv_dots(self, r: torch.Tensor, p: torch.Tensor, beta):
        """(p' = r + beta p, w = A p', delta = p'.w) in one pass (K3)."""
        fn = (stencil_axpy_apply_dots if self.impl == "kernel"
              else stencil_axpy_apply_dots_torch)
        return fn(r, p, beta, *self._dims())

    # ------------------------------------------ whole-solve CG in one launch
    # ``cg_vmem_loop`` (variant 'vmem', K5) runs on this operator; whether
    # a grid fits the kernel's L2 plan is for ops/stencil_cg_vmem.py alone
    # to decide, at the vectors' width
    supports_vmem_cg = True
