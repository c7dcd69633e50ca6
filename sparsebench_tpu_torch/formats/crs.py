"""CRS and CCRS device formats (reference src/matrix-CRS.c,
src/matrix-CCRS.c; counterpart of sparsebench_tpu/formats/crs.py).

The reference runs a row loop with a scalar dot per row
(src/matrix-CRS.c:46-64). Here the SpMV keeps its semantics (no row
reordering, exact nnz storage) as two torch calls: a gather of x by column
and a segment sum of the products over the rows' runs
(``torch.segment_reduce`` with the row pointers). The JAX package stores a
row index per element for its segment sum; a CUDA segment reduction takes
the row pointers instead. There is no kernel of the port here. CCRS
registers as an alias: on the device the two are the same (the reference's
CCRS convertMatrix is a no-op, src/matrix-CCRS.c:12).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.base import default_policy
from sparsebench_tpu_torch.formats.registry import register_format
from sparsebench_tpu_torch.host import HostCSR


@register_format("crs")
@dataclasses.dataclass
class CRSMatrix:
    val: torch.Tensor      # (nnz,) value dtype, rows in order
    col: torch.Tensor      # (nnz,) index dtype
    row_ptr: torch.Tensor  # (nr + 1,) index dtype
    nr: int
    nc: int
    nnz: int
    start_row: int = 0
    total_nr: int = 0
    total_nnz: int = 0
    impl = "torch"

    @property
    def device(self) -> torch.device:
        return self.val.device

    @classmethod
    def from_csr(cls, csr: HostCSR, policy: Optional[DTypePolicy] = None, *,
                 device: Union[str, torch.device]) -> "CRSMatrix":
        policy = default_policy(policy)
        idx = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(device=device, dtype=policy.index)
        return cls(
            val=torch.from_numpy(csr.val.astype(policy.host_value)).to(
                device=device, dtype=policy.value),
            col=idx(csr.col), row_ptr=idx(csr.row_ptr),
            nr=csr.nr, nc=csr.nc, nnz=csr.nnz, start_row=csr.start_row,
            total_nr=csr.total_nr, total_nnz=csr.total_nnz,
        )

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x (reference spMVM, src/matrix-CRS.c:46-64)."""
        if self.nnz == 0:
            return torch.zeros(self.nr, dtype=self.val.dtype, device=x.device)
        prod = self.val * torch.index_select(x, 0, self.col).to(self.val.dtype)
        return torch.segment_reduce(prod, "sum", offsets=self.row_ptr)

    @property
    def permuted_output(self) -> bool:
        return False

    def permute_vector(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def unpermute_vector(self, v: torch.Tensor) -> torch.Tensor:
        return v


@register_format("ccrs")
@dataclasses.dataclass
class CCRSMatrix(CRSMatrix):
    """CLI and API alias of CRS (module docstring)."""
