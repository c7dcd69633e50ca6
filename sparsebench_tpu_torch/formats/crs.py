"""CRS and CCRS device formats (reference src/matrix-CRS.c,
src/matrix-CCRS.c; counterpart of sparsebench_tpu/formats/crs.py).

The reference runs a row loop with a scalar dot per row
(src/matrix-CRS.c:46-64). Here the SpMV keeps its semantics (no row
reordering, exact nnz storage): on a card, for f32 or f64 values under
vectors of the same dtype and int32 columns, the CUDA kernel K14
(``ops/crs_spmv.py``, ``csrc/crs_spmv.cu``), which sums each row in
column order; elsewhere, and always on the CPU, two torch calls, a gather
of x by column and a segment sum of the products over the rows' runs
(``torch.segment_reduce`` with the row pointers). The JAX package stores a
row index per element for its segment sum; the port takes the row
pointers instead. ``impl`` is ``kernel`` (K14 where it applies) or
``torch``; ``auto`` is ``kernel`` on CUDA and ``torch`` on the CPU. CCRS
registers as an alias: on the device the two are the same (the reference's
CCRS convertMatrix is a no-op, src/matrix-CCRS.c:12).

``from_stencil`` builds the generated 27/7-point matrix on the device,
without the host CSR: row pointers from the per-axis neighbour counts,
then columns and values in row chunks, each row's columns ascending as
the reference's generateMatrix writes them (src/matrix.c:30-121); it
equals ``from_csr(generate_stencil(...))`` element for element. Columns
take the policy's index dtype, which must hold the largest column (else
``ValueError``); row pointers take it too unless the matrix has more than
``NARROW_ENTRIES`` entries, as the 27-point stencil has from 431^3 on: then
they are int64, and K14 runs its wide form. The reference's default build
keeps both in its 32-bit unsigned ``UINT_TYPE`` up to 2^32 - 1 entries;
int32 row pointers here stop at ``NARROW_ENTRIES`` = 2^31 - 1 - 1536, the
most entries of K14's narrow form (``ops/crs_spmv.py``).

While the program's recorder records (``profiler.py``), ``spmv`` is a span
``crs.spmv`` (``kernel`` K14 or torch, ``nnz``, ``row_ptr`` i32 or i64) and
``from_stencil`` a span ``crs.build`` (``n``, ``points``, ``row_ptr``,
``nnz``) holding ``crs.build.row_ptr`` (the counts, their prefix sum and
the copy of the chunk bounds to the host) and ``crs.build.cols``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.base import default_policy
from sparsebench_tpu_torch.formats.dia import resolve_impl
from sparsebench_tpu_torch.formats.registry import register_format
from sparsebench_tpu_torch.host import OFFSETS_27, HostCSR
from sparsebench_tpu_torch.ops.crs_spmv import (
    NARROW_ENTRIES,
    crs_spmv,
    crs_spmv_torch,
    kernel_applies,
)

# rows a chunk of from_stencil: its (rows, 27) int64 columns take 56 MB
BUILD_ROWS = 1 << 18
# a row pointers' dtype -> its name in spans
PTR_NAMES = {torch.int32: "i32", torch.int64: "i64"}


def _axis_counts(i: torch.Tensor, extent: int) -> torch.Tensor:
    """Neighbours of coordinate ``i`` along an axis of ``extent`` points,
    itself included: 1 + (i > 0) + (i < extent - 1)."""
    return 1 + (i > 0).to(torch.int64) + (i < extent - 1).to(torch.int64)


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
    impl: str = "torch"    # "kernel" | "torch"

    @property
    def device(self) -> torch.device:
        return self.val.device

    @classmethod
    def from_csr(cls, csr: HostCSR, policy: Optional[DTypePolicy] = None, *,
                 device: Union[str, torch.device],
                 impl: str = "auto") -> "CRSMatrix":
        policy = default_policy(policy)
        device = torch.device(device)
        idx = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(device=device, dtype=policy.index)
        return cls(
            val=torch.from_numpy(csr.val.astype(policy.host_value)).to(
                device=device, dtype=policy.value),
            col=idx(csr.col), row_ptr=idx(csr.row_ptr),
            nr=csr.nr, nc=csr.nc, nnz=csr.nnz, start_row=csr.start_row,
            total_nr=csr.total_nr, total_nnz=csr.total_nnz,
            impl=resolve_impl(impl, device),
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
    ) -> Tuple["CRSMatrix", np.ndarray]:
        """The 27/7-point stencil matrix (reference src/matrix.c:30-121)
        built on ``device`` in CRS layout: this rank's rows of ``size``
        subgrids stacked in z, 27 on the diagonal and -1 at each neighbour
        inside the grid, columns global. Returns ``(matrix, row_counts)``,
        as ``DiaMatrix.from_stencil`` does."""
        with profiler.span("crs.build", n=nx * ny * nz,
                           points=7 if use_7pt else 27) as s:
            A, counts = cls._from_stencil(nx, ny, nz, torch.device(device),
                                          rank, size, use_7pt,
                                          default_policy(policy), impl)
            s.set(row_ptr=PTR_NAMES[A.row_ptr.dtype], nnz=A.nnz)
            return A, counts

    @classmethod
    def _from_stencil(cls, nx, ny, nz, device, rank, size, use_7pt, policy,
                      impl):
        impl = resolve_impl(impl, device)
        nr = nx * ny * nz
        total_nr = nr * size
        start_row = nr * rank
        plane = nx * ny
        shifts = [s for s in OFFSETS_27
                  if not use_7pt or s[0] ** 2 + s[1] ** 2 + s[2] ** 2 <= 1]
        if total_nr - 1 > torch.iinfo(policy.index).max:
            raise ValueError(f"crs: {total_nr} columns do not fit "
                             f"{policy.index} indices")
        i64 = dict(dtype=torch.int64, device=device)
        with profiler.span("crs.build.row_ptr"):
            local = torch.arange(nr, **i64)
            cx = _axis_counts(local % nx, nx)
            cy = _axis_counts((local // nx) % ny, ny)
            # z on the global grid: ranks stack their subgrids in z
            cz = _axis_counts((local + start_row) // plane, nz * size)
            counts = cx * cy * cz if not use_7pt else cx + cy + cz - 2
            del local, cx, cy, cz
            ptr = torch.zeros(nr + 1, **i64)
            torch.cumsum(counts, 0, out=ptr[1:])
            bounds = ptr[::BUILD_ROWS].tolist() + [int(ptr[-1])]
            nnz = bounds[-1]
            # NARROW_ENTRIES: the most entries of K14's narrow form
            row_ptr = ptr.to(policy.index if nnz <= NARROW_ENTRIES
                             else torch.int64)
            del ptr
        with profiler.span("crs.build.cols"):
            offs = torch.tensor([sz * plane + sy * nx + sx
                                 for sz, sy, sx in shifts], **i64)
            sy = torch.tensor([s[1] for s in shifts], **i64)
            sx = torch.tensor([s[2] for s in shifts], **i64)
            # 27 on the diagonal (the shift (0, 0, 0)), -1 elsewhere
            stencil_val = torch.where(offs == 0, 27.0, -1.0).to(
                device=device, dtype=policy.value)
            col = torch.empty(nnz, dtype=policy.index, device=device)
            val = torch.empty(nnz, dtype=policy.value, device=device)
            for c, a in enumerate(range(0, nr, BUILD_ROWS)):
                rows = torch.arange(a, min(a + BUILD_ROWS, nr), **i64)[:, None]
                ix, iy = rows % nx + sx, (rows // nx) % ny + sy
                cols = rows + (start_row + offs)
                valid = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
                         & (cols >= 0) & (cols < total_nr))
                lo, hi = bounds[c], bounds[c + 1]
                # row-major selection keeps each row's shift order, which
                # is its columns ascending
                col[lo:hi] = cols[valid].to(policy.index)
                val[lo:hi] = stencil_val.expand_as(valid)[valid]
        obj = cls(
            val=val, col=col, row_ptr=row_ptr, nr=nr, nc=nr, nnz=nnz,
            start_row=start_row, total_nr=total_nr,
            total_nnz=nnz if size == 1 else 27 * total_nr, impl=impl,
        )
        return obj, counts.to(torch.int32).cpu().numpy()

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x (reference spMVM, src/matrix-CRS.c:46-64), in the
        values' dtype."""
        if profiler.recording():
            with profiler.span("crs.spmv", kernel="K14" if self._k14(x)
                               else "torch", nnz=self.nnz,
                               row_ptr=PTR_NAMES[self.row_ptr.dtype]):
                return self._spmv(x)
        return self._spmv(x)

    def _k14(self, x: torch.Tensor) -> bool:
        return self.impl == "kernel" and kernel_applies(
            self.val, self.col, self.row_ptr, x)

    def _spmv(self, x: torch.Tensor) -> torch.Tensor:
        fn = crs_spmv if self.impl == "kernel" else crs_spmv_torch
        return fn(self.val, self.col, self.row_ptr, x)

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
