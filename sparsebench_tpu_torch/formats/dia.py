"""DIA (diagonal) device format (counterpart of sparsebench_tpu/formats/dia.py).

A banded matrix is stored as its ``ndiag`` populated diagonals,
``data[d, i] = A[i, i + offsets[d]]`` (zero outside the matrix and in the
padded rows), and

    y = sum_d  data[d, :nr] * x[offset_d : offset_d + nr]

reads x as contiguous shifted slices — no column-index gather. The stored
layout (offsets sorted ascending, ``nr_pad`` from ``_grid_pad``, lossless
bf16 compression of f32 values) is the JAX package's, so byte counts and
results line up; only the (ndiag, nr_pad/128, 128) TPU tiling is flattened
to (ndiag, nr_pad).

``impl`` picks the SpMV and the multi-RHS product ``spmm_kn``: ``kernel``
(the CUDA kernels, ops/dia_spmv.py and ops/dia_spmm.py) or ``torch``
(their plain versions). ``auto`` is ``kernel`` on CUDA and ``torch``
on the CPU; ``kernel`` on the CPU raises. Unlike the JAX package there is
no self-check that quietly swaps a failing kernel for the plain path: a
wrong kernel fails loudly.

While the program's recorder records (``profiler.py``), ``spmv`` and
``spmm_kn`` are spans ``dia.spmv`` and ``dia.spmm`` (the wrapper's checks,
the output's allocation and the launch; ``kernel``: K1, K8 with its
``form``, or ``torch``), and ``from_stencil`` is a span ``dia.build`` with
its device step (``dia.build.diagonals``: the diagonals and row counts
enqueued) and its host step (``dia.build.row_counts``: the counts copied
to the host, which waits for the device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.base import default_policy, round_up
from sparsebench_tpu_torch.formats.registry import register_format
from sparsebench_tpu_torch.host import OFFSETS_27, HostCSR, generate_stencil
from sparsebench_tpu_torch.ops.dia_spmm import dia_spmm, dia_spmm_torch
from sparsebench_tpu_torch.ops.dia_spmv import (
    MAX_DIAGS,
    dia_spmv,
    dia_spmv_torch,
)

LANES = 128

VALID_IMPLS = ("auto", "torch", "kernel")

Device = Union[str, torch.device]


class DiaUnsuitableError(ValueError):
    """Matrix is not banded enough for DIA storage."""


def resolve_impl(impl: str, device: torch.device) -> str:
    """``auto`` -> ``kernel`` on CUDA, ``torch`` on the CPU. The kernel
    exists only on CUDA, so asking for it on the CPU raises."""
    if impl not in VALID_IMPLS:
        raise ValueError(
            f"unknown impl {impl!r}; valid: {', '.join(VALID_IMPLS)}"
        )
    if impl == "auto":
        return "kernel" if device.type == "cuda" else "torch"
    if impl == "kernel" and device.type != "cuda":
        raise ValueError(
            f"impl 'kernel' is a CUDA kernel and the device is {device}; "
            "use impl 'torch' (the plain version) on the CPU"
        )
    return impl


def _grid_pad(nr: int) -> int:
    """nr_pad of the JAX package's DIA layout: 128-lane rows, and at
    benchmark scale a multiple of 512 such rows (formats/dia.py:112-126).
    Kept so that the stored layout and its byte count match."""
    pad = max(LANES, round_up(nr, LANES))
    rows = pad // LANES
    if rows >= 4096 and rows % 512:
        pad = round_up(rows, 512) * LANES
    return pad


def _stencil_dia(specs, nx, ny, local_nrow, total_nrow, start_row, nr_pad,
                 store_dt, device):
    """The 27/7-point stencil's DIA data, built on ``device`` (the JAX
    package's ``_stencil_dia_device``): per diagonal a constant under
    bound checks on grid coordinates derived from the row index.

    Returns (data (ndiag, nr_pad) in ``store_dt``, counts (nr_pad,) int32).
    """
    local = torch.arange(nr_pad, dtype=torch.int64, device=device)
    ix = local % nx
    iy = (local // nx) % ny
    valid = local < local_nrow
    counts = torch.zeros(nr_pad, dtype=torch.int32, device=device)
    data = torch.empty((len(specs), nr_pad), dtype=store_dt, device=device)
    for d, (off, _sz, sy, sx) in enumerate(specs):
        col = local + (start_row + off)
        m = (
            valid
            & (ix + sx >= 0) & (ix + sx < nx)
            & (iy + sy >= 0) & (iy + sy < ny)
            & (col >= 0) & (col < total_nrow)
        )
        data[d] = torch.where(m, 27.0 if off == 0 else -1.0, 0.0)
        counts += m
    return data, counts


@register_format("dia")
@dataclasses.dataclass
class DiaMatrix:
    data: torch.Tensor  # (ndiag, nr_pad), value dtype (bf16 when compressed)
    offsets: Tuple[int, ...]
    nr: int
    nc: int
    nnz: int
    n_elems: int
    nr_pad: int
    impl: str = "torch"  # "kernel" | "torch"
    start_row: int = 0
    total_nr: int = 0
    total_nnz: int = 0

    @property
    def device(self) -> torch.device:
        return self.data.device

    @classmethod
    def from_csr(
        cls,
        csr: HostCSR,
        policy: Optional[DTypePolicy] = None,
        *,
        device: Device,
        max_diags: int = MAX_DIAGS,
        impl: str = "auto",
        compress: bool = True,
    ) -> "DiaMatrix":
        """DIA storage of a host CSR matrix: one diagonal per distinct
        ``col - row``, at most ``max_diags`` of them, f32 values stored as
        bf16 when every value round-trips exactly."""
        policy = default_policy(policy)
        device = torch.device(device)
        impl = resolve_impl(impl, device)
        if csr.nc != csr.nr:
            raise DiaUnsuitableError(
                f"DIA requires a square local matrix (nr={csr.nr}, nc={csr.nc})"
            )
        rows = np.repeat(np.arange(csr.nr, dtype=np.int64), csr.row_lengths)
        keys = csr.col - rows
        offsets = np.unique(keys)
        if offsets.size > max_diags:
            raise DiaUnsuitableError(
                f"{offsets.size} populated diagonals exceeds max_diags={max_diags}"
            )
        nr_pad = _grid_pad(csr.nr)
        # numpy has no bf16: a bf16 policy rounds through f32
        host_dt = np.float64 if policy.value == torch.float64 else np.float32
        host = np.zeros((offsets.size, nr_pad), dtype=host_dt)
        host[np.searchsorted(offsets, keys), rows] = csr.val.astype(host_dt)
        data = torch.from_numpy(host).to(policy.value)
        if compress and data.dtype == torch.float32:
            # lossless bf16 compression halves the dominant traffic term;
            # the SpMV accumulates in the x dtype
            bf = data.to(torch.bfloat16)
            if torch.equal(bf.to(torch.float32), data):
                data = bf
        return cls(
            data=data.to(device),
            offsets=tuple(int(o) for o in offsets),
            nr=csr.nr,
            nc=csr.nc,
            nnz=csr.nnz,
            n_elems=offsets.size * csr.nr,
            nr_pad=nr_pad,
            impl=impl,
            start_row=csr.start_row,
            total_nr=csr.total_nr,
            total_nnz=csr.total_nnz,
        )

    @classmethod
    def from_stencil(
        cls,
        nx: int,
        ny: int,
        nz: int,
        *,
        device: Device,
        rank: int = 0,
        size: int = 1,
        use_7pt: bool = False,
        policy: Optional[DTypePolicy] = None,
        impl: str = "auto",
        compress: bool = True,
    ) -> Tuple["DiaMatrix", np.ndarray]:
        """The 27/7-point stencil matrix (reference src/matrix.c:30-121)
        built directly in DIA layout on ``device``: the populated diagonals
        are known (offset = sz*nx*ny + sy*nx + sx), the values are 27 / -1,
        and validity per row is a few bound checks.

        Returns ``(matrix, row_counts)``; the row counts feed the
        reference's b = 27 - (nnzrow - 1) setup (src/CGSolver.c:25-36).
        """
        with profiler.span("dia.build", n=nx * ny * nz,
                           points=7 if use_7pt else 27):
            return cls._from_stencil(nx, ny, nz, device, rank, size, use_7pt,
                                     policy, impl, compress)

    @classmethod
    def _from_stencil(cls, nx, ny, nz, device, rank, size, use_7pt, policy,
                      impl, compress):
        policy = default_policy(policy)
        device = torch.device(device)
        impl = resolve_impl(impl, device)
        local_nrow = nx * ny * nz
        total_nrow = local_nrow * size
        start_row = local_nrow * rank
        plane = nx * ny

        specs = [
            (sz * plane + sy * nx + sx, sz, sy, sx)
            for (sz, sy, sx) in OFFSETS_27
            if not use_7pt or (sz * sz + sy * sy + sx * sx <= 1)
        ]
        offs = [s[0] for s in specs]
        if len(set(offs)) != len(offs):
            # degenerate tiny grids (nx or ny <= 2) alias two neighbour
            # shifts onto one diagonal: take the general CSR path
            csr = generate_stencil(nx, ny, nz, rank=rank, size=size,
                                   use_7pt=use_7pt)
            return (
                cls.from_csr(csr, policy, device=device, impl=impl,
                             compress=compress),
                csr.row_lengths,
            )
        specs.sort()  # from_csr's np.unique-sorted offset order

        # bf16 is exact for the stencil's constants
        if compress and policy.value == torch.float32:
            store_dt = torch.bfloat16
        else:
            store_dt = policy.value
        nr_pad = _grid_pad(local_nrow)
        with profiler.span("dia.build.diagonals"):
            data, counts = _stencil_dia(
                specs, nx, ny, local_nrow, total_nrow, start_row, nr_pad,
                store_dt, device,
            )
        with profiler.span("dia.build.row_counts"):
            counts = counts[:local_nrow].cpu().numpy()

        # offsets as from_csr derives them (global col - local row): they
        # include the rank's start_row shift for stacked multi-rank grids
        offsets = tuple(start_row + s[0] for s in specs)
        nnz = int(counts.sum())
        obj = cls(
            data=data,
            offsets=offsets,
            nr=local_nrow,
            nc=local_nrow,
            nnz=nnz,
            n_elems=len(specs) * local_nrow,
            nr_pad=nr_pad,
            impl=impl,
            start_row=start_row,
            total_nr=total_nrow,
            total_nnz=nnz if size == 1 else 27 * total_nrow,
        )
        return obj, counts

    @classmethod
    def from_jax_arrays(
        cls,
        data: np.ndarray,
        offsets,
        nr: int,
        nc: int,
        nnz: int,
        nr_pad: int,
        start_row: int = 0,
        total_nr: int = 0,
        total_nnz: int = 0,
        *,
        device: Device,
        impl: str,
    ) -> "DiaMatrix":
        """A DiaMatrix from the JAX package's DiaMatrix fields, passed as
        numpy arrays (``np.asarray(A.data)``), so both packages compute with
        the same matrix. The JAX data may be (ndiag, nr_pad/128, 128) and
        bf16 (an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy``
        does not take: its bits travel as uint16)."""
        device = torch.device(device)
        # a copy: arrays read from JAX are read-only, torch tensors are not
        data = np.array(data).reshape(len(offsets), nr_pad)
        if data.dtype.name == "bfloat16":
            t = torch.from_numpy(data.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(data)
        return cls(
            data=t.to(device),
            offsets=tuple(int(o) for o in offsets),
            nr=int(nr),
            nc=int(nc),
            nnz=int(nnz),
            n_elems=len(offsets) * int(nr),
            nr_pad=int(nr_pad),
            impl=resolve_impl(impl, device),
            start_row=int(start_row),
            total_nr=int(total_nr),
            total_nnz=int(total_nnz),
        )

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x for a length-nc x on this matrix's device. bf16 x is
        widened to f32 for the sum and the result narrowed back, as the JAX
        package's kernel path does (formats/dia.py:357-375)."""
        if profiler.recording():
            with profiler.span("dia.spmv", kernel="K1" if self.impl == "kernel"
                               else "torch"):
                return self._spmv(x)
        return self._spmv(x)

    def _spmv(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = x.dtype
        if out_dtype == torch.bfloat16:
            x = x.to(torch.float32)
        if self.impl == "kernel":
            y = dia_spmv(self.data, x, self.offsets, self.nr)
        else:
            y = self._spmv_torch(x)
        return y.to(out_dtype)

    def _spmv_torch(self, x: torch.Tensor) -> torch.Tensor:
        return dia_spmv_torch(self.data, x, self.offsets, self.nr)

    def spmm_kn(self, X: torch.Tensor) -> torch.Tensor:
        """Multi-RHS SpMV in the slab-major layout: X is (k, nc), returns
        (k, nr) = (A @ X.T).T, the diagonals read once for all k rows (K8,
        ops/dia_spmm.py, or its plain version). bf16 X is widened to f32
        for the sum and the result narrowed back, as ``spmv`` does (the JAX
        package's Pallas path, formats/dia.py:437-448), so row c of the
        result is ``spmv(X[c])`` bit for bit."""
        if profiler.recording():
            with profiler.span("dia.spmm", kernel="K8" if self.impl == "kernel"
                               else "torch", rhs=X.shape[0]):
                return self._spmm_kn(X)
        return self._spmm_kn(X)

    def _spmm_kn(self, X: torch.Tensor) -> torch.Tensor:
        out_dtype = X.dtype
        if out_dtype == torch.bfloat16:
            X = X.to(torch.float32)
        fn = dia_spmm if self.impl == "kernel" else dia_spmm_torch
        return fn(self.data, X.contiguous(), self.offsets, self.nr).to(
            out_dtype)
