"""CRS SpMV: the hand-written CUDA kernel K14 and the plain PyTorch version.

The JAX package has no kernel here (its CRS SpMV is XLA's gather and
segment sum, sparsebench_tpu/formats/crs.py). The kernel is
``csrc/crs_spmv.cu``; its source note says how it is laid out and what
bounds it. A matrix is ``val`` (nnz,), ``col`` (nnz,) and ``row_ptr``
(nr + 1,), rows in order (formats/crs.py).

* ``crs_spmv_torch(val, col, row_ptr, x)`` — the plain version, the port's
  CRS SpMV before K14: a gather of x by column (``index_select``, cast to
  the values' dtype), the products, and a segment sum over the row pointers
  (``segment_reduce``). Its result has the values' dtype.
* ``crs_spmv(val, col, row_ptr, x)`` — K14 where ``kernel_applies``: CUDA
  tensors on one device, values and x both f32 or both f64, int32 columns,
  and int32 row pointers with at most ``NARROW_ENTRIES`` entries (K14's
  narrow form) or int64 ones (its wide form, for larger matrices,
  ``formats/crs.py``). Every other combination on a card (bf16 values or
  vectors, values of another dtype than x, int64 columns, int32 row
  pointers over more entries) and every CPU tensor takes the plain
  version, as before K14; that choice is made from the dtypes, the entry
  count and the devices alone, never from the operands' layout or a
  failed launch. Where K14
  applies, a strided 1-D x is launched on a contiguous copy, and operands
  of another shape or non-contiguous ``val``, ``col`` or ``row_ptr`` raise
  ``ValueError``.
  K14 sums each row in stored order, the plain version in torch's order,
  so the two agree to the rounding bound of a row's sum; the two forms of
  K14 sum in the same order, so they agree bit for bit.

``crs_spmv.launches`` counts K14's launches, of either form; while the
program's recorder records, each launch also counts ``crs_spmv.launches``
there, and a launch of the wide form ``crs_spmv.wide`` besides.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.profiler import Kernel

# the most entries of K14's narrow form: its chunk loop steps an int chunk
# start by kChunk = 1536 entries (csrc/crs_spmv.cu) past the last entry
NARROW_ENTRIES = 2**31 - 1 - 1536
# (values and x dtype, row pointers dtype) -> C entry point in
# csrc/crs_spmv.cu: the narrow form with int32 row pointers, the wide one
# with int64
_ENTRY = {
    (torch.float32, torch.int32): "sb_crs_spmv_f32",
    (torch.float64, torch.int32): "sb_crs_spmv_f64",
    (torch.float32, torch.int64): "sb_crs_spmv_wide_f32",
    (torch.float64, torch.int64): "sb_crs_spmv_wide_f64",
}


def crs_spmv_torch(val: torch.Tensor, col: torch.Tensor,
                   row_ptr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version: y[i] = sum of val[j] * x[col[j]] over row i's entries,
    in the values' dtype (x is cast to it)."""
    nr = row_ptr.numel() - 1
    if val.numel() == 0:
        return torch.zeros(nr, dtype=val.dtype, device=x.device)
    prod = val * torch.index_select(x, 0, col).to(val.dtype)
    return torch.segment_reduce(prod, "sum", offsets=row_ptr)


def kernel_applies(val: torch.Tensor, col: torch.Tensor,
                   row_ptr: torch.Tensor, x: torch.Tensor) -> bool:
    """Whether ``crs_spmv`` launches K14 for these operands (module
    docstring)."""
    return (val.device.type == "cuda" and x.device == val.device
            and col.device == val.device and row_ptr.device == val.device
            and (val.dtype, row_ptr.dtype) in _ENTRY and x.dtype == val.dtype
            and col.dtype == torch.int32
            and (row_ptr.dtype == torch.int64 or val.numel() <= NARROW_ENTRIES))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("crs_spmv")
    p = ctypes.c_void_p
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return lib


def crs_spmv(val: torch.Tensor, col: torch.Tensor, row_ptr: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A x: K14 where ``kernel_applies``, else the plain version."""
    if not kernel_applies(val, col, row_ptr, x):
        return crs_spmv_torch(val, col, row_ptr, x)
    nr = row_ptr.numel() - 1
    if (val.dim() != 1 or col.shape != val.shape or row_ptr.dim() != 1
            or x.dim() != 1
            or not (val.is_contiguous() and col.is_contiguous()
                    and row_ptr.is_contiguous())):
        raise ValueError(
            f"crs_spmv: val {tuple(val.shape)} and col {tuple(col.shape)} "
            f"must be contiguous (nnz,), row_ptr {tuple(row_ptr.shape)} "
            f"contiguous (nr + 1,) and x {tuple(x.shape)} (nc,)")
    x = x.contiguous()
    if nr == 0 or val.numel() == 0:
        return torch.zeros(nr, dtype=val.dtype, device=x.device)
    lib = _library()
    y = torch.empty(nr, dtype=val.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(lib, _ENTRY[val.dtype, row_ptr.dtype])(
            val.data_ptr(), col.data_ptr(), row_ptr.data_ptr(), x.data_ptr(),
            y.data_ptr(), nr, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "crs_spmv")
    crs_spmv.launches += 1
    profiler.count("crs_spmv.launches")
    if row_ptr.dtype == torch.int64:
        profiler.count("crs_spmv.wide")
    return y


crs_spmv.launches = 0

# the registry's entry (profiler.kernels)
KERNELS = (Kernel("K14", ("crs_spmv_kernel", "crs_spmv_wide_kernel"),
                  "SpMV kernels", (crs_spmv,)),)
