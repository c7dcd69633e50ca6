"""DIA SpMV: the hand-written CUDA kernel and its plain PyTorch version.

Counterpart of sparsebench_tpu/ops/dia_pallas.py (``dia_spmv_pallas``).
The kernel is ``csrc/dia_spmv.cu``; its source note says what bounds it and
why its design differs from the TPU kernel's.

* ``dia_spmv_torch(data, x, offsets, nr)`` — the plain version: the same
  shifted-slice sum as the JAX package's ``DiaMatrix._spmv_xla``
  (formats/dia.py:377-388).
* ``dia_spmv(data, x, offsets, nr)`` — the wrapper. A CPU tensor goes to
  the plain version; a CUDA tensor launches the kernel or raises. There is
  no fallback from one to the other. ``dia_spmv.launches`` counts kernel
  launches.

Both take ``data`` of shape (ndiag, nr_pad) (row i of diagonal d at
``data[d, i]``, zero beyond the matrix) and a length >= nr ``x``, of which
the first ``nr`` entries are used (DIA matrices are square); they return y
of length nr in x's dtype, summing the diagonals in the order given.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.profiler import Kernel

MAX_DIAGS = 64  # kMaxDiags in csrc/dia_spmv.cu; DIA's max_diags default

# (data dtype, x dtype) -> C entry point in csrc/dia_spmv.cu
_ENTRY = {
    (torch.bfloat16, torch.float32): "sb_dia_spmv_bf16_f32",
    (torch.float32, torch.float32): "sb_dia_spmv_f32_f32",
    (torch.float64, torch.float64): "sb_dia_spmv_f64_f64",
}


def dia_spmv_torch(data: torch.Tensor, x: torch.Tensor,
                   offsets: Sequence[int], nr: int) -> torch.Tensor:
    """Plain version: y = sum_d data[d, :nr] * x_padded[off_d : off_d + nr],
    accumulated in x's dtype (the diagonals may be stored in bf16)."""
    x = x[:nr]
    lo = -min(0, min(offsets))
    hi = max(0, max(offsets))
    xp = F.pad(x, (lo, hi))
    y = torch.zeros(nr, dtype=x.dtype, device=x.device)
    for d, off in enumerate(offsets):
        y = y + data[d, :nr].to(x.dtype) * xp[lo + off : lo + off + nr]
    return y


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("dia_spmv")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, i64, i64, i32, ctypes.POINTER(i64), p]
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _offsets_arg(offsets: tuple):
    return (ctypes.c_longlong * len(offsets))(*offsets)


def dia_spmv(data: torch.Tensor, x: torch.Tensor,
             offsets: Sequence[int], nr: int) -> torch.Tensor:
    """DIA SpMV: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (see module docstring)."""
    if data.device.type == "cpu" and x.device.type == "cpu":
        return dia_spmv_torch(data, x, offsets, nr)
    if data.device.type != "cuda" or x.device != data.device:
        raise ValueError(
            f"dia_spmv: data on {data.device} and x on {x.device}; both must "
            "be on one CUDA device (or both on the CPU)"
        )
    name = _ENTRY.get((data.dtype, x.dtype))
    if name is None:
        raise TypeError(
            f"dia_spmv: no kernel for data {data.dtype} with x {x.dtype}; "
            f"supported (data, x): {list(_ENTRY)}"
        )
    offsets = tuple(int(o) for o in offsets)
    ndiag = len(offsets)
    if not 0 < ndiag <= MAX_DIAGS or data.dim() != 2 or data.shape[0] != ndiag:
        raise ValueError(
            f"dia_spmv: data {tuple(data.shape)} must be (ndiag, nr_pad) with "
            f"ndiag = len(offsets) = {ndiag} in 1..{MAX_DIAGS}"
        )
    if not 0 < nr <= data.shape[1] or x.dim() != 1 or x.shape[0] < nr:
        raise ValueError(
            f"dia_spmv: nr={nr} needs 0 < nr <= nr_pad={data.shape[1]} and a "
            f"1-D x of length >= nr, got x {tuple(x.shape)}"
        )
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_spmv: data and x must be contiguous")
    lib = _library()
    y = torch.empty(nr, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            data.data_ptr(), x.data_ptr(), y.data_ptr(), nr, data.shape[1],
            ndiag, _offsets_arg(offsets),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "dia_spmv")
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0

# the registry's entry (profiler.kernels)
KERNELS = (Kernel("K1", ("dia_spmv_kernel",), "SpMV kernels", (dia_spmv,)),)
