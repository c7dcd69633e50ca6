"""DIA times a block of vectors (multi-RHS SpMV): the hand-written CUDA
kernel K8 and its plain PyTorch version.

Counterpart of sparsebench_tpu/ops/dia_pallas.py (``dia_spmm_pallas``).
The kernel is ``csrc/dia_spmm.cu``; its source note says what bounds it and
why its design differs from the TPU kernel's.

* ``dia_spmm_torch(data, X, offsets, nr)`` — the plain version: the
  shifted-slice sum of the JAX package's ``DiaMatrix.spmm_kn`` XLA path
  (formats/dia.py:418-429), each diagonal broadcast over the k rows of X.
* ``dia_spmm(data, X, offsets, nr)`` — the wrapper. CPU tensors go to the
  plain version; CUDA tensors launch the kernel or raise. There is no
  fallback from one to the other. ``dia_spmm.launches`` counts kernel
  launches; the form launched (``quad``: four rows a thread, or ``row``)
  is set on the caller's open span (``profiler.annotate``).

Both take ``data`` of shape (ndiag, nr_pad), as ``dia_spmv`` does, and a
slab-major X of shape (k, >= nr), of which the first ``nr`` entries of each
row are used; they return Y of shape (k, nr) in X's dtype, row c of Y being
A X[c] summed over the diagonals in the order given — bit for bit what
``dia_spmv`` gives on X[c].
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.ops.dia_spmv import MAX_DIAGS
from sparsebench_tpu_torch.profiler import Kernel

# (data dtype, X dtype) -> C entry point in csrc/dia_spmm.cu
_ENTRY = {
    (torch.bfloat16, torch.float32): "sb_dia_spmm_bf16_f32",
    (torch.float32, torch.float32): "sb_dia_spmm_f32_f32",
    (torch.float64, torch.float64): "sb_dia_spmm_f64_f64",
}


RUN = 4   # diagonals a chunk, at most (csrc/dia_spmm.cu kRun)
QUAD = 4  # rows a thread in the four-row form (kQuad)
ALIGN = 16  # bytes: the four-row form's vector loads and stores


class Chunk(NamedTuple):
    """Diagonals d0 .. d0 + length - 1, with the consecutive offsets start ..
    start + length - 1. ``shift`` >= 0: in the four-row form the chunk reads
    x as one aligned vector a column, at offset o = start + 1 - shift (o = 0
    mod 4), beside the value before it and the one after it; -1: as
    scalars."""
    d0: int
    length: int
    start: int
    shift: int = -1


class SpmmPlan(NamedTuple):
    """K8's gate: ``quad`` runs the four-row form; ``chunks`` in order."""
    quad: bool
    chunks: tuple


def aligned_shift(start: int, length: int) -> int:
    """start + 1 - o for the o = 0 (mod 4) whose six x values o - 1 .. o + 4
    cover what four rows read through offsets start .. start + length - 1
    (o in [start + length - 2, start + 1]); -1 where there is none. A run
    of three is aligned where its centre is 0 mod 4."""
    for o in range(start + length - 2, start + 2):
        if o % QUAD == 0:
            return start + 1 - o
    return -1


def spmm_plan(offsets: Sequence[int], n: int, nr_pad: int, ldx: int,
              ldy: int, aligned: bool) -> SpmmPlan:
    """The chunks (runs of consecutive offsets, at most RUN each, in the
    order given) and the form: four rows a thread where n, nr_pad, ldx and
    ldy are multiples of 4 and ``aligned`` (data, X and Y start 16 B
    aligned), each chunk with its ``aligned_shift``; else one row a thread,
    every chunk read as scalars."""
    chunks = []
    for d, off in enumerate(int(o) for o in offsets):
        last = chunks[-1] if chunks else None
        if last and last.length < RUN and off == last.start + last.length:
            chunks[-1] = last._replace(length=last.length + 1)
        else:
            chunks.append(Chunk(d, 1, off))
    quad = aligned and all(v % QUAD == 0 for v in (n, nr_pad, ldx, ldy))
    if quad:
        chunks = [c._replace(shift=aligned_shift(c.start, c.length))
                  for c in chunks]
    return SpmmPlan(quad, tuple(chunks))


def dia_spmm_torch(data: torch.Tensor, X: torch.Tensor,
                   offsets: Sequence[int], nr: int) -> torch.Tensor:
    """Plain version: Y = sum_d data[d, :nr] * Xp[:, off_d : off_d + nr],
    accumulated in X's dtype (the diagonals may be stored in bf16)."""
    X = X[:, :nr]
    lo = -min(0, min(offsets))
    hi = max(0, max(offsets))
    Xp = F.pad(X, (lo, hi))
    Y = torch.zeros((X.shape[0], nr), dtype=X.dtype, device=X.device)
    for d, off in enumerate(offsets):
        Y = Y + data[d, :nr].to(X.dtype)[None, :] * Xp[:, lo + off:lo + off + nr]
    return Y


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("dia_spmm")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        # data, X, Y, n, nr_pad, k, ldx, ldy, quad, chunks, start, d0,
        # length, shift, stream
        fn.argtypes = [p, p, p, i64, i64, i32, i64, i64, i32, i32,
                       ctypes.POINTER(i64)] + [ctypes.POINTER(i32)] * 3 + [p]
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _plan_args(offsets: tuple, n: int, nr_pad: int, ldx: int, ldy: int,
               aligned: bool) -> tuple:
    """``spmm_plan`` as the C entry points take it, once a shape: quad, the
    chunk count and the start, d0, length and shift arrays."""
    plan = spmm_plan(offsets, n, nr_pad, ldx, ldy, aligned)
    cols = list(zip(*plan.chunks))
    n = len(plan.chunks)
    return (int(plan.quad), n, (ctypes.c_longlong * n)(*cols[2]),
            *((ctypes.c_int * n)(*cols[i]) for i in (0, 1, 3)))


def dia_spmm(data: torch.Tensor, X: torch.Tensor,
             offsets: Sequence[int], nr: int) -> torch.Tensor:
    """Multi-RHS DIA SpMV: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see module docstring)."""
    if data.device.type == "cpu" and X.device.type == "cpu":
        return dia_spmm_torch(data, X, offsets, nr)
    if data.device.type != "cuda" or X.device != data.device:
        raise ValueError(
            f"dia_spmm: data on {data.device} and X on {X.device}; both must "
            "be on one CUDA device (or both on the CPU)"
        )
    name = _ENTRY.get((data.dtype, X.dtype))
    if name is None:
        raise TypeError(
            f"dia_spmm: no kernel for data {data.dtype} with X {X.dtype}; "
            f"supported (data, X): {list(_ENTRY)}"
        )
    offsets = tuple(int(o) for o in offsets)
    ndiag = len(offsets)
    if not 0 < ndiag <= MAX_DIAGS or data.dim() != 2 or data.shape[0] != ndiag:
        raise ValueError(
            f"dia_spmm: data {tuple(data.shape)} must be (ndiag, nr_pad) with "
            f"ndiag = len(offsets) = {ndiag} in 1..{MAX_DIAGS}"
        )
    if (not 0 < nr <= data.shape[1] or X.dim() != 2 or X.shape[0] < 1
            or X.shape[1] < nr):
        raise ValueError(
            f"dia_spmm: nr={nr} needs 0 < nr <= nr_pad={data.shape[1]} and a "
            f"(k, >= nr) X with k >= 1, got X {tuple(X.shape)}"
        )
    if not (data.is_contiguous() and X.is_contiguous()):
        raise ValueError("dia_spmm: data and X must be contiguous")
    lib = _library()
    k = X.shape[0]
    Y = torch.empty((k, nr), dtype=X.dtype, device=X.device)
    aligned = all(t.data_ptr() % ALIGN == 0 for t in (data, X, Y))
    plan = _plan_args(offsets, nr, data.shape[1], X.shape[1], nr, aligned)
    profiler.annotate(form="quad" if plan[0] else "row")
    with torch.cuda.device(X.device):
        err = getattr(lib, name)(
            data.data_ptr(), X.data_ptr(), Y.data_ptr(), nr, data.shape[1], k,
            X.shape[1], nr, *plan,
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    _build.check(lib, err, "dia_spmm")
    dia_spmm.launches += 1
    return Y


dia_spmm.launches = 0

# the registry's entry (profiler.kernels): one row a thread, or four
KERNELS = (Kernel("K8", ("dia_spmm_kernel", "dia_spmm_quad_kernel"),
                  "SpMV kernels", (dia_spmm,)),)
