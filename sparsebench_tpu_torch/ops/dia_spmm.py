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
  launches; the form launched (``spmm_plan``: ``staged``, ``quad``, four
  rows a thread, or ``row``) is set on the caller's open span
  (``profiler.annotate``), and while the program's recorder records, each
  launch of the staged form counts ``dia_spmm.staged``.

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


class Staged(NamedTuple):
    """The staged form's limits, as csrc/dia_spmm.cu checks them."""
    tile_rows: int = 512      # kTileRows: rows a unit, at most
    tile_step: int = 128      # kTileStep: unit rows are a multiple
    march_stages: int = 3     # kMarchStages: units a block has in flight
    stage_cols: int = 8       # kStageCols: columns a stage, at most
    smem_budget: int = 232448  # kSmemBudget: bytes of shared memory a block
    max_windows: int = 16     # kMaxWindows
    bar_bytes: int = 48       # kBarBytes: a full and an empty mbarrier a stage
    guard_bytes: int = 16     # kGuardBytes


STAGED = Staged()
# The staged form runs where a row's diagonals take fewer bytes than
# STAGE_RATIO times its X values in a stage's columns; at more the
# four-row form, reading the data with vector loads and X through L1, was
# as fast or faster on the stencils at 100^3 and 200^3 (PERF.md §6: f64
# at 1 to 3 columns, f32 diagonals under 1 column of f32).
STAGE_RATIO = 7
FORMS = {"row": 0, "quad": 1, "staged": 2}  # the entry points' ``form``


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


class Window(NamedTuple):
    """Chunks first .. first + count - 1, whose offsets lie in lo .. hi."""
    first: int
    count: int
    lo: int
    hi: int


class SpmmPlan(NamedTuple):
    """K8's gate: ``form`` (``staged``, ``quad`` or ``row``) and its
    ``chunks`` in order; the staged form's ``windows``, rows a unit
    ``rows``, columns a stage ``cols`` and the ``plane`` it marches
    through."""
    form: str
    chunks: tuple
    windows: tuple = ()
    rows: int = 0
    cols: int = 0
    plane: int = 0


def aligned_shift(start: int, length: int) -> int:
    """start + 1 - o for the o = 0 (mod 4) whose six x values o - 1 .. o + 4
    cover what four rows read through offsets start .. start + length - 1
    (o in [start + length - 2, start + 1]); -1 where there is none. A run
    of three is aligned where its centre is 0 mod 4."""
    for o in range(start + length - 2, start + 2):
        if o % QUAD == 0:
            return start + 1 - o
    return -1


def windows_of(chunks: Sequence[Chunk]) -> tuple:
    """The chunks in windows: runs of consecutive chunks, a chunk joining
    the run before it where its offsets lie within a unit's rows
    (``STAGED.tile_rows``) of the run's (a wider gap costs more to copy
    than a window of its own)."""
    out = []
    for r, c in enumerate(chunks):
        lo, hi = c.start, c.start + c.length - 1
        last = out[-1] if out else None
        if last and max(lo - last.hi, last.lo - hi, 0) <= STAGED.tile_rows:
            out[-1] = Window(last.first, last.count + 1, min(last.lo, lo),
                             max(last.hi, hi))
        else:
            out.append(Window(r, 1, lo, hi))
    return tuple(out)


def march_plane(windows: Sequence[Window], n: int) -> int:
    """P where the windows are planes the staged form marches through: two
    or more windows whose centres lie P > 0 apart, P = 0 mod 8 and n = 0
    mod P (the 27- and 7-point stencils: nx ny); else 0, and the staged
    form does not run."""
    if len(windows) < 2:
        return 0
    twice = [w.lo + w.hi for w in windows]
    d = twice[1] - twice[0]
    if any(t - twice[0] != i * d for i, t in enumerate(twice)):
        return 0
    return d // 2 if d > 0 and d % 16 == 0 and n % (d // 2) == 0 else 0


def segments(windows: Sequence[Window], plane: int, rows: int,
             x_size: int) -> tuple:
    """(lo, len) of each window's X segment for a unit of ``rows`` rows
    from row i0: X[i0 + lo .. i0 + lo + len). Every window reads one as
    wide, ``plane`` rows after the window before it, covering what its
    rows read, rounded out to 16 B."""
    e = ALIGN // x_size
    lo = min(w.lo - i * plane for i, w in enumerate(windows)) // e * e
    hi = -(-max(w.hi - i * plane for i, w in enumerate(windows)) // e) * e
    return tuple((lo + i * plane, rows + hi - lo)
                 for i in range(len(windows)))


def ring_bytes(windows: Sequence[Window], ndiag: int, rows: int, cols: int,
               sizes: tuple, plane: int) -> int:
    """Bytes of the staged form's ring: march_stages data stages of ndiag
    x rows diagonal values, and windows + march_stages - 1 X slots of
    ``cols`` columns of a segment, since a unit copies one new segment a
    column."""
    (_, length), *_ = segments(windows, plane, rows, sizes[1])
    stages = STAGED.march_stages
    return (stages * ndiag * rows * sizes[0]
            + (len(windows) + stages - 1) * cols * length * sizes[1])


def staged_shape(windows: Sequence[Window], ndiag: int, k: int,
                 sizes: tuple, plane: int):
    """(rows, cols) of the staged form: min(k, stage_cols) columns a stage
    and the most rows, a multiple of tile_step up to tile_rows, whose
    stages fit the shared memory; None where none fits."""
    cols = min(k, STAGED.stage_cols)
    for rows in range(STAGED.tile_rows, 0, -STAGED.tile_step):
        used = STAGED.bar_bytes + STAGED.guard_bytes + ring_bytes(
            windows, ndiag, rows, cols, sizes, plane)
        if used <= STAGED.smem_budget:
            return rows, cols
    return None


def staged_plan(chunks: Sequence[Chunk], n: int, nr_pad: int, k: int,
                sizes: tuple):
    """The staged form for the four-row form's ``chunks``, where it can run:
    a diagonal's row of nr_pad values is a multiple of 16 B, the chunks
    make at most ``max_windows`` windows that are planes (``march_plane``)
    and their stages fit (``staged_shape``); else None."""
    windows = windows_of(chunks)
    plane = march_plane(windows, n)
    if not (plane and len(windows) <= STAGED.max_windows
            and nr_pad * sizes[0] % ALIGN == 0):
        return None
    ndiag = sum(c.length for c in chunks)
    shape = staged_shape(windows, ndiag, k, sizes, plane)
    if shape is None:
        return None
    return SpmmPlan("staged", tuple(chunks), windows, *shape, plane)


def spmm_plan(offsets: Sequence[int], n: int, nr_pad: int, ldx: int,
              ldy: int, aligned: bool, k: int, sizes: tuple) -> SpmmPlan:
    """The chunks (runs of consecutive offsets, at most RUN each, in the
    order given) and the form, from the shapes alone (``sizes``: the data's
    and X's bytes a value):

    * ``staged`` where the four-row form's conditions hold, the staged form
      can run (``staged_plan``) and a row's diagonals take fewer bytes than
      STAGE_RATIO times its X values in a stage's columns;
    * ``quad``, four rows a thread, where n, nr_pad, ldx and ldy are
      multiples of 4 and ``aligned`` (data, X and Y start 16 B aligned);
    * else ``row``, one row a thread, every chunk read as scalars.

    The staged and four-row forms read each chunk with its
    ``aligned_shift``."""
    chunks = []
    for d, off in enumerate(int(o) for o in offsets):
        last = chunks[-1] if chunks else None
        if last and last.length < RUN and off == last.start + last.length:
            chunks[-1] = last._replace(length=last.length + 1)
        else:
            chunks.append(Chunk(d, 1, off))
    if not (aligned and all(v % QUAD == 0 for v in (n, nr_pad, ldx, ldy))):
        return SpmmPlan("row", tuple(chunks))
    chunks = tuple(c._replace(shift=aligned_shift(c.start, c.length))
                   for c in chunks)
    plan = staged_plan(chunks, n, nr_pad, k, sizes)
    if plan is None or (len(offsets) * sizes[0]
                        >= STAGE_RATIO * plan.cols * sizes[1]):
        return SpmmPlan("quad", chunks)
    return plan


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


_I64P, _I32P = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
# the C entry points' arguments: data, X, Y, n, nr_pad, k, ldx, ldy, form,
# chunks, start, d0, length, shift, layout, stream
ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int]
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [_I64P]
            + [_I32P] * 3 + [_I64P, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("dia_spmm")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def plan_args(plan: SpmmPlan, x_size: int) -> tuple:
    """A plan as the C entry points take it: the form's number, the chunk
    count, the start, d0, length and shift arrays, and the staged form's
    layout (rows, cols, plane, the window count, then each window's first
    chunk and its segment's lo and len; None in the other forms)."""
    cols = list(zip(*plan.chunks))
    n = len(plan.chunks)
    layout = None
    if plan.form == "staged":
        segs = segments(plan.windows, plan.plane, plan.rows, x_size)
        vals = [plan.rows, plan.cols, plan.plane, len(plan.windows)]
        for w, (lo, length) in zip(plan.windows, segs):
            vals += [w.first, lo, length]
        layout = (ctypes.c_longlong * len(vals))(*vals)
    return (FORMS[plan.form], n, (ctypes.c_longlong * n)(*cols[2]),
            *((ctypes.c_int * n)(*cols[i]) for i in (0, 1, 3)), layout)


@functools.lru_cache(maxsize=None)
def _plan_args(offsets: tuple, n: int, nr_pad: int, ldx: int, ldy: int,
               aligned: bool, k: int, sizes: tuple) -> tuple:
    """(form, ``plan_args`` of ``spmm_plan``), once a shape."""
    plan = spmm_plan(offsets, n, nr_pad, ldx, ldy, aligned, k, sizes)
    return plan.form, plan_args(plan, sizes[1])


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
    form, plan = _plan_args(offsets, nr, data.shape[1], X.shape[1], nr,
                            aligned, k, (data.element_size(), X.element_size()))
    profiler.annotate(form=form)
    with torch.cuda.device(X.device):
        err = getattr(lib, name)(
            data.data_ptr(), X.data_ptr(), Y.data_ptr(), nr, data.shape[1], k,
            X.shape[1], nr, *plan,
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    _build.check(lib, err, "dia_spmm")
    dia_spmm.launches += 1
    if form == "staged":
        profiler.count("dia_spmm.staged")
    return Y


dia_spmm.launches = 0

# the registry's entry (profiler.kernels): one row a thread, four, or
# the staged form
KERNELS = (Kernel("K8", ("dia_spmm_kernel", "dia_spmm_quad_kernel",
                         "dia_spmm_kernel_staged"),
                  "SpMV kernels", (dia_spmm,)),)
