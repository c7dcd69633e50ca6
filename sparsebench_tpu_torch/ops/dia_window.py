"""DIA SpMV window schedules: the hand-written CUDA kernels P1 (dia_micro's
variants) and P2 (dia_shear's) and their plain PyTorch version (counterpart
of benchmarks/dia_micro.py ``run_variant`` and benchmarks/dia_shear.py
``run``).

The kernels are ``csrc/dia_window.cu``, one body under two entries; its
source note says what bounds them. For nd diagonals with non-negative
shifts s_d = 128 q + r, x f32 (1-D) and data bf16 (nd, n_rows, 128), both
compute y (n_rows, 128), flat index i = 128 j + l:

    y[i] = sum over the plan (q, r, d) of f32(data[d, i]) * x[s_d + i]

in plan order (``shift_plan``: sorted by (q, r, d)), each product and sum
rounded on its own. What the TPU variants become on the card:

    TPU variant (P1)             card schedule   reads
    roll1, carry_roll            direct          x[s_d + i] from device memory
    grp_carry, grp_align         grouped         each q-group's window staged
                                                 once in shared memory, read
                                                 at lane offset r
    qfloor                       qfloor          x[128 q + i]  (lower bound,
    floor                        floor           x[i]           wrong result)
    TPU variant (P2)
    roll                         direct          as above, on P2's chunked x
    shear_chunk                  shear           grouped, staged by cp.async

* ``dia_window_torch(x1d, data3d, shifts, schedule)`` — the plain version of
  every card schedule above, the kernels' bit-exact reference.
* ``dia_window(x1d, data3d, shifts, schedule, rows)`` — P1: ``schedule``
  one of ``SCHEDULES``; ``rows`` the TPU tile height, a multiple of 8
  dividing n_rows.
* ``dia_shear(x1d, data3d, shifts, variant, rows, tpc)`` — P2: ``variant``
  "roll" or "shear_chunk"; x is P2's layout, ``tpc`` tiles of ``rows`` rows
  a chunk, (n_chunks tpc rows + span + 8) 128 floats.

Both wrappers run the plain version for CPU tensors and the kernel for CUDA
tensors, and refuse (ValueError, naming the size) an x that does not hold
every read, (n_rows + q_max + 1) 128 floats, and for P2 one shorter than the
(rows, tpc) layout. The card stages by q-group a piece of 8 rows at a time
(9 KB a block), so no (rows, tpc) is refused for its staging: the TPU's
whole chunk window (316 KiB of span alone at 200^3) is what does not fit a
block's shared memory. ``dia_window.launches`` and ``dia_shear.launches``
count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from sparsebench_tpu_torch.ops import _build

LANES = 128
PIECE_ROWS = 8   # rows a staged kernel block computes (csrc kPieceRows)
MAX_DIAGS = 64   # csrc kMaxDiags

SCHEDULES = ("direct", "grouped", "qfloor", "floor")
SHEAR_VARIANTS = ("roll", "shear_chunk")
# the card schedule that stands for each TPU variant
TPU_SCHEDULE = {
    "roll1": "direct", "carry_roll": "direct",
    "grp_carry": "grouped", "grp_align": "grouped",
    "qfloor": "qfloor", "floor": "floor",
    "roll": "direct", "shear_chunk": "shear",
}
EXACT = ("direct", "grouped", "shear")
_P1_CODE = {"direct": 0, "grouped": 1, "qfloor": 2, "floor": 3}
_P2_CODE = {"roll": 0, "shear_chunk": 1}


def shift_plan(shifts: Sequence[int]) -> list:
    """[(q, r, d)] sorted by (q, r, d): the summation order."""
    return sorted((s // LANES, s % LANES, d) for d, s in enumerate(shifts))


def _offset(schedule: str, q: int, r: int) -> int:
    if schedule == "qfloor":
        return q * LANES
    if schedule == "floor":
        return 0
    return q * LANES + r


def _check(name: str, x1d: torch.Tensor, data3d: torch.Tensor,
           shifts: Sequence[int], rows: int) -> int:
    """Validate; return n_rows."""
    if x1d.dim() != 1 or x1d.dtype != torch.float32:
        raise ValueError(f"{name}: x1d must be 1-D f32, got {x1d.dtype} "
                         f"{tuple(x1d.shape)}")
    if (data3d.dim() != 3 or data3d.dtype != torch.bfloat16
            or data3d.shape[2] != LANES or data3d.shape[0] != len(shifts)):
        raise ValueError(
            f"{name}: data3d must be bf16 ({len(shifts)}, n_rows, {LANES}), "
            f"got {data3d.dtype} {tuple(data3d.shape)}")
    if not 0 < len(shifts) <= MAX_DIAGS or min(shifts) < 0:
        raise ValueError(f"{name}: 1 to {MAX_DIAGS} non-negative shifts, got "
                         f"{len(shifts)} (min {min(shifts, default=None)})")
    n_rows = data3d.shape[1]
    if rows <= 0 or rows % PIECE_ROWS or n_rows % rows or n_rows == 0:
        raise ValueError(
            f"{name}: the tile height rows={rows} must be a positive multiple "
            f"of {PIECE_ROWS} dividing n_rows={n_rows}")
    need = (n_rows + max(shifts) // LANES + 1) * LANES
    if x1d.numel() < need:
        raise ValueError(
            f"{name}: x holds {x1d.numel()} floats; the window of {n_rows} "
            f"rows at shift {max(shifts)} reads {need} ((n_rows + q_max + 1) "
            f"x {LANES})")
    return n_rows


def dia_window_torch(x1d: torch.Tensor, data3d: torch.Tensor,
                     shifts: Sequence[int], schedule: str) -> torch.Tensor:
    """Plain version of a card schedule (``SCHEDULES`` or "shear"): y
    (n_rows, 128) f32, in plan order (module docstring)."""
    if schedule not in SCHEDULES + ("shear",):
        raise ValueError(f"unknown DIA window schedule {schedule!r}; "
                         f"{SCHEDULES + ('shear',)}")
    n_rows = data3d.shape[1]
    n_out = n_rows * LANES
    planes = data3d.reshape(len(shifts), n_out)
    acc = None
    for q, r, d in shift_plan(shifts):
        off = _offset(schedule, q, r)
        term = planes[d].to(torch.float32) * x1d[off: off + n_out]
        acc = term if acc is None else acc + term
    return acc.view(n_rows, LANES)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("dia_window")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # x, data, y, plan, nd, n_rows, schedule, stream
    for fn in (lib.sb_dia_window_f32, lib.sb_dia_shear_f32):
        fn.argtypes = [p, p, p, p, i32, i64, i32, p]
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _plan_tensor(shifts: Tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """(nd, 2) int32 [shift, diagonal] in plan order, on the device (made
    once per shifts and device, so that a captured launch copies nothing)."""
    rows = [(q * LANES + r, d) for q, r, d in shift_plan(shifts)]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _launch(name: str, entry: str, code: int, x1d: torch.Tensor,
            data3d: torch.Tensor, shifts: Sequence[int],
            n_rows: int) -> torch.Tensor:
    dev = x1d.device
    if dev.type != "cuda" or data3d.device != dev:
        raise ValueError(
            f"{name}: the kernel runs on one CUDA device and got x on {dev}, "
            f"data on {data3d.device}")
    if not (x1d.is_contiguous() and data3d.is_contiguous()):
        raise ValueError(f"{name}: x1d and data3d must be contiguous")
    if x1d.data_ptr() % 16:
        raise ValueError(f"{name}: x1d must be 16 B aligned (cp.async rows)")
    plan = _plan_tensor(tuple(int(s) for s in shifts), dev)
    lib = _library()
    y = torch.empty((n_rows, LANES), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            x1d.data_ptr(), data3d.data_ptr(), y.data_ptr(), plan.data_ptr(),
            len(shifts), n_rows, code,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, name)
    return y


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def dia_window(x1d: torch.Tensor, data3d: torch.Tensor,
               shifts: Sequence[int], schedule: str,
               rows: int) -> torch.Tensor:
    """P1: y (n_rows, 128) of ``schedule`` (one of ``SCHEDULES``): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if schedule not in SCHEDULES:
        raise ValueError(f"dia_window: {schedule!r} is not a P1 schedule "
                         f"{SCHEDULES}; shear is dia_shear's")
    n_rows = _check("dia_window", x1d, data3d, shifts, rows)
    if _on_cpu(x1d, data3d):
        return dia_window_torch(x1d, data3d, shifts, schedule)
    y = _launch("dia_window", "sb_dia_window_f32", _P1_CODE[schedule], x1d,
                data3d, shifts, n_rows)
    dia_window.launches += 1
    return y


def shear_x_floats(n_rows: int, rows: int, tpc: int, span: int) -> int:
    """Floats of P2's x: whole chunks of ``tpc`` tiles plus span + 8 rows."""
    n_chunks = -(-(n_rows // rows) // tpc)
    return (n_chunks * tpc * rows + span + 8) * LANES


def dia_shear(x1d: torch.Tensor, data3d: torch.Tensor, shifts: Sequence[int],
              variant: str, rows: int, tpc: int) -> torch.Tensor:
    """P2: y (n_rows, 128) of ``variant`` ("roll" or "shear_chunk"): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if variant not in SHEAR_VARIANTS:
        raise ValueError(f"dia_shear: unknown variant {variant!r}; "
                         f"{SHEAR_VARIANTS}")
    n_rows = _check("dia_shear", x1d, data3d, shifts, rows)
    span = -(-(max(shifts) // LANES + 2) // 8) * 8
    need = shear_x_floats(n_rows, rows, tpc, span) if tpc > 0 else None
    if need is None or x1d.numel() < need:
        raise ValueError(
            f"dia_shear: tpc={tpc} must be positive and x must hold the "
            f"(rows={rows}, tpc={tpc}) layout's {need} floats; got "
            f"{x1d.numel()}")
    if _on_cpu(x1d, data3d):
        return dia_window_torch(x1d, data3d, shifts, TPU_SCHEDULE[variant])
    y = _launch("dia_shear", "sb_dia_shear_f32", _P2_CODE[variant], x1d,
                data3d, shifts, n_rows)
    dia_shear.launches += 1
    return y


dia_window.launches = 0
dia_shear.launches = 0
