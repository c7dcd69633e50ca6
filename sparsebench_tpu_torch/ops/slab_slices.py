"""Slice loops of the slab SpMV: the hand-written CUDA kernels P3 (slab_micro's
variants, (8, 128) slices) and P4 (slab_micro2's, (SUB, 128) slices) and their
plain PyTorch version (counterpart of benchmarks/slab_micro.py and
benchmarks/slab_micro2.py ``run_variant``).

The kernel is ``csrc/slab_slices.cu``, one body under two wrappers; its source
note says what bounds it. Arrays (T tiles, S slices, SUB rows a slice):

    meta  (T, S, W) int32        W = 2 (slab base, lane rotation r) or 8
                                 (scatter8: a row per sublane)
    x2d   (x_rows, 128) f32      the x table
    vals  (T, S, SUB, 128)       bf16 or f32
    lidx  (T, S, SUB, 128) int8  lane indices

and y (T, SUB, 128) f32, from 0, slice after slice in order, each product
and sum rounded on its own:

    y[t, s, l] += f32(vals[t, p, s, l]) * x2d[row, lane]

with the row and lane of the variant's table and lane modes (``P3`` and
``P4`` below; the source note lists them). A row or lane outside the table
reads NaN. P4's ``sum`` adds f32(vals) and reads no x.

* ``slab_slices_torch(meta, x2d, vals, lidx, table, lane)`` — the plain
  version, the kernel's bit-exact reference.
* ``slab_slices(meta, x2d, vals, lidx, variant)`` — P3, SUB = 8, ``variant``
  a key of ``P3``.
* ``slab_slices_tall(meta, x2d, vals, lidx, variant)`` — P4, SUB from vals
  (even), ``variant`` a key of ``P4``.

Both run the plain version for CPU tensors and the kernel for CUDA tensors
(or raise). ``slab_slices.launches`` and ``slab_slices_tall.launches``
count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sparsebench_tpu_torch.ops import _build

LANES = 128
SUBLANES = 8

# variant -> (table mode, lane mode); aff_roll and P4's roll rotate the
# table by -r (pltpu.roll), the same lanes as the affine gather
P3 = {
    "scatter8": ("scatter8", "lidx"),
    "slab_u": ("slab", "lidx"),
    "slab_a": ("slab", "lidx"),
    "aff_u": ("slab", "affine"),
    "aff_roll": ("slab", "affine"),
    "floor": ("slab", "identity"),
    "fixed": ("fixed", "lidx"),
    "noload": ("fixed", "lidx"),
}
P4 = {
    "sum": ("none", "identity"),
    "floor": ("slab", "identity"),
    "roll": ("slab", "affine"),
    "gather": ("slab", "lidx"),
}
_TABLE = {"scatter8": 0, "slab": 1, "fixed": 2, "none": 3}
_LANE = {"lidx": 0, "affine": 1, "identity": 2}
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _check(name: str, meta: torch.Tensor, x2d: torch.Tensor,
           vals: torch.Tensor, lidx: torch.Tensor, table: str,
           lane: str) -> None:
    if vals.dim() != 4 or vals.shape[3] != LANES or vals.dtype not in _SUFFIX:
        raise ValueError(
            f"{name}: vals must be bf16 or f32 (T, S, SUB, {LANES}), got "
            f"{vals.dtype} {tuple(vals.shape)}")
    T, S, sub, _ = vals.shape
    if min(T, S) <= 0 or sub <= 0 or sub % 2:
        raise ValueError(f"{name}: T={T}, S={S} must be positive and SUB={sub}"
                         " positive and even")
    if tuple(lidx.shape) != tuple(vals.shape) or lidx.dtype != torch.int8:
        raise ValueError(f"{name}: lidx must be int8 {tuple(vals.shape)}, got "
                         f"{lidx.dtype} {tuple(lidx.shape)}")
    need_w = sub if table == "scatter8" else 2 if lane == "affine" else 1
    if (meta.dim() != 3 or tuple(meta.shape[:2]) != (T, S)
            or meta.dtype != torch.int32 or meta.shape[2] < need_w):
        raise ValueError(
            f"{name}: meta must be int32 ({T}, {S}, >= {need_w}) for table "
            f"{table!r} and lanes {lane!r}, got {meta.dtype} "
            f"{tuple(meta.shape)}")
    if x2d.dim() != 2 or x2d.shape[1] != LANES or x2d.dtype != torch.float32:
        raise ValueError(f"{name}: x2d must be f32 (rows, {LANES}), got "
                         f"{x2d.dtype} {tuple(x2d.shape)}")


def slab_slices_torch(meta: torch.Tensor, x2d: torch.Tensor,
                      vals: torch.Tensor, lidx: torch.Tensor, table: str,
                      lane: str) -> torch.Tensor:
    """Plain version: y (T, SUB, 128) f32 (module docstring)."""
    T, S, sub, _ = vals.shape
    dev = vals.device
    acc = torch.zeros((T, sub, LANES), dtype=torch.float32, device=dev)
    s_idx = torch.arange(sub, device=dev)
    l_idx = torch.arange(LANES, device=dev)
    xf = x2d.reshape(-1)
    nan = torch.full((), float("nan"), device=dev)
    for p in range(S):
        v = vals[:, p].to(torch.float32)
        if table == "none":
            acc = acc + v
            continue
        if table == "scatter8":
            rows = meta[:, p, :sub].long()
        elif table == "slab":
            rows = meta[:, p, :1].long() + s_idx
        else:
            rows = s_idx.expand(T, sub)
        if lane == "lidx":
            lanes = lidx[:, p].long()
        elif lane == "affine":
            lanes = ((l_idx + meta[:, p, 1:2, None].long()) & (LANES - 1)
                     ).expand(T, sub, LANES)
        else:
            lanes = l_idx.expand(T, sub, LANES)
        rows = rows[:, :, None].expand(T, sub, LANES)
        ok = ((rows >= 0) & (rows < x2d.shape[0]) & (lanes >= 0)
              & (lanes < LANES))
        g = xf[torch.where(ok, rows * LANES + lanes, 0)]
        acc = acc + v * torch.where(ok, g, nan)
    return acc


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("slab_slices")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    # meta, meta_w, x, x_rows, vals, lidx, y, n_tiles, s_max, sub, table,
    # lane, stream
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"sb_slab_slices_{sfx}")
        fn.argtypes = [p, i32, p, i32, p, p, p, i32, i32, i32, i32, i32, p]
        fn.restype = i32
    return lib


def _run(name: str, meta: torch.Tensor, x2d: torch.Tensor,
         vals: torch.Tensor, lidx: torch.Tensor, table: str,
         lane: str) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    _check(name, meta, x2d, vals, lidx, table, lane)
    tensors = (meta, x2d, vals, lidx)
    if all(t.device.type == "cpu" for t in tensors):
        return slab_slices_torch(meta, x2d, vals, lidx, table, lane)
    dev = vals.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name}: the kernel runs on one CUDA device and got tensors on "
            f"{sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: meta, x2d, vals and lidx must be "
                         "contiguous")
    T, S, sub, _ = vals.shape
    lib = _library()
    y = torch.empty((T, sub, LANES), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"sb_slab_slices_{_SUFFIX[vals.dtype]}")(
            meta.data_ptr(), meta.shape[2], x2d.data_ptr(), x2d.shape[0],
            vals.data_ptr(), lidx.data_ptr(), y.data_ptr(), T, S, sub,
            _TABLE[table], _LANE[lane],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, name)
    return y


def _on_cuda(*tensors: torch.Tensor) -> bool:
    return any(t.device.type == "cuda" for t in tensors)


def slab_slices(meta: torch.Tensor, x2d: torch.Tensor, vals: torch.Tensor,
                lidx: torch.Tensor, variant: str) -> torch.Tensor:
    """P3: y (T, 8, 128) of a slab_micro variant (a key of ``P3``)."""
    if variant not in P3:
        raise ValueError(f"slab_slices: unknown variant {variant!r}; "
                         f"{tuple(P3)}")
    if vals.dim() != 4 or vals.shape[2] != SUBLANES:
        raise ValueError(f"slab_slices: slices are ({SUBLANES}, {LANES}); got "
                         f"vals {tuple(vals.shape)}")
    y = _run("slab_slices", meta, x2d, vals, lidx, *P3[variant])
    if _on_cuda(vals):
        slab_slices.launches += 1
    return y


def slab_slices_tall(meta: torch.Tensor, x2d: torch.Tensor,
                     vals: torch.Tensor, lidx: torch.Tensor,
                     variant: str) -> torch.Tensor:
    """P4: y (T, SUB, 128) of a slab_micro2 variant (a key of ``P4``), SUB
    = vals.shape[2]."""
    if variant not in P4:
        raise ValueError(f"slab_slices_tall: unknown variant {variant!r}; "
                         f"{tuple(P4)}")
    y = _run("slab_slices_tall", meta, x2d, vals, lidx, *P4[variant])
    if _on_cuda(vals):
        slab_slices_tall.launches += 1
    return y


slab_slices.launches = 0
slab_slices_tall.launches = 0
