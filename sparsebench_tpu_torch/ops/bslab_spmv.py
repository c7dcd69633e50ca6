"""BSLAB SpMV: the hand-written CUDA kernels K6 and K7 and their plain
PyTorch version.

Counterpart of sparsebench_tpu/ops/bslab_pallas.py (``bslab_spmv``,
``bslab_spmv_win``). The kernels are ``csrc/bslab_spmv.cu``; its source
note says what bounds them and how their design differs from the TPU
kernels'. The slice planes of one matrix travel together as ``Slices``:

    meta_aff  (n_tiles, s_aff, 2) int32   [dbase, r]
    vals_aff  (n_tiles, s_aff, sub, 128)  value dtype
    meta_gen  (n_tiles, s_gen, 1) int32   dbase
    vals_gen, lidx_gen (int8)             (n_tiles, s_gen, sub, 128)
    meta_wide (n_tiles, s_wide, 1) int32  dbase at dblk == 0
    vals_wide, lidx_wide, dblk_wide (int8) (n_tiles, s_wide, sub, 128)

and y (n_tiles, sub, 128) sums, per output, the tile's slices in stored
order (affine, general, wide), reading x at padded row ``dbase + s (+
dblk)``; the padded x has ``lead`` zero rows before x (formats/bslab.py).

* ``bslab_spmv_torch(sl, x, sub=, lead=, x_rows=)`` — the plain version:
  the JAX package's ``_spmv_xla`` gathers on a zero-padded x, summed slice
  by slice in the kernels' order, so it is their bit-exact reference.
* ``bslab_spmv(sl, x, sub=, lead=)`` — K6, x gathered through the caches.
* ``bslab_spmv_win(wchunk, sl, x, sub=, lead=, w_blocks=, cluster=0)`` —
  K7, each persistent unit (a block, or a cluster of blocks) keeping the
  tiles' windows of x rows [wchunk W, wchunk W + 2W) in a ring of W-row
  chunks in shared memory. ``win_plan`` sizes the unit: the smallest
  cluster (1-8 blocks) whose shared memory holds two chunks, with a third
  where it fits too; K7 raises, naming the size, only where a cluster of 8
  cannot hold two.

The wrappers launch their kernel on CUDA tensors and raise on any other
device: the choice between kernel and plain version is the matrix's
``impl`` alone (formats/bslab.py). ``launches`` on each wrapper counts its
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.profiler import Kernel

LANES = 128

# (values dtype, x dtype) -> suffix of the C entry points
_SUFFIX = {
    (torch.bfloat16, torch.float32): "bf16_f32",
    (torch.float32, torch.float32): "f32_f32",
    (torch.float64, torch.float64): "f64_f64",
}

# Shared memory a block may use on an H100 (227 KB, the opt-in maximum).
# K6 keeps only the tile's metadata there, within the 48 KB default; a K7
# block holds its mbarriers, its stripe of each ring slot and the metadata.
SMEM_BYTES = 232_448
K6_META_BYTES = 48 * 1024
BAR_BYTES = 128
MAX_CLUSTER = 8            # the portable cluster sizes are 1-8
ALIGN = 16                 # bytes: 16 B loads of x, bulk copies of its rows


class Slices(NamedTuple):
    meta_aff: torch.Tensor
    vals_aff: torch.Tensor
    meta_gen: torch.Tensor
    vals_gen: torch.Tensor
    lidx_gen: torch.Tensor
    meta_wide: torch.Tensor
    vals_wide: torch.Tensor
    lidx_wide: torch.Tensor
    dblk_wide: torch.Tensor

    @property
    def counts(self):
        """(s_aff, s_gen, s_wide)."""
        return (self.vals_aff.shape[1], self.vals_gen.shape[1],
                self.vals_wide.shape[1])

    @property
    def n_tiles(self) -> int:
        return self.vals_aff.shape[0]


def meta_bytes(sl: Slices) -> int:
    s_aff, s_gen, s_wide = sl.counts
    return 4 * (2 * s_aff + s_gen + s_wide)


class WinPlan(NamedTuple):
    """K7's unit: ``cluster`` blocks, each holding ``stripe`` rows of each
    of the ring's ``ring`` W-row chunks, in ``smem`` bytes."""
    cluster: int
    ring: int
    stripe: int
    smem: int


def ring_smem_bytes(sl: Slices, w_blocks: int, x_dtype: torch.dtype,
                    cluster: int, ring: int) -> int:
    """Shared memory of a K7 block: mbarriers, its stripe of ``ring`` W-row
    chunks (W / cluster rows, rounded up), the tile's metadata."""
    stripe = -(-w_blocks // cluster)
    return (BAR_BYTES + ring * stripe * LANES * x_dtype.itemsize
            + meta_bytes(sl))


def win_plan(sl: Slices, w_blocks: int, x_dtype: torch.dtype,
             cluster: int = 0) -> WinPlan:
    """K7's unit for windows of 2 ``w_blocks`` rows: the smallest cluster
    whose blocks hold a two-chunk ring (or ``cluster`` when given), with a
    third chunk where that cluster holds three. Raises a ValueError, naming
    the size, where the cluster cannot hold two."""
    if cluster and not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"bslab_spmv_win: cluster={cluster} is not a "
                         f"cluster size of 1 to {MAX_CLUSTER}")
    if w_blocks <= 0:
        raise ValueError(f"bslab_spmv_win: w_blocks={w_blocks} must be "
                         "positive")
    for c in ([cluster] if cluster else range(1, MAX_CLUSTER + 1)):
        if ring_smem_bytes(sl, w_blocks, x_dtype, c, 2) <= SMEM_BYTES:
            ring = 3 if ring_smem_bytes(sl, w_blocks, x_dtype, c,
                                        3) <= SMEM_BYTES else 2
            return WinPlan(c, ring, -(-w_blocks // c),
                           ring_smem_bytes(sl, w_blocks, x_dtype, c, ring))
    c = cluster or MAX_CLUSTER
    need = ring_smem_bytes(sl, w_blocks, x_dtype, c, 2)
    raise ValueError(
        f"bslab_spmv_win: two chunks of {w_blocks} x rows ({x_dtype}) need "
        f"{need} B of shared memory a block in a cluster of {c}, over the "
        f"{SMEM_BYTES} B a block may use; use the kernel impl (K6) for this "
        "matrix")


def bslab_spmv_torch(sl: Slices, x: torch.Tensor, *, sub: int, lead: int,
                     x_rows: int) -> torch.Tensor:
    """Plain version: y (n_tiles, sub, 128) in x's dtype, from x padded with
    ``lead`` zero rows in front and zeros up to ``x_rows`` rows; each slice
    adds ``vals.to(x.dtype) * gathered`` to the sum in stored order."""
    dev = x.device
    xp = torch.zeros(x_rows * LANES, dtype=x.dtype, device=dev)
    xp[lead * LANES:lead * LANES + x.shape[0]] = x
    lanes = torch.arange(LANES, device=dev)
    subs = torch.arange(sub, device=dev)
    acc = torch.zeros((sl.n_tiles, sub, LANES), dtype=x.dtype, device=dev)

    def rows(meta, p):  # (n_tiles, sub, 1) padded row of slice p
        return (meta[:, p, 0].long()[:, None] + subs[None, :])[:, :, None]

    s_aff, s_gen, s_wide = sl.counts
    for p in range(s_aff):
        idx = (lanes[None, :] + sl.meta_aff[:, p, 1].long()[:, None]) & (
            LANES - 1)
        gcol = rows(sl.meta_aff, p) * LANES + idx[:, None, :]
        acc = acc + sl.vals_aff[:, p].to(x.dtype) * xp[gcol]
    for p in range(s_gen):
        gcol = rows(sl.meta_gen, p) * LANES + sl.lidx_gen[:, p].long()
        acc = acc + sl.vals_gen[:, p].to(x.dtype) * xp[gcol]
    for p in range(s_wide):
        gcol = ((rows(sl.meta_wide, p) + sl.dblk_wide[:, p].long()) * LANES
                + sl.lidx_wide[:, p].long())
        acc = acc + sl.vals_wide[:, p].to(x.dtype) * xp[gcol]
    return acc


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("bslab_spmv")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    args = [p] * 9 + [i32] * 3 + [p, i64, p, i32, i32, i32]
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"sb_bslab_spmv_{sfx}")
        fn.argtypes = args + [p]
        fn.restype = i32
        fn = getattr(lib, f"sb_bslab_spmv_win_{sfx}")
        fn.argtypes = args + [p, i32, i32, i32, p]
        fn.restype = i32
    return lib


def _check(name: str, sl: Slices, x: torch.Tensor, sub: int):
    """Validate what the kernels take; return the entry-point suffix and x,
    copied where its storage is not 16 B aligned (the kernels read x 16 B
    at a time; a fresh tensor always is)."""
    tensors = [*sl, x]
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name}: the kernel runs on one CUDA device and got tensors on "
            f"{sorted({str(t.device) for t in tensors})}; on the CPU the "
            "plain version bslab_spmv_torch runs (the matrix's impl 'torch')")
    vdt = sl.vals_aff.dtype
    sfx = _SUFFIX.get((vdt, x.dtype))
    if sfx is None or sl.vals_gen.dtype != vdt or sl.vals_wide.dtype != vdt:
        raise TypeError(
            f"{name}: no kernel for values {vdt} with x {x.dtype}; supported "
            f"(values, x): {list(_SUFFIX)}")
    n_tiles = sl.n_tiles
    s_aff, s_gen, s_wide = sl.counts
    shapes = {
        "meta_aff": (sl.meta_aff, (n_tiles, s_aff, 2), torch.int32),
        "meta_gen": (sl.meta_gen, (n_tiles, s_gen, 1), torch.int32),
        "meta_wide": (sl.meta_wide, (n_tiles, s_wide, 1), torch.int32),
        "vals_aff": (sl.vals_aff, (n_tiles, s_aff, sub, LANES), vdt),
        "vals_gen": (sl.vals_gen, (n_tiles, s_gen, sub, LANES), vdt),
        "lidx_gen": (sl.lidx_gen, (n_tiles, s_gen, sub, LANES), torch.int8),
        "vals_wide": (sl.vals_wide, (n_tiles, s_wide, sub, LANES), vdt),
        "lidx_wide": (sl.lidx_wide, (n_tiles, s_wide, sub, LANES),
                      torch.int8),
        "dblk_wide": (sl.dblk_wide, (n_tiles, s_wide, sub, LANES),
                      torch.int8),
    }
    for key, (t, shape, dt) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{name}: {key} must be contiguous {dt} {shape}, got "
                f"{t.dtype} {tuple(t.shape)}")
    if sub <= 0 or sub % 8 or n_tiles <= 0:
        raise ValueError(f"{name}: sub={sub} must be a positive multiple of "
                         f"8 and n_tiles={n_tiles} positive")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous 1-D tensor")
    for key in ("vals_aff", "vals_gen", "lidx_gen", "vals_wide", "lidx_wide",
                "dblk_wide"):
        if getattr(sl, key).data_ptr() % ALIGN:
            raise ValueError(f"{name}: {key} must start {ALIGN} B aligned")
    if x.shape[0] >= 2**31:
        raise ValueError(f"{name}: x has {x.shape[0]} entries; the kernels "
                         "index it with 32-bit integers")
    return sfx, (x.clone() if x.data_ptr() % ALIGN else x)


def _args(sl: Slices, x: torch.Tensor, y: torch.Tensor, sub: int,
          lead: int):
    return [*(t.data_ptr() for t in sl), *sl.counts, x.data_ptr(),
            x.shape[0], y.data_ptr(), sl.n_tiles, sub, lead]


def bslab_spmv(sl: Slices, x: torch.Tensor, *, sub: int,
               lead: int) -> torch.Tensor:
    """K6: y (n_tiles, sub, 128) for CUDA tensors, x gathered through the
    caches."""
    sfx, x = _check("bslab_spmv", sl, x, sub)
    if meta_bytes(sl) > K6_META_BYTES:
        raise ValueError(
            f"bslab_spmv: {meta_bytes(sl)} B of slice metadata a tile exceed "
            f"the kernel's {K6_META_BYTES} B of shared memory")
    lib = _library()
    y = torch.empty((sl.n_tiles, sub, LANES), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(lib, f"sb_bslab_spmv_{sfx}")(
            *_args(sl, x, y, sub, lead),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "bslab_spmv")
    bslab_spmv.launches += 1
    return y


def bslab_spmv_win(wchunk: torch.Tensor, sl: Slices, x: torch.Tensor, *,
                   sub: int, lead: int, w_blocks: int,
                   cluster: int = 0) -> torch.Tensor:
    """K7: y (n_tiles, sub, 128) for CUDA tensors, gathered from the tiles'
    windows of x held in each unit's chunk ring in shared memory. The unit
    is ``win_plan``'s (``cluster`` blocks when given, else the smallest
    cluster that holds the ring); raises a ValueError where it cannot hold
    two chunks."""
    sfx, x = _check("bslab_spmv_win", sl, x, sub)
    plan = win_plan(sl, w_blocks, x.dtype, cluster)
    if (tuple(wchunk.shape) != (sl.n_tiles,) or wchunk.dtype != torch.int32
            or wchunk.device != x.device or not wchunk.is_contiguous()):
        raise ValueError(
            f"bslab_spmv_win: wchunk must be contiguous int32 "
            f"({sl.n_tiles},) on {x.device}")
    lib = _library()
    y = torch.empty((sl.n_tiles, sub, LANES), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(lib, f"sb_bslab_spmv_win_{sfx}")(
            *_args(sl, x, y, sub, lead), wchunk.data_ptr(), w_blocks,
            plan.cluster, plan.ring,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "bslab_spmv_win")
    bslab_spmv_win.launches += 1
    return y


bslab_spmv.launches = 0
bslab_spmv_win.launches = 0

# the registry's entries (profiler.kernels)
KERNELS = (
    Kernel("K6", ("bslab_spmv_kernel",), "SpMV kernels", (bslab_spmv,)),
    Kernel("K7", ("bslab_spmv_win_kernel",), "SpMV kernels",
           (bslab_spmv_win,)),
)
