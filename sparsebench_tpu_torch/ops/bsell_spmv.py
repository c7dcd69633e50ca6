"""BSELL SpMV: the hand-written CUDA kernels K9, K10 and K11 and their plain
PyTorch version.

Counterpart of sparsebench_tpu/ops/bsell_pallas.py (``bsell_spmv_pallas``,
``bsell_spmv_win2``, ``bsell_spmv_windowed``). The kernels are
``csrc/bsell_spmv.cu``; its source note says what bounds them and how their
design differs from the TPU kernels'. One matrix's arrays (formats/bsell.py):

    blocks  (n_tiles, s_max, 8) int32       x block row per sublane, relative
                                            to the tile's window base
    vals    (n_tiles, s_max, 8, 128)        bf16, f32 or f64
    lidx    (n_tiles, s_max, 8, 128) int8   lane index within the block row

and y (n_tiles, 8, 128), in x's dtype, row (8 t + s) 128 + lane, sums over
the tile's slices p = 0 .. s_max - 1 in stored order

    vals[t,p,s,lane] * x2d[base_t + blocks[t,p,s], lidx[t,p,s,lane]]

each product and each sum rounded on its own.

* ``bsell_spmv_torch(blocks, base, x2d, vals, lidx)`` — the plain version:
  ``base`` (n_tiles, 1, 8) int32 holds base_t (replicated); slice by slice
  in stored order, as the Pallas kernels' ``_accumulate_slices`` adds them,
  so it is the kernels' bit-exact reference. (The JAX package's XLA form
  sums over the slice axis in an order XLA picks.)
* ``bsell_spmv(blocks, base, x2d, vals, lidx)`` — K9, x2d the whole x
  (nc_pad / 128, 128), gathered through the caches by persistent blocks
  that walk consecutive lane groups with K10's slice loop.
* ``bsell_spmv_win2(wchunk, blocks, x2d, vals, lidx, w_blocks=,
  cluster=0)`` — K10: base_t = wchunk[t] W and x2d the windowed layout's x
  (xw_rows, 128). Persistent units of ``cluster`` blocks walk consecutive
  tiles and keep their windows, x2d rows [base_t, base_t + 2W), in a ring of
  two W-row chunks in shared memory (in a unit of several blocks each holds
  a stripe of the rows), copying a chunk only when the tiles' chunk moves
  past what is resident. A block id outside the window reads NaN.
* ``bsell_spmv_windowed(wchunk, blocks, x2d, vals, lidx, w_blocks=,
  cluster=0)`` — K11, the same product from the same ring; as the TPU
  kernel's two W-row chunks do, a block id below the window reads its first
  row and one above it its last.

``win_plan`` sizes K10/K11's unit: the smallest ``cluster`` of 1-8 blocks
whose blocks hold two chunks (a stripe of each) and, where there are
several, the warps' row buffers; ``cluster=`` forces one. The name is
bslab's; the blocks launch independently, not as a thread-block cluster,
as none reads another's shared memory. So K10 and K11 run every window up
to a cluster of 8 (200^3: 4 blocks, f64 7) and raise, naming the size,
only beyond it. The wrappers launch their
kernel on CUDA tensors and raise on any other device: the choice between
kernel and plain version is the matrix's ``impl`` alone. ``launches`` on
each wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.profiler import Kernel

LANES = 128
SUBLANES = 8
TILE_ROWS = LANES * SUBLANES  # 1024 rows per (8, 128) output tile

# (values dtype, x dtype) -> suffix of the C entry points
_SUFFIX = {
    (torch.bfloat16, torch.float32): "bf16_f32",
    (torch.float32, torch.float32): "f32_f32",
    (torch.float64, torch.float64): "f64_f64",
}

# Shared memory a block may use on an H100 (227 KB, the opt-in maximum). A
# K10/K11 block holds its mbarriers, its stripe of the ring's two chunks
# and, in a unit of several blocks, its 32 warps' row buffers
# (csrc/bsell_spmv.cu kBufRows: two rows of f32, one of f64, 32 KB either
# way).
SMEM_BYTES = 232_448
BAR_BYTES = 128
WARPS = 32
ROW_BUF_BYTES = WARPS * 2 * LANES * 4
MAX_CLUSTER = 8            # blocks a unit
ALIGN = 16                 # bytes: bulk copies of x rows, vector plane loads


class WinPlan(NamedTuple):
    """K10/K11's unit: ``cluster`` blocks, each holding ``stripe`` rows of
    each of the ring's two W-row chunks, in ``smem`` bytes."""
    cluster: int
    stripe: int
    smem: int


def ring_smem_bytes(w_blocks: int, x_dtype: torch.dtype,
                    cluster: int) -> int:
    """Shared memory of a K10/K11 block: mbarriers, its stripe of two W-row
    chunks (W / cluster rows, rounded up) and, in a unit of several blocks,
    the row buffers."""
    stripe = -(-w_blocks // cluster)
    return (BAR_BYTES + 2 * stripe * LANES * x_dtype.itemsize
            + (ROW_BUF_BYTES if cluster > 1 else 0))


def win_plan(w_blocks: int, x_dtype: torch.dtype,
             cluster: int = 0) -> WinPlan:
    """K10/K11's unit for windows of 2 ``w_blocks`` rows: the smallest
    cluster of blocks that holds the two-chunk ring (or ``cluster`` when
    given). Raises a ValueError, naming the size, where it cannot."""
    if cluster and not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"bsell window: cluster={cluster} is not a cluster "
                         f"size of 1 to {MAX_CLUSTER}")
    if w_blocks <= 0:
        raise ValueError(f"bsell window: w_blocks={w_blocks} must be "
                         "positive")
    for c in ([cluster] if cluster else range(1, MAX_CLUSTER + 1)):
        need = ring_smem_bytes(w_blocks, x_dtype, c)
        if need <= SMEM_BYTES:
            return WinPlan(c, -(-w_blocks // c), need)
    c = cluster or MAX_CLUSTER
    raise ValueError(
        f"bsell window: two chunks of {w_blocks} x rows ({x_dtype}) need "
        f"{need} B of shared memory a block in a cluster of {c}, over the "
        f"{SMEM_BYTES} B a block may use; use the kernel impl (K9) for this "
        "matrix")


def bsell_spmv_torch(blocks: torch.Tensor, base: torch.Tensor,
                     x2d: torch.Tensor, vals: torch.Tensor,
                     lidx: torch.Tensor) -> torch.Tensor:
    """Plain version: y (n_tiles, 8, 128) in x2d's dtype; each slice adds
    ``vals.to(x.dtype) * gathered`` to the sum in stored order."""
    n_tiles, s_max = vals.shape[:2]
    xf = x2d.reshape(-1)
    rows = blocks.long() + base[:, :, :1].long()  # (n_tiles, s_max, 8)
    acc = torch.zeros((n_tiles, SUBLANES, LANES), dtype=x2d.dtype,
                      device=x2d.device)
    for p in range(s_max):
        g = xf[rows[:, p, :, None] * LANES + lidx[:, p].long()]
        acc = acc + vals[:, p].to(x2d.dtype) * g
    return acc


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("bsell_spmv")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    # blocks, base or wchunk, x, vals, lidx, y, n_tiles, s_max, x_rows,
    # [w_blocks, cluster,] stream
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"sb_bsell_spmv_{sfx}")
        fn.argtypes = [p] * 6 + [i32] * 3 + [p]
        fn.restype = i32
        for name in ("win2", "windowed"):
            fn = getattr(lib, f"sb_bsell_spmv_{name}_{sfx}")
            fn.argtypes = [p] * 6 + [i32] * 5 + [p]
            fn.restype = i32
    return lib


def _check(name: str, blocks: torch.Tensor, table: torch.Tensor,
           table_shape: tuple, x2d: torch.Tensor, vals: torch.Tensor,
           lidx: torch.Tensor) -> str:
    """Validate what the kernels take; return the entry-point suffix."""
    tensors = (blocks, table, x2d, vals, lidx)
    dev = x2d.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name}: the kernel runs on one CUDA device and got tensors on "
            f"{sorted({str(t.device) for t in tensors})}; on the CPU the "
            "plain version bsell_spmv_torch runs (the matrix's impl 'torch')")
    sfx = _SUFFIX.get((vals.dtype, x2d.dtype))
    if sfx is None:
        raise TypeError(
            f"{name}: no kernel for values {vals.dtype} with x {x2d.dtype}; "
            f"supported (values, x): {list(_SUFFIX)}")
    n_tiles, s_max = vals.shape[:2]
    shapes = {
        "blocks": (blocks, (n_tiles, s_max, SUBLANES), torch.int32),
        "base/wchunk": (table, table_shape, torch.int32),
        "vals": (vals, (n_tiles, s_max, SUBLANES, LANES), vals.dtype),
        "lidx": (lidx, (n_tiles, s_max, SUBLANES, LANES), torch.int8),
    }
    for key, (t, shape, dt) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{name}: {key} must be contiguous {dt} {shape}, got "
                f"{t.dtype} {tuple(t.shape)}")
    if n_tiles <= 0 or s_max <= 0:
        raise ValueError(f"{name}: n_tiles={n_tiles} and s_max={s_max} must "
                         "be positive")
    if x2d.dim() != 2 or x2d.shape[1] != LANES or not x2d.is_contiguous():
        raise ValueError(f"{name}: x2d must be a contiguous (rows, {LANES}) "
                         f"tensor, got {tuple(x2d.shape)}")
    for key, t in (("vals", vals), ("lidx", lidx)):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: {key} must start {ALIGN} B aligned")
    return sfx


def bsell_spmv(blocks: torch.Tensor, base: torch.Tensor, x2d: torch.Tensor,
               vals: torch.Tensor, lidx: torch.Tensor) -> torch.Tensor:
    """K9: y (n_tiles, 8, 128) for CUDA tensors, x gathered through the
    caches."""
    n_tiles = vals.shape[0]
    sfx = _check("bsell_spmv", blocks, base, (n_tiles, 1, SUBLANES), x2d,
                 vals, lidx)
    lib = _library()
    y = torch.empty((n_tiles, SUBLANES, LANES), dtype=x2d.dtype,
                    device=x2d.device)
    with torch.cuda.device(x2d.device):
        err = getattr(lib, f"sb_bsell_spmv_{sfx}")(
            blocks.data_ptr(), base.data_ptr(), x2d.data_ptr(),
            vals.data_ptr(), lidx.data_ptr(), y.data_ptr(), n_tiles,
            vals.shape[1], x2d.shape[0],
            torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(lib, err, "bsell_spmv")
    bsell_spmv.launches += 1
    return y


def _launch_window(name: str, wchunk: torch.Tensor, blocks: torch.Tensor,
                   x2d: torch.Tensor, vals: torch.Tensor, lidx: torch.Tensor,
                   w_blocks: int, cluster: int) -> torch.Tensor:
    n_tiles = vals.shape[0]
    sfx = _check(f"bsell_spmv_{name}", blocks, wchunk, (n_tiles,), x2d, vals,
                 lidx)
    plan = win_plan(w_blocks, x2d.dtype, cluster)
    if x2d.data_ptr() % ALIGN:
        x2d = x2d.clone()  # the bulk copies read x 16 B aligned
    lib = _library()
    y = torch.empty((n_tiles, SUBLANES, LANES), dtype=x2d.dtype,
                    device=x2d.device)
    with torch.cuda.device(x2d.device):
        err = getattr(lib, f"sb_bsell_spmv_{name}_{sfx}")(
            blocks.data_ptr(), wchunk.data_ptr(), x2d.data_ptr(),
            vals.data_ptr(), lidx.data_ptr(), y.data_ptr(), n_tiles,
            vals.shape[1], x2d.shape[0], w_blocks, plan.cluster,
            torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(lib, err, f"bsell_spmv_{name}")
    return y


def bsell_spmv_win2(wchunk: torch.Tensor, blocks: torch.Tensor,
                    x2d: torch.Tensor, vals: torch.Tensor, lidx: torch.Tensor,
                    *, w_blocks: int, cluster: int = 0) -> torch.Tensor:
    """K10: y (n_tiles, 8, 128) for CUDA tensors, gathered from the tiles'
    windows held in each unit's chunk ring in shared memory. The unit is
    ``win_plan``'s (``cluster`` blocks when given, else the fewest that hold
    the ring); raises a ValueError where it cannot hold two chunks."""
    y = _launch_window("win2", wchunk, blocks, x2d, vals, lidx, w_blocks,
                       cluster)
    bsell_spmv_win2.launches += 1
    return y


def bsell_spmv_windowed(wchunk: torch.Tensor, blocks: torch.Tensor,
                        x2d: torch.Tensor, vals: torch.Tensor,
                        lidx: torch.Tensor, *, w_blocks: int,
                        cluster: int = 0) -> torch.Tensor:
    """K11: as K10, block ids clamped into the window (module docstring)."""
    y = _launch_window("windowed", wchunk, blocks, x2d, vals, lidx, w_blocks,
                       cluster)
    bsell_spmv_windowed.launches += 1
    return y


bsell_spmv.launches = 0
bsell_spmv_win2.launches = 0
bsell_spmv_windowed.launches = 0

# the registry's entries (profiler.kernels): K10 and K11 share one body
KERNELS = (
    Kernel("K9", ("bsell_spmv_kernel",), "SpMV kernels", (bsell_spmv,)),
    Kernel("K10", ("bsell_spmv_win_kernel",), "SpMV kernels",
           (bsell_spmv_win2,)),
    Kernel("K11", ("bsell_spmv_win_kernel",), "SpMV kernels",
           (bsell_spmv_windowed,)),
)
