"""Read ceiling of device memory: the hand-written CUDA kernel K12 and its
plain PyTorch version (counterpart of sparsebench_tpu/ops/memroof.py).

The kernel is ``csrc/memroof.cu``; its source note says what bounds it and
how it keeps the compiler from deleting its loads.

* ``read_passes_torch(x2d, n_tiles, reps, tile_rows)`` — the plain version:
  ``out``, the sum over steps i = 0 .. reps*n_tiles - 1, in order, of rows
  0-7 of tile ``i mod n_tiles`` (the JAX package's ``_read_passes``), and
  ``sink``, the per-block sums of every value read, in the kernel's order.
* ``read_passes(x2d, n_tiles, reps, tile_rows)`` — the wrapper. A CPU tensor
  goes to the plain version; a CUDA tensor launches the kernel or raises.
  ``read_passes.launches`` counts kernel launches.
* ``measure_dma_read_gbps(n_floats, reps, trials, tile_rows)`` — the JAX
  package's measurement: the differential (t(3 reps) - t(reps)) / 2 reps
  passes over an ``n_floats`` f32 array of ones, each time the best of
  ``trials`` launches, with CUDA events on the card (8 launches a call: two
  warm-ups, then ``trials`` at each rep count). It refuses an array below
  4 x the card's L2, whose later passes would be read from the L2.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.profiler import Kernel
from sparsebench_tpu_torch.utils import elapsed_seconds

LANES = 128
TILE_ROWS = 2048  # default (2048, 128) f32 tiles = 1 MB per step
STRIP_ROWS = 8    # rows of a tile that feed ``out``
THREADS = 256     # sb::kThreads: the kernel's block width
L2_MULTIPLE = 4   # the array must be at least this many L2 sizes


def _check_shape(x2d: torch.Tensor, n_tiles: int, reps: int,
                 tile_rows: int) -> None:
    if tile_rows < STRIP_ROWS or tile_rows % STRIP_ROWS:
        raise ValueError(f"read_passes: tile_rows={tile_rows} must be a "
                         f"positive multiple of {STRIP_ROWS}")
    if n_tiles < 1 or reps < 1:
        raise ValueError(f"read_passes: n_tiles={n_tiles} and reps={reps} "
                         "must be >= 1")
    if (x2d.dtype != torch.float32 or x2d.dim() != 2
            or x2d.shape[1] != LANES or x2d.shape[0] < n_tiles * tile_rows):
        raise ValueError(
            f"read_passes: x2d {x2d.dtype} {tuple(x2d.shape)} must be f32 of "
            f"shape (>= n_tiles*tile_rows = {n_tiles * tile_rows}, {LANES})")


def read_passes_torch(x2d: torch.Tensor, n_tiles: int, reps: int,
                      tile_rows: int = TILE_ROWS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (out (8, 128), sink (tile_rows / 8,)), as the kernel
    computes them. Thread j of the kernel reads float4 j of every tile in
    step order: ``out`` is the running sum of the first 8 rows' float4s,
    ``sink`` the per-block tree sum of each thread's running sum of
    x, y, z, w (``sb::block_sum``'s tree)."""
    _check_shape(x2d, n_tiles, reps, tile_rows)
    tiles = x2d[: n_tiles * tile_rows].reshape(n_tiles, tile_rows * LANES
                                               // 4, 4)
    strip = torch.zeros(STRIP_ROWS * LANES // 4, 4, dtype=torch.float32,
                        device=x2d.device)
    total = torch.zeros(tiles.shape[1], dtype=torch.float32,
                        device=x2d.device)
    for i in range(reps * n_tiles):
        v = tiles[i % n_tiles]
        strip = strip + v[: strip.shape[0]]
        for c in range(4):
            total = total + v[:, c]
    red = total.reshape(-1, THREADS)
    s = THREADS // 2
    while s:
        red = red[:, :s] + red[:, s: 2 * s]
        s //= 2
    return strip.reshape(STRIP_ROWS, LANES), red[:, 0].contiguous()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("memroof")
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.sb_read_passes_f32.argtypes = [p, p, p, i64, i64, i64, p]
    lib.sb_read_passes_f32.restype = ctypes.c_int
    return lib


def read_passes(x2d: torch.Tensor, n_tiles: int, reps: int,
                tile_rows: int = TILE_ROWS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``reps`` passes over the first ``n_tiles * tile_rows`` rows of
    ``x2d`` in one launch: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor (see module docstring)."""
    if x2d.device.type == "cpu":
        return read_passes_torch(x2d, n_tiles, reps, tile_rows)
    if x2d.device.type != "cuda":
        raise ValueError(f"read_passes: x2d on {x2d.device}; it must be on a "
                         "CUDA device (or on the CPU)")
    _check_shape(x2d, n_tiles, reps, tile_rows)
    if not x2d.is_contiguous():
        raise ValueError("read_passes: x2d must be contiguous")
    lib = _library()
    out = torch.empty((STRIP_ROWS, LANES), dtype=torch.float32,
                      device=x2d.device)
    sink = torch.empty(tile_rows // STRIP_ROWS, dtype=torch.float32,
                       device=x2d.device)
    with torch.cuda.device(x2d.device):
        err = lib.sb_read_passes_f32(
            x2d.data_ptr(), out.data_ptr(), sink.data_ptr(), n_tiles,
            tile_rows, reps, torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(lib, err, "read_passes")
    read_passes.launches += 1
    return out, sink


read_passes.launches = 0


def measure_dma_read_gbps(n_floats: int = 64 * 1024 * 1024, reps: int = 4,
                          trials: int = 3, tile_rows: int = TILE_ROWS,
                          device: Optional[torch.device] = None) -> float:
    """Differential read bandwidth in GB/s of ``reps`` and ``3 * reps``
    passes over an ``n_floats`` f32 array (see module docstring).
    ``device`` defaults to the current CUDA device; a CPU device times the
    plain version on the host clock (for the tests). On CUDA an array below
    4 x the L2 raises ValueError before anything is allocated."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("measure_dma_read_gbps: no CUDA card "
                               "(torch.cuda.is_available() is False)")
        l2 = torch.cuda.get_device_properties(device).L2_cache_size
        if n_floats * 4 < L2_MULTIPLE * l2:
            raise ValueError(
                f"measure_dma_read_gbps: {n_floats} floats "
                f"({n_floats * 4 / 2**20:.1f} MiB) is below {L2_MULTIPLE} x "
                f"the card's {l2 / 2**20:.0f} MiB L2; later passes would read "
                "the L2, not device memory")
    n_tiles = n_floats // (tile_rows * LANES)
    if n_tiles < 1 or reps < 1 or trials < 1:
        raise ValueError(
            f"measure_dma_read_gbps: n_floats={n_floats} must hold a tile of "
            f"{tile_rows} x {LANES}, and reps={reps}, trials={trials} >= 1")
    x = torch.ones((n_tiles * tile_rows, LANES), dtype=torch.float32,
                   device=device)
    for r in (reps, 3 * reps):  # warm-up: the build and the first launch
        read_passes(x, n_tiles, r, tile_rows)

    def timed(r):
        return min(elapsed_seconds(
            lambda: read_passes(x, n_tiles, r, tile_rows), device)
            for _ in range(trials))

    t_lo, t_hi = timed(reps), timed(3 * reps)
    dt = (t_hi - t_lo) / (2 * reps)
    if dt <= 0:
        dt = t_hi / (3 * reps)
    return n_tiles * tile_rows * LANES * 4 / dt / 1e9

# the registry's entry (profiler.kernels): the device's read ceiling
KERNELS = (Kernel("K12", ("read_passes_kernel",), "device", (read_passes,)),)
