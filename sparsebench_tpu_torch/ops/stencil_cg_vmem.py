"""The whole CG solve on the matrix-free stencil in one launch: the CUDA
kernel K5, its plan and its plain PyTorch version.

Counterpart of sparsebench_tpu/ops/stencil_cg_vmem.py
(``stencil_cg_vmem_pallas``). The kernel is ``csrc/stencil_cg_vmem.cu``, one
cooperative launch of a persistent kernel; its source note gives the
recurrence (the lagged exit test, beta = 0 at k == 1, the breakdown freeze,
NaN history past the exit), the design and the memory-ordering argument.
An iteration is two phases separated by two grid barriers: phase A forms
p' = r + beta p_old on the plan's tiles, writes p' into the other of two p
buffers and w = A p', and adds p'.w to a partial a block; phase B streams
r -= alpha w, x += alpha p' and r.r. Phase A has two forms, the plan's
``form``:

* ``ring``: a tile spans all nx columns and R rows over tz planes; a
  producer warp bulk-copies each plane of it, with its halo rows, as one
  contiguous range of r and one of p_old into a ring of ``RING_STAGES``
  slabs in shared memory, running ahead over the block's tiles, and seven
  consumer warps form p' and the sums from the slabs, consumer c the
  columns c, c + ``RING_CONSUMERS``, ... of the tile, up to
  ``RING_POINTS`` / R of them, R rows each (``ring_columns``: at nx = 200
  one column each, and 24 of the 224 consumers idle);
* ``march``: the tiled plane march of ``csrc/stencil_apply.cuh`` (K2's and
  K3's), tiles of 32 columns and 8 R rows.

The plan (``cg_plan``). The form by shape (``ring_takes``): the ring
where it applies (``ring_rows``: a row is whole 16-byte units, a bulk
copy's, and a plane-tile of one row fits the consumers, nx at most
``RING_CONSUMERS`` * ``RING_POINTS``) and an iteration's vectors do not
fit the L2 (``L2_RESIDENT_BUDGET``; within it the march was faster:
100^3 f32 in 2.62 ms against the ring's 2.71-3.00, H100, PERF.md §6);
else the march. The ring's R is the largest of ``PLAN_ROWS`` up to
``RING_ROWS``, ny and the rows whose plane-tile the consumers hold. The
march's R rows a thread and its shared bytes
(``ops/stencil.py`` ``plan_rows``, ``march_smem``). Then the persistent
grid (the blocks of the form's kernel that fit on the card at once at its
shared bytes, which the C side reports; a larger grid would deadlock the
barriers) and tz, the planes a tile, chosen so that the tiles spread
evenly over the blocks: block b walks tiles b, b + blocks, ...
(``block_tiles``; a tile's place is ``ops/stencil.py``
``block_origin``). Partials are one a block for each of
the two dots. ``device_cg_plan`` makes the plan on the card; the C side
recomputes it and refuses one that differs.

Viability (``vmem_cg_viable``). The TPU kernel keeps r and p in VMEM and
plans its tiles for that (``_plan``); on a backend whose VMEM it has not
measured, the CPU among them, only the conservative tier of that plan
runs, and 200^3 is refused. The plain version keeps that refusal, so the
two packages refuse the same grids on the CPU. On the card the vectors
stay in device memory either way, so the kernel runs every grid whose
``VECTORS`` vectors fit the card's memory; whether the five that an
iteration touches (r, the two p buffers, w and x) also fit the 50 MB L2
(``L2_RESIDENT_BUDGET``, 40 MB with margin: 100^3 in f32 takes 20 MB,
200^3 160 MB) only moves its speed, and the wrapper notes it on stderr
once per grid.

* ``stencil_cg_vmem_torch(r0, x0, eps, nx, ny, nz, itermax, use_7pt)`` —
  the plain version, the same recurrence in PyTorch with the stencil's
  plain apply; it reads the scalars on the host.
* ``stencil_cg_vmem(..., plan=None)`` — the wrapper: CPU tensors to the
  plain version, CUDA tensors to the kernel on ``plan`` (by default
  ``device_cg_plan``'s), or it raises; ``launches`` counts launches, and
  while the program's recorder records (``profiler.py``) so does the
  counter ``stencil_cg_vmem.launches`` (and ``stencil_cg_vmem.ring``, a
  launch of the ring form), and a launch sets the plan's ``form``, ``r``,
  ``tz`` and ``blocks`` on the innermost open span (the solve's
  ``stencil.cg_vmem``, ``solvers/cg.py`` ``cg_vmem_loop``).

Both take r0 = b - A x0 and x0 of one dtype, f32 or f64 (the computation
runs in that dtype; the solver widens bf16 vectors first), and return
(x, hist) with hist of length itermax, NaN past the exit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import sys

import torch

from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.ops import stencil as st
from sparsebench_tpu_torch.ops.stencil import (
    MAX_SERIAL,
    PLAN_ROWS,
    THREADS,
    TILE_X,
    WARPS,
    march_smem,
    on_cpu,
    plan_rows,
    stencil_apply_torch,
)
from sparsebench_tpu_torch.profiler import Kernel

# bytes of the vectors an iteration touches (r, the two p buffers, w and
# x) that the L2 is planned to hold; the H100's L2 is 50 MB
L2_RESIDENT_BUDGET = 40 * 2**20
# vectors of n values a kernel solve holds in device memory: r0 and x0,
# and the kernel's r, two p buffers, w and x
VECTORS = 7
# of those, the ones an iteration reads or writes
ITERATION_VECTORS = 5

# The ring form of phase A (csrc/stencil_cg_vmem.cu keeps the same numbers):
# its consumer threads (warps 0-6; warp 7 copies), the points of a
# plane-tile a consumer holds, its slabs and the most rows a tile takes (at
# 200^3 f32 on an H100, three blocks an SM: R 4 with 2 slabs 18.5-18.7 ms
# a solve against R 8's 19.1-19.4, R 2's 22.8-22.9 and 3 to 6 slabs'
# 19.2-19.9; the source note, PERF.md §6)
RING_CONSUMERS = THREADS - 32
RING_POINTS = 8
RING_STAGES = 2
RING_ROWS = 4

# The JAX package's conservative VMEM tier (sparsebench_tpu/ops/
# stencil_cg_vmem.py ``_plan`` with ``_conservative_vmem()``): r and p,
# padded to (nz + 2) * nyp rows of nxp lanes in f32, within 12 MB, and z
# slabs whose three live apply windows fit 2 MB, at most 16 of them.
_JAX_RESIDENT_BUDGET = 12 * 1024 * 1024
_JAX_TEMP_BUDGET = 2 * 1024 * 1024

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _jax_conservative_plan_fits(nx: int, ny: int, nz: int) -> bool:
    """The JAX package's answer on a conservative backend (the CPU): its
    ``pad_dims``, ``choose_tz_cg`` and resident budget, in f32 as it
    plans every dtype."""
    nxp = nx + 128 if nx % 128 == 0 else -(-nx // 128) * 128
    nyp = -(-ny // 8) * 8
    if nyp == ny:
        nyp += 8
    plane = nyp * nxp * 4
    tz_fits = any(nz % tz == 0 and 3 * (tz + 2) * plane <= _JAX_TEMP_BUDGET
                  and nz // tz <= 16 for tz in range(1, nz + 1))
    return tz_fits and 2 * (nz + 2) * nyp * nxp * 4 <= _JAX_RESIDENT_BUDGET


def vmem_cg_viable(nx: int, ny: int, nz: int, itemsize: int = 4,
                   device_type: str = "cpu", device_bytes: int = 0) -> bool:
    """Whether the one-launch solve takes an nx*ny*nz grid: on CUDA when
    its ``VECTORS`` vectors of ``itemsize`` bytes fit ``device_bytes`` (the
    card's memory), elsewhere where the JAX package's conservative plan
    fits (module docstring)."""
    if device_type == "cuda":
        return VECTORS * nx * ny * nz * itemsize <= device_bytes
    return _jax_conservative_plan_fits(nx, ny, nz)


@functools.lru_cache(maxsize=None)
def _note_l2(nx: int, ny: int, nz: int, itemsize: int) -> None:
    """Say once per grid whether an iteration's vectors fit the L2 budget."""
    nbytes = ITERATION_VECTORS * nx * ny * nz * itemsize
    where = ("within" if nbytes <= L2_RESIDENT_BUDGET
             else "above, so they stream from device memory,")
    print(f"vmem CG {nx}x{ny}x{nz}: r, the two p buffers, w and x take "
          f"{nbytes / 2**20:.1f} MB, {where} the "
          f"{L2_RESIDENT_BUDGET / 2**20:.0f} MB the L2 is planned to hold",
          file=sys.stderr)


@dataclasses.dataclass(frozen=True)
class CgPlan:
    """K5's launch: the form of phase A (``ring`` or ``march``), R rows a
    thread (the ring: the rows of a tile) and tz planes a tile, the tile
    counts (tiles_x * tiles_y * runs tiles of tile_x columns and tile_y
    rows: the ring's nx and R, the march's ``TILE_X`` and 8 R), the
    persistent grid (``blocks``, all co-resident), the dynamic shared bytes
    (the march: two staged planes; the ring: its mbarriers and slabs) and
    ``parts``, the partials (one a block for each of the two dots)."""

    r: int
    tz: int
    tiles_x: int
    tiles_y: int
    runs: int
    tiles: int
    blocks: int
    smem: int
    parts: int
    form: str = "march"
    tile_x: int = TILE_X
    tile_y: int = 0


def block_tiles(plan: CgPlan, b: int) -> range:
    """The tiles block ``b`` takes in phase A, in order: b, b + blocks,
    ..."""
    return range(b, plan.tiles, plan.blocks)


def ring_smem(nx: int, rows: int, itemsize: int) -> int:
    """The ring's dynamic shared bytes: two mbarriers a slab, then the
    ``RING_STAGES`` slabs, each (rows + 2) nx values of r and as many of
    p_old."""
    return RING_STAGES * (16 + 2 * (rows + 2) * nx * itemsize)


def ring_rows(nx: int, ny: int, itemsize: int):
    """R, the rows of a tile of the ring form, for rows of nx values of
    ``itemsize`` bytes, or None where the form does not apply: a row not
    whole 16-byte units, or a row of the tile beyond the consumers'
    ``RING_CONSUMERS`` * ``RING_POINTS`` points. R is the largest of
    ``PLAN_ROWS`` up to ``RING_ROWS``, ny and the rows whose plane-tile the
    consumers hold; the slabs then take at most 172064 bytes (R 1 at nx
    1792 in f64), within the H100's 227 KB a block."""
    cap = RING_CONSUMERS * RING_POINTS // nx
    if nx * itemsize % 16 or cap < 1:
        return None
    return max(q for q in PLAN_ROWS if q <= min(cap, ny, RING_ROWS))


def ring_columns(plan: CgPlan, nx: int):
    """The ring's columns of a tile by consumer: for consumer c, columns c,
    c + ``RING_CONSUMERS``, ... up to ``RING_POINTS`` / R of them, None
    past nx."""
    return [[i if i < nx else None
             for i in range(c, c + RING_CONSUMERS * (RING_POINTS // plan.r),
                            RING_CONSUMERS)]
            for c in range(RING_CONSUMERS)]


def ring_takes(nx: int, ny: int, nz: int, itemsize: int) -> bool:
    """The shape rule: the ring form where it applies and an iteration's
    ``ITERATION_VECTORS`` vectors do not fit the L2 budget."""
    return (ring_rows(nx, ny, itemsize) is not None
            and ITERATION_VECTORS * nx * ny * nz * itemsize
            > L2_RESIDENT_BUDGET)


def cg_plan(nx: int, ny: int, nz: int, itemsize: int, resident: int,
            r: int = None, tz: int = None, form: str = None) -> CgPlan:
    """K5's plan for an nx x ny x nz grid of vectors of ``itemsize`` bytes
    (4 f32, 8 f64) on a card where ``resident`` blocks of the form's kernel
    fit at once at the plan's shared bytes. ``form`` forces the form
    (``ring_takes`` by default; a forced ``r`` means the march), ``r`` the
    march's R and ``tz`` the planes a tile. The march's R is
    ``plan_rows(ny)`` by default, the ring's from ``ring_rows``; tz, up to nz
    (the march: and ``MAX_SERIAL`` / R), the one whose busiest block stages
    the fewest planes, ceil(tiles / resident) (tz + 2), the larger on a
    tie, then evened out over its runs. Raises ValueError on a bad input
    or a forced plan outside those limits."""
    for name, v in (("nx", nx), ("ny", ny), ("nz", nz),
                    ("resident", resident)):
        st._positive_int(name, v, "cg_plan")
    if itemsize not in (4, 8):
        raise ValueError(f"cg_plan: itemsize must be 4 or 8, got "
                         f"{itemsize!r}")
    if (ny + 2) * nx >= 2**31 - 1:
        raise ValueError(f"cg_plan: a plane of {nx} x {ny} points is too "
                         "large for the kernel's 32-bit in-plane offsets")
    if form is None:
        form = ("march" if r is not None or not ring_takes(nx, ny, nz,
                                                           itemsize)
                else "ring")
    if form == "ring":
        if r is not None:
            raise ValueError("cg_plan: the ring's R follows from the shape "
                             "(ring_rows)")
        r = ring_rows(nx, ny, itemsize)
        if r is None:
            raise ValueError(f"cg_plan: no ring form for rows of {nx} values"
                             f" of {itemsize} B")
        tz_max, tile_x, tile_y = nz, nx, r
        smem = ring_smem(nx, r, itemsize)
    elif form == "march":
        if r is None:
            r = plan_rows(ny)
        elif r not in PLAN_ROWS:
            raise ValueError(f"cg_plan: r must be one of {PLAN_ROWS}, got "
                             f"{r!r}")
        tz_max, tile_x, tile_y = MAX_SERIAL // r, TILE_X, WARPS * r
        smem = march_smem(r, itemsize)
    else:
        raise ValueError(f"cg_plan: form must be ring or march, got "
                         f"{form!r}")
    tiles_x = -(-nx // tile_x)
    tiles_y = -(-ny // tile_y)

    def tiles_at(q: int) -> int:
        return tiles_x * tiles_y * -(-nz // q)

    if tz is None:
        tz = min(range(1, min(tz_max, nz) + 1),
                 key=lambda q: (-(-tiles_at(q) // resident) * (q + 2), -q))
        tz = -(-nz // -(-nz // tz))  # the same runs, evened out
    elif st._positive_int("tz", tz, "cg_plan") > tz_max:
        raise ValueError(f"cg_plan: tz {tz} exceeds the {form}'s "
                         f"{tz_max}")
    tiles = tiles_at(tz)
    if tiles >= 2**31:
        raise ValueError(f"cg_plan: {tiles} tiles exceed the kernel's "
                         "32-bit tile index")
    return CgPlan(r=r, tz=tz, tiles_x=tiles_x, tiles_y=tiles_y,
                  runs=-(-nz // tz), tiles=tiles, blocks=resident,
                  smem=smem, parts=2 * resident, form=form, tile_x=tile_x,
                  tile_y=tile_y)


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _card_bytes(index: int) -> int:
    return torch.cuda.get_device_properties(index).total_memory


def _check(r0: torch.Tensor, x0: torch.Tensor, nx: int, ny: int, nz: int,
           itermax: int) -> None:
    n = nx * ny * nz
    dev = r0.device
    total = _card_bytes(_index(dev)) if dev.type == "cuda" else 0
    if not vmem_cg_viable(nx, ny, nz, r0.element_size(), dev.type, total):
        where = (f"its {VECTORS} vectors do not fit the card's {total} B"
                 if dev.type == "cuda" else
                 "the JAX package's VMEM plan refuses it on this backend")
        raise ValueError(
            f"vmem CG not viable at {nx}x{ny}x{nz} on {dev}: {where} "
            "(ops/stencil_cg_vmem.vmem_cg_viable); use a smaller grid or "
            "another cg variant")
    if r0.dtype not in _SUFFIX or x0.dtype != r0.dtype:
        raise TypeError(f"stencil_cg_vmem: r0 {r0.dtype} and x0 {x0.dtype} "
                        f"must both be one of {list(_SUFFIX)}")
    if r0.shape != (n,) or x0.shape != (n,) or itermax < 1:
        raise ValueError(f"stencil_cg_vmem: r0 {tuple(r0.shape)} and x0 "
                         f"{tuple(x0.shape)} must have length {n}, and "
                         f"itermax {itermax} >= 1")


def stencil_cg_vmem_torch(r0, x0, eps, nx: int, ny: int, nz: int,
                          itermax: int, use_7pt: bool = False):
    """Plain version of K5 (see the kernel's source note)."""
    _check(r0, x0, nx, ny, nz, itermax)
    dt = r0.dtype
    eps = torch.as_tensor(eps, device=r0.device).to(dt)
    r = r0.clone()
    p = torch.zeros_like(r0)
    x = x0.clone()
    hist = torch.full((itermax,), float("nan"), dtype=dt, device=r0.device)
    rtrans = torch.sum(r * r)
    rtrans_prev = rtrans
    hist[0] = torch.sqrt(rtrans)
    done = False
    for k in range(1, itermax):
        if done or not bool(torch.sqrt(rtrans_prev) > eps):
            break
        hist[k] = torch.sqrt(rtrans)
        if k == 1 or bool(rtrans_prev == 0):
            beta = torch.zeros((), dtype=dt, device=r0.device)
        else:
            beta = rtrans / rtrans_prev
        p = r + beta * p
        w = stencil_apply_torch(p, nx, ny, nz, use_7pt)
        pap = torch.sum(w * p)
        done = bool(pap <= rtrans * 1e-30)
        alpha = (torch.zeros((), dtype=dt, device=r0.device) if done
                 else rtrans / torch.where(pap == 0, 1, pap))
        r = r - alpha * w
        x = x + alpha * p
        rtrans_prev, rtrans = rtrans, torch.sum(r * r)
    return x, hist


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(_build.load_library("stencil_cg_vmem"))


_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the entry points' arguments: the vectors, hist, parts and eps; nx, ny,
# nz, use_7pt and itermax; the plan (rows, tz, blocks, smem, ring); the
# stream. The occupancy query: rows, use_7pt, ring, smem and the count.
ARGTYPES = [_p] * 8 + [_i32] * 5 + [_i32, _i32, _i64, _i64, _i32, _p]
BLOCKS_ARGTYPES = [_i32, _i32, _i32, _i64, ctypes.POINTER(_i32)]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s K5 entry points with their argument types."""
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"sb_stencil_cg_vmem_{sfx}")
        fn.argtypes = ARGTYPES
        fn.restype = _i32
        fn = getattr(lib, f"sb_stencil_cg_vmem_blocks_{sfx}")
        fn.argtypes = BLOCKS_ARGTYPES
        fn.restype = _i32
    return lib


@functools.lru_cache(maxsize=None)
def resident_blocks(dtype: torch.dtype, r: int, use_7pt: bool, ring: bool,
                    smem: int, device_index: int) -> int:
    """The blocks of the kernel (R rows, the stencil, the form, the vector
    type) that fit on a device at once with ``smem`` bytes of dynamic
    shared memory."""
    lib = _library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = getattr(lib, f"sb_stencil_cg_vmem_blocks_{_SUFFIX[dtype]}")(
            r, int(use_7pt), int(ring), smem, ctypes.byref(blocks))
    _build.check(lib, err, "stencil_cg_vmem occupancy")
    return blocks.value


def device_cg_plan(v: torch.Tensor, nx: int, ny: int, nz: int,
                   use_7pt: bool = False, r: int = None, tz: int = None,
                   form: str = None) -> CgPlan:
    """``cg_plan`` for CUDA vectors like ``v`` on their card (its choices
    forced where given), made once per grid, stencil, dtype and card."""
    return _device_cg_plan(nx, ny, nz, bool(use_7pt), r, tz, form, v.dtype,
                           _index(v.device))


@functools.lru_cache(maxsize=None)
def _device_cg_plan(nx, ny, nz, use_7pt, r, tz, form, dtype, index) -> CgPlan:
    # the plan at one block, for its form, R and shared bytes; then the
    # blocks of that kernel the card holds at those bytes
    shape = cg_plan(nx, ny, nz, dtype.itemsize, 1, r, tz, form)
    resident = resident_blocks(dtype, shape.r, use_7pt,
                               shape.form == "ring", shape.smem, index)
    return cg_plan(nx, ny, nz, dtype.itemsize, resident, r, tz, shape.form)


def stencil_cg_vmem(r0, x0, eps, nx: int, ny: int, nz: int, itermax: int,
                    use_7pt: bool = False, plan: CgPlan = None):
    """K5: the whole solve in one cooperative launch for CUDA tensors (on
    ``plan``, by default ``device_cg_plan``'s), the plain version for CPU
    tensors."""
    if on_cpu("stencil_cg_vmem", r0, x0):
        return stencil_cg_vmem_torch(r0, x0, eps, nx, ny, nz, itermax,
                                     use_7pt)
    x, hist = _launch(r0, x0, eps, nx, ny, nz, itermax, use_7pt, plan)
    stencil_cg_vmem.launches += 1
    profiler.count("stencil_cg_vmem.launches")
    return x, hist


def _launch(r0, x0, eps, nx, ny, nz, itermax, use_7pt, plan):
    """(x, hist): K5 on ``plan`` (default ``device_cg_plan``'s) from r0 and
    x0, which it copies; the two p buffers (the first zeros), w and the
    partials beside them. Counts ``stencil_cg_vmem.ring`` where the plan's
    form is the ring."""
    _check(r0, x0, nx, ny, nz, itermax)
    _note_l2(nx, ny, nz, r0.element_size())
    dev = r0.device
    plan = plan or device_cg_plan(r0, nx, ny, nz, use_7pt)
    profiler.annotate(form=plan.form, r=plan.r, tz=plan.tz,
                      blocks=plan.blocks)
    r = r0.contiguous().clone()
    x = x0.contiguous().clone()
    p0 = torch.zeros_like(r)  # p_old of the first iteration
    p1 = torch.empty_like(r)
    w = torch.empty_like(r)
    hist = torch.empty(itermax, dtype=r0.dtype, device=dev)
    parts = torch.empty(plan.parts, dtype=r0.dtype, device=dev)
    eps_t = torch.as_tensor(eps, dtype=r0.dtype, device=dev)
    st._call(_library(), f"sb_stencil_cg_vmem_{_SUFFIX[r0.dtype]}", dev, r,
             p0, p1, w, x, hist, parts, eps_t, nx, ny, nz, int(use_7pt),
             itermax, plan.r, plan.tz, plan.blocks, plan.smem,
             int(plan.form == "ring"))
    if plan.form == "ring":
        profiler.count("stencil_cg_vmem.ring")
    return x, hist


stencil_cg_vmem.launches = 0

# the registry's entry (profiler.kernels): a whole solve in one launch
KERNELS = (Kernel("K5", ("stencil_cg_vmem_kernel",), "solver loops",
                  (stencil_cg_vmem,)),)
