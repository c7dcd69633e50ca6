"""Matrix-free stencil apply: the CUDA kernels K2 and K3, their tile plan
and their plain PyTorch versions.

Counterpart of sparsebench_tpu/ops/stencil_pallas.py. The kernels are
``csrc/stencil.cu``, on the tiled plane march of ``csrc/stencil_apply.cuh``;
their source notes say what bounds them and why their design differs from
the TPU kernels'.

Vectors have the generator's natural row order, i = (iz*ny + iy)*nx + ix,
length nx*ny*nz, with no padding (the TPU kernels' padded
(nz+2, nyp, nxp) space serves 128-lane rolls and costs 35 % more bytes per
vector pass at 100^3). The operator (reference src/matrix.c:30-121) is

    27-point:  A v = 28 v - Sz(Sy(Sx v))
    7-point:   A v = 30 v - ((Sx v + Sy v) + Sz v)

with S_a the zero-boundary 3-point sum ((left + centre) + right) along axis
a, each op rounded on its own. The kernels use the same order, so kernel and
plain version agree bit for bit. (The JAX package's XLA form sums Sx first
as here; its Pallas form applies Sz first. Against JAX the port is held to
a tolerance.) bf16 vectors are computed in f32 and stored as bf16.

* ``stencil_apply_torch(x, nx, ny, nz, use_7pt)`` -> y
* ``stencil_apply_dots_torch(...)`` -> (y, f32 [x.x, (Ax).x])
* ``stencil_axpy_apply_dots_torch(r, p, beta, ...)`` -> (p', w, delta):
  p' = r + beta p, w = A p', delta = p'.w at the compute width (f32 for
  bf16/f32 vectors, f64 for f64), beta at that width.

The march. A block of 256 threads owns an (x, y) tile, 32 columns (a
warp's lanes) by 8 R rows (R a thread), over a run of tz planes; it stages
each plane of the run and the one on either side, with a 1-point halo in x
and y, once in shared memory, forms Sx and Sy(Sx) there and carries the
z-sums in registers. ``tile_plan(nx, ny, nz, itemsize, sms)`` chooses R,
tz and the grid (tiles x runs) from the card's SM count and gives the
shared bytes; the wrappers pass it to the C entry points, which check it
against the grid and refuse a plan that does not fit. ``block_origin``
says which tile and planes a block of the plan owns, as the kernels
compute it. The dots' partials are one per block of the plan: a thread
adds its own R * tz terms in order (at most ``MAX_SERIAL``, so the dots
stay within the summation bound that chip_smoke.py's ``dots_check``
holds them to), the block its threads by a fixed tree, and the wrapper
the blocks with torch.sum.

``stencil_apply``, ``stencil_apply_dots`` and ``stencil_axpy_apply_dots``
are the wrappers: CPU tensors go to the plain version, CUDA tensors launch
the kernel or raise; there is no fallback from one to the other. On CUDA
they take the plan of ``device_plan`` (cached per grid, vector width and
device) unless given one. Each wrapper's ``launches`` counts its kernel
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.profiler import Kernel

THREADS = 256            # kThreads in csrc/common.cuh: a block's threads
TILE_X = 32              # sb::kTileX: a tile's columns, one a lane
WARPS = THREADS // 32    # sb::kMarchWarps: R rows of a tile each
STAGE_X = TILE_X + 2     # sb::kStageX: a staged row, the tile and its halo
PLAN_ROWS = (1, 2, 4, 8)  # the R (rows a thread) the kernels are built for
# a thread's serial run of dot terms, R * tz: with the product's rounding,
# the block tree and torch.sum it stays inside dots_check's bound
MAX_SERIAL = 32
# a run's planes to start from: runs of 8 timed best at 100^3 and 200^3 on
# the H100 (PERF.md, profile_cg --stencil-plans); each block stages
# tz + 2 planes for tz
TZ_START = 8
# blocks of the plan an SM should have to take in: tz shrinks until the
# grid reaches this many a SM, or tz is 1
BLOCKS_PER_SM = 2

# vector dtype -> suffix of the C entry points
DTYPE_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32",
                torch.float64: "f64"}


def compute_dtype(dt: torch.dtype) -> torch.dtype:
    """The arithmetic width of a vector dtype: bf16 computes in f32."""
    return torch.float32 if dt == torch.bfloat16 else dt


def _sum3(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Zero-boundary 3-point sum along ``dim``: (left + centre) + right."""
    n = v.shape[dim]
    z = torch.zeros_like(v.narrow(dim, 0, 1))
    p = torch.cat([z, v, z], dim)
    return (p.narrow(dim, 0, n) + p.narrow(dim, 1, n)) + p.narrow(dim, 2, n)


def _apply(v: torch.Tensor, nx: int, ny: int, nz: int,
           use_7pt: bool) -> torch.Tensor:
    """A v in v's own dtype (the compute width), flat natural order."""
    v3 = v.reshape(nz, ny, nx)
    if use_7pt:
        s = (_sum3(v3, 2) + _sum3(v3, 1)) + _sum3(v3, 0)
        y = 30 * v3 - s
    else:
        y = 28 * v3 - _sum3(_sum3(_sum3(v3, 2), 1), 0)
    return y.reshape(-1)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A launch of the march: R rows a thread (a tile of 32 x 8 R points),
    tz planes a run, the tile counts, the grid (tiles_x * tiles_y * runs
    blocks, one dot partial each) and the dynamic shared bytes (two staged
    planes at the compute width)."""

    r: int
    tz: int
    tiles_x: int
    tiles_y: int
    runs: int
    grid: int
    smem: int

    @property
    def tile_y(self) -> int:
        return WARPS * self.r


def _positive_int(name: str, v, who: str = "tile_plan") -> int:
    if isinstance(v, bool) or not isinstance(v, int) or v < 1:
        raise ValueError(f"{who}: {name} must be a positive int, got {v!r}")
    return v


def plan_rows(ny: int) -> int:
    """The default R: the one of ``PLAN_ROWS`` that stages the fewest rows
    of a plane, ceil(ny / 8R) (8R + 2), the larger on a tie."""
    return min(PLAN_ROWS, key=lambda q: (-(-ny // (WARPS * q))
                                         * (WARPS * q + 2), -q))


def march_smem(r: int, itemsize: int) -> int:
    """The march's dynamic shared bytes: two staged planes of (8R + 2) x 34
    values at the compute width (f32 for bf16 vectors)."""
    return 2 * (WARPS * r + 2) * STAGE_X * (8 if itemsize == 8 else 4)


def tile_plan(nx: int, ny: int, nz: int, itemsize: int, sms: int,
              r: int = None, tz: int = None) -> TilePlan:
    """The march's plan for an nx x ny x nz grid of vectors of ``itemsize``
    bytes (2 bf16, 4 f32, 8 f64; the staged planes hold the compute width,
    f32 for bf16) on a card of ``sms`` SMs. ``r`` and ``tz`` force those
    choices. By default R is the one of ``PLAN_ROWS`` that stages the
    fewest rows of a plane, ceil(ny / 8R) (8R + 2), the larger on a tie;
    and tz the largest, up to ``TZ_START``, ``MAX_SERIAL`` / R and nz, that
    still gives ``BLOCKS_PER_SM`` blocks a SM (else 1), then evened out
    over its runs.
    Raises ValueError on a bad input or a forced plan outside those
    limits."""
    for name, v in (("nx", nx), ("ny", ny), ("nz", nz), ("sms", sms)):
        _positive_int(name, v)
    if itemsize not in (2, 4, 8):
        raise ValueError(f"tile_plan: itemsize must be 2, 4 or 8, got "
                         f"{itemsize!r}")
    if (ny + 2) * nx >= 2**31 - 1:
        raise ValueError(f"tile_plan: a plane of {nx} x {ny} points is too "
                         "large for the kernels' 32-bit in-plane offsets")
    if r is None:
        r = plan_rows(ny)
    elif r not in PLAN_ROWS:
        raise ValueError(f"tile_plan: r must be one of {PLAN_ROWS}, got "
                         f"{r!r}")
    tz_max = MAX_SERIAL // r
    tiles_x = -(-nx // TILE_X)
    tiles_y = -(-ny // (WARPS * r))
    if tz is None:
        tz = min(TZ_START, tz_max, nz)
        while tz > 1 and tiles_x * tiles_y * -(-nz // tz) < (
                BLOCKS_PER_SM * sms):
            tz -= 1
        tz = -(-nz // -(-nz // tz))  # the same runs, evened out
    elif _positive_int("tz", tz) > tz_max:
        raise ValueError(f"tile_plan: r * tz = {r * tz} exceeds the dots' "
                         f"serial run of {MAX_SERIAL}")
    runs = -(-nz // tz)
    return TilePlan(r=r, tz=tz, tiles_x=tiles_x, tiles_y=tiles_y, runs=runs,
                    grid=tiles_x * tiles_y * runs, smem=march_smem(r, itemsize))


def block_origin(plan, nz: int, b: int):
    """(x0, y0, z0, z1) of tile ``b`` of ``plan`` (a ``TilePlan``, where
    block b marches tile b, or K5's ``CgPlan``): its first column and row
    and its planes [z0, z1), as the kernels compute them (x tiles fastest,
    then y tiles, then runs)."""
    rest, tx = divmod(b, plan.tiles_x)
    run, ty = divmod(rest, plan.tiles_y)
    return (tx * TILE_X, ty * plan.tile_y, run * plan.tz,
            min(run * plan.tz + plan.tz, nz))


@functools.lru_cache(maxsize=None)
def _device_plan(nx, ny, nz, itemsize, index) -> TilePlan:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return tile_plan(nx, ny, nz, itemsize, sms)


def device_plan(v: torch.Tensor, nx: int, ny: int, nz: int) -> TilePlan:
    """The plan for CUDA vectors like ``v``, cached per grid, width and
    device."""
    return _device_plan(nx, ny, nz, v.element_size(), v.device.index
                        if v.device.index is not None
                        else torch.cuda.current_device())


def _check_vec(name: str, v: torch.Tensor, n: int) -> None:
    if v.dtype not in DTYPE_SUFFIX:
        raise TypeError(f"{name}: no kernel for {v.dtype}; supported: "
                        f"{list(DTYPE_SUFFIX)}")
    if v.dim() != 1 or v.shape[0] != n or not v.is_contiguous():
        raise ValueError(f"{name}: vectors must be contiguous 1-D of length "
                         f"nx*ny*nz = {n}, got {tuple(v.shape)}")


def on_cpu(name: str, *vs: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; False when all lie on one
    CUDA device; raises otherwise."""
    if all(v.device.type == "cpu" for v in vs):
        return True
    dev = vs[0].device
    if dev.type != "cuda" or any(v.device != dev for v in vs):
        raise ValueError(
            f"{name}: tensors on {[str(v.device) for v in vs]}; all must be "
            "on one CUDA device (or all on the CPU)")
    return False


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("stencil")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    plan = [i32, i32, i64, i64]  # r, tz, grid, smem
    for sfx in DTYPE_SUFFIX.values():
        fn = getattr(lib, f"sb_stencil_apply_{sfx}")
        fn.argtypes = [p, p, p, i32, i32, i32, i32, *plan, p]
        fn.restype = i32
        fn = getattr(lib, f"sb_stencil_axpy_apply_dots_{sfx}")
        fn.argtypes = [p, p, p, p, p, p, i32, i32, i32, i32, *plan, p]
        fn.restype = i32
    return lib


# -- K2 -------------------------------------------------------------------


def stencil_apply_torch(x: torch.Tensor, nx: int, ny: int, nz: int,
                        use_7pt: bool = False) -> torch.Tensor:
    """Plain version of K2: y = A x in x's dtype."""
    return _apply(x.to(compute_dtype(x.dtype)), nx, ny, nz,
                  use_7pt).to(x.dtype)


def stencil_apply_dots_torch(x: torch.Tensor, nx: int, ny: int, nz: int,
                             use_7pt: bool = False):
    """Plain version of K2's dots form: (A x, f32 [x.x, (Ax).x]), the dots
    from the values before a bf16 store rounds y."""
    y = _apply(x.to(compute_dtype(x.dtype)), nx, ny, nz, use_7pt)
    xf, yf = x.float(), y.float()
    return y.to(x.dtype), torch.stack([torch.sum(xf * xf), torch.sum(yf * xf)])


def _call(lib: ctypes.CDLL, name: str, device: torch.device, *args) -> None:
    """Launch ``name`` of ``lib`` on ``device``'s current stream, tensors
    passed as their data pointers; raise if the C side refused it."""
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = getattr(lib, name)(
            *ptrs, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, name)


def _launch_apply(x: torch.Tensor, nx, ny, nz, use_7pt, with_dots, plan):
    """(y, parts): K2 on ``plan`` (default ``device_plan``'s); parts, with
    the dots, one f32 pair per block of the plan."""
    _check_vec("stencil_apply", x, nx * ny * nz)
    plan = plan or device_plan(x, nx, ny, nz)
    y = torch.empty_like(x)
    parts = (torch.empty((plan.grid, 2), dtype=torch.float32,
                         device=x.device) if with_dots else None)
    _call(_library(), f"sb_stencil_apply_{DTYPE_SUFFIX[x.dtype]}", x.device,
          x, y, parts, nx, ny, nz, int(use_7pt), plan.r, plan.tz, plan.grid,
          plan.smem)
    return y, parts


def stencil_apply(x: torch.Tensor, nx: int, ny: int, nz: int,
                  use_7pt: bool = False, plan: TilePlan = None) -> torch.Tensor:
    """K2: the CUDA kernel for a CUDA x (on ``plan``, by default
    ``device_plan``'s), the plain version for a CPU x."""
    if on_cpu("stencil_apply", x):
        return stencil_apply_torch(x, nx, ny, nz, use_7pt)
    y, _ = _launch_apply(x, nx, ny, nz, use_7pt, False, plan)
    stencil_apply.launches += 1
    return y


def stencil_apply_dots(x: torch.Tensor, nx: int, ny: int, nz: int,
                       use_7pt: bool = False, plan: TilePlan = None):
    """K2's dots form: (A x, f32 [x.x, (Ax).x]); on CUDA the partials, one
    pair per block of the plan, are summed with torch.sum."""
    if on_cpu("stencil_apply_dots", x):
        return stencil_apply_dots_torch(x, nx, ny, nz, use_7pt)
    y, parts = _launch_apply(x, nx, ny, nz, use_7pt, True, plan)
    stencil_apply_dots.launches += 1
    return y, torch.sum(parts, dim=0)


# -- K3 -------------------------------------------------------------------


def stencil_axpy_apply_dots_torch(r: torch.Tensor, p: torch.Tensor, beta,
                                  nx: int, ny: int, nz: int,
                                  use_7pt: bool = False):
    """Plain version of K3: (p' = r + beta p, w = A p', delta = p'.w)."""
    cdt = compute_dtype(r.dtype)
    beta = torch.as_tensor(beta, device=r.device).to(cdt)
    pn = r.to(cdt) + beta * p.to(cdt)
    w = _apply(pn, nx, ny, nz, use_7pt)
    return pn.to(r.dtype), w.to(r.dtype), torch.sum(w * pn)


def _launch_axpy(r: torch.Tensor, p: torch.Tensor, beta, nx, ny, nz, use_7pt,
                 plan):
    """(p', w, parts): K3 on ``plan`` (default ``device_plan``'s); parts,
    one delta partial per block of the plan at the compute width."""
    n = nx * ny * nz
    _check_vec("stencil_axpy_apply_dots", r, n)
    _check_vec("stencil_axpy_apply_dots", p, n)
    if p.dtype != r.dtype:
        raise TypeError(f"stencil_axpy_apply_dots: r {r.dtype} and p "
                        f"{p.dtype} differ")
    cdt = compute_dtype(r.dtype)
    beta = torch.as_tensor(beta, device=r.device).to(cdt).reshape(1)
    plan = plan or device_plan(r, nx, ny, nz)
    pn = torch.empty_like(r)
    w = torch.empty_like(r)
    parts = torch.empty(plan.grid, dtype=cdt, device=r.device)
    _call(_library(), f"sb_stencil_axpy_apply_dots_{DTYPE_SUFFIX[r.dtype]}",
          r.device, r, p, beta, pn, w, parts, nx, ny, nz, int(use_7pt),
          plan.r, plan.tz, plan.grid, plan.smem)
    return pn, w, parts


def stencil_axpy_apply_dots(r: torch.Tensor, p: torch.Tensor, beta,
                            nx: int, ny: int, nz: int, use_7pt: bool = False,
                            plan: TilePlan = None):
    """K3: the CUDA kernel for CUDA r and p (on ``plan``, by default
    ``device_plan``'s), the plain version on the CPU. ``beta`` is a scalar
    or a 0-d tensor; it stays on the device. delta is the torch.sum of one
    partial per block of the plan."""
    if on_cpu("stencil_axpy_apply_dots", r, p):
        return stencil_axpy_apply_dots_torch(r, p, beta, nx, ny, nz, use_7pt)
    pn, w, parts = _launch_axpy(r, p, beta, nx, ny, nz, use_7pt, plan)
    stencil_axpy_apply_dots.launches += 1
    return pn, w, torch.sum(parts)


stencil_apply.launches = 0
stencil_apply_dots.launches = 0
stencil_axpy_apply_dots.launches = 0

# the registry's entries (profiler.kernels): K2 with and without its dots
KERNELS = (
    Kernel("K2", ("stencil_apply_kernel",), "SpMV kernels",
           (stencil_apply, stencil_apply_dots)),
    Kernel("K3", ("stencil_axpy_apply_dots_kernel",), "SpMV kernels",
           (stencil_axpy_apply_dots,)),
)
