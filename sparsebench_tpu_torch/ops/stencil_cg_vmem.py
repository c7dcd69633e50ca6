"""The whole CG solve on the matrix-free stencil in one launch: the CUDA
kernel K5 and its plain PyTorch version.

Counterpart of sparsebench_tpu/ops/stencil_cg_vmem.py
(``stencil_cg_vmem_pallas``). The kernel is ``csrc/stencil_cg_vmem.cu``, one
cooperative launch of a persistent kernel whose grid-wide barriers separate
the phases of each iteration; its source note gives the recurrence (the
lagged exit test, beta = 0 at k == 1, the breakdown freeze, NaN history
past the exit) and the design.

Viability (``vmem_cg_viable``). The TPU kernel keeps r and p in VMEM and
plans its tiles for that (``_plan``); on a backend whose VMEM it has not
measured, the CPU among them, only the conservative tier of that plan
runs, and 200^3 is refused. The plain version keeps that refusal, so the
two packages refuse the same grids on the CPU. On the card r and p stay
in device memory either way, so the kernel runs every grid whose vectors
fit the card's memory; whether r and p also fit the 50 MB L2
(``L2_RESIDENT_BUDGET``, 40 MB with margin for x's stream: 100^3 in f32
takes 8 MB, 200^3 64 MB) only moves its speed, and the wrapper notes it
on stderr once per grid.

* ``stencil_cg_vmem_torch(r0, x0, eps, nx, ny, nz, itermax, use_7pt)`` —
  the plain version, the same recurrence in PyTorch with the stencil's
  plain apply; it reads the scalars on the host.
* ``stencil_cg_vmem(...)`` — the wrapper: CPU tensors to the plain version,
  CUDA tensors to the kernel (or it raises); ``launches`` counts launches.

Both take r0 = b - A x0 and x0 of one dtype, f32 or f64 (the computation
runs in that dtype; the solver widens bf16 vectors first), and return
(x, hist) with hist of length itermax, NaN past the exit.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import torch

from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.ops.stencil import on_cpu, stencil_apply_torch

L2_RESIDENT_BUDGET = 40 * 2**20  # bytes of r and p; the H100's L2 is 50 MB
# vectors of n values a kernel solve holds in device memory: r0 and x0,
# and the kernel's r, p and x
VECTORS = 5

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
    """Say once per grid whether r and p fit the L2 budget."""
    nbytes = 2 * nx * ny * nz * itemsize
    where = ("within" if nbytes <= L2_RESIDENT_BUDGET
             else "above, so they stream from device memory,")
    print(f"vmem CG {nx}x{ny}x{nz}: r and p take {nbytes / 2**20:.1f} MB, "
          f"{where} the {L2_RESIDENT_BUDGET / 2**20:.0f} MB the L2 is "
          "planned to hold", file=sys.stderr)


def _check(r0: torch.Tensor, x0: torch.Tensor, nx: int, ny: int, nz: int,
           itermax: int) -> None:
    n = nx * ny * nz
    dev = r0.device
    total = (torch.cuda.get_device_properties(dev).total_memory
             if dev.type == "cuda" else 0)
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
    lib = _build.load_library("stencil_cg_vmem")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"sb_stencil_cg_vmem_{sfx}")
        fn.argtypes = [p, p, p, p, p, p, i32, i32, i32, i32, i32, i32, p]
        fn.restype = i32
        fn = getattr(lib, f"sb_stencil_cg_vmem_blocks_{sfx}")
        fn.argtypes = [ctypes.POINTER(i32)]
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def grid_blocks(dtype: torch.dtype, device_index: int) -> int:
    """The kernel's grid on a device: the co-resident block count."""
    lib = _library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = getattr(lib, f"sb_stencil_cg_vmem_blocks_{_SUFFIX[dtype]}")(
            ctypes.byref(blocks))
    _build.check(lib, err, "stencil_cg_vmem occupancy")
    return blocks.value


def stencil_cg_vmem(r0, x0, eps, nx: int, ny: int, nz: int, itermax: int,
                    use_7pt: bool = False):
    """K5: the whole solve in one cooperative launch for CUDA tensors, the
    plain version for CPU tensors."""
    if on_cpu("stencil_cg_vmem", r0, x0):
        return stencil_cg_vmem_torch(r0, x0, eps, nx, ny, nz, itermax,
                                     use_7pt)
    _check(r0, x0, nx, ny, nz, itermax)
    _note_l2(nx, ny, nz, r0.element_size())
    dev = r0.device
    blocks = grid_blocks(r0.dtype, dev.index if dev.index is not None
                         else torch.cuda.current_device())
    r = r0.contiguous().clone()
    x = x0.contiguous().clone()
    p = torch.zeros_like(r)
    hist = torch.empty(itermax, dtype=r0.dtype, device=dev)
    parts = torch.empty(2 * blocks, dtype=r0.dtype, device=dev)
    eps_t = torch.as_tensor(eps, device=dev).to(r0.dtype).reshape(1)
    lib = _library()
    with torch.cuda.device(dev):
        err = getattr(lib, f"sb_stencil_cg_vmem_{_SUFFIX[r0.dtype]}")(
            r.data_ptr(), p.data_ptr(), x.data_ptr(), hist.data_ptr(),
            parts.data_ptr(), eps_t.data_ptr(), nx, ny, nz, int(use_7pt),
            itermax, blocks, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "stencil_cg_vmem")
    stencil_cg_vmem.launches += 1
    return x, hist


stencil_cg_vmem.launches = 0
