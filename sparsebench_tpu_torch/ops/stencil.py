"""Matrix-free stencil apply: the CUDA kernels K2 and K3 and their plain
PyTorch versions.

Counterpart of sparsebench_tpu/ops/stencil_pallas.py. The kernels are
``csrc/stencil.cu``; its source note says what bounds them and why their
design differs from the TPU kernels'.

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

``stencil_apply``, ``stencil_apply_dots`` and ``stencil_axpy_apply_dots``
are the wrappers: CPU tensors go to the plain version, CUDA tensors launch
the kernel or raise; there is no fallback from one to the other. Each
wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sparsebench_tpu_torch.ops import _build

THREADS = 256  # kThreads in csrc/common.cuh: one dot partial per block

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
    p, i32 = ctypes.c_void_p, ctypes.c_int
    for sfx in DTYPE_SUFFIX.values():
        fn = getattr(lib, f"sb_stencil_apply_{sfx}")
        fn.argtypes = [p, p, p, i32, i32, i32, i32, p]
        fn.restype = i32
        fn = getattr(lib, f"sb_stencil_axpy_apply_dots_{sfx}")
        fn.argtypes = [p, p, p, p, p, p, i32, i32, i32, i32, p]
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


def _launch_apply(x: torch.Tensor, nx, ny, nz, use_7pt, with_dots):
    n = nx * ny * nz
    _check_vec("stencil_apply", x, n)
    lib = _library()
    y = torch.empty_like(x)
    parts = (torch.empty((-(-n // THREADS), 2), dtype=torch.float32,
                         device=x.device) if with_dots else None)
    with torch.cuda.device(x.device):
        err = getattr(lib, f"sb_stencil_apply_{DTYPE_SUFFIX[x.dtype]}")(
            x.data_ptr(), y.data_ptr(),
            parts.data_ptr() if with_dots else None, nx, ny, nz,
            int(use_7pt), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "stencil_apply")
    return y, parts


def stencil_apply(x: torch.Tensor, nx: int, ny: int, nz: int,
                  use_7pt: bool = False) -> torch.Tensor:
    """K2: the CUDA kernel for a CUDA x, the plain version for a CPU x."""
    if on_cpu("stencil_apply", x):
        return stencil_apply_torch(x, nx, ny, nz, use_7pt)
    y, _ = _launch_apply(x, nx, ny, nz, use_7pt, False)
    stencil_apply.launches += 1
    return y


def stencil_apply_dots(x: torch.Tensor, nx: int, ny: int, nz: int,
                       use_7pt: bool = False):
    """K2's dots form: (A x, f32 [x.x, (Ax).x]); on CUDA the per-block
    partials are summed with torch.sum."""
    if on_cpu("stencil_apply_dots", x):
        return stencil_apply_dots_torch(x, nx, ny, nz, use_7pt)
    y, parts = _launch_apply(x, nx, ny, nz, use_7pt, True)
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


def stencil_axpy_apply_dots(r: torch.Tensor, p: torch.Tensor, beta,
                            nx: int, ny: int, nz: int, use_7pt: bool = False):
    """K3: the CUDA kernel for CUDA r and p, the plain version on the CPU.
    ``beta`` is a scalar or a 0-d tensor; it stays on the device."""
    if on_cpu("stencil_axpy_apply_dots", r, p):
        return stencil_axpy_apply_dots_torch(r, p, beta, nx, ny, nz, use_7pt)
    n = nx * ny * nz
    _check_vec("stencil_axpy_apply_dots", r, n)
    _check_vec("stencil_axpy_apply_dots", p, n)
    if p.dtype != r.dtype:
        raise TypeError(f"stencil_axpy_apply_dots: r {r.dtype} and p "
                        f"{p.dtype} differ")
    cdt = compute_dtype(r.dtype)
    beta = torch.as_tensor(beta, device=r.device).to(cdt).reshape(1)
    lib = _library()
    pn = torch.empty_like(r)
    w = torch.empty_like(r)
    parts = torch.empty(-(-n // THREADS), dtype=cdt, device=r.device)
    with torch.cuda.device(r.device):
        err = getattr(lib, f"sb_stencil_axpy_apply_dots_{DTYPE_SUFFIX[r.dtype]}")(
            r.data_ptr(), p.data_ptr(), beta.data_ptr(), pn.data_ptr(),
            w.data_ptr(), parts.data_ptr(), nx, ny, nz, int(use_7pt),
            torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, err, "stencil_axpy_apply_dots")
    stencil_axpy_apply_dots.launches += 1
    return pn, w, torch.sum(parts)


stencil_apply.launches = 0
stencil_apply_dots.launches = 0
stencil_axpy_apply_dots.launches = 0
