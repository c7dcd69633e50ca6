"""The body of simultaneous (multi-RHS) CG fused around the blocked SpMV:
the CUDA kernels K15.

The kernels are ``csrc/cg_multi_body.cu``; its source note says what
bounds them and how each column's dots keep K13's order. They replace no
TPU kernel: the JAX package's loop is fused by XLA. A body of
``solvers/cg_multi.py cg_multi_loop`` on a (k, n) slab is

    A  P-update    per column active, first, beta; P = R + beta P;
                   hist[it, c] = sqrt(rt)
       SpMV        AP = A P (K8 on DIA, else the stacked products)
    B  p.Ap        per column alpha, breakdown; commit count, rtrans,
                   normr, done
    C  X/R-update  X += alpha P; R -= alpha AP; r.r for the next body

one launch a stage for all k columns. Which body a loop takes is
``cg_body.body_kind`` (unpreconditioned), the rule K13 follows: f32 or f64
vectors accumulated in the same dtype on a CUDA card. ``takes`` says
whether the SpMV's product is a slab the kernels read; the eager loop
(``solvers/cg_multi.py plain_bodies``, the plain version) runs wherever
either says no.

* ``check_slab``: raises unless a tensor is a contiguous (k, n) slab of a
  dtype on a device, 16-byte aligned.
* ``Run``: one run's device state (X, P, R, the history, the per-column
  counts and flags, the scalar slots ``SLOTS``), K13's grid over n
  (``cg_body._grid``) and the launch arguments, all set up once a run.
  ``body_p``, ``body_pap`` and ``body_xr`` launch one kernel each and count
  their launches in ``.launches``. A run takes the R and the history it is
  given as its own and writes into them (the loop's init made both); X0 it
  copies.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.ops.cg_body import _SUFFIX, _grid
from sparsebench_tpu_torch.profiler import Kernel

# the rows of a run's (6, k) scalar slots, in the scalars' dtype (enum Slot
# in csrc/cg_multi_body.cu): each column's rtrans and normr, the r.r of its
# current r, the body's rt and new normr, its alpha
SLOTS = ("rtrans", "normr", "rr", "rt", "normr_new", "alpha")
# the rows of a run's (3, k) int32 flags (enum Flag): the body's active
# flag, the column's ticket, done
FLAGS = ("active", "ticket", "done")
ALIGN = 16  # bytes: the kernels' vector loads and stores
MAX_COLUMNS = 65535  # gridDim.y


def check_slab(name: str, t: torch.Tensor, dtype: torch.dtype,
               device: torch.device, shape: tuple) -> None:
    """Raise ValueError unless ``t`` is a contiguous ``shape`` slab of
    ``dtype`` on ``device`` whose data start 16-byte aligned."""
    if (t.dtype != dtype or t.device != device or tuple(t.shape) != shape
            or not t.is_contiguous() or t.data_ptr() % ALIGN):
        raise ValueError(
            f"cg_multi_body: {name} must be a contiguous {shape} {dtype} slab "
            f"on {device}, {ALIGN}-byte aligned; got {tuple(t.shape)} "
            f"{t.dtype} on {t.device}, strides {t.stride()}, data at "
            f"{t.data_ptr() % ALIGN} mod {ALIGN}")


def takes(ap: torch.Tensor, dtype: torch.dtype, shape: tuple) -> bool:
    """Whether the kernels read the SpMV's product ``ap`` of a run of
    ``dtype`` vectors on ``shape`` slabs (``check_slab`` on its device)."""
    try:
        check_slab("AP", ap, dtype, ap.device, shape)
    except ValueError:
        return False
    return True


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("cg_multi_body")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"sb_cg_multi_p_{sfx}")
        fn.argtypes = [p, p, p, p, p, p, i64, p, i64, i64, i32, i32, i32, p]
        fn.restype = i32
        fn = getattr(lib, f"sb_cg_multi_pap_{sfx}")
        fn.argtypes = [p, p, p, p, p, p, i64, i32, i32, i32, p]
        fn.restype = i32
        fn = getattr(lib, f"sb_cg_multi_xr_{sfx}")
        fn.argtypes = [p, p, p, p, p, p, p, i64, i32, i32, i32, p]
        fn.restype = i32
    return lib


class Run:
    """One fused blocked run on one card, set up once from the state the
    loop's init leaves: X0 and R (k, n) slabs, rtrans and normr (k,), the
    history (k_end, k), contiguous, with its row 0 written, eps (k,); the
    per-column counts start at 1. R and the history become the run's
    ``R`` and ``hist``. Set up inside ``torch.cuda.device`` of the slabs."""

    def __init__(self, X0, R, rtrans, normr, hist, eps, k_end: int):
        dt, dev, shape = R.dtype, R.device, tuple(R.shape)
        if R.dim() != 2:
            raise ValueError(f"cg_multi_body: R must be (k, n), got {shape}")
        k, n = shape
        check_slab("R", R, dt, dev, shape)
        for name, v, want in (("X0", X0, shape), ("rtrans", rtrans, (k,)),
                              ("normr", normr, (k,)), ("eps", eps, (k,)),
                              ("hist", hist, (k_end, k))):
            if (v.dtype != dt or v.device != dev or tuple(v.shape) != want
                    or name == "hist" and not v.is_contiguous()):
                raise ValueError(
                    f"cg_multi_body: {name} must be {want} {dt} on {dev}"
                    f"{', contiguous' if name == 'hist' else ''}, got "
                    f"{tuple(v.shape)} {v.dtype} on {v.device}, strides "
                    f"{v.stride()}")
        if (dt not in _SUFFIX or dev.type != "cuda" or n == 0
                or not 0 < k <= MAX_COLUMNS):
            raise TypeError(f"cg_multi_body: no kernel for {dt} slabs of "
                            f"{shape} on {dev}")
        sfx = _SUFFIX[dt]
        self.lib = _library()
        self.shape, self.dtype, self.device = shape, dt, dev
        same = torch.contiguous_format
        self.X = X0.clone(memory_format=same)
        self.R = R
        self.P = torch.zeros_like(R)
        self.hist = hist
        self.iters = torch.ones(k, dtype=torch.int32, device=dev)
        self.s = torch.zeros((len(SLOTS), k), dtype=dt, device=dev)
        self.s[0] = rtrans
        self.s[1] = normr
        self.eps = eps.contiguous()
        self.flags = torch.zeros((len(FLAGS), k), dtype=torch.int32,
                                 device=dev)
        g = _grid(n, sfx, dev.index if dev.index is not None
                  else torch.cuda.current_device())
        self.partials = torch.empty((k, g), dtype=dt, device=dev)
        vec = int(n * R.element_size() % ALIGN == 0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        x_, p_, r_, s_ = (t.data_ptr() for t in (self.X, self.P, self.R,
                                                 self.s))
        flags, parts = self.flags.data_ptr(), self.partials.data_ptr()
        self.fn_p = getattr(self.lib, f"sb_cg_multi_p_{sfx}")
        self.args_p = (r_, p_, s_, self.iters.data_ptr(),
                       self.eps.data_ptr(), self.hist.data_ptr(), k_end,
                       flags, k_end, n, g, k, vec, stream)
        self.fn_pap = getattr(self.lib, f"sb_cg_multi_pap_{sfx}")
        self.args_pap = (p_, s_, self.iters.data_ptr(), flags, parts, n, g,
                         k, vec, stream)
        self.fn_xr = getattr(self.lib, f"sb_cg_multi_xr_{sfx}")
        self.args_xr = (x_, p_, r_, s_, flags, parts, n, g, k, vec, stream)


def body_p(run: Run) -> None:
    """A: P = R + beta P in the active columns; hist[it]."""
    _build.check(run.lib, run.fn_p(*run.args_p), "cg_multi_p")
    body_p.launches += 1


def body_pap(run: Run, ap: torch.Tensor) -> None:
    """B: p.Ap and alpha a column; commits each active column's count,
    rtrans, normr and done. Raises on an ``ap`` the run does not take."""
    check_slab("AP", ap, run.dtype, run.device, run.shape)
    _build.check(run.lib, run.fn_pap(ap.data_ptr(), *run.args_pap),
                 "cg_multi_pap")
    body_pap.launches += 1


def body_xr(run: Run, ap: torch.Tensor) -> None:
    """C: X += alpha P, R -= alpha AP, r.r a column for the next body."""
    check_slab("AP", ap, run.dtype, run.device, run.shape)
    _build.check(run.lib, run.fn_xr(ap.data_ptr(), *run.args_xr),
                 "cg_multi_xr")
    body_xr.launches += 1


for _w in (body_p, body_pap, body_xr):
    _w.launches = 0

# the registry's entry (profiler.kernels)
KERNELS = (Kernel("K15", ("cg_multi_p_kernel", "cg_multi_pap_kernel",
                          "cg_multi_xr_kernel"), "solver loops",
                  (body_p, body_pap, body_xr)),)
