"""The body of CG fused around the SpMV, over k columns at once: the CUDA
kernels K15.

The kernels are ``csrc/cg_multi_body.cu``; its source note says what
bounds them and how each column's dots keep one order. They replace no TPU
kernel: the JAX package's loops are fused by XLA. A body of
``solvers/cg_multi.py cg_multi_loop`` on a (k, n) slab, and of
``solvers/cg.py cg_run`` at k = 1, is

    A  P-update    per column active, first, beta; P = R + beta P;
                   hist[it, c] = sqrt(rt)
       SpMV        AP = A P (K8 on DIA, else the stacked products; the
                   format's own kernel at k = 1)
    B  p.Ap        per column alpha, breakdown; commit count, rtrans,
                   normr, done
    C  X/R-update  X += alpha P; R -= alpha AP; r.r for the next body

one launch a stage for all k columns.

* ``body_kind(device_type, vdt, sdt, preconditioned)``: which body a loop
  takes, ``"kernel"`` or ``"torch"``; a pure function of what the run's
  input shows. The kernels take f32 or f64 vectors whose scalars
  accumulate in the same dtype, unpreconditioned, on a CUDA card; the CPU,
  bf16 vectors and PCG keep the plain body (``ops/cg_body.py``,
  ``solvers/cg_multi.py plain_bodies``).
* ``takes``: whether the SpMV's product is a slab the kernels read; the
  loops run the plain body where it is not.
* ``check_slab``: raises unless a tensor is a contiguous (k, n) slab of a
  dtype on a device, 16-byte aligned.
* ``Run``: one run's device state (X, P, R, the history, the per-column
  counts, the flags ``FLAGS`` with done among them, the scalar slots
  ``SLOTS``), the grid over n and the launch arguments, all set up once a
  run from any CG state. ``body_rr``, ``body_p``, ``body_pap`` and
  ``body_xr`` launch one kernel each and count their launches in
  ``.launches``. A run takes the slabs, history and counts it is given as
  its own and writes into them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sparsebench_tpu_torch.ops import _build
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
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def body_kind(device_type: str, vdt: torch.dtype, sdt: torch.dtype,
              preconditioned: bool) -> str:
    """``"kernel"`` where a CG loop runs K15: a CUDA device, no
    preconditioner, vectors and accumulation of one dtype, f32 or f64.
    ``"torch"`` (the plain body) everywhere else."""
    if (device_type == "cuda" and not preconditioned and vdt == sdt
            and vdt in _SUFFIX):
        return "kernel"
    return "torch"


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
    ``dtype`` vectors on ``shape`` slabs (``check_slab`` on its device).
    The product of one SpMV keeps its kind, so a loop asks once a run."""
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
        fn = getattr(lib, f"sb_cg_multi_blocks_{sfx}")
        fn.argtypes = [i64, ctypes.POINTER(i32)]
        fn.restype = i32
        fn = getattr(lib, f"sb_cg_multi_p_{sfx}")
        fn.argtypes = [p, p, p, p, p, p, i64, p, i64, i64, i32, i32, i32, p]
        fn.restype = i32
        fn = getattr(lib, f"sb_cg_multi_pap_{sfx}")
        fn.argtypes = [p, p, p, p, p, p, i64, i32, i32, i32, p]
        fn.restype = i32
        fn = getattr(lib, f"sb_cg_multi_xr_{sfx}")
        fn.argtypes = [p, p, p, p, p, p, p, i64, i32, i32, i32, i32, p]
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _grid(n: int, sfx: str, device_index: int) -> int:
    """The blocks over n of every launch of a run with n elements a column:
    one wave of the card at most (``sb_cg_multi_blocks_*``). Fixed for (n,
    dtype, card), so the dots of two runs sum in one order; cached, so a
    run set up inside a CUDA graph capture queries nothing."""
    lib = _library()
    g = ctypes.c_int(0)
    _build.check(lib, getattr(lib, f"sb_cg_multi_blocks_{sfx}")(
        n, ctypes.byref(g)), "cg_multi_body grid")
    return g.value


class Run:
    """One fused run on one card, set up once from a CG state of k columns:
    X, R and P (k, n) slabs, rtrans and normr (k,), the history (rows, k),
    contiguous, eps (k,) in f64, the counts (k,) int32 and done (k,) bool.
    X, R, P, the history and the counts become the run's own and are
    written in place; done is copied into the flags' row ``done``. Set up
    inside ``torch.cuda.device`` of the slabs."""

    def __init__(self, X, R, P, rtrans, normr, hist, eps, count, done,
                 k_end: int):
        dt, dev, shape = R.dtype, R.device, tuple(R.shape)
        if R.dim() != 2:
            raise ValueError(f"cg_multi_body: R must be (k, n), got {shape}")
        k, n = shape
        if dt not in _SUFFIX:
            raise TypeError(f"cg_multi_body: no kernel for {dt} slabs")
        for name, v in (("R", R), ("X", X), ("P", P)):
            check_slab(name, v, dt, dev, shape)
        for name, v, want, vdt in (
                ("rtrans", rtrans, (k,), dt), ("normr", normr, (k,), dt),
                ("eps", eps, (k,), torch.float64),
                ("hist", hist, (*hist.shape[:1], k), dt),
                ("count", count, (k,), torch.int32),
                ("done", done, (k,), torch.bool)):
            if (v.dtype != vdt or v.device != dev or tuple(v.shape) != want
                    or not v.is_contiguous()):
                raise ValueError(
                    f"cg_multi_body: {name} must be a contiguous {want} "
                    f"{vdt} tensor on {dev}, got {tuple(v.shape)} {v.dtype} "
                    f"on {v.device}, strides {v.stride()}")
        if dev.type != "cuda" or n == 0 or not 0 < k <= MAX_COLUMNS:
            raise TypeError(f"cg_multi_body: no kernel for {dt} slabs of "
                            f"{shape} on {dev}")
        sfx = _SUFFIX[dt]
        self.lib = _library()
        self.shape, self.dtype, self.device = shape, dt, dev
        self.X, self.R, self.P, self.hist = X, R, P, hist
        self.count, self.eps = count, eps
        self.s = torch.zeros((len(SLOTS), k), dtype=dt, device=dev)
        self.s[0] = rtrans
        self.s[1] = normr
        self.flags = torch.zeros((len(FLAGS), k), dtype=torch.int32,
                                 device=dev)
        self.flags[2] = done
        g = _grid(n, sfx, dev.index if dev.index is not None
                  else torch.cuda.current_device())
        self.partials = torch.empty((k, g), dtype=dt, device=dev)
        # column 0 starts aligned (check_slab), the others where n packs
        vec = int(k == 1 or n * R.element_size() % ALIGN == 0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        x_, p_, r_, s_ = (t.data_ptr() for t in (X, P, R, self.s))
        flags, parts = self.flags.data_ptr(), self.partials.data_ptr()
        self.fn_p = getattr(self.lib, f"sb_cg_multi_p_{sfx}")
        self.args_p = (r_, p_, s_, count.data_ptr(), eps.data_ptr(),
                       hist.data_ptr(), hist.shape[0], flags, k_end, n, g, k,
                       vec, stream)
        self.fn_pap = getattr(self.lib, f"sb_cg_multi_pap_{sfx}")
        self.args_pap = (p_, s_, count.data_ptr(), flags, parts, n, g, k, vec,
                         stream)
        self.fn_xr = getattr(self.lib, f"sb_cg_multi_xr_{sfx}")
        self.args_xr = (x_, p_, r_, s_, flags, parts, n, g, k, vec, 1, stream)
        self.args_rr = (None, None, None, r_, s_, flags, parts, n, g, k, vec,
                        0, stream)


def body_rr(run: Run) -> None:
    """C with no update: each column's r.r of the run's R into its slot
    ``rr`` (the start of a run from a state whose r.r it does not carry,
    on the grid of every C)."""
    _build.check(run.lib, run.fn_xr(*run.args_rr), "cg_multi_xr")
    body_rr.launches += 1


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


for _w in (body_rr, body_p, body_pap, body_xr):
    _w.launches = 0

# the registry's entry (profiler.kernels)
KERNELS = (Kernel("K15", ("cg_multi_p_kernel", "cg_multi_pap_kernel",
                          "cg_multi_xr_kernel"), "solver loops",
                  (body_rr, body_p, body_pap, body_xr)),)
