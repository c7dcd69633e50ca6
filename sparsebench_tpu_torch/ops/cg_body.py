"""The body of standard CG fused around the SpMV: the CUDA kernels K13 and
their plain PyTorch version.

The kernels are ``csrc/cg_body.cu``; its source note says what bounds them
and how their dots keep one order. They replace no TPU kernel: the JAX
package's body is fused by XLA. A body of ``solvers/cg.py cg_run`` is

    A  p-update    active, first, beta; p = r + beta p; hist[k] = sqrt(rt)
       SpMV        Ap = A p (the format's own kernel, K1 on DIA)
    B  p.Ap        alpha, breakdown; commit k, rtrans, normr, done
    C  x/r-update  x += alpha p; r -= alpha Ap; r.r for the next body

* ``body_kind(device_type, vdt, sdt, preconditioned)``: which body a run
  takes, ``"kernel"`` or ``"torch"``; a pure function of what the run's
  input shows. The kernels take f32 or f64 vectors whose scalars
  accumulate in the same dtype, unpreconditioned, on a CUDA card; the CPU,
  bf16 vectors and PCG keep the plain body.
* ``body_p_torch``, ``body_pap_torch``, ``body_xr_torch``: the plain
  version, the three stages as torch operations in the order the eager
  body has always run them (r.r is taken at the start of A there, where
  the kernels take it at the end of the previous C: the same r, summed in
  another order). ``plain_bodies`` runs them around the SpMV; ``cg_run``
  runs it wherever the kernels do not engage.
* ``Run``: one run's device state for the kernels (its own x, p, r, the
  history, k, done and the scalar slots ``SLOTS``), the grid and the
  launch arguments, all set up once a run. ``body_rr``, ``body_p``,
  ``body_pap`` and ``body_xr`` launch one kernel each on it and count
  their launches in ``.launches``. A run never writes into the state it
  starts from, so never into ``b`` or ``x0``. ``Run.takes`` says, on the
  run's first body, whether the SpMV's product is a vector the kernels
  read; where it is not (a format whose product keeps its values' dtype
  when the vectors have another), ``cg_run`` runs the plain body instead,
  from the state the run started from.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.ops.blas1 import ddot, safe_div
from sparsebench_tpu_torch.profiler import Kernel

# the scalar slots of a run, in the scalars' dtype (enum Slot in
# csrc/cg_body.cu): the state's rtrans and normr, the r.r of the current r,
# the body's rt and new normr, its alpha
SLOTS = ("rtrans", "normr", "rr", "rt", "normr_new", "alpha")
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def body_kind(device_type: str, vdt: torch.dtype, sdt: torch.dtype,
              preconditioned: bool) -> str:
    """``"kernel"`` where ``cg_run`` runs the fused body: a CUDA device, no
    preconditioner, vectors and accumulation of one dtype, f32 or f64.
    ``"torch"`` (the plain body) everywhere else."""
    if (device_type == "cuda" and not preconditioned and vdt == sdt
            and vdt in _SUFFIX):
        return "kernel"
    return "torch"


# -- the plain version ------------------------------------------------------

class PStage(NamedTuple):
    """What A leaves for the rest of a plain body."""
    active: torch.Tensor
    rt: torch.Tensor
    p_new: torch.Tensor
    normr_new: torch.Tensor
    hist: torch.Tensor


def body_p_torch(state, k_end: int, eps, steps, sdt, apply_m=None) -> PStage:
    """Plain A: the body's flags and scalars, p_new and the history.
    ``apply_m`` (PCG): p_new = z + beta p, z = M^-1 r, with rtrans carrying
    r.z and the history the true ||r||."""
    k, _x, p, r, rtrans, normr, hist, done = state
    vdt = r.dtype
    active = (k < k_end) & (normr > eps) & ~done
    first = k == 1
    if apply_m is None:
        new_rtrans = ddot(r, r, acc_dtype=sdt)
        rt = torch.where(first, rtrans, new_rtrans)
        # first body: p = r (beta = 0; x0 is finite, so r + 0*p == r)
        beta = torch.where(first, 0, safe_div(new_rtrans, rtrans)).to(vdt)
        p_new = r + beta * p
        normr_new = torch.sqrt(rt)
    else:
        z = apply_m(r)
        rz = ddot(r, z, acc_dtype=sdt)
        rt = torch.where(first, rtrans, rz)
        beta = torch.where(first, 0, safe_div(rz, rtrans)).to(vdt)
        p_new = z + beta * p
        normr_new = torch.sqrt(ddot(r, r, acc_dtype=sdt))
    hist = torch.where(active & (steps == k), normr_new, hist)
    return PStage(active, rt, p_new, normr_new, hist)


def body_pap_torch(a: PStage, ap: torch.Tensor, sdt):
    """Plain B: (breakdown, alpha) from p.Ap; alpha is 0 on a breakdown
    and in an inactive body."""
    pap = ddot(a.p_new, ap, acc_dtype=sdt)
    breakdown = pap <= a.rt * 1e-30
    alpha = torch.where(breakdown | ~a.active, 0,
                        safe_div(a.rt, pap)).to(a.p_new.dtype)
    return breakdown, alpha


def body_xr_torch(state, a: PStage, ap: torch.Tensor, b):
    """Plain C: the state after the body; an inactive body keeps every
    entry but x and r, which take alpha = 0."""
    k, x, p, r, rtrans, normr, _hist, done = state
    breakdown, alpha = b
    x = x + alpha * a.p_new
    r = r - alpha * ap
    p = torch.where(a.active, a.p_new, p)
    rtrans = torch.where(a.active, a.rt, rtrans)
    normr = torch.where(a.active, a.normr_new, normr)
    done = done | (a.active & breakdown)
    k = k + a.active.to(k.dtype)
    return k, x, p, r, rtrans, normr, a.hist, done


def plain_bodies(spmv, state, bodies: int, k_end: int, eps, sdt,
                 apply_m=None, span=contextlib.nullcontext):
    """``bodies`` plain bodies from ``state``, each in ``span("cg.body")``:
    the state after them. ``eps`` is a tensor of the scalars' dtype ``sdt``
    on the vectors' device."""
    steps = torch.arange(state[6].numel(), device=state[3].device)
    for _ in range(bodies):
        with span("cg.body"):
            a = body_p_torch(state, k_end, eps, steps, sdt, apply_m)
            ap = spmv(a.p_new)
            state = body_xr_torch(state, a, ap, body_pap_torch(a, ap, sdt))
    return state


# -- the kernels ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("cg_body")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"sb_cg_body_blocks_{sfx}")
        fn.argtypes = [i64, ctypes.POINTER(i32)]
        fn.restype = i32
        fn = getattr(lib, f"sb_cg_body_p_{sfx}")
        fn.argtypes = [p, p, p, p, p, p, p, i64, p, i64, i64, i32, p]
        fn.restype = i32
        fn = getattr(lib, f"sb_cg_body_pap_{sfx}")
        fn.argtypes = [p, p, p, p, p, p, p, i64, i32, p]
        fn.restype = i32
        fn = getattr(lib, f"sb_cg_body_xr_{sfx}")
        fn.argtypes = [p, p, p, p, p, p, p, i64, i32, i32, p]
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _grid(n: int, sfx: str, device_index: int) -> int:
    """The blocks of every launch of a run of n elements: one wave of the
    card at most (``sb_cg_body_blocks_*``). Fixed for (n, dtype, card), so
    the dots of two runs sum in one order; cached, so a run set up inside a
    CUDA graph capture queries nothing."""
    lib = _library()
    g = ctypes.c_int(0)
    _build.check(lib, getattr(lib, f"sb_cg_body_blocks_{sfx}")(
        n, ctypes.byref(g)), "cg_body grid")
    return g.value


def _vector(name: str, v: torch.Tensor, dt, device, n: int) -> None:
    if v.dtype != dt or v.device != device or v.dim() != 1 or v.numel() != n:
        raise ValueError(
            f"cg_body: {name} must be a 1-D {dt} vector of length {n} on "
            f"{device}, got {tuple(v.shape)} {v.dtype} on {v.device}")


class Run:
    """One run of the fused body on one card, set up once: checks, copies
    of the state, scalar slots, the grid, the stream and the launch
    arguments. Set up inside ``torch.cuda.device`` of the vectors."""

    def __init__(self, state, k_end: int, eps: torch.Tensor):
        k, x, p, r, rtrans, normr, hist, done = state
        dt, dev, n = r.dtype, r.device, r.numel()
        if dt not in _SUFFIX or dev.type != "cuda" or n == 0:
            raise TypeError(
                f"cg_body: no kernel for {dt} vectors of length {n} on {dev}")
        for name, v in (("x", x), ("p", p), ("r", r)):
            _vector(name, v, dt, dev, n)
        _vector("hist", hist, dt, dev, hist.numel())
        for name, v in (("k", k), ("rtrans", rtrans), ("normr", normr),
                        ("done", done)):
            if v.numel() != 1 or v.device != dev:
                raise ValueError(f"cg_body: {name} must be one value on {dev}")
        sfx = _SUFFIX[dt]
        self.lib = _library()
        self.n, self.dtype, self.device = n, dt, dev
        same = torch.contiguous_format
        self.x, self.p, self.r = (v.clone(memory_format=same)
                                  for v in (x, p, r))
        self.hist = hist.clone(memory_format=same)
        self.k = k.reshape(()).to(torch.int64, copy=True)
        self.done = done.reshape(()).to(torch.bool, copy=True)
        self.s = torch.zeros(len(SLOTS), dtype=dt, device=dev)
        self.s[0] = rtrans.reshape(())
        self.s[1] = normr.reshape(())
        self.eps = eps.to(device=dev, dtype=torch.float64).reshape(())
        self.flags = torch.zeros(2, dtype=torch.int32, device=dev)
        g = _grid(n, sfx, dev.index if dev.index is not None
                  else torch.cuda.current_device())
        self.partials = torch.empty(g, dtype=dt, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        x_, p_, r_, s_ = (t.data_ptr() for t in (self.x, self.p, self.r,
                                                 self.s))
        flags, parts = self.flags.data_ptr(), self.partials.data_ptr()
        self.fn_p = getattr(self.lib, f"sb_cg_body_p_{sfx}")
        self.args_p = (r_, p_, s_, self.k.data_ptr(), self.done.data_ptr(),
                       self.eps.data_ptr(), self.hist.data_ptr(),
                       self.hist.numel(), flags, k_end, n, g, stream)
        self.fn_pap = getattr(self.lib, f"sb_cg_body_pap_{sfx}")
        self.args_pap = (p_, s_, self.k.data_ptr(), self.done.data_ptr(),
                         flags, parts, n, g, stream)
        self.fn_xr = getattr(self.lib, f"sb_cg_body_xr_{sfx}")
        self.args_xr = (x_, p_, r_, s_, flags, parts, n, g, 1, stream)
        self.args_rr = (None, None, None, r_, s_, flags, parts, n, g, 0,
                        stream)
        self.ap_taken = False

    def takes(self, ap: torch.Tensor) -> bool:
        """Whether B and C can read the SpMV's product ``ap``: a contiguous
        vector of the run's dtype, length and device, 16-byte aligned (the
        kernels read it 16 bytes at a time). Checked on the run's first
        body; the product of one SpMV keeps its kind, so later bodies only
        read the answer."""
        if not self.ap_taken:
            self.ap_taken = (
                ap.dtype == self.dtype and ap.device == self.device
                and ap.dim() == 1 and ap.numel() == self.n
                and ap.is_contiguous() and ap.data_ptr() % 16 == 0)
        return self.ap_taken

    def state(self):
        """The run's state tuple (k, x, p, r, rtrans, normr, hist, done)."""
        return (self.k, self.x, self.p, self.r, self.s[0], self.s[1],
                self.hist, self.done)


def body_rr(run: Run) -> None:
    """C with no update: r.r of the run's r into its slot ``rr`` (the
    start of a run, on the grid of every C)."""
    _build.check(run.lib, run.fn_xr(*run.args_rr), "cg_body_xr")
    body_rr.launches += 1


def body_p(run: Run) -> None:
    """A: p = r + beta p where the body is active; hist[k]."""
    _build.check(run.lib, run.fn_p(*run.args_p), "cg_body_p")
    body_p.launches += 1


def body_pap(run: Run, ap: torch.Tensor) -> None:
    """B: p.Ap, alpha; commits k, rtrans, normr and done. ``ap`` is one
    the run takes (``Run.takes``)."""
    _build.check(run.lib, run.fn_pap(ap.data_ptr(), *run.args_pap),
                 "cg_body_pap")
    body_pap.launches += 1


def body_xr(run: Run, ap: torch.Tensor) -> None:
    """C: x += alpha p, r -= alpha Ap, r.r for the next body."""
    _build.check(run.lib, run.fn_xr(ap.data_ptr(), *run.args_xr),
                 "cg_body_xr")
    body_xr.launches += 1


for _w in (body_rr, body_p, body_pap, body_xr):
    _w.launches = 0

# the registry's entry (profiler.kernels)
KERNELS = (Kernel("K13", ("cg_body_p_kernel", "cg_body_pap_kernel",
                          "cg_body_xr_kernel"), "solver loops",
                  (body_rr, body_p, body_pap, body_xr)),)
