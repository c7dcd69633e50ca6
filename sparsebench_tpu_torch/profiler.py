"""Region profiler with the reference's bandwidth/flops model (reference
src/profiler.{h,c}; counterpart of sparsebench_tpu/profiler.py).

  * regions WAXPBY / SPMVM / DDOT / COMM (src/profiler.h:24);
  * per-element work model (src/profiler.c:19-22 with the factors of
    src/main.c:181-190): per CG iteration waxpby moves 3 words and does 6
    flops per row, ddot 2 words / 4 flops per row, spMVM moves
    (value_bytes + index_bytes) per nnz and does 2 flops per nnz;
  * the report table has the reference's layout (src/profiler.c:127-139).

The LIKWID marker hook (src/likwid-marker.h) becomes ``trace``: a
``torch.profiler`` capture of CUDA activity, with the program's spans
beside it, written as a Chrome trace.

The program's own record (``span``, ``count``, ``spans``, ``counts``,
``export``): spans at the port's layer boundaries (a solve and its bodies
in ``solvers/cg.py`` and ``solvers/cg_multi.py``, K5's whole solve in
``cg_vmem_loop``, an SpMV in ``formats/dia.py``, ``formats/crs.py`` and
``formats/stencil.py``, the matrix builds, a kernel library's load in
``ops/_build.py``) and counters beside them, kept in
memory and handed out at the end. Spans are stamped with ``time.time_ns()``, the clock
(CLOCK_REALTIME) on which ``torch.profiler`` puts its host and device
events, so a span lines up with the device operations and the CUDA
runtime calls of the same trace. The recorder records while it is
switched on (``set_mode("on")``, as ``trace`` does) or, in its default
mode ``auto``, while a ``torch.profiler`` session records; otherwise a
span is one check and records nothing, and a solver loop reads the switch
once a solve.

The kernel registry (``Kernel``, ``kernels``, ``kernels_named``): each
ops module declares its kernels beside their wrappers, by id (K1-K12,
K14, K15, P1-P5), the names their device events carry, their layer and
the wrappers whose ``launches`` count them; ``kernels`` gathers them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import functools
import importlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

HLINE = "-" * 70


class Region(enum.IntEnum):
    WAXPBY = 0
    SPMVM = 1
    DDOT = 2
    COMM = 3


_LABELS = {
    Region.WAXPBY: "waxpby:  ",
    Region.SPMVM: "spMVM:   ",
    Region.DDOT: "ddot:    ",
    Region.COMM: "comm:    ",
}

# words (in value-sized units) and flops per element per iteration
# (src/profiler.c:19-22)
_WORDS_PER_ELEM = {Region.WAXPBY: 3, Region.SPMVM: 0, Region.DDOT: 2, Region.COMM: 0}
_FLOPS_PER_ELEM = {Region.WAXPBY: 6, Region.SPMVM: 2, Region.DDOT: 4, Region.COMM: 0}


class Profiler:
    def __init__(self) -> None:
        self.times = np.zeros(len(Region))
        self.words = np.zeros(len(Region))   # bytes per iteration
        self.flops = np.zeros(len(Region))   # flops per iteration

    def init_factors(
        self,
        total_nr: int,
        total_nnz: int,
        value_bytes: int = 8,
        index_bytes: int = 4,
    ) -> None:
        """Reference profilerInit + factor setup (src/main.c:181-190,
        src/profiler.c:24-41). ``total_nnz`` is the reference's model count
        (27*total_nr for generated problems). COMM stays 0 until the
        distributed layer is ported."""
        for r in Region:
            self.words[r] = _WORDS_PER_ELEM[r] * value_bytes * total_nr
            self.flops[r] = _FLOPS_PER_ELEM[r] * total_nr
        self.flops[Region.SPMVM] = 2 * total_nnz
        self.words[Region.SPMVM] = (value_bytes + index_bytes) * total_nnz

    def add(self, region: Region, seconds: float) -> None:
        self.times[region] += seconds

    def report_aggregate(self, iterations: int, seconds: float) -> str:
        """Whole-solve summary: the solve is not split by region, so report
        the aggregate rate over all regions (the per-region table is the
        profiled solve's)."""
        by = self.words.sum() * iterations
        fl = self.flops.sum() * iterations
        mbs = 1.0e-6 * by / seconds if seconds > 0 else 0.0
        mfs = 1.0e-6 * fl / seconds if seconds > 0 else 0.0
        return (
            f"Solve aggregate (fused): {mbs:.2f} MB/s  {mfs:.2f} MFlop/s  "
            f"{seconds:.2f} s ({iterations} iterations; per-region table "
            f"requires --profile)"
        )

    def report(self, iterations: int) -> str:
        """Render the reference report (src/profiler.c:127-139)."""
        lines = [HLINE, "Function   Rate(MB/s)  Rate(MFlop/s)  Walltime(s)"]
        for r in (Region.WAXPBY, Region.SPMVM, Region.DDOT):
            t = self.times[r]
            by = self.words[r] * iterations
            fl = self.flops[r] * iterations
            mbs = 1.0e-6 * by / t if t > 0 else 0.0
            mfs = 1.0e-6 * fl / t if t > 0 else 0.0
            lines.append(f"{_LABELS[r]}{mbs:11.2f} {mfs:11.2f} {t:11.2f}")
        lines.append(HLINE)
        return "\n".join(lines)


# -- the program's spans and counters ---------------------------------------

MODES = ("auto", "on", "off")


class Span:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns()``;
    ``end_ns`` 0 while open), the index of its ``parent`` in the record (or
    None), the ``request`` it belongs to (a span opened with none open
    starts a request; its children share its id) and ``attrs``. Used as a
    context manager, it closes itself."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "attrs",
                 "_rec")

    def __init__(self, rec, name, parent, request, attrs):
        self.name, self.parent, self.request = name, parent, request
        self.attrs, self._rec = attrs, rec
        self.end_ns = 0
        self.start_ns = time.time_ns()

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._rec.stack.pop()
        return False

    def as_dict(self) -> dict:
        return {"name": self.name, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "parent": self.parent,
                "request": self.request, "attrs": dict(self.attrs)}


class _NoSpan:
    """What ``span`` gives while nothing is recorded."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class Recorder:
    """The spans and counter records of one process, in the order they
    opened."""

    def __init__(self) -> None:
        self.spans: list = []
        self.counts: list = []  # (name, n, time_ns, parent, request)
        self.stack: list = []   # indices of the open spans
        self._requests = itertools.count()

    def open(self, name: str, attrs: dict) -> Span:
        stack = self.stack
        if stack:
            parent = stack[-1]
            request = self.spans[parent].request
        else:
            parent, request = None, next(self._requests)
        s = Span(self, name, parent, request, attrs)
        stack.append(len(self.spans))
        self.spans.append(s)
        return s

    def count(self, name: str, n: int) -> None:
        parent = self.stack[-1] if self.stack else None
        request = self.spans[parent].request if parent is not None else None
        self.counts.append((name, n, time.time_ns(), parent, request))

    def clear(self) -> None:
        self.spans, self.counts, self.stack = [], [], []


RECORDER = Recorder()


class _Always:
    _is_profiler_enabled = True


class _Never:
    _is_profiler_enabled = False


# the switch is one attribute read: in mode "auto" it is torch's own flag
# of a recording profiler session, in "on" and "off" a constant
_SWITCHES = {"auto": _autograd_profiler, "on": _Always, "off": _Never}
_mode = "auto"
_switch = _autograd_profiler


def set_mode(mode: str) -> str:
    """Set the recorder's mode (one of ``MODES``): ``auto``, the default,
    records while a ``torch.profiler`` session records, ``on`` always,
    ``off`` never. Returns the mode it replaced."""
    global _mode, _switch
    if mode not in MODES:
        raise ValueError(f"recorder mode {mode!r} is not one of {MODES}")
    prev, _mode, _switch = _mode, mode, _SWITCHES[mode]
    return prev


def recording() -> bool:
    """Whether spans and counters are recorded now."""
    return _switch._is_profiler_enabled


def span(name: str, **attrs):
    """A span of ``name`` with ``attrs`` around a ``with`` block, recorded
    while the recorder records (``NO_SPAN`` otherwise)."""
    if _switch._is_profiler_enabled:
        return RECORDER.open(name, attrs)
    return NO_SPAN


def _no_span(name: str, **attrs):
    return NO_SPAN


def span_fn() -> Callable:
    """``span`` while the recorder records, else a function that records
    nothing: a loop reads the switch once and opens its bodies' spans
    through what this returns."""
    return span if _switch._is_profiler_enabled else _no_span


def annotate(**attrs) -> None:
    """Add ``attrs`` to the innermost open span, if one is open (a kernel
    wrapper naming the form it launched)."""
    if RECORDER.stack:
        RECORDER.spans[RECORDER.stack[-1]].attrs.update(attrs)


def count(name: str, n: int = 1) -> None:
    """Record ``n`` more of counter ``name`` while the recorder records."""
    if _switch._is_profiler_enabled:
        RECORDER.count(name, n)


def spans() -> list:
    """The recorded spans (``Span``), in the order they opened."""
    return list(RECORDER.spans)


def counts() -> dict:
    """{counter name: total recorded}."""
    out: dict = defaultdict(int)
    for name, n, *_rest in RECORDER.counts:
        out[name] += n
    return dict(out)


def export(path: str) -> None:
    """Write the record as JSON: {"spans": [...], "counts": [...]}."""
    data = {"clock": "time.time_ns (CLOCK_REALTIME)",
            "spans": [s.as_dict() for s in RECORDER.spans],
            "counts": [dict(zip(("name", "n", "time_ns", "parent",
                                 "request"), c)) for c in RECORDER.counts]}
    with open(path, "w") as f:
        json.dump(data, f)


def chrome_events(records, base_ns: int = 0) -> list:
    """Chrome trace events ("X", category ``program``) of the spans
    ``records``, on this process's host thread, ``ts`` in us after
    ``base_ns``."""
    pid, tid = os.getpid(), threading.get_native_id()
    out = []
    for s in records:
        if not s.end_ns:
            continue
        args = {k: v if isinstance(v, (int, float, str, bool)) else str(v)
                for k, v in s.attrs.items()}
        args["request"] = s.request
        out.append({"ph": "X", "cat": "program", "name": s.name,
                    "pid": pid, "tid": tid,
                    "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """LIKWID-marker analog: a Chrome trace of the block in
    ``logdir/trace.json``: with a CUDA card, ``torch.profiler``'s CUDA
    activity (device operations and the CUDA runtime calls that issued
    them); and the program's spans, recorded meanwhile, on the host
    thread's track. Host operations are not recorded: recording each one
    doubled a 200^3 solve, and so the trace would show another program."""
    if not logdir:
        yield
        return
    first = len(RECORDER.spans)
    mode = set_mode("on")
    try:
        if torch.cuda.is_available():
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                yield
        else:
            prof = None
            yield
    finally:
        set_mode(mode)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    data = {"traceEvents": []}
    if prof is not None:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    data["traceEvents"].extend(chrome_events(
        RECORDER.spans[first:], data.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(data, f)


# -- the kernel registry -----------------------------------------------------

# the layers of PERF.md's list that the port's kernels belong to
LAYERS = ("SpMV kernels", "solver loops", "device", "prototypes")

# the ops modules that declare kernels (``KERNELS`` beside their wrappers)
KERNEL_MODULES = ("dia_spmv", "stencil", "cg_fused", "stencil_cg_vmem",
                  "bslab_spmv", "dia_spmm", "bsell_spmv", "memroof",
                  "dia_window", "slab_slices", "csr_twopass", "crs_spmv",
                  "cg_multi_body")


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A hand-written kernel: its ``id`` (K1-K12, K14, K15, P1-P5), the
    ``names`` of the ``__global__`` functions its device events carry, its
    ``layer`` (one of ``LAYERS``) and the ``wrappers`` whose ``launches``
    count its launches."""
    id: str
    names: tuple
    layer: str
    wrappers: tuple

    @property
    def launches(self) -> int:
        return sum(w.launches for w in self.wrappers)


@functools.lru_cache(maxsize=None)
def kernels() -> dict:
    """{id: Kernel} of every ops module in ``KERNEL_MODULES``."""
    out = {}
    for mod in KERNEL_MODULES:
        for k in importlib.import_module(
                f"sparsebench_tpu_torch.ops.{mod}").KERNELS:
            if k.id in out:
                raise ValueError(f"kernel {k.id} declared twice")
            out[k.id] = k
    return out


def device_name(event_name: str) -> str:
    """The ``__global__`` function of a device event's name: without its
    return type, namespace, template arguments and parameters."""
    name = event_name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.rsplit("::", 1)[-1].strip()


def kernels_named(event_name: str) -> tuple:
    """The registry's kernels whose device events carry ``event_name``
    (two ids may share a body: K10 and K11, P1 and P2, P3 and P4)."""
    name = device_name(event_name)
    return tuple(k for k in kernels().values() if name in k.names)
