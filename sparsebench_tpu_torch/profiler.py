"""Region profiler with the reference's bandwidth/flops model (reference
src/profiler.{h,c}; counterpart of sparsebench_tpu/profiler.py).

  * regions WAXPBY / SPMVM / DDOT / COMM (src/profiler.h:24);
  * per-element work model (src/profiler.c:19-22 with the factors of
    src/main.c:181-190): per CG iteration waxpby moves 3 words and does 6
    flops per row, ddot 2 words / 4 flops per row, spMVM moves
    (value_bytes + index_bytes) per nnz and does 2 flops per nnz;
  * the report table has the reference's layout (src/profiler.c:127-139).

The LIKWID marker hook (src/likwid-marker.h) becomes ``trace``: a
``torch.profiler`` capture written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import enum
import os
from typing import Optional

import numpy as np
import torch

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


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """LIKWID-marker analog: capture a ``torch.profiler`` trace of the span
    (CPU, plus CUDA when present) into ``logdir/trace.json``."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
