"""crs_spmv_host_us.crs (us): the mean duration of the traced window's
SpMV spans (``crs.spmv``, ``CRSMatrix.spmv`` in the port's
``formats/crs.py``): the wrapper's checks, the output's allocation and
K14's launch, on the host. Layer: SpMV kernels. Moves ``solve_ms``. None
where the port records no such span."""

from harness import spans as sp


def read(ctx):
    spans, w = sp.program_spans(), sp.window_ns(ctx)
    if not spans or w is None:
        return None
    calls = sp.in_window(spans, *w, "crs.spmv")
    if not calls:
        return None
    return sum(s.end_ns - s.start_ns for s in calls) * 1e-3 / len(calls)
