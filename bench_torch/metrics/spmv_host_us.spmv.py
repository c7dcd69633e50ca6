"""spmv_host_us.spmv (us): the mean duration of the window's SpMV spans
(``dia.spmv``, ``DiaMatrix.spmv`` in the port's ``formats/dia.py``): the
wrapper's checks, the output's allocation and K1's launch, on the host.
Layer: SpMV kernels. Moves ``spmv_ms``. None where the port records no
spans."""

from harness import spans as sp


def read(ctx):
    spans, w = sp.program_spans(), sp.window_ns(ctx)
    if not spans or w is None:
        return None
    calls = sp.in_window(spans, *w, "dia.spmv")
    if not calls:
        return None
    return sum(s.end_ns - s.start_ns for s in calls) * 1e-3 / len(calls)
