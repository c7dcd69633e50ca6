"""stencil_cg_host_us.vmem (us): the mean duration of the traced window's
K5 solve spans (``stencil.cg_vmem``, around K5's wrapper in the port's
``solvers/cg.py`` ``cg_vmem_loop``): the wrapper's checks, plan,
allocations and launch, on the host. Layer: solver loops. Moves
``solve_ms``. None where the port records no such span."""

from harness import spans as sp


def read(ctx):
    spans, w = sp.program_spans(), sp.window_ns(ctx)
    if not spans or w is None:
        return None
    calls = sp.in_window(spans, *w, "stencil.cg_vmem")
    if not calls:
        return None
    return sum(s.end_ns - s.start_ns for s in calls) * 1e-3 / len(calls)
