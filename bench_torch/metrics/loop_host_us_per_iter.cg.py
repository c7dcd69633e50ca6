"""loop_host_us_per_iter.cg (us): host time inside the CG loop per
iteration: the durations of the window's solve spans (``cg.solve``, the
port's ``solvers/cg.py``) over their count times the configuration's
itermax. It includes any wait of the host on a full launch queue. Layer:
solver loops. Moves ``solve_ms``. None where the port records no spans."""

from harness import spans as sp


def read(ctx):
    spans, w = sp.program_spans(), sp.window_ns(ctx)
    if not spans or w is None:
        return None
    solves = sp.in_window(spans, *w, "cg.solve")
    if not solves:
        return None
    host_ns = sum(s.end_ns - s.start_ns for s in solves)
    return host_ns * 1e-3 / (len(solves) * ctx.config["itermax"])
