"""loop_idle_pct.cg (%): the share of the traced window in which no device
operation ran while the innermost span open on the host was the CG loop's
own (``cg.solve``, ``cg.init`` or ``cg.body`` of ``solvers/cg.py``; not
the SpMV's ``dia.spmv`` inside it): the idle time that the loop's host
code leaves. Layer: solver loops. Moves ``solve_ms``. None where the port
records no spans."""

from harness import spans as sp

LOOP_SPANS = ("cg.solve", "cg.init", "cg.body")


def read(ctx):
    spans, w = sp.program_spans(), sp.window_ns(ctx)
    if not spans or w is None or not sp.in_window(spans, *w, "cg.solve"):
        return None
    idle = sp.breakdown(ctx, spans)["idle_by_span"]
    return 100.0 * sum(idle.get(n, 0.0) for n in LOOP_SPANS) / ctx.window_s
