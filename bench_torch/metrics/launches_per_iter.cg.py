"""launches_per_iter.cg (count): device operations (kernels, copies and
sets) in the traced window over its solves times the configuration's
itermax, as ``profile_cg`` counts them; it includes each solve's few
check kernels. Layer: solver loops (``solvers/cg.py``). Moves
``solve_ms``."""


def read(ctx):
    if not ctx.iterations or not ctx.device_events:
        return None
    return ctx.device_events / ctx.iterations
