"""idle_pct.nrhs (%): the share of the traced window in which no device
operation ran: 100 x (window - busy) / window, busy the union of the
device operations' intervals. Layer: device. Moves ``rhs_solve_ms``."""


def read(ctx):
    if ctx.window_s <= 0 or not ctx.device_events:
        return None
    return 100.0 * (ctx.window_s - ctx.busy_s) / ctx.window_s
