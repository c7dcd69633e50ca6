"""The arithmetic of a window and of the spread between runs."""

from __future__ import annotations

import statistics


def percentile(values, q: int) -> float:
    """The q-th percentile (1 <= q <= 99) of ``values`` by
    ``statistics.quantiles`` (its default, exclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100)[q - 1]


def window_metrics(window_s: float, ops: int, rhs: int, op_s) -> dict:
    """The statistics a traffic mix can name as its end-to-end metrics:
    ``op_ms`` (the window over the operations it completed), ``rhs_ms``
    (the window over operations times right-hand sides) and
    ``op_p95_ms`` (the 95th percentile of the operations' own times, when
    they were taken)."""
    out = {"op_ms": window_s / ops * 1e3,
           "rhs_ms": window_s / (ops * rhs) * 1e3}
    if op_s:
        out["op_p95_ms"] = percentile(op_s, 95) * 1e3
    return out


def spread(values) -> float:
    """The distance between the first and third quartile, as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
