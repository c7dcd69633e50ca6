"""The program's own spans in a traced window, read beside its device
operations.

The port records spans at its layer boundaries
(``sparsebench_tpu_torch.profiler``) while a ``torch.profiler`` session
records, so the traced window of a ``--trace 1`` run holds them, stamped
on the clock of the trace's device events (``time.time_ns()``). A port
without that recorder gives no spans, and every reading here is then
None.

* ``window_ns``: the window on that clock, ``ctx.window_s`` long and
  ending with the last device operation (the window's last operation is
  closed by a synchronise);
* ``idle_intervals``: the gaps between device operations inside it;
* ``timeline``: at each instant of it, the innermost span open on the
  host (``OUTSIDE`` where none is);
* ``idle_by_span``: the window's idle time put down to the innermost
  span open during each gap, by overlap of intervals; the parts sum to
  the window's idle time;
* ``self_s``: each span name's self time in the window (its spans'
  durations less their children's);
* ``mean_us``: each span name's mean duration, which an untraced window
  gives too.
"""

from __future__ import annotations

from collections import defaultdict

OUTSIDE = "outside any span"


def program_spans():
    """The port's closed spans, in the order they opened, or None when the
    port has no span recorder."""
    try:
        from sparsebench_tpu_torch import profiler
    except ImportError:
        return None
    spans = getattr(profiler, "spans", None)
    if spans is None:
        return None
    return [s for s in spans() if s.end_ns]


def window_ns(ctx) -> tuple:
    """(start, end) of the traced window on the trace's clock, or None
    without device operations."""
    if not ctx.device:
        return None
    end = max(e for _n, _s, e in ctx.device)
    return end - round(ctx.window_s * 1e9), end


def in_window(spans, w0: int, w1: int, name: str) -> list:
    """The spans of ``name`` that lie inside [w0, w1]."""
    return [s for s in spans
            if s.name == name and s.start_ns >= w0 and s.end_ns <= w1]


def idle_intervals(device, w0: int, w1: int) -> list:
    """[(start, end)] of [w0, w1] in which no device operation ran;
    ``device`` holds (name, start, end) sorted by start."""
    out, cur = [], w0
    for _n, s, e in device:
        if e <= cur:
            continue
        if s > cur:
            out.append((cur, min(s, w1)))
        cur = e
        if cur >= w1:
            break
    if cur < w1:
        out.append((cur, w1))
    return [(a, b) for a, b in out if b > a]


def timeline(spans, w0: int, w1: int) -> list:
    """[(start, end, name)] covering [w0, w1] in order: the innermost span
    open at each instant, ``OUTSIDE`` where none is. Spans of one thread
    nest, so a stack walk finds it."""
    out, stack = [], []
    t = w0

    def upto(stop):
        nonlocal t
        stop = min(max(stop, w0), w1)
        if stop > t:
            out.append((t, stop, stack[-1].name if stack else OUTSIDE))
            t = stop

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1].end_ns <= s.start_ns:
            upto(stack[-1].end_ns)
            stack.pop()
        upto(s.start_ns)
        stack.append(s)
    while stack:
        upto(stack[-1].end_ns)
        stack.pop()
    upto(w1)
    return out


def overlap_by_name(intervals, segments) -> dict:
    """{name: ns} of ``intervals`` covered by each name's ``segments``
    (both sorted, the segments contiguous)."""
    out, j = defaultdict(int), 0
    for a, b in intervals:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            lo, hi = max(a, segments[k][0]), min(b, segments[k][1])
            if hi > lo:
                out[segments[k][2]] += hi - lo
            k += 1
    return dict(out)


def self_s(segments) -> dict:
    """{name: seconds} of a ``timeline``, largest first."""
    out = defaultdict(int)
    for a, b, name in segments:
        out[name] += b - a
    return {k: v * 1e-9 for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def mean_us(spans) -> dict:
    """{name: mean duration in us} of ``spans``."""
    total, n = defaultdict(int), defaultdict(int)
    for s in spans:
        total[s.name] += s.end_ns - s.start_ns
        n[s.name] += 1
    return {k: total[k] * 1e-3 / n[k] for k in total}


def breakdown(ctx, spans) -> dict:
    """{"window_s", "idle_s", "idle_by_span": {name: s}, "self_s": {name:
    s}} of the traced window, or None without device operations."""
    w = window_ns(ctx)
    if w is None:
        return None
    w0, w1 = w
    segments = timeline(spans, w0, w1)
    idle = idle_intervals(ctx.device, w0, w1)
    by_span = overlap_by_name(idle, segments)
    return {"window_s": (w1 - w0) * 1e-9,
            "idle_s": sum(b - a for a, b in idle) * 1e-9,
            "idle_by_span": {k: v * 1e-9 for k, v in sorted(
                by_span.items(), key=lambda kv: -kv[1])},
            "self_s": self_s(segments)}
