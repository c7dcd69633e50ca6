"""The traced window: ``torch.profiler`` with CUDA activity alone around
it, read from the profiler's raw events (``kineto_results.events()``:
building its Python event tree would cost minutes at 100^3, where a
second holds some 10^5 kernels). Host activity is left out: recording
every host operation doubled a solve's time at 200^3 and so changed the
very idle share the trace is taken for.

From the trace: every device operation (kernels, copies and sets) with
its start and end; busy time as the union of their intervals; the
operations that took most time; and the idle gaps between them, summed
by what the host was doing, as the device shows it: issuing the
operation that ended the gap, or, after an operation's copy of its
check to the host, synchronising and issuing the next operation.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

from torch.autograd import DeviceType

TOP = 10


class Trace:
    """What a traced window gives its per-layer readers (``ctx``)."""

    def __init__(self, events, window_s: float, ops: int, cfg: dict,
                 traffic: dict, device_kind: str, spans: dict):
        self.config, self.device_kind = cfg, device_kind
        self.spans = spans
        self.window_s = window_s
        self.ops = ops
        self.rhs = traffic.get("rhs", 1)
        # a solve is the configuration's itermax iterations, as the
        # reference counts them; an SpMV is one
        self.iterations = ops * (cfg["itermax"] if traffic["op"] != "spmv"
                                 else 1)
        dev = []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                start = e.start_ns()
                dev.append((e.name(), start, start + e.duration_ns()))
        dev.sort(key=lambda d: d[1])
        self.device = dev
        self.device_events = len(dev)
        self.device_s = sum(end - s for _n, s, end in dev) * 1e-9
        self.busy_s = _union_ns(dev) * 1e-9

    def kernel(self, names) -> tuple:
        """(count, seconds) of the device operations whose name holds
        one of ``names``."""
        count, ns = 0, 0
        for name, s, end in self.device:
            if any(k in name for k in names):
                count += 1
                ns += end - s
        return count, ns * 1e-9

    def breakdown(self) -> dict:
        by_name = defaultdict(int)
        for name, s, end in self.device:
            by_name[short(name)] += end - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self._gaps().items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, t * 1e-9] for n, t in ops],
                "idle_gaps": [[n, t * 1e-9] for n, t in gaps]}

    def _gaps(self) -> dict:
        """Idle nanoseconds between device operations, summed by what the
        host was doing."""
        out = defaultdict(int)
        end, last = None, None
        for name, s, e in self.device:
            if end is not None and s > end:
                if "DtoH" in last:
                    out["host between operations (synchronise, check, "
                        "next issue)"] += s - end
                else:
                    out[f"host issuing {short(name)}"] += s - end
            if end is None or e > end:
                end, last = e, name
        return out


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and arguments, cut to
    ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, c in enumerate(name):
        depth += c == "<"
        depth -= c == ">"
        if c == "(" and depth == 0:
            name = name[:i]
            break
    return name[:width]


def _union_ns(intervals) -> int:
    total, cur_s, cur_e = 0, None, None
    for _n, s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profiled(fn):
    """(fn(), the profiler's raw events) with CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def read_metrics(spec, workload: str, ctx: Trace) -> dict:
    """{name: {"value", "unit"}} of the cell's per-layer metrics whose
    readers found something to read."""
    out = {}
    for m in spec.per_layer(workload):
        value: Optional[float] = spec.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
