"""One cell of the benchmark: its configuration's matrix built once, the
inputs of a seed, the window, and the comparison after it.

Set-up is the matrix build, the inputs and ``warmup_ops`` operations of
the mix (the only shapes the window uses); each is a span of the
benchmark's own, timed by the host clock after a synchronise.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from harness import check, program, traffic as traffic_mod
from harness.trace import Trace, profiled


class Cell:
    def __init__(self, spec, workload: str, device: torch.device,
                 control: bool = False, config: dict | None = None):
        self.device = device
        cell = spec.cell(workload)
        self.cfg = config if config is not None else spec.config(cell["config"])
        self.traffic = spec.traffic(cell["traffic"])
        self.limits = spec.limits(workload)
        # the control: the program's own path one precision down
        self.vectors = self.cfg["control_vectors" if control else "vectors"]
        self.vdt = program.DTYPES[self.vectors]
        self.spans = {}
        with self.span("matrix_build"):
            self.A = program.build_matrix(self.cfg, self.vectors, device)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.spans[name] = time.perf_counter() - t0

    def prepare(self, seed: int):
        """The inputs of ``seed`` and the warmed-up operation."""
        with self.span("inputs"):
            self.pool = traffic_mod.make_inputs(self.cfg, self.traffic, seed,
                                                self.vdt, self.device)
        self.op = traffic_mod.Operation(self.traffic, self.cfg, self.A,
                                        self.pool)
        with self.span("warmup"):
            for i in range(self.traffic["warmup_ops"]):
                _answer, ok = self.op.issue(i)
                if ok is not None:
                    bool(ok)

    def window(self, seed: int, seconds: float, trace: bool):
        """(Window, Trace or None): the closed loop for ``seconds``
        (traced: for the mix's ``trace_seconds`` at most)."""
        t = self.traffic
        time_ops = "op_p95_ms" in t["end_to_end"].values()
        if not trace:
            return traffic_mod.drive(self.op, seconds, seed, t["check_sample"],
                                     time_ops), None
        seconds = min(seconds, t["trace_seconds"])
        w, events = profiled(lambda: traffic_mod.drive(
            self.op, seconds, seed, t["check_sample"], time_ops))
        kind = torch.cuda.get_device_name(self.device)
        return w, Trace(events, w.seconds, w.ops, self.cfg, t, kind,
                        self.spans)

    def release(self):
        """Free the program's matrix and state; the sampled answers and
        the inputs stay for the comparison."""
        del self.op, self.A
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, samples: list, failed: int) -> tuple:
        """(correct, checks) of the sampled answers against the plain
        reference."""
        numbers = check.compare(self.traffic, self.cfg, self.pool, samples)
        return check.verdict(numbers, self.limits, failed)
