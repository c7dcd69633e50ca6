"""The one general generator: it reads a traffic mix's parameters
(``bench_torch/traffic/<name>.json``), makes the inputs from the seed and
drives the window as a closed loop of one client.

A mix's keys:

* ``op``: ``cg`` (a solve of the masked CG loop of ``variant``, one
  right-hand side), ``cg_multi`` (a blocked solve of ``rhs`` right-hand
  sides) or ``spmv`` (one SpMV);
* ``pool``: how many distinct inputs the seed draws; operation i takes
  input i mod pool, so no two operations in a row read the same one;
* ``x``: the distribution of each drawn vector, ``{"low", "high"}``
  uniform: the exact solution x* of a solve, whose right-hand side
  b = A x* the plain reference computes, or the operand of an SpMV;
* ``warmup_ops``: operations run in set-up, before the window;
* ``check_sample``: how many of the window's answers the comparison
  draws, uniformly by the seed (a reservoir), against the plain
  reference;
* ``trace_seconds``: the length of the traced window of a ``--trace 1``
  run;
* ``end_to_end``: metric name -> the window statistic that it reports
  (``harness.stats.window_metrics``);
* ``hist_from``: the comparison of a solve's residual history covers the
  iterations where the reference's is at least this share of its start.
"""

from __future__ import annotations

import random
import time

import torch

from harness import program
from reference import hpcg

OPS = ("cg", "cg_multi", "spmv")


def make_inputs(cfg: dict, traffic: dict, seed: int, vectors: torch.dtype,
                device: torch.device) -> list:
    """The pool of inputs of ``seed``, in the program's vector dtype: for
    ``cg`` b (n,), for ``cg_multi`` B (rhs, n), for ``spmv`` x (n,). Each
    vector is drawn in f64 on the device by one generator; b = A x* is the
    plain reference's product, rounded once to ``vectors``."""
    n = cfg["nx"] * cfg["ny"] * cfg["nz"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    lo, hi = traffic["x"]["low"], traffic["x"]["high"]
    pool = []
    for _ in range(traffic["pool"]):
        cols = []
        for _ in range(traffic.get("rhs", 1)):
            v = torch.rand(n, generator=gen, dtype=torch.float64,
                           device=device) * (hi - lo) + lo
            if traffic["op"] != "spmv":
                v = hpcg.apply(v, cfg)
            cols.append(v.to(vectors))
        pool.append(torch.stack(cols) if traffic["op"] == "cg_multi"
                    else cols[0])
    return pool


class Operation:
    """Operation i of the mix: ``issue(i)`` enqueues it and returns
    (answer, ok), ``ok`` a device flag that the answer passed the checks
    the device can make (finite; the configuration's iterations, where
    eps = 0 makes every solve run them), or None."""

    def __init__(self, traffic: dict, cfg: dict, A, pool: list):
        if traffic["op"] not in OPS:
            raise ValueError(f"traffic op {traffic['op']!r} is not one of {OPS}")
        self.kind = traffic["op"]
        self.A, self.pool, self.itermax = A, pool, cfg["itermax"]
        self.full = cfg["eps"] == 0
        device = pool[0].device
        self.eps = torch.tensor(cfg["eps"], dtype=torch.float32, device=device)
        self.x0 = torch.zeros_like(pool[0])
        if self.kind == "cg":
            self.loop = program.cg_loop(traffic["variant"])
        elif self.kind == "cg_multi":
            self.loop = program.cg_multi_loop()

    def issue(self, i: int):
        j = i % len(self.pool)
        if self.kind == "spmv":
            return (j, self.A.spmv(self.pool[j])), None
        x, k, hist = self.loop(self.A, self.pool[j], self.x0, self.itermax,
                               self.eps)
        ok = torch.isfinite(x).all()
        if self.full:
            ok = ok & (k == self.itermax).all()
        return (j, x, k, hist), ok


class Window:
    """What a window did: operations completed and failed, its seconds on
    the host clock, each operation's own seconds (when taken), and the
    sampled answers."""

    def __init__(self):
        self.ops = 0
        self.failed = 0
        self.seconds = 0.0
        self.op_s = []
        self.samples = []


def drive(op: Operation, seconds: float, seed: int, sample: int,
          time_ops: bool) -> Window:
    """Run operations back to back until ``seconds`` have passed, each
    closed by a synchronise (through its ok flag), and keep a sample of
    ``sample`` answers drawn uniformly by the seed. With ``time_ops`` each
    operation is timed on the device with CUDA events from its issue to
    its end (on the CPU by the host clock)."""
    device = op.pool[0].device
    cuda = device.type == "cuda"
    rng = random.Random(seed)
    w = Window()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        if time_ops:
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            else:
                h0 = time.perf_counter()
        answer, ok = op.issue(w.ops)
        if time_ops and cuda:
            e1.record()
        if ok is None:
            sync()
            good = True
        else:
            good = bool(ok)
        if time_ops:
            w.op_s.append(e0.elapsed_time(e1) * 1e-3 if cuda
                          else time.perf_counter() - h0)
        w.failed += not good
        # reservoir sampling: every answer of the window equally likely
        if len(w.samples) < sample:
            w.samples.append(answer)
        else:
            r = rng.randrange(w.ops + 1)
            if r < sample:
                w.samples[r] = answer
        w.ops += 1
        if time.perf_counter() >= deadline:
            break
    w.seconds = time.perf_counter() - t0
    return w
