"""Shared pieces of the prototype benchmarks: stderr logging, the device
argument, the final JSON line and the differential chain timer.

``chain_time`` is the port bench's method (``bench.py`` ``spmv_chain_stats``):
a chain of ``r`` and of ``3 r`` data-dependent calls, each timed with CUDA
events on the card (the host clock on the CPU), the best of ``trials``
timings of each, and the seconds a call the differential

    (t(3 r) - t(r)) / 2 r

(``t(3 r) / 3 r`` where noise makes it non-positive), the definition the JAX
prototypes use. With ``min_diff_s`` the chain length doubles until the
differential spans that long, as csr_twopass_proto.py's timer does.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Optional, Tuple

import torch

from sparsebench_tpu_torch.config import resolve_device
from sparsebench_tpu_torch.utils import elapsed_seconds, nvidia_smi


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="cuda (default: the kernels, timed) or cpu (the plain "
             "versions at the script's check size, untimed: for the tests)")


def open_device(name: str) -> torch.device:
    """The run's device; logs the card's name and power limit."""
    device = resolve_device(name)
    if device.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(device)} "
            f"({nvidia_smi() or 'nvidia-smi not available'})")
    else:
        log("device: cpu (plain versions, no timing)")
    return device


def device_fields(device: torch.device) -> dict:
    """Where the line's numbers come from."""
    if device.type == "cuda":
        return {"device": torch.cuda.get_device_name(device),
                "nvidia_smi": nvidia_smi()}
    return {"device": "cpu"}


def emit(res: dict) -> None:
    print(json.dumps(res), flush=True)


def chain_time(step: Callable[[torch.Tensor], torch.Tensor],
               x0: torch.Tensor, reps: int, trials: int,
               min_diff_s: Optional[float] = None,
               max_reps: int = 4096) -> Tuple[float, float, float]:
    """(seconds a call, raw t(3 r) / 3 r, spread) of ``step`` chained from
    ``x0``; spread = (worst - best) / best of the final t(3 r) trials."""
    device = x0.device

    def run(n):
        u = x0
        for _ in range(n):
            u = step(u)
        return u

    def timed(n):
        return [elapsed_seconds(lambda: run(n), device) for _ in range(trials)]

    def estimate(r):
        run(r)
        run(3 * r)  # warm-up at both lengths
        lo, hi = min(timed(r)), timed(3 * r)
        best = min(hi)
        dt = (best - lo) / (2 * r)
        return (dt if dt > 0 else best / (3 * r)), best / (3 * r), \
            (max(hi) - best) / best if best > 0 else 0.0

    dt, raw, spread = estimate(reps)
    while min_diff_s is not None and 2 * reps * dt < min_diff_s \
            and reps < max_reps:
        reps *= 2
        dt, raw, spread = estimate(reps)
    return dt, raw, spread
