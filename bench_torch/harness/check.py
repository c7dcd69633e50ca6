"""The comparison that decides ``correct``: the window's sampled answers
against the plain reference (``reference/hpcg.py``, f64), run once the
window has closed and the program's matrix is freed.

The numbers compared, each the worst over the sampled answers:

* ``x_err``: max|x - x_ref| / max|x_ref| of a solve's x, the worst
  column of a blocked solve (x_ref: the reference's CG from the same b,
  the same iterations);
* ``hist_err``: the largest |h - h_ref| / h_ref of the residual history
  over the iterations where h_ref is at least ``hist_from`` of its start;
* ``iters``: the largest |k - k_ref| of the iteration counts;
* ``y_err``: max|y - y_ref| / max|y_ref| of an SpMV's y.
"""

from __future__ import annotations

import torch

from reference import hpcg

NUMBERS = {"cg": ("x_err", "hist_err", "iters"),
           "cg_multi": ("x_err", "hist_err", "iters"),
           "spmv": ("y_err",)}


def _max_rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows of max|a - ref| / max|ref|, in f64."""
    a, ref = a.double().reshape(-1, ref.shape[-1]), ref.reshape(
        -1, ref.shape[-1])
    num = (a - ref).abs().amax(dim=1)
    return float((num / ref.abs().amax(dim=1)).max())


def compare(traffic: dict, cfg: dict, pool: list, samples: list) -> dict:
    """{number: worst value} over ``samples``, each (pool index, answer
    ...) as ``harness.traffic.Operation.issue`` gives it. A NaN anywhere
    reads NaN (``amax`` and ``max`` carry it), which no limit passes."""
    kind = traffic["op"]
    worst = dict.fromkeys(NUMBERS[kind], 0.0)
    refs = {}
    for j, *answer in samples:
        b = pool[j].double()
        if kind == "spmv":
            if j not in refs:
                refs[j] = hpcg.apply(b, cfg)
            worst["y_err"] = max(worst["y_err"],
                                 _max_rel(answer[0], refs[j]), key=_nan_first)
            continue
        if j not in refs:
            refs[j] = hpcg.cg(b.reshape(-1, b.shape[-1]), cfg)
        x_ref, k_ref, h_ref = refs[j]
        x, k, hist = answer
        hist = hist.double().reshape(h_ref.shape)
        keep = h_ref >= traffic["hist_from"] * h_ref[0]
        h_gap = ((hist - h_ref).abs() / h_ref)[keep]
        numbers = {
            "x_err": _max_rel(x, x_ref),
            "hist_err": float(h_gap.max()) if h_gap.numel() else 0.0,
            "iters": float((k.reshape(-1).cpu() - k_ref.cpu()).abs().max()),
        }
        for name, value in numbers.items():
            worst[name] = max(worst[name], value, key=_nan_first)
    return worst


def _nan_first(v: float):
    return (v != v, v)


def verdict(numbers: dict, limits: dict, failed: int) -> tuple:
    """(correct, checks): ``checks`` is {number: {"value", "limit"}};
    correct when no operation failed and every number is within its
    limit (a number with no limit, or NaN, is not)."""
    checks, ok = {}, failed == 0
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return ok, checks
