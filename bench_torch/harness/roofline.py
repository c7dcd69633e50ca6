"""The table of peaks and the least time of a kernel call.

Peaks of one NVIDIA H100 SXM at its full 700 W, from NVIDIA's data sheet:
3.35 TB/s of HBM and 67 TFLOP/s of f32 outside the tensor cores. The
least time of a call is the larger of its bytes over the first and its
operations over the second; a kernel's share of its roofline is that
least time over its measured time. Bytes and operations are counted from
the configuration's shapes by the metric that reads the kernel, never
from the program's objects, so a change of layout is judged on the same
work.
"""

from __future__ import annotations

from typing import Optional

# device kind (a substring of torch.cuda.get_device_name) -> peaks
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}

ITEMSIZE = {"bf16": 2, "f32": 4, "f64": 8}


def peaks(device_kind: str) -> Optional[dict]:
    for kind, p in PEAKS.items():
        if kind in device_kind:
            return p
    return None


def least_s(device_kind: str, nbytes: float, flops: float) -> Optional[float]:
    """The least seconds of a call that moves ``nbytes`` and computes
    ``flops`` in f32, or None for a device without a row in the table."""
    p = peaks(device_kind)
    if p is None:
        return None
    return max(nbytes / p["hbm_bytes_per_s"], flops / p["f32_flops_per_s"])


def rows(cfg: dict) -> int:
    return cfg["nx"] * cfg["ny"] * cfg["nz"]


def share_pct(ctx, kernels, nbytes: float, flops: float) -> Optional[float]:
    """100 x the least time of one call over the mean device time of the
    calls of ``kernels`` in the trace, or None where the trace holds none
    of them or the device has no peaks in the table."""
    count, seconds = ctx.kernel(kernels)
    least = least_s(ctx.device_kind, nbytes, flops)
    if count == 0 or least is None:
        return None
    return 100.0 * least / (seconds / count)
