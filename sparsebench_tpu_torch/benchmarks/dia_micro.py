"""DIA SpMV window schedules on the card: P1 of the port (counterpart of
benchmarks/dia_micro.py).

    python -m sparsebench_tpu_torch.benchmarks.dia_micro [tile_rows] [grid]
        [--device cuda|cpu]

The 27-point stencil's shifts at 200^3 (``stencil_shifts``, offset to be
non-negative as the DIA kernel's lead pad does: 10 q-groups, span 632 rows)
over ``grid`` tiles of ``tile_rows`` rows of 128 (defaults 256 and 8; 256
and 245 is the 200^3 extent, 62,720 rows). Every schedule streams the same
bytes (27 bf16 planes, x, y) and the exact ones give the same y. The TPU's
six variants map to four card schedules (ops/dia_window.py):

  direct   roll1, carry_roll: x[s_d + i] read from device memory
  grouped  grp_carry, grp_align: each q-group's window staged in shared
           memory once, read at lane offset r
  qfloor   r ignored: x[128 q + i]     [lower bound, wrong result]
  floor    x[i]                        [lower bound, wrong result]

Each is checked against the f64 oracle (relative error 1e-2, the JAX
script's bound for bf16 data; the exact schedules agree far below it) and,
on the card, timed with ``_chain.chain_time`` (CUDA events, 200 and 600
chained calls, best of 4; each call adds 1e-30 y into x in place). Inputs
come from numpy's default_rng(0) as in the JAX script, or, for grids above
16 on the card, from a seeded torch.Generator on the device.
``--device cpu`` runs the plain versions and times nothing. A wrong exact
schedule exits non-zero. The last stdout line is one JSON object: per
schedule the error, us a call (differential and raw), ns per (256, 128)
tile-diagonal and GB/s.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from sparsebench_tpu_torch.benchmarks._chain import (
    add_device_arg,
    chain_time,
    device_fields,
    emit,
    log,
    open_device,
)
from sparsebench_tpu_torch.ops.dia_window import (
    EXACT,
    LANES,
    SCHEDULES,
    TPU_SCHEDULE,
    dia_window,
)


def stencil_shifts(nx: int = 200, ny: int = 200) -> tuple:
    """The 27-point stencil's 27 shifts at nx x ny planes, offset to
    non-negative exactly as the DIA kernel's lead pad does."""
    offs = sorted(i + nx * j + nx * ny * k
                  for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1))
    m = -min(0, min(offs))
    lead = ((m + LANES - 1) // LANES) * LANES
    return tuple(o + lead for o in offs)


def span_rows(shifts) -> int:
    """x rows past the last tile: q_max + 2, rounded up to 8."""
    return ((max(shifts) // LANES + 2 + 7) // 8) * 8


def oracle(x1d: torch.Tensor, data3d: torch.Tensor, shifts) -> torch.Tensor:
    """f64 y (n_rows, 128), diagonal by diagonal."""
    nd, n_rows, _ = data3d.shape
    n_out = n_rows * LANES
    x = x1d.double()
    y = torch.zeros(n_out, dtype=torch.float64, device=x1d.device)
    for d, s in enumerate(shifts):
        y += data3d[d].reshape(-1).double() * x[s: s + n_out]
    return y.view(n_rows, LANES)


def make_inputs(n_rows: int, span: int, nd: int, device: torch.device,
                on_device: bool):
    """(x1d f32, data3d bf16): numpy default_rng(0) as the JAX script, or a
    torch.Generator seeded 0 on the device."""
    if on_device:
        gen = torch.Generator(device=device).manual_seed(0)
        x1d = torch.randn((n_rows + span) * LANES, generator=gen,
                          device=device)
        data3d = torch.randn((nd, n_rows, LANES), generator=gen,
                             device=device).to(torch.bfloat16)
        return x1d, data3d
    rng = np.random.default_rng(0)
    x1d = rng.standard_normal((n_rows + span) * LANES).astype(np.float32)
    data3d = rng.standard_normal((nd, n_rows, LANES)).astype(np.float32)
    return (torch.from_numpy(x1d).to(device),
            torch.from_numpy(data3d).to(torch.bfloat16).to(device))


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparsebench_tpu_torch.benchmarks.dia_micro",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("tile", nargs="?", type=int, default=256)
    ap.add_argument("grid", nargs="?", type=int, default=8)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device)
    on_card = device.type == "cuda"
    tile, grid = args.tile, args.grid
    shifts = stencil_shifts()
    span = span_rows(shifts)
    n_rows = tile * grid
    x1d, data3d = make_inputs(n_rows, span, len(shifts), device,
                              on_device=on_card and grid > 16)
    want = oracle(x1d, data3d, shifts)
    scale = max(1.0, float(want.abs().max()))
    qs = sorted({s // LANES for s in shifts})
    data_mb = data3d.numel() * 2 / 1e6
    log(f"27 shifts, {len(qs)} distinct q groups, span={span} rows, "
        f"tile={tile}, grid={grid}, data {data_mb:.1f} MB/call")
    res = {"tile": tile, "grid": grid, "n_rows": n_rows, "span": span,
           "q_groups": len(qs), "data_MB": data_mb,
           "stands_for": {s: [v for v, c in TPU_SCHEDULE.items()
                              if c == s and v not in ("roll", "shear_chunk")]
                          for s in SCHEDULES},
           **device_fields(device)}
    nbytes = data3d.numel() * 2 + (n_rows + span + n_rows) * LANES * 4
    wrong = []
    for v in SCHEDULES:
        exact = v in EXACT
        y = dia_window(x1d, data3d, shifts, v, tile)
        err = float((y.double() - want).abs().max()) / scale
        res[f"{v}_err"] = err
        label = "" if exact else "  [lower bound, wrong result]"
        if exact and err > 1e-2:  # bf16 data => ~1e-2 relative
            log(f"{v:8s} WRONG (rel err {err:.2e})")
            wrong.append(v)
            continue
        if not on_card:
            log(f"{v:8s} rel err {err:.2e} (plain version, no timing)"
                + label)
            continue

        def step(c, v=v):
            y = dia_window(c, data3d, shifts, v, tile).reshape(-1)
            c[: y.numel()].add_(y, alpha=1e-30)
            return c

        dt, raw, sp = chain_time(step, x1d.clone(), reps=200, trials=4)
        per_tile_diag = dt / grid / len(shifts) / (tile / 256) * 1e9
        res[f"{v}_us"] = dt * 1e6
        res[f"{v}_raw_us"] = raw * 1e6
        res[f"{v}_spread"] = sp
        res[f"{v}_ns_per_tile_diag"] = per_tile_diag
        res[f"{v}_GBps"] = nbytes / dt / 1e9
        log(f"{v:8s} {dt * 1e6:8.1f} us/call (raw {raw * 1e6:8.1f})  "
            f"{per_tile_diag:6.1f} ns/(256,128)/diag  "
            f"{nbytes / dt / 1e9:6.1f} GB/s" + label)
    emit(res)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
