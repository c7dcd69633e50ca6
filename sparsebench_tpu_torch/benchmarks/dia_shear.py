"""DIA SpMV with each diagonal's window staged by asynchronous copies: P2
of the port (counterpart of benchmarks/dia_shear.py).

    python -m sparsebench_tpu_torch.benchmarks.dia_shear [rows] [grid] [tpc]
        [--device cuda|cpu]

The 27-point stencil's shifts at 200^3 over ``grid`` tiles of ``rows`` rows
of 128 (defaults 256, 32 and 2), with x laid out in chunks of ``tpc``
tiles: (n_chunks tpc rows + span + 8) 128 floats, n_chunks = ceil(grid /
tpc), so a grid that is not a multiple of tpc ends in a partial chunk. Two
variants (ops/dia_window.py ``dia_shear``):

  roll         the direct schedule: x[s_d + i] read from device memory
  shear_chunk  each q-group's window, 8 rows at a time, copied into shared
               memory by cp.async while the previous group is summed; the
               inner loop is convert, multiply and add out of shared memory

Both are checked against the f64 oracle (relative error 1e-2, the JAX
script's bound) and, on the card, timed with ``_chain.chain_time`` (CUDA
events, 60 and 180 chained calls, best of 4; each call adds 1e-30 y into x
in place). Inputs come from numpy's default_rng(0) as in the JAX script,
or, for grids above 16 on the card, from a seeded torch.Generator on the
device. ``--device cpu`` runs the plain version and times nothing. A wrong
variant exits non-zero. The last stdout line is one JSON object: per
variant the error, us a call (differential and raw) and physical GB/s.
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
from sparsebench_tpu_torch.benchmarks.dia_micro import (
    oracle,
    span_rows,
    stencil_shifts,
)
from sparsebench_tpu_torch.ops.dia_window import (
    LANES,
    SHEAR_VARIANTS,
    dia_shear,
    shear_x_floats,
)


def make_inputs(x_len: int, n_rows: int, nd: int, device: torch.device,
                on_device: bool):
    """(x1d f32, data3d bf16): numpy default_rng(0) as the JAX script, or a
    torch.Generator seeded 0 on the device."""
    if on_device:
        gen = torch.Generator(device=device).manual_seed(0)
        x1d = torch.randn(x_len, generator=gen, device=device)
        data3d = torch.randn((nd, n_rows, LANES), generator=gen,
                             device=device).to(torch.bfloat16)
        return x1d, data3d
    rng = np.random.default_rng(0)
    x1d = rng.standard_normal(x_len).astype(np.float32)
    data3d = rng.standard_normal((nd, n_rows, LANES)).astype(np.float32)
    return (torch.from_numpy(x1d).to(device),
            torch.from_numpy(data3d).to(torch.bfloat16).to(device))


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparsebench_tpu_torch.benchmarks.dia_shear",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="?", type=int, default=256)
    ap.add_argument("grid", nargs="?", type=int, default=32)
    ap.add_argument("tpc", nargs="?", type=int, default=2)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device)
    on_card = device.type == "cuda"
    rows, grid, tpc = args.rows, args.grid, args.tpc
    shifts = stencil_shifts()
    span = span_rows(shifts)
    n_rows = rows * grid
    x_len = shear_x_floats(n_rows, rows, tpc, span)
    x1d, data3d = make_inputs(x_len, n_rows, len(shifts), device,
                              on_device=on_card and grid > 16)
    log(f"device={device} rows={rows} grid={grid} tpc={tpc} "
        f"data {data3d.numel() * 2 / 1e6:.1f} MB/call, x "
        f"{x_len * 4 / 1e6:.1f} MB")
    want = oracle(x1d, data3d, shifts)
    scale = float(want.abs().max())
    res = {"rows": rows, "grid": grid, "tpc": tpc, "n_rows": n_rows,
           "span": span, "x_floats": x_len, **device_fields(device)}
    nbytes = (data3d.numel() * 2 + (n_rows + span) * LANES * 4
              + n_rows * LANES * 4)
    wrong = []
    for v in SHEAR_VARIANTS:
        y = dia_shear(x1d, data3d, shifts, v, rows, tpc)
        err = float((y.double() - want).abs().max()) / scale
        res[f"{v}_err"] = err
        if err > 1e-2:
            log(f"{v:12s} WRONG (rel err {err:.2e})")
            wrong.append(v)
            continue
        if not on_card:
            log(f"{v:12s} rel err {err:.2e} (plain version, no timing)")
            continue

        def step(c, v=v):
            y = dia_shear(c, data3d, shifts, v, rows, tpc).reshape(-1)
            c[: y.numel()].add_(y, alpha=1e-30)
            return c

        dt, raw, sp = chain_time(step, x1d.clone(), reps=60, trials=4)
        res[f"{v}_us"] = dt * 1e6
        res[f"{v}_raw_us"] = raw * 1e6
        res[f"{v}_spread"] = sp
        res[f"{v}_GBps"] = nbytes / dt / 1e9
        log(f"{v:12s} {dt * 1e6:9.1f} us/call (raw {raw * 1e6:9.1f})  "
            f"{nbytes / dt / 1e9:6.1f} GB/s-physical")
    emit(res)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
