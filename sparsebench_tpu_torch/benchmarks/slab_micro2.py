"""Slice loop cost against the slice height on the card: P4 of the port
(counterpart of benchmarks/slab_micro2.py).

    python -m sparsebench_tpu_torch.benchmarks.slab_micro2 [total_units]
        [--device cuda|cpu]

``total_units`` (8, 128) unit slices (default 55,296 = 54 x 1024), the same
for every slice height SUB in {8, 16, 32, 64}: 16 slices a tile and
total_units / (16 SUB / 8) tiles (slab of slice p of tile t at SUB t + (p
mod 17) - 8, clipped; rotation p mod 128; random planes from numpy as in
the JAX script on the CPU, from a seeded torch.Generator on the card).
Variants (ops/slab_slices.py ``P4``):

  sum     acc += vals[p]                     (value streaming, no x)
  floor   acc += vals[p] * slab              (no lane permutation)
  roll    acc += vals[p] * slab[(l + r) & 127]   (affine slices)
  gather  acc += vals[p] * slab[lidx]        (general slices)

each with bf16 and f32 values. On the card each is checked against its
plain version (bit for bit) and timed with ``_chain.chain_time`` (CUDA
events, 20 and 60 chained calls, best of 3; y overwrites the head of x in
place). ``--device cpu`` runs the plain versions and times nothing. A failed
check exits non-zero. The last stdout line is one JSON object: per (SUB,
dtype, variant) ms, spread, ns a unit slice and GB/s streamed.
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
from sparsebench_tpu_torch.benchmarks.slab_micro import bits_equal, slab_meta
from sparsebench_tpu_torch.ops.slab_slices import (
    LANES,
    P4,
    slab_slices_tall,
    slab_slices_torch,
)

SUBS = (8, 16, 32, 64)
S_MAX = 16  # slices a tile


def sub_inputs(total_units: int, sub: int, source, device):
    """(n_tiles, x2d, lidx, meta) of one height: x2d and lidx drawn as the
    JAX script draws them when ``source`` is a numpy Generator, else from a
    seeded torch.Generator on the card (the values follow per dtype,
    ``draw_vals``)."""
    n_tiles = max(1, total_units // (S_MAX * (sub // 8)))
    n_xrows = n_tiles * sub + 64
    shape = (n_tiles, S_MAX, sub, LANES)
    if isinstance(source, np.random.Generator):
        x2d = source.standard_normal((n_xrows, LANES)).astype(np.float32)
        lidx = source.integers(0, LANES, shape).astype(np.int8)
        x2d, lidx = torch.from_numpy(x2d), torch.from_numpy(lidx)
    else:
        x2d = torch.randn((n_xrows, LANES), generator=source, device=device)
        lidx = torch.randint(0, LANES, shape, generator=source,
                             device=device, dtype=torch.int8)
    meta = slab_meta(S_MAX, n_tiles, sub, n_xrows)[0]
    return n_tiles, x2d.to(device), lidx.to(device), meta.to(device)


def draw_vals(shape: tuple, source, device) -> torch.Tensor:
    """f64 (numpy) or f32 (card) normal values of one pass."""
    if isinstance(source, np.random.Generator):
        return torch.from_numpy(source.standard_normal(shape)).to(device)
    return torch.randn(shape, generator=source, device=device)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparsebench_tpu_torch.benchmarks.slab_micro2",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("total_units", nargs="?", type=int, default=55296)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device)
    on_card = device.type == "cuda"
    source = (torch.Generator(device=device).manual_seed(0) if on_card
              else np.random.default_rng(0))
    res = {"total_units": args.total_units, "s_max": S_MAX,
           **device_fields(device)}
    failed = []
    for sub in SUBS:
        n_tiles, x2d, lidx, meta = sub_inputs(args.total_units, sub, source,
                                              device)
        n_units = n_tiles * S_MAX * (sub // 8)
        n_rows = n_tiles * sub
        for dt_name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            vals = draw_vals((n_tiles, S_MAX, sub, LANES), source,
                             device).to(dt)
            for variant in P4:
                key = f"sub{sub}_{dt_name}_{variant}"
                y = slab_slices_tall(meta, x2d, vals, lidx, variant)
                if not on_card:
                    ok = bool(torch.isfinite(y).all())
                    res[f"{key}_finite"] = ok
                    log(f"sub={sub} {dt_name} {variant}: plain version ok"
                        if ok else f"{key}: non-finite result")
                    if not ok:
                        failed.append(key)
                    continue
                same = bits_equal(y, slab_slices_torch(meta, x2d, vals, lidx,
                                                       *P4[variant]))
                res[f"{key}_equals_plain"] = same
                if not same:
                    failed.append(key)
                    continue

                def step(c, vals=vals, variant=variant):
                    y = slab_slices_tall(meta, c, vals, lidx, variant)
                    c[:n_rows].copy_(y.view(n_rows, LANES))
                    return c

                t, _raw, sp = chain_time(step, x2d.clone(), reps=20, trials=3)
                vb = 2 if dt_name == "bf16" else 4
                lb = 1 if variant == "gather" else 0
                gbps = (1024 * (vb + lb)) * n_units / t / 1e9
                res[f"{key}_ms"] = t * 1e3
                res[f"{key}_spread"] = sp
                res[f"{key}_ns_unit"] = t / n_units * 1e9
                res[f"{key}_GBps"] = gbps
                log(f"sub={sub:2d} {dt_name:4s} {variant:6s} "
                    f"{t * 1e3:7.4f} ms  {t / n_units * 1e9:5.3f} ns/unit  "
                    f"{gbps:6.1f} GB/s streamed")
    if failed:
        log(f"FAILED: {failed}")
    emit(res)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
