"""Per-slice x-table strategies of the slab SpMV on the card: P3 of the port
(counterpart of benchmarks/slab_micro.py).

    python -m sparsebench_tpu_torch.benchmarks.slab_micro [s_max] [n_tiles]
        [--device cuda|cpu]

A slice is an (8, 128) tile of values whose x sources lie in one known
128-column block per sublane. The synthetic banded problem (``build_inputs``:
slice p of tile t reads the slab at dbase = 8 t + (p mod 17) - 8, clipped,
lane rotation r = p mod 128; random planes from numpy as in the JAX script
on the CPU, from a seeded torch.Generator on the card) runs through the
eight variants (ops/slab_slices.py ``P3``: table mode x lane mode):

  scatter8  8 rows, one per sublane (meta (T, S, 8)) + lidx gather
  slab_u    one slab, rows dbase + s, + lidx gather
  slab_a    slab_u with dbase rounded down to 8
  aff_u     slab, lane (l + r) & 127 computed, no lidx plane
  aff_roll  the same lanes (the TPU rolled the table by -r)
  floor     slab, no lane permutation
  fixed     rows 0-7, + lidx gather
  noload    rows 0-7 (the TPU hoisted the table out of the loop)

Defaults s_max 54, n_tiles 1024 (55,296 slices). On the card: the
scatter8 / slab_u cross-check (one gather encoded two ways: equal), each
variant's kernel against its plain version (bit for bit), then each timed
with ``_chain.chain_time`` (CUDA events, 20 and 60 chained calls, best of 3;
y overwrites the head of x in place) with bf16 values, and again with f32
values (not slab_a, fixed, noload). ``--device cpu`` runs the plain version
of every variant against the numpy oracle (``reference_result``) at the
JAX script's check size (s_max 5, 3 tiles, relative error 2e-2) and times
nothing. A failed check exits non-zero. The last stdout line is one JSON
object: per variant ms, spread, ns a slice, GB/s streamed and the checks.
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
from sparsebench_tpu_torch.ops.slab_slices import (
    LANES,
    P3,
    SUBLANES,
    slab_slices,
    slab_slices_torch,
)

F32_SKIP = ("slab_a", "fixed", "noload")


def slab_meta(s_max: int, n_tiles: int, sub: int, n_xrows: int):
    """(meta_slab, meta_slab_a, meta_scatter) of the JAX scripts: slice p of
    tile t reads the slab at dbase = sub t + (p mod 17) - 8, clipped, lane
    rotation r = p mod 128 (int32 CPU tensors)."""
    t_idx = np.arange(n_tiles)[:, None]
    p_idx = np.arange(s_max)[None, :]
    dbase = np.clip(sub * t_idx + (p_idx % 17) - 8, 0,
                    n_xrows - sub).astype(np.int32)
    r = (p_idx % LANES).astype(np.int32) + np.zeros_like(dbase)
    dbase_a = (dbase // 8 * 8).astype(np.int32)
    rows = dbase[:, :, None] + np.arange(sub)[None, None, :]
    return (torch.from_numpy(np.stack([dbase, r], axis=2)),
            torch.from_numpy(np.stack([dbase_a, r], axis=2)),
            torch.from_numpy(rows.astype(np.int32)))


def random_planes(shape: tuple, n_xrows: int, source, device):
    """(x2d f32, vals f64 or f32, lidx int8): from a numpy Generator in
    the JAX scripts' order, or from a seeded torch.Generator on the card."""
    if isinstance(source, np.random.Generator):
        x2d = source.standard_normal((n_xrows, LANES)).astype(np.float32)
        vals = source.standard_normal(shape)
        lidx = source.integers(0, LANES, shape).astype(np.int8)
        return (torch.from_numpy(x2d).to(device),
                torch.from_numpy(vals).to(device),
                torch.from_numpy(lidx).to(device))
    x2d = torch.randn((n_xrows, LANES), generator=source, device=device)
    vals = torch.randn(shape, generator=source, device=device)
    lidx = torch.randint(0, LANES, shape, generator=source, device=device,
                         dtype=torch.int8)
    return x2d, vals, lidx


def build_inputs(s_max: int, n_tiles: int, source,
                 val_dtype=torch.bfloat16, device="cpu"):
    """The JAX script's ``build_inputs`` (its numpy stream when ``source``
    is a numpy Generator): (x2d, vals, lidx, meta_slab, meta_slab_a,
    meta_scatter) on ``device``."""
    n_xrows = n_tiles * SUBLANES + 32
    x2d, vals, lidx = random_planes((n_tiles, s_max, SUBLANES, LANES),
                                    n_xrows, source, device)
    metas = slab_meta(s_max, n_tiles, SUBLANES, n_xrows)
    return (x2d, vals.to(val_dtype), lidx, *(m.to(device) for m in metas))


def metas_of(m_slab, m_slab_a, m_sc) -> dict:
    return {"scatter8": m_sc, "slab_u": m_slab, "slab_a": m_slab_a,
            "aff_u": m_slab, "aff_roll": m_slab, "floor": m_slab,
            "fixed": m_slab, "noload": m_slab}


def reference_result(variant: str, meta, x2d, vals, lidx) -> np.ndarray:
    """numpy oracle of the JAX script (its ``reference_result``)."""
    x = np.asarray(x2d)
    v = np.asarray(vals.to(torch.float32))
    li = np.asarray(lidx).astype(np.int64)
    meta = np.asarray(meta)
    T, S = v.shape[:2]
    table, lane = P3[variant]
    y = np.zeros((T, SUBLANES, LANES), np.float32)
    lanes = np.arange(LANES)
    for t in range(T):
        for p in range(S):
            if table == "scatter8":
                tbl = x[meta[t, p]]
            elif table == "slab":
                b = int(meta[t, p, 0])
                tbl = x[b: b + SUBLANES]
            else:
                tbl = x[0:SUBLANES]
            if lane == "identity":
                g = tbl
            elif lane == "lidx":
                g = np.take_along_axis(tbl, li[t, p], axis=1)
            else:
                rr = int(meta[t, p, 1])
                idx = np.broadcast_to((lanes + rr) & (LANES - 1),
                                      (SUBLANES, LANES))
                g = np.take_along_axis(tbl, idx, axis=1)
            y[t] += v[t, p] * g
    return y


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_correctness(res: dict) -> bool:
    """Each variant's plain version against the numpy oracle (the JAX
    script's check size and bound)."""
    rng = np.random.default_rng(0)
    s_max, n_tiles = 5, 3
    x2d, vals, lidx, m_slab, m_slab_a, m_sc = build_inputs(s_max, n_tiles,
                                                           rng)
    ok = True
    for variant, meta in metas_of(m_slab, m_slab_a, m_sc).items():
        y = slab_slices(meta, x2d, vals, lidx, variant).numpy()
        want = reference_result(variant, meta, x2d, vals, lidx)
        err = float(np.abs(y - want).max() / max(np.abs(want).max(), 1e-9))
        res[f"{variant}_oracle_err"] = err
        log(f"  {variant:9s} rel err {err:.2e} "
            f"{'ok' if err < 2e-2 else 'FAIL'}")
        ok &= err < 2e-2
    return ok


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparsebench_tpu_torch.benchmarks.slab_micro",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("s_max", nargs="?", type=int, default=54)
    ap.add_argument("n_tiles", nargs="?", type=int, default=1024)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device)
    res = dict(device_fields(device))
    if device.type == "cpu":
        ok = check_correctness(res)
        log("CPU: plain versions against the oracle, no timing")
        emit(res)
        return 0 if ok else 1

    s_max, n_tiles = args.s_max, args.n_tiles
    gen = torch.Generator(device=device).manual_seed(1)
    x2d, vals, lidx, m_slab, m_slab_a, m_sc = build_inputs(
        s_max, n_tiles, gen, device=device)
    metas = metas_of(m_slab, m_slab_a, m_sc)
    n_slices = s_max * n_tiles
    res.update(s_max=s_max, n_tiles=n_tiles, n_slices=n_slices)
    log(f"s_max={s_max} n_tiles={n_tiles}: vals "
        f"{vals.numel() * 2 / 1e6:.0f} MB bf16, lidx {lidx.numel() / 1e6:.0f} "
        f"MB")
    # scatter8 and slab_u encode the same gather (rows dbase + s): equal
    y_sc = slab_slices(m_sc, x2d, vals, lidx, "scatter8")
    y_sl = slab_slices(m_slab, x2d, vals, lidx, "slab_u")
    cross = float((y_sc - y_sl).abs().max())
    res["cross_check_scatter8_slab_u"] = cross
    log(f"cross-check scatter8 vs slab_u: max abs diff {cross:.2e}")
    failed = [] if bits_equal(y_sc, y_sl) else ["cross-check"]

    n_rows = n_tiles * SUBLANES
    for val_dtype, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        v_t = vals.to(val_dtype)
        for variant, meta in metas.items():
            if sfx and variant in F32_SKIP:
                continue
            key = variant + sfx
            y = slab_slices(meta, x2d, v_t, lidx, variant)
            same = bits_equal(y, slab_slices_torch(meta, x2d, v_t, lidx,
                                                   *P3[variant]))
            res[f"{key}_equals_plain"] = same
            if not same:
                failed.append(key)
                continue

            def step(c, meta=meta, variant=variant):
                y = slab_slices(meta, c, v_t, lidx, variant)
                c[:n_rows].copy_(y.view(n_rows, LANES))
                return c

            dt, _raw, sp = chain_time(step, x2d.clone(), reps=20, trials=3)
            with_lidx = P3[variant][1] == "lidx"
            bytes_slice = SUBLANES * LANES * (v_t.element_size()
                                              + (1 if with_lidx else 0))
            res[f"{key}_ms"] = dt * 1e3
            res[f"{key}_spread"] = sp
            res[f"{key}_ns_slice"] = dt / n_slices * 1e9
            res[f"{key}_GBps"] = bytes_slice * n_slices / dt / 1e9
            log(f"{key:13s} {dt * 1e3:7.4f} ms  "
                f"{dt / n_slices * 1e9:6.3f} ns/slice  "
                f"{res[f'{key}_GBps']:6.1f} GB/s streamed")
    if failed:
        log(f"FAILED: {failed}")
    emit(res)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
