"""Compact (non-positional) row-block CSR SpMV prototype on the card: P5 of
the port (counterpart of benchmarks/csr_twopass_proto.py).

    python -m sparsebench_tpu_torch.benchmarks.csr_twopass_proto [out.json]
        [--device cuda|cpu]

The RGL matrix (host.py ``rgl_csr`` is its spec: n = 2,000,000, band 512,
degree 16, seed 1; ``SB_PROTO_SMALL=1``: n = 8192, band 128) is laid out as
per-row-block flat streams: R = 1024 rows a block (512 small), the block's
stored entries in row order, padded to ``block_cap`` slots (a multiple of
16 x 128), each column kept relative to the block's window of x. Then

  pass 1 (the kernel, ops/csr_twopass.py): per slot, val * x[colrel] from
      the block's window (R + 2 band floats);
  pass 2 (plain torch): the row sums, as (a) a segment sum over the sorted
      row ids (``index_add_``), (b) a cumulative-sum difference (fast but
      lossy by cancellation: reported, not proposed), or (c) one pass with
      the gather in torch and a segment sum (``csrseg_onepass``).

The streams are built on the device, as the JAX prototype builds them: the
ELL intermediate from a top-k over the banded hash mask (``_ell_chunk``),
the block streams from a scatter and a running sum (``_block_chunk``).
Rows past n in the last block (n is not a multiple of R at full size: 896
phantom rows) carry degree 0; where JAX clamps an out-of-range gather and
drops an out-of-range scatter or segment id, the port clamps and masks
explicitly, to the same streams.

Validation: A 1 = 1 exactly (Laplacian + I row sums) and each variant
against the first on x = 0.5 + (i mod 97) / 97; at the small size also
against the host spec CSR (``rgl_csr``), to 1e-5. On the card each variant
is timed with ``_chain.chain_time`` (CUDA events, auto-scaled chain), and at
full size beside it the positional layout (``rgl_bslab``, K6) and cuSPARSE
CSR f32 on the same matrix, the library yardstick. ``--device cpu`` runs
the plain versions at the small size and times nothing. A failed check
exits non-zero. The last stdout line is one JSON object: per variant ms,
spread and effective GB/s (8 B a nonzero), and the validation errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
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
from sparsebench_tpu_torch.formats.rgl_build import _hash
from sparsebench_tpu_torch.host import rgl_csr, threshold
from sparsebench_tpu_torch.ops.csr_twopass import LANES, pass1_products

SUB = 16          # element-tile sublanes: block_cap is a multiple of 16 x 128
CAP = 56          # ELL slots (edges + diagonal): P(Poisson(16) > 55) ~ 1e-15
CHUNK = 16384     # ELL build rows a step


# ------------------------------------------------------------- device build

def _ell_chunk(c0: int, n: int, band: int, thresh: int, seed: int,
               device: torch.device):
    """(rows, CAP) ascending ELL columns (0 past a row's entries) and the
    per-row entry counts (diagonal included) of rows c0 .. c0 + CHUNK - 1
    below n: the JAX prototype's ``_ell_chunk`` (top-k on a descending
    position key; rows past n are not formed, JAX cuts them off)."""
    rows = torch.arange(c0, min(c0 + CHUNK, n), device=device)
    offs = torch.arange(-band, band + 1, device=device)
    w = offs.numel()
    j = rows[:, None] + offs[None, :]
    inb = (j >= 0) & (j < n) & (offs[None, :] != 0)
    lo = torch.minimum(rows[:, None], j).clamp_min(0)
    hi = torch.maximum(rows[:, None], j).clamp_min(0)
    edge = inb & (_hash(lo, hi, seed) < thresh)
    del j, inb, lo, hi
    mask = edge | (offs[None, :] == 0)
    deg = mask.sum(dim=1).to(torch.int32)
    key = torch.where(mask, (w - torch.arange(w, device=device))[None, :],
                      torch.zeros((), dtype=torch.int64, device=device))
    topv = torch.topk(key, CAP, dim=1, sorted=True).values  # descending
    col = torch.where(topv > 0, rows[:, None] + (w - topv) - band,
                      torch.zeros((), dtype=torch.int64, device=device))
    return col.to(torch.int32), deg


def _block_chunk(b0: int, ell_col, deg, row_ptr, blk_start, blk_nnz,
                 rows_per_block: int, block_cap: int, band: int, n: int):
    """Blocks b0 .. b0 + len(blk_start) - 1 as (val, colrel, rowseg), each
    (blocks, block_cap): the JAX prototype's ``_block_chunk``. A row's start
    is scattered as a 1 into its block's slots and a running sum recovers
    each slot's row. JAX drops the scatter of a start at block_cap (a
    phantom row of a full block) and clamps the gathers of rows past n (the
    slots past a block's entries); both are written out here."""
    dev = ell_col.device
    nbc = blk_start.numel()
    blocks = b0 + torch.arange(nbc, device=dev)
    r_all = b0 * rows_per_block + torch.arange(nbc * rows_per_block,
                                               device=dev)
    starts = row_ptr[r_all].long() - blk_start.long().repeat_interleave(
        rows_per_block)
    owner = torch.arange(nbc, device=dev).repeat_interleave(rows_per_block)
    keep = starts < block_cap
    delta = torch.zeros(nbc * block_cap, dtype=torch.int32, device=dev)
    delta.index_add_(0, (owner * block_cap + starts)[keep],
                     torch.ones(int(keep.sum()), dtype=torch.int32,
                                device=dev))
    rows_rel = torch.cumsum(delta.view(nbc, block_cap), dim=1) - 1
    del delta
    r = blocks[:, None] * rows_per_block + rows_rel          # (nbc, cap)
    rc = r.clamp(0, n - 1)                                   # JAX's clamp
    e = torch.arange(block_cap, device=dev)[None, :]
    valid = e < blk_nnz.long()[:, None]
    k = e - (row_ptr[r].long() - blk_start.long()[:, None])
    col = ell_col.reshape(-1)[rc * CAP + k.clamp(0, CAP - 1)].long()
    del k
    val = torch.where(col == r, deg[rc].to(torch.float32),
                      torch.full((), -1.0, device=dev))
    val = torch.where(valid, val, torch.zeros((), device=dev))
    ws = blocks[:, None] * rows_per_block - band
    colrel = torch.where(valid, col - ws, torch.zeros((), dtype=torch.int64,
                                                      device=dev))
    rowseg = torch.where(valid, r, r.max(dim=1, keepdim=True).values)
    return val, colrel.to(torch.int32), rowseg.to(torch.int32)


def build_streams(n: int, band: int, deg: float, seed: int,
                  rows_per_block: int, device: torch.device) -> dict:
    """The compact streams of the RGL matrix on ``device`` (the JAX
    prototype's ``build_streams``, the same arrays)."""
    device = torch.device(device)
    thresh = int(threshold(band, deg))
    cols, degs = [], []
    for c0 in range(0, n, CHUNK):
        c, d = _ell_chunk(c0, n, band, thresh, seed, device)
        cols.append(c)
        degs.append(d)
    ell_col = torch.cat(cols)
    deg_v = torch.cat(degs)
    del cols, degs
    overflow = int((deg_v > CAP).sum())
    if overflow:
        raise RuntimeError(f"{overflow} rows exceed ELL cap {CAP}")
    nnz = int(deg_v.sum())
    # ceil blocks: phantom tail rows carry degree 0
    nb = -(-n // rows_per_block)
    deg_pad = torch.cat([deg_v, torch.zeros(nb * rows_per_block - n,
                                            dtype=torch.int32, device=device)])
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=device),
                         torch.cumsum(deg_pad, 0).to(torch.int32)])
    blk_start = row_ptr[:-1:rows_per_block][:nb]
    blk_end = row_ptr[rows_per_block::rows_per_block][:nb]
    blk_nnz = blk_end - blk_start
    tile = SUB * LANES
    block_cap = -(-int(blk_nnz.max()) // tile) * tile
    vals, crels, rsegs = [], [], []
    bc = max(1, (1 << 25) // block_cap)  # blocks a step
    for b0 in range(0, nb, bc):
        b1 = min(b0 + bc, nb)
        v, c, rs = _block_chunk(b0, ell_col, deg_v, row_ptr, blk_start[b0:b1],
                                blk_nnz[b0:b1], rows_per_block, block_cap,
                                band, n)
        vals.append(v)
        crels.append(c)
        rsegs.append(rs)
    del ell_col
    val = torch.cat(vals).reshape(nb, block_cap // LANES, LANES)
    colrel = torch.cat(crels).reshape(nb, block_cap // LANES, LANES)
    rowseg = torch.cat(rsegs).reshape(-1)
    return dict(val=val, colrel=colrel, rowseg=rowseg, row_ptr=row_ptr,
                blk_start=blk_start, nnz=nnz, nb=nb, block_cap=block_cap,
                pad_ratio=nb * block_cap / nnz, deg=deg_v)


def streams_csr(S: dict, n: int, band: int, rows_per_block: int):
    """The same matrix as a torch.sparse_csr_tensor (f32 values, int32
    indices), for the cuSPARSE yardstick: the streams' valid slots are the
    CSR entries in row order."""
    dev = S["val"].device
    nb, cap = S["nb"], S["block_cap"]
    e = torch.arange(cap, device=dev)[None, :]
    blk_nnz = (S["row_ptr"][rows_per_block::rows_per_block][:nb]
               - S["blk_start"]).long()
    valid = e < blk_nnz[:, None]
    ws = torch.arange(nb, device=dev)[:, None] * rows_per_block - band
    col = S["colrel"].reshape(nb, cap).long() + ws
    return torch.sparse_csr_tensor(
        S["row_ptr"][: n + 1].to(torch.int32), col[valid].to(torch.int32),
        S["val"].reshape(nb, cap)[valid], (n, n), check_invariants=False)


# --------------------------------------------------------------- variants

def make_variants(S: dict, n: int, band: int, rows_per_block: int):
    """x -> y functions of the four variants, and S with the row bounds of
    the cumulative-sum variant added."""
    dev = S["val"].device
    row_ptr, blk_start = S["row_ptr"], S["blk_start"]
    block_cap = S["block_cap"]
    r_idx = torch.arange(n, device=dev)
    b_of_r = r_idx // rows_per_block
    start_pad = (b_of_r * block_cap
                 + (row_ptr[r_idx] - blk_start[b_of_r]).long())
    end_pad = (b_of_r * block_cap
               + (row_ptr[r_idx + 1] - blk_start[b_of_r]).long())
    # segment ids past n (padding slots of the last block) go to a spare
    # segment that is dropped, as segment_sum(num_segments=n) drops them
    seg = S["rowseg"].long().clamp_max(n)
    ws = (torch.arange(S["nb"], device=dev) * rows_per_block).view(-1, 1, 1)
    lead = torch.zeros(band, dtype=torch.float32, device=dev)
    tail = torch.zeros(rows_per_block + band, dtype=torch.float32, device=dev)

    def pad(x):
        return torch.cat([lead, x, tail])

    def segment_sum(p):
        y = torch.zeros(n + 1, dtype=p.dtype, device=dev)
        return y.index_add_(0, seg, p.reshape(-1))[:n]

    def pass1(x):
        return pass1_products(S["val"], S["colrel"], pad(x), band,
                              rows_per_block)

    def twopass_segsum(x):
        return segment_sum(pass1(x))

    def twopass_cumsum(x):
        p = pass1(x).reshape(-1)
        P = torch.cat([torch.zeros(1, dtype=p.dtype, device=dev),
                       torch.cumsum(p, 0)])
        return P[end_pad] - P[start_pad]

    def pass1_only(x):
        p = pass1(x)
        # real data dependence at negligible magnitude: keeps the chain
        # honest without a reduction pass
        return x + 1e-30 * torch.sum(p.reshape(-1)[::4097])

    def csrseg_onepass(x):
        xg = pad(x)[S["colrel"].long() + ws]
        return segment_sum(S["val"] * xg)

    S = dict(S, start_pad=start_pad, end_pad=end_pad)
    return S, dict(twopass_segsum=twopass_segsum,
                   twopass_cumsum=twopass_cumsum,
                   pass1_only=pass1_only,
                   csrseg_onepass=csrseg_onepass)


# ------------------------------------------------------------------- main

def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparsebench_tpu_torch.benchmarks.csr_twopass_proto",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default=None,
                    help="also write the JSON line to this file")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device)
    small = bool(os.environ.get("SB_PROTO_SMALL")) or device.type == "cpu"
    n, band, deg, seed = ((8192, 128, 16.0, 1) if small
                          else (2_000_000, 512, 16.0, 1))
    rows_per_block = 512 if small else 1024
    K = (rows_per_block + 2 * band) // LANES

    t0 = time.perf_counter()
    S = build_streams(n, band, deg, seed, rows_per_block, device)
    log(f"build: n={n} nnz={S['nnz']} blocks={S['nb']} "
        f"block_cap={S['block_cap']} pad={S['pad_ratio']:.3f} "
        f"K={K} ({time.perf_counter() - t0:.1f}s)")
    S, variants = make_variants(S, n, band, rows_per_block)

    xr = 0.5 + (torch.arange(n, dtype=torch.float32, device=device)
                % 97) / 97.0
    res = {"n": n, "band": band, "deg": deg, "nnz": S["nnz"],
           "rows_per_block": rows_per_block, "K_window_slabs": K,
           "block_pad_ratio": round(float(S["pad_ratio"]), 4),
           **device_fields(device)}
    ones = torch.ones(n, dtype=torch.float32, device=device)
    y_ref = None
    failed = []
    for name, fn in variants.items():
        if name == "pass1_only":
            continue
        err1 = float((fn(ones) - 1.0).abs().max())
        yr = fn(xr)
        if y_ref is None:
            y_ref, errx = yr, 0.0
        else:
            errx = float((yr - y_ref).abs().max() / y_ref.abs().max())
        res[f"{name}_err_ones"] = err1
        res[f"{name}_err_cross"] = errx
        log(f"validate {name}: |A@1 - 1| {err1:.2e}, cross {errx:.2e}")
        # the segment sums of integers are exact; the cumulative-sum
        # difference is lossy by design (reported, not proposed)
        if name != "twopass_cumsum" and (err1 != 0.0 or errx > 1e-5):
            failed.append(name)

    if small:  # independent oracle: the host-numpy spec CSR
        y_h = rgl_csr(n, band=band, deg=deg, seed=seed).spmv(
            xr.cpu().numpy().astype(np.float64))
        err_h = float(np.abs(y_ref.cpu().numpy() - y_h).max()
                      / np.abs(y_h).max())
        res["host_oracle_err"] = err_h
        log(f"validate vs host-spec CSR oracle: {err_h:.2e}")
        if not err_h < 1e-5:
            failed.append("host_oracle")
    if failed:
        log(f"validation failed: {failed}")
        emit(res)
        return 1

    if device.type == "cuda":
        for name, fn in variants.items():
            dt, _raw, sp = chain_time(fn, ones, reps=10, trials=3,
                                      min_diff_s=0.030)
            res[f"{name}_ms"] = dt * 1e3
            res[f"{name}_spread"] = sp
            res[f"{name}_eff_GBps"] = 8 * S["nnz"] / dt / 1e9
            log(f"{name}: {dt * 1e3:.4f} ms (spread {sp:.1%}, "
                f"{res[f'{name}_eff_GBps']:.1f} GB/s effective)")
        if not small:
            _baselines(res, S, variants, n, band, deg, seed, rows_per_block,
                       device, ones, xr)
    emit(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(res) + "\n")
    return 0


def _baselines(res, S, variants, n, band, deg, seed, rows_per_block, device,
               ones, xr) -> None:
    """The positional layout (``rgl_bslab``, K6, f32 x with bf16 values as
    the CLI's default builds it) and cuSPARSE CSR f32 on the same matrix,
    timed as the variants are."""
    from sparsebench_tpu_torch.config import DTypePolicy
    from sparsebench_tpu_torch.formats.rgl_build import rgl_bslab

    Ar, nnz_r = rgl_bslab(n, band=band, deg=deg, seed=seed, device=device,
                          policy=DTypePolicy.from_names("f32"))
    dt, _raw, sp = chain_time(Ar.spmv, ones, reps=10, trials=3,
                              min_diff_s=0.030)
    res["positional_bslab_ms"] = dt * 1e3
    res["positional_bslab_spread"] = sp
    res["positional_bslab_eff_GBps"] = 8 * nnz_r / dt / 1e9
    log(f"positional bslab (K6): {dt * 1e3:.4f} ms "
        f"({res['positional_bslab_eff_GBps']:.1f} GB/s effective)")
    del Ar
    csr = streams_csr(S, n, band, rows_per_block)
    err = float((csr @ xr - variants["twopass_segsum"](xr)).abs().max())
    dt, _raw, sp = chain_time(lambda u: csr @ u, ones, reps=10, trials=3,
                              min_diff_s=0.030)
    res["cusparse_csr_ms"] = dt * 1e3
    res["cusparse_csr_spread"] = sp
    res["cusparse_csr_eff_GBps"] = 8 * S["nnz"] / dt / 1e9
    res["cusparse_csr_err"] = err
    log(f"cuSPARSE CSR f32: {dt * 1e3:.4f} ms "
        f"({res['cusparse_csr_eff_GBps']:.1f} GB/s effective, "
        f"max|csr - twopass_segsum| {err:.2e})")


if __name__ == "__main__":
    sys.exit(main())
