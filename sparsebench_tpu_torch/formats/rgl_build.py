"""Device build of the RGL matrix (random-graph Laplacian) straight into a
BslabMatrix (counterpart of sparsebench_tpu/formats/rgl_build.py).

The matrix (host.py ``rgl_csr`` is its spec) is generated and laid out on
the device from (n, band, deg, seed), with no host CSR:

  * the (rows x offsets) edge mask is the spec's u32 pair hash on index
    grids, computed in int64 masked to 32 bits (torch's uint32 lacks
    arithmetic on CUDA);
  * block-diagonal bucket d = ((row mod 128) + off) >> 7 sees only the
    offsets [128d - 127, 128d + 127] (clipped to the band), so the work of
    a bucket runs on (rows, <= 255) windows;
  * phase 1 counts the stored entries of every (row, bucket) once; the
    per-bucket histograms, the exact slice caps, the overflow-pool
    capacities of every candidate layout and the row degrees all come from
    that count matrix;
  * ``_choose_caps`` picks per-bucket caps, wide-pool capacities and the
    pool span with ``_kernel_cost``'s rule, unchanged, so the port builds
    the JAX package's layout;
  * phase 2 writes the slice planes with one scatter per (row block,
    bucket): the k-th stored entry of (row, bucket), in ascending offset
    order, goes to that bucket's k-th general slice while k < cap; the rest
    go to the wide pool of the bucket's group, after the overflow of the
    group's earlier buckets (the JAX package's one-hot contraction gives
    the same layout). A slot beyond a pool's probed capacity raises.

Every slice is general or wide: the matrix is irregular by design. Values
are -1 and degree + 1, exact in bf16 up to 256 (the JAX package rounds
degree + 1 through bf16 in every dtype; the two agree while it is at most
256), so f32 values are stored as bf16.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.base import default_policy
from sparsebench_tpu_torch.formats.bslab import BslabMatrix, _window_plan
from sparsebench_tpu_torch.host import threshold
from sparsebench_tpu_torch.ops.bslab_spmv import LANES

_U32 = 0xFFFFFFFF
_HIST_CAP = 48  # per-(row, d) counts beyond this are off-distribution
# rows x offsets grid points of one phase step (a few 64 MB int64 temps)
_STEP_POINTS = 1 << 23


def _bucket_window(band: int, d: int) -> Tuple[int, int]:
    """Offset window of block-diagonal bucket d: an entry at (row, row +
    off) lands in bucket ((row mod 128) + off) >> 7, so bucket d only sees
    off in [128d - 127, 128d + 127], clipped to the band."""
    return (max(-band, LANES * d - (LANES - 1)),
            min(band, LANES * d + (LANES - 1)))


def _hash(lo: torch.Tensor, hi: torch.Tensor, seed: int) -> torch.Tensor:
    """host.mix32 on int64 tensors of nonnegative values < 2^31, each step
    reduced mod 2^32 (every product stays below 2^63)."""
    h = ((lo * 0x9E3779B1) & _U32) + ((hi * 0x85EBCA77) & _U32)
    h = (h + ((seed & _U32) * 0xC2B2AE3D & _U32)) & _U32
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _U32
    h = h ^ (h >> 13)
    h = (h * 0x297A2D39) & _U32
    return h ^ (h >> 16)


def _bucket_masks(r0: int, r1: int, n: int, band: int, d: int, thresh: int,
                  seed: int, device: torch.device):
    """Rows [r0, r1) of bucket d on its offset window: (i, offs, md) with
    md the stored entries (edges and, in bucket 0, the diagonal)."""
    w_lo, w_hi = _bucket_window(band, d)
    i = torch.arange(r0, r1, device=device)
    offs = torch.arange(w_lo, w_hi + 1, device=device)
    j = i[:, None] + offs[None, :]
    inb = (j >= 0) & (j < n) & (offs[None, :] != 0)
    lo = torch.minimum(i[:, None], j).clamp_min(0)
    hi = torch.maximum(i[:, None], j).clamp_min(0)
    in_bucket = (((i & (LANES - 1))[:, None] + offs[None, :]) >> 7) == d
    md = inb & (_hash(lo, hi, seed) < thresh) & in_bucket
    if w_lo <= 0 <= w_hi:
        md = md | ((offs[None, :] == 0) & in_bucket)
    return i, offs, md


def _row_steps(n: int, band: int):
    """Row blocks [r0, r1) covering [0, n), sized to _STEP_POINTS grid
    points of the widest bucket window."""
    step = max(LANES, _STEP_POINTS // min(2 * band + 1, 2 * LANES - 1))
    return [(r0, min(r0 + step, n)) for r0 in range(0, n, step)]


def _count_matrix(n, band, nD, d_min, thresh, seed, device) -> torch.Tensor:
    """Phase 1: (n, nD) int32 count of stored entries per (row, bucket)."""
    cnt = torch.empty((n, nD), dtype=torch.int32, device=device)
    for r0, r1 in _row_steps(n, band):
        for bi in range(nD):
            _, _, md = _bucket_masks(r0, r1, n, band, d_min + bi, thresh,
                                     seed, device)
            cnt[r0:r1, bi] = md.sum(dim=1)
    return cnt


def _probe_hist(cnt: torch.Tensor) -> np.ndarray:
    """(nD, _HIST_CAP) histograms of the per-(row, bucket) counts."""
    clamped = cnt.clamp_max(_HIST_CAP - 1).long()
    return np.stack([
        torch.bincount(clamped[:, bi], minlength=_HIST_CAP).cpu().numpy()
        for bi in range(cnt.shape[1])
    ])


def _probe_overflow(cnt: torch.Tensor, q: np.ndarray, span: int):
    """For candidate caps q (nC, nD): the per-group wide-pool capacities
    (max over rows of the group's total overflow; groups are runs of
    ``span`` buckets) and the total overflow, ((nC, G), (nC,)) numpy."""
    nD = cnt.shape[1]
    nG = -(-nD // span)
    qt = torch.as_tensor(np.asarray(q), dtype=torch.int32, device=cnt.device)
    over = (cnt[None, :, :] - qt[:, None, :]).clamp_min(0)   # (nC, n, nD)
    caps = np.zeros((qt.shape[0], nG), np.int64)
    for g in range(nG):
        caps[:, g] = over[:, :, g * span:(g + 1) * span].sum(dim=2).amax(
            dim=1).cpu().numpy()
    return caps, over.sum(dim=(1, 2)).cpu().numpy()


def _kernel_cost(s_gen: int, s_wide: int, wide_k: int, n_groups: int,
                 vb: float, objective: str = "time") -> float:
    """Per-tile cost model of the slab kernel, in byte units a row (the JAX
    package's rule and constant, kept so that both packages pick one
    layout):

      memory  = (vb+1)*s_gen + (vb+2)*s_wide          (streamed planes)
      gathers = KAPPA * (s_gen + wide_k*s_wide + n_groups)
      time   ~ max(memory, gathers)

    KAPPA = 3.07 weighs a gather against a byte unit. It was calibrated on
    another accelerator, so on the H100 the layout it picks is unverified
    (PERF.md, open questions). objective="bytes" minimises storage."""
    KAPPA = 3.07
    mem = (vb + 1) * s_gen + (vb + 2) * s_wide
    if objective == "bytes":
        return mem
    comp = KAPPA * (s_gen + wide_k * s_wide + n_groups)
    return max(mem, comp)


def _choose_caps(hist: np.ndarray, n: int, caps_max, probe, vb: float,
                 nD: int, objective: str = "time") -> Tuple[tuple, tuple, int]:
    """Per-bucket quantile caps, per-group wide-pool capacities and pool
    span minimising ``_kernel_cost``: candidates sweep a per-(row, bucket)
    tail probability alpha, crossed with the span; ``probe(q, span)`` gives
    the exact pool capacities. Returns (caps, wcaps, span)."""
    cands = [tuple(caps_max)]
    for alpha in (0.0003, 0.001, 0.003, 0.01, 0.03, 0.1):
        caps_a = []
        for d in range(nD):
            rows_gt = hist[d][::-1].cumsum()[::-1]  # rows with cnt >= c
            q = caps_max[d]
            while q > 1 and rows_gt[q] <= alpha * n:
                q -= 1
            caps_a.append(max(q, 1))
        t = tuple(caps_a)
        if t not in cands:
            cands.append(t)
    best = (tuple(caps_max), (), nD)
    best_cost = _kernel_cost(sum(caps_max), 0, nD, 0, vb, objective)
    if len(cands) > 1:
        q = np.asarray(cands[1:], np.int32)
        for span in sorted({2, 3, nD} - {1}):
            w_caps, _tots = probe(q, span)
            for t, wc in zip(cands[1:], np.asarray(w_caps)):
                wc = tuple(int(w) for w in wc)
                ng = sum(1 for w in wc if w)
                cost = _kernel_cost(sum(t), sum(wc), span, ng, vb, objective)
                if cost < best_cost:
                    best, best_cost = (t, wc, span), cost
    return best


def _build_planes(cnt, n, band, sub, n_tiles, caps, wcaps, span, d_min,
                  thresh, seed, store_dt, device):
    """Phase 2: (vals, lidx, vals_wide, lidx_wide, dblk_wide) by scatter."""
    nD = len(caps)
    R = sub * LANES
    s_gen, s_wide = int(sum(caps)), int(sum(wcaps))
    cbase = np.concatenate([[0], np.cumsum(caps)]).tolist()
    wbase = np.concatenate([[0], np.cumsum(wcaps)]).tolist() if s_wide else []
    planes = lambda s, dt: torch.zeros(  # noqa: E731
        n_tiles * s * R, dtype=dt, device=device)
    vals, lidx = planes(s_gen, store_dt), planes(s_gen, torch.int8)
    wv, wl, wd = (planes(s_wide, store_dt), planes(s_wide, torch.int8),
                  planes(s_wide, torch.int8))
    degree = cnt.sum(dim=1) - 1  # every row stores its diagonal
    capt = torch.as_tensor(caps, dtype=torch.int64, device=device)
    # overflow of a row's earlier buckets in the same pool group
    woff = torch.zeros_like(cnt)
    if s_wide:
        over = (cnt - capt).clamp_min(0)
        for bi in range(nD):
            if bi % span:
                woff[:, bi] = woff[:, bi - 1] + over[:, bi - 1]
    for r0, r1 in _row_steps(n, band):
        for bi in range(nD):
            i, offs, md = _bucket_masks(r0, r1, n, band, d_min + bi, thresh,
                                        seed, device)
            rank = torch.cumsum(md, dim=1) - 1
            ri, oi = md.nonzero(as_tuple=True)
            row = i[ri]
            k = rank[ri, oi]
            off = offs[oi]
            val = torch.where(off == 0, (degree[row] + 1).to(torch.float32),
                              -1.0).to(store_dt)
            li = ((row + off) & (LANES - 1)).to(torch.int8)
            t, e = row // R, row % R   # e = s*128 + lane within the tile
            gen = k < caps[bi]
            if not s_wide and not bool(gen.all()):
                raise RuntimeError(
                    f"RGL build: bucket {d_min + bi} exceeds its probed cap "
                    f"{caps[bi]} (phase 1 and phase 2 disagree)")
            dest = (t * s_gen + cbase[bi] + k) * R + e
            vals[dest[gen]] = val[gen]
            lidx[dest[gen]] = li[gen]
            if s_wide:
                g = bi // span
                wo = ~gen
                wlocal = woff[row[wo], bi] + k[wo] - caps[bi]
                if bool((wlocal >= wcaps[g]).any()):
                    raise RuntimeError(
                        f"RGL build overflowed pool {g} (capacity "
                        f"{wcaps[g]}): phase 1 and phase 2 disagree")
                wdest = (t[wo] * s_wide + wbase[g] + wlocal) * R + e[wo]
                wv[wdest] = val[wo]
                wl[wdest] = li[wo]
                wd[wdest] = bi - g * span
    shape = lambda s: (n_tiles, s, sub, LANES)  # noqa: E731
    return (vals.view(shape(s_gen)), lidx.view(shape(s_gen)),
            wv.view(shape(s_wide)), wl.view(shape(s_wide)),
            wd.view(shape(s_wide)))


def rgl_bslab(
    n: int,
    band: int = 512,
    deg: float = 16.0,
    seed: int = 1,
    *,
    device: Union[str, torch.device],
    policy: Optional[DTypePolicy] = None,
    sub: int = 64,
    impl: str = "auto",
    tail: bool = True,
    objective: str = "time",
    force_caps: Optional[tuple] = None,
    force_span: int = 0,
) -> Tuple[BslabMatrix, int]:
    """The RGL matrix built on ``device`` as a BslabMatrix; returns
    (matrix, nnz). b = A 1 = ones, so the exact solution is x == 1.

    ``tail`` (default) weighs quantile caps with the overflow in wide
    slices against ``objective`` ("time": ``_kernel_cost``'s model;
    "bytes": least storage); ``tail=False`` keeps the exact caps. The test
    hooks ``force_caps`` (and ``force_span``) fix the caps and the pool
    span."""
    policy = default_policy(policy)
    device = torch.device(device)
    if band < 1 or band >= n:
        raise ValueError(f"band must be in [1, n); got {band} for n={n}")
    lead = sub
    n_tiles = max(1, -(-n // (sub * LANES)))
    nb = max(1, -(-n // LANES))
    d_min = -((band + LANES - 1) // LANES)
    d_max = (LANES - 1 + band) // LANES
    nD = d_max - d_min + 1
    thresh = int(threshold(band, deg))
    store_dt = torch.bfloat16 if policy.value == torch.float32 else policy.value
    vb = store_dt.itemsize

    cnt = _count_matrix(n, band, nD, d_min, thresh, seed, device)
    hist = _probe_hist(cnt)
    if hist[:, -1].any():
        raise ValueError(
            f"per-(row, d) entry counts reached the histogram clamp "
            f"({_HIST_CAP - 1}); this deg/band combination is outside the "
            f"layout's design range")
    caps_max = [
        max(1, int(np.nonzero(hist[d])[0].max()) if hist[d].any() else 1)
        for d in range(nD)
    ]
    # the wide dbase (group anchor blocks) must not underflow the lead pad
    if force_caps is not None:
        if lead + d_min < 0:
            raise ValueError(
                f"wide slices need sub >= {-d_min} (lead pad underflow)")
        caps = tuple(int(c) for c in force_caps)
        span = force_span if force_span else nD
        wcaps = tuple(int(w) for w in _probe_overflow(cnt, [caps], span)[0][0])
    elif tail and lead + d_min >= 0:
        caps, wcaps, span = _choose_caps(
            hist, n, caps_max, lambda q, sp: _probe_overflow(cnt, q, sp),
            vb, nD, objective)
    else:
        caps, wcaps, span = tuple(caps_max), (), nD
    s_gen = int(sum(caps))
    s_wide = int(sum(wcaps))
    vals, lidx, wv, wl, wd = _build_planes(
        cnt, n, band, sub, n_tiles, caps, wcaps, span, d_min, thresh, seed,
        store_dt, device)
    nnz = int(cnt.sum())
    del cnt

    # slice metadata: bucket bi (d = d_min + bi) owns the slices
    # [sum(caps[:bi]), sum(caps[:bi+1])) with dbase = sub*t + d + lead. Pool
    # g anchors at block d_min + g*span (its dblk counts up through span
    # blocks); the x rows cover the tallest pool slab.
    wide_ext = ((span - 1 + 7) & ~7) if s_wide else 0
    anchors = [d_min + g * span for g, c in enumerate(wcaps) if c]
    top_anchor = max(anchors) if anchors else 0
    extra = (max(0, top_anchor + wide_ext - (d_min + nD - 1)) if s_wide
             else 0)
    x_rows = lead + nb + sub + extra
    pos_d = np.concatenate(
        [np.full(c, d_min + bi, np.int64) for bi, c in enumerate(caps)])
    t_np = np.arange(n_tiles, dtype=np.int64)
    dbase = np.clip(sub * t_np[:, None] + pos_d[None, :] + lead, 0,
                    x_rows - sub)
    meta_gen = dbase.astype(np.int32)[:, :, None]
    lo, hi = dbase.min(axis=1), dbase.max(axis=1)
    if s_wide:
        pos_w = np.concatenate([
            np.full(c, a, np.int64)
            for a, c in zip(anchors, [c for c in wcaps if c])
        ])
        dbase_w = sub * t_np[:, None] + pos_w[None, :] + lead  # >= 0
        meta_wide = dbase_w.astype(np.int32)[:, :, None]
        lo = np.minimum(lo, dbase_w.min(axis=1))
        hi = np.maximum(hi, dbase_w.max(axis=1) + wide_ext)
    else:
        meta_wide = np.zeros((n_tiles, 0, 1), np.int32)
    w_blocks, wchunk, xw_rows = _window_plan(n_tiles, lo, hi, sub)
    live_pools = tuple(c for c in wcaps if c)
    obj = BslabMatrix(
        meta_aff=torch.zeros((n_tiles, 0, 2), dtype=torch.int32,
                             device=device),
        vals_aff=torch.zeros((n_tiles, 0, sub, LANES), dtype=store_dt,
                             device=device),
        meta_gen=torch.from_numpy(meta_gen).to(device),
        vals_gen=vals,
        lidx_gen=lidx,
        meta_wide=torch.from_numpy(meta_wide).to(device),
        vals_wide=wv,
        lidx_wide=wl,
        dblk_wide=wd,
        wchunk=torch.from_numpy(wchunk).to(device),
        nr=n, nc=n, nnz=nnz,
        n_tiles=n_tiles, s_aff=0, s_gen=s_gen, s_wide=s_wide,
        wide_k=span if s_wide else 1, sub=sub,
        x_rows=x_rows, w_blocks=w_blocks, xw_rows=xw_rows,
        n_elems=n_tiles * (s_gen + s_wide) * sub * LANES,
        start_row=0, total_nr=n, total_nnz=nnz,
        wide_groups=live_pools if len(live_pools) > 1 else (),
    )
    return obj.with_impl(impl), nnz
