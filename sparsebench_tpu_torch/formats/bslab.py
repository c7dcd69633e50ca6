"""BSLAB — slab-table BSELL, the general device format (counterpart of
sparsebench_tpu/formats/bslab.py).

Rows group 128 to a lane group and ``sub`` lane groups to a tile. Entries
bucket by block diagonal d = col/128 - row/128, so a slice (one (sub, 128)
plane per tile) reads one run of x rows starting at ``dbase`` (in rows of
the x padded with ``lead`` = ``sub`` zero rows). Slices are classified at
build time: *affine* slices (lane index (lane + r) & 127 for one r, every
banded or stencil slice) store no index plane; *general* slices store an
int8 lane index per element; *wide* slices (built only by
formats/rgl_build.py) also store an int8 block delta ``dblk``. The host
build (``_auto_sub``, ``_window_plan``, ``_build_arrays``) is a numpy copy
of the JAX package's, so the arrays come out equal element for element;
ops/bslab_spmv.py says what the SpMV computes from them.

``impl`` picks the SpMV: ``kernel`` (K6), ``kernel_win`` (K7, the tiles'
windows of x held in a ring of chunks in shared memory) or ``torch``
(their plain version). ``auto`` is ``kernel`` on CUDA and ``torch`` on the
CPU. The JAX package sends the RGL matrix and the 200^3 stencil to its
windowed kernel; here K7 runs only when asked for, and ``auto`` keeps K6
(PERF.md §6 times both, §7 asks where K7 should be the default). K7 runs
every window: where two chunks exceed a block's shared memory (200^3: 778
KB in f32) it spreads them over a thread-block cluster, and it raises, at
the first SpMV, only where a cluster of 8 blocks cannot hold them.
``kernel`` and ``kernel_win`` on the CPU raise. ``impl`` is the one choice
between kernel and plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.base import default_policy, round_up
from sparsebench_tpu_torch.formats.registry import register_format
from sparsebench_tpu_torch.host import OFFSETS_27, HostCSR, generate_stencil
from sparsebench_tpu_torch.ops.bslab_spmv import (
    LANES,
    Slices,
    bslab_spmv,
    bslab_spmv_torch,
    bslab_spmv_win,
)
from sparsebench_tpu_torch.ops.stencil import compute_dtype

VALID_IMPLS = ("auto", "torch", "kernel", "kernel_win")
DEFAULT_SUB = 64

Device = Union[str, torch.device]


def resolve_impl(impl: str, device: torch.device) -> str:
    """``auto`` -> ``kernel`` (K6) on CUDA, ``torch`` on the CPU; the
    kernels exist only on CUDA."""
    if impl not in VALID_IMPLS:
        raise ValueError(
            f"unknown bslab impl {impl!r}; valid: {', '.join(VALID_IMPLS)}")
    if device.type != "cuda":
        if impl in ("kernel", "kernel_win"):
            raise ValueError(
                f"impl {impl!r} is a CUDA kernel and the device is {device}; "
                "use impl 'torch' (the plain version) on the CPU")
        return "torch"
    return "kernel" if impl == "auto" else impl


def _auto_sub(nr: int, sub: int, default: int = DEFAULT_SUB) -> int:
    """Slice height: ``sub`` when given (a multiple of 8), else the tallest
    power of two <= ``default`` whose tile does not dwarf the matrix."""
    if sub:
        if sub % 8 or sub < 8:
            raise ValueError(f"sub must be a multiple of 8 >= 8, got {sub}")
        return sub
    s = default
    while s > 8 and s * LANES > max(nr, 1):
        s //= 2
    return s


def _window_plan(n_tiles: int, lo: np.ndarray, hi: np.ndarray, sub: int):
    """Chunk plan of the windowed kernel: the slab starts of tile t lie in
    [lo_t, hi_t]; W covers the widest span plus a slab, and every tile's
    slabs lie in chunks [wchunk, wchunk + 2)."""
    span = int(max(1, (hi - lo).max())) if n_tiles else 1
    w_blocks = round_up(span + sub, 8)
    wchunk = (lo // w_blocks).astype(np.int32)
    xw_rows = int(wchunk.max() + 2) * w_blocks
    return w_blocks, wchunk, xw_rows


def _build_arrays(csr: HostCSR, host_dt: np.dtype, sub: int):
    """Vectorised host construction (numpy) of the slab-slice arrays, in
    ``host_dt`` values (numpy has no bf16: bf16 is narrowed with torch)."""
    nr, nc = csr.nr, csr.nc
    lead = sub  # x lead pad rows: the slab of a real entry never underflows
    tile_rows = sub * LANES
    n_tiles = max(1, -(-nr // tile_rows))
    n_groups_total = n_tiles * sub
    nb = max(1, -(-nc // LANES))
    x_rows = lead + nb + sub
    nnz = csr.nnz
    if nnz == 0:
        meta_aff = np.full((n_tiles, 1, 2), 0, np.int32)
        meta_aff[:, :, 0] = lead
        vals_aff = np.zeros((n_tiles, 1, sub, LANES), host_dt)
        meta_gen = np.zeros((n_tiles, 0, 1), np.int32)
        vals_gen = np.zeros((n_tiles, 0, sub, LANES), host_dt)
        lidx_gen = np.zeros((n_tiles, 0, sub, LANES), np.int8)
        wchunk = np.zeros(n_tiles, np.int32)
        return (meta_aff, vals_aff, meta_gen, vals_gen, lidx_gen, wchunk,
                n_tiles, 1, 0, x_rows, 2 * sub, 4 * sub)

    lens = csr.row_lengths
    rows = np.repeat(np.arange(nr, dtype=np.int64), lens)
    col = csr.col.astype(np.int64)
    val = csr.val
    # the occurrence runs below need column-sorted rows: an unsorted row
    # would collapse same-(row, d) entries onto one slot
    same_row = rows[1:] == rows[:-1]
    if np.any(same_row & (col[1:] <= col[:-1])):
        order0 = np.lexsort((col, rows))
        col = col[order0]
        val = val[order0]
    g = rows >> 7
    lane = (rows & 127).astype(np.int64)
    b = col >> 7
    lidx = (col & 127).astype(np.int64)
    t = g // sub
    s = g % sub
    dk = b - g + n_groups_total             # shifted block diagonal >= 0
    ndk = nb + n_groups_total               # dk < ndk

    # occurrence j within each (row, d) run
    key_rd = rows * ndk + dk
    is_new = np.empty(nnz, bool)
    is_new[0] = True
    is_new[1:] = key_rd[1:] != key_rd[:-1]
    run_start = np.flatnonzero(is_new)
    run_id = np.cumsum(is_new) - 1
    j = np.arange(nnz, dtype=np.int64) - run_start[run_id]

    # per (tile, d): the longest (row, d) run
    run_len = np.diff(np.append(run_start, nnz))
    key_td_run = t[run_start] * ndk + dk[run_start]
    order = np.argsort(key_td_run, kind="stable")
    ktd_sorted = key_td_run[order]
    len_sorted = run_len[order]
    td_new = np.empty(ktd_sorted.size, bool)
    td_new[0] = True
    td_new[1:] = ktd_sorted[1:] != ktd_sorted[:-1]
    td_starts = np.flatnonzero(td_new)
    td_keys = ktd_sorted[td_starts]          # ascending (tile, dk)
    lmax_td = np.maximum.reduceat(len_sorted, td_starts)
    td_t = td_keys // ndk
    td_dk = td_keys % ndk

    # global slice ids: the slices of (t, d) are [gbase_td, gbase_td + lmax)
    csum = np.cumsum(lmax_td)
    gbase_td = csum - lmax_td
    total_slices = int(csum[-1])
    key_td_entry = t * ndk + dk
    td_pos = np.searchsorted(td_keys, key_td_entry)
    gid = gbase_td[td_pos] + j

    # a slice is affine when all its entries share one r = (lidx - lane) & 127
    re = (lidx - lane) & 127
    re_min = np.full(total_slices, 200, np.int64)
    re_max = np.full(total_slices, -1, np.int64)
    np.minimum.at(re_min, gid, re)
    np.maximum.at(re_max, gid, re)
    affine = re_min == re_max                # every slice has >= 1 entry

    within = np.arange(total_slices, dtype=np.int64) - np.repeat(
        gbase_td, lmax_td)
    rep = np.repeat(np.arange(td_keys.size), lmax_td)
    sl_tile = td_t[rep]
    sl_dk = td_dk[rep]
    # dbase in padded x rows: b - (g - sub*t) + lead for a real entry
    sl_dbase = (sub * sl_tile + (sl_dk - n_groups_total) + lead).astype(
        np.int64)

    # per-tile class partition: affine slices first (ordered by d, j)
    order2 = np.lexsort((within, sl_dk, np.logical_not(affine), sl_tile))
    sorted_tile = sl_tile[order2]
    tile_change = np.empty(total_slices, bool)
    tile_change[0] = True
    tile_change[1:] = sorted_tile[1:] != sorted_tile[:-1]
    tile_first = np.flatnonzero(tile_change)
    pos_sorted = np.arange(total_slices) - np.repeat(
        tile_first, np.diff(np.append(tile_first, total_slices)))
    pos = np.empty(total_slices, np.int64)
    pos[order2] = pos_sorted
    n_aff_tile = np.zeros(n_tiles, np.int64)
    np.add.at(n_aff_tile, sl_tile, affine)
    n_all_tile = np.zeros(n_tiles, np.int64)
    np.add.at(n_all_tile, sl_tile, 1)
    pos_cls = np.where(affine, pos, pos - n_aff_tile[sl_tile])
    s_aff = int(n_aff_tile.max())
    s_gen = int((n_all_tile - n_aff_tile).max())

    # window plan from the real slices' dbase ranges
    lo = np.full(n_tiles, x_rows - sub, np.int64)
    hi = np.zeros(n_tiles, np.int64)
    np.minimum.at(lo, sl_tile, sl_dbase)
    np.maximum.at(hi, sl_tile, sl_dbase)
    lo = np.minimum(lo, hi)
    empty = n_all_tile == 0
    lo[empty] = lead
    hi[empty] = lead
    w_blocks, wchunk, xw_rows = _window_plan(n_tiles, lo, hi, sub)

    # slice metadata (padding slices stay in the window)
    meta_aff = np.zeros((n_tiles, max(s_aff, 1), 2), np.int32)
    meta_aff[:, :, 0] = lo[:, None]
    meta_gen = np.zeros((n_tiles, s_gen, 1), np.int32)
    if s_gen:
        meta_gen[:, :, 0] = lo[:, None]
    a_sel = affine
    meta_aff[sl_tile[a_sel], pos_cls[a_sel], 0] = sl_dbase[a_sel]
    meta_aff[sl_tile[a_sel], pos_cls[a_sel], 1] = re_min[a_sel]
    g_sel = ~affine
    if s_gen:
        meta_gen[sl_tile[g_sel], pos_cls[g_sel], 0] = sl_dbase[g_sel]
    s_aff = max(s_aff, 1)

    # scatter the entries
    vals_aff = np.zeros((n_tiles, s_aff, sub, LANES), host_dt)
    vals_gen = np.zeros((n_tiles, s_gen, sub, LANES), host_dt)
    lidx_gen = np.zeros((n_tiles, s_gen, sub, LANES), np.int8)
    e_aff = affine[gid]
    e_pos = pos_cls[gid]
    v = val.astype(host_dt)
    vals_aff[t[e_aff], e_pos[e_aff], s[e_aff], lane[e_aff]] = v[e_aff]
    if s_gen:
        ge = ~e_aff
        vals_gen[t[ge], e_pos[ge], s[ge], lane[ge]] = v[ge]
        lidx_gen[t[ge], e_pos[ge], s[ge], lane[ge]] = lidx[ge].astype(np.int8)
    return (meta_aff, vals_aff, meta_gen, vals_gen, lidx_gen, wchunk,
            n_tiles, s_aff, s_gen, x_rows, w_blocks, xw_rows)


def empty_wide(n_tiles: int, sub: int, store_dt: torch.dtype,
               device: torch.device) -> dict:
    """Zero-size wide-class arrays (every build but RGL's)."""
    return dict(
        meta_wide=torch.zeros((n_tiles, 0, 1), dtype=torch.int32,
                              device=device),
        vals_wide=torch.zeros((n_tiles, 0, sub, LANES), dtype=store_dt,
                              device=device),
        lidx_wide=torch.zeros((n_tiles, 0, sub, LANES), dtype=torch.int8,
                              device=device),
        dblk_wide=torch.zeros((n_tiles, 0, sub, LANES), dtype=torch.int8,
                              device=device),
    )


def _stencil_vals(slices, nx, ny, nr, n_tiles, sub, store_dt, device,
                  block_tiles: int = 16):
    """Value planes of the stencil slab build, on ``device`` (the JAX
    package's ``_stencil_vals_device``): per slice (one part of one
    diagonal) a constant under bound checks on grid coordinates, built
    ``block_tiles`` tiles at a time. Returns (vals (n_tiles, S, sub, 128),
    counts (n_tiles*sub*128,) int32, row lengths with rows >= nr zero)."""
    R = sub * LANES
    S = len(slices)
    col_of = lambda k: torch.tensor([sp[k] for sp in slices],  # noqa: E731
                                    dtype=torch.int64, device=device)[:, None]
    off_a, sy_a, sx_a, r_a = col_of(0), col_of(2), col_of(3), col_of(4)
    isb_a = col_of(5).bool()
    v_a = torch.where(off_a == 0, 27.0, -1.0)
    vals = torch.empty((n_tiles, S, sub, LANES), dtype=store_dt,
                       device=device)
    counts = torch.empty(n_tiles * R, dtype=torch.int32, device=device)
    for t0 in range(0, n_tiles, block_tiles):
        nt = min(block_tiles, n_tiles - t0)
        i = torch.arange(t0 * R, (t0 + nt) * R, device=device)[None, :]
        ix = i % nx
        iy = (i // nx) % ny
        col = i + off_a
        m = ((i < nr)
             & (ix + sx_a >= 0) & (ix + sx_a < nx)
             & (iy + sy_a >= 0) & (iy + sy_a < ny)
             & (col >= 0) & (col < nr))                     # (S, rows)
        counts[t0 * R:(t0 + nt) * R] = (m & ~isb_a).sum(dim=0)
        wrap = (i % LANES) + r_a >= LANES
        sel = torch.where(isb_a, wrap, ~wrap)
        planes = torch.where(m & sel, v_a, 0.0).to(store_dt)
        vals[t0:t0 + nt] = planes.reshape(S, nt, sub, LANES).transpose(0, 1)
    return vals, counts


@register_format("bslab")
@dataclasses.dataclass
class BslabMatrix:
    meta_aff: torch.Tensor   # (n_tiles, s_aff, 2) int32 [dbase, r]
    vals_aff: torch.Tensor   # (n_tiles, s_aff, sub, 128) value dtype
    meta_gen: torch.Tensor   # (n_tiles, s_gen, 1) int32 dbase
    vals_gen: torch.Tensor   # (n_tiles, s_gen, sub, 128)
    lidx_gen: torch.Tensor   # (n_tiles, s_gen, sub, 128) int8
    meta_wide: torch.Tensor  # (n_tiles, s_wide, 1) int32 dbase at dblk == 0
    vals_wide: torch.Tensor  # (n_tiles, s_wide, sub, 128)
    lidx_wide: torch.Tensor  # (n_tiles, s_wide, sub, 128) int8
    dblk_wide: torch.Tensor  # (n_tiles, s_wide, sub, 128) int8 < wide_k
    wchunk: torch.Tensor     # (n_tiles,) int32 covering-chunk index
    nr: int
    nc: int
    nnz: int
    n_tiles: int
    s_aff: int
    s_gen: int
    s_wide: int
    wide_k: int              # range of dblk
    sub: int                 # slice height in lane groups
    x_rows: int              # rows of the padded x
    w_blocks: int            # W of the window plan
    xw_rows: int             # rows of the windowed layout's padded x
    n_elems: int
    impl: str = "torch"      # "kernel" | "kernel_win" | "torch"
    start_row: int = 0
    total_nr: int = 0
    total_nnz: int = 0
    # per-group wide slice counts (sum s_wide) of span-limited pools, each
    # group's slices sharing one anchor; () for one pool or none
    wide_groups: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.vals_aff.device

    @property
    def lead(self) -> int:
        return self.sub

    @property
    def slices(self) -> Slices:
        return Slices(self.meta_aff, self.vals_aff, self.meta_gen,
                      self.vals_gen, self.lidx_gen, self.meta_wide,
                      self.vals_wide, self.lidx_wide, self.dblk_wide)

    # ------------------------------------------------------- constructors
    @classmethod
    def from_csr(
        cls,
        csr: HostCSR,
        policy: Optional[DTypePolicy] = None,
        *,
        device: Device,
        impl: str = "auto",
        compress: bool = True,
        sub: int = 0,
        min_s_aff: int = 0,
        min_s_gen: int = 0,
    ) -> "BslabMatrix":
        """The slab layout of a host CSR matrix; f32 values are stored as
        bf16 when every value round-trips exactly. ``min_s_aff`` and
        ``min_s_gen`` pad the slice classes with zero slices."""
        policy = default_policy(policy)
        device = torch.device(device)
        sub = _auto_sub(csr.nr, sub)
        (meta_aff, vals_aff, meta_gen, vals_gen, lidx_gen, wchunk, n_tiles,
         s_aff, s_gen, x_rows, w_blocks, xw_rows) = _build_arrays(
            csr, policy.host_value, sub)
        va = torch.from_numpy(vals_aff).to(policy.value)
        vg = torch.from_numpy(vals_gen).to(policy.value)
        if compress and va.dtype == torch.float32:
            bf = [a.to(torch.bfloat16) for a in (va, vg)]
            if all(torch.equal(b.to(torch.float32), a)
                   for a, b in zip((va, vg), bf)):
                va, vg = bf
        if min_s_aff > s_aff:
            pad = min_s_aff - s_aff
            va = torch.cat([va, va.new_zeros((n_tiles, pad, sub, LANES))], 1)
            m = np.zeros((n_tiles, pad, 2), np.int32)
            m[:, :, 0] = meta_aff[:, :1, 0]
            meta_aff = np.concatenate([meta_aff, m], axis=1)
            s_aff = min_s_aff
        if min_s_gen > s_gen:
            pad = min_s_gen - s_gen
            vg = torch.cat([vg, vg.new_zeros((n_tiles, pad, sub, LANES))], 1)
            lidx_gen = np.pad(lidx_gen, ((0, 0), (0, pad), (0, 0), (0, 0)))
            m = np.zeros((n_tiles, pad, 1), np.int32)
            m[:, :, 0] = meta_aff[:, :1, 0]
            meta_gen = np.concatenate([meta_gen, m], axis=1)
            s_gen = min_s_gen
        obj = cls(
            meta_aff=torch.from_numpy(meta_aff).to(device),
            vals_aff=va.to(device),
            meta_gen=torch.from_numpy(meta_gen).to(device),
            vals_gen=vg.to(device),
            lidx_gen=torch.from_numpy(lidx_gen).to(device),
            **empty_wide(n_tiles, sub, va.dtype, device),
            wchunk=torch.from_numpy(wchunk).to(device),
            nr=csr.nr, nc=csr.nc, nnz=csr.nnz,
            n_tiles=n_tiles, s_aff=s_aff, s_gen=s_gen, s_wide=0, wide_k=1,
            sub=sub, x_rows=x_rows, w_blocks=w_blocks, xw_rows=xw_rows,
            n_elems=n_tiles * (s_aff + s_gen) * sub * LANES,
            start_row=csr.start_row, total_nr=csr.total_nr,
            total_nnz=csr.total_nnz,
        )
        return obj.with_impl(impl)

    def with_impl(self, impl: str) -> "BslabMatrix":
        """This matrix with ``impl`` resolved (``resolve_impl``); every
        constructor ends here."""
        self.impl = resolve_impl(impl, self.device)
        return self

    @classmethod
    def from_stencil(
        cls,
        nx: int,
        ny: int,
        nz: int,
        *,
        device: Device,
        use_7pt: bool = False,
        policy: Optional[DTypePolicy] = None,
        impl: str = "auto",
        compress: bool = True,
        sub: int = 0,
    ) -> Tuple["BslabMatrix", np.ndarray]:
        """The 27/7-point stencil (reference src/matrix.c:30-121) built on
        ``device`` in slab layout: every slice is one part of one diagonal,
        all affine, no index planes. Single shard. Returns ``(matrix,
        row_counts)``."""
        policy = default_policy(policy)
        device = torch.device(device)
        nr = nx * ny * nz
        # sub 128 at benchmark scale (2M rows and up), 64 below it: the
        # JAX package's choice, kept so the two layouts are equal
        sub = _auto_sub(nr, sub, default=128 if nr >= 2_000_000 else 64)
        lead = sub
        plane = nx * ny
        specs = sorted(
            (sz * plane + sy * nx + sx, sz, sy, sx)
            for (sz, sy, sx) in OFFSETS_27
            if not use_7pt or (sz * sz + sy * sy + sx * sx <= 1)
        )
        if len({sp[0] for sp in specs}) != len(specs):
            # degenerate tiny grids alias two shifts onto one diagonal:
            # take the general CSR path
            csr = generate_stencil(nx, ny, nz, use_7pt=use_7pt)
            obj = cls.from_csr(csr, policy, device=device, impl=impl,
                               compress=compress, sub=sub)
            return obj, csr.row_lengths

        # slice plan (off, sz, sy, sx, d, r, part): part B (1) where the
        # lane shift wraps into the next block
        slices = []
        for off, sz, sy, sx in specs:
            q, r = divmod(off, LANES)
            slices.append((off, sz, sy, sx, q, r, 0))
            if r != 0:
                slices.append((off, sz, sy, sx, q + 1, r, 1))
        s_aff = len(slices)
        n_tiles = max(1, -(-nr // (sub * LANES)))
        nb = max(1, -(-nr // LANES))
        x_rows = lead + nb + sub
        d_arr = np.asarray([sp[4] for sp in slices], np.int64)
        r_arr = np.asarray([sp[5] for sp in slices], np.int64)
        t_np = np.arange(n_tiles, dtype=np.int64)
        # a clipped dbase belongs to a slice whose values are all zero
        dbase = np.clip(sub * t_np[:, None] + d_arr[None, :] + lead, 0,
                        x_rows - sub)
        meta_aff = np.stack(
            [dbase, np.broadcast_to(r_arr[None, :], dbase.shape)], axis=2
        ).astype(np.int32)
        w_blocks, wchunk, xw_rows = _window_plan(
            n_tiles, dbase.min(axis=1), dbase.max(axis=1), sub)

        if compress and policy.value == torch.float32:
            store_dt = torch.bfloat16  # exact for 27 and -1
        else:
            store_dt = policy.value
        vals_aff, counts = _stencil_vals(
            tuple((sp[0], sp[1], sp[2], sp[3], sp[5], sp[6]) for sp in slices),
            nx, ny, nr, n_tiles, sub, store_dt, device)
        counts = counts[:nr].cpu().numpy()
        nnz = int(counts.sum())
        obj = cls(
            meta_aff=torch.from_numpy(meta_aff).to(device),
            vals_aff=vals_aff,
            meta_gen=torch.zeros((n_tiles, 0, 1), dtype=torch.int32,
                                 device=device),
            vals_gen=torch.zeros((n_tiles, 0, sub, LANES), dtype=store_dt,
                                 device=device),
            lidx_gen=torch.zeros((n_tiles, 0, sub, LANES), dtype=torch.int8,
                                 device=device),
            **empty_wide(n_tiles, sub, store_dt, device),
            wchunk=torch.from_numpy(wchunk).to(device),
            nr=nr, nc=nr, nnz=nnz,
            n_tiles=n_tiles, s_aff=s_aff, s_gen=0, s_wide=0, wide_k=1,
            sub=sub, x_rows=x_rows, w_blocks=w_blocks, xw_rows=xw_rows,
            n_elems=n_tiles * s_aff * sub * LANES,
            start_row=0, total_nr=nr, total_nnz=nnz,
        )
        return obj.with_impl(impl), counts

    # ---------------------------------------------------------------- spmv
    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x for a length-nc x on this matrix's device, in x's dtype
        (bf16 x is widened to f32 for the sum and the result narrowed)."""
        out_dtype = x.dtype
        x = x.to(compute_dtype(out_dtype))
        if self.impl == "kernel":
            y3 = bslab_spmv(self.slices, x, sub=self.sub, lead=self.lead)
        elif self.impl == "kernel_win":
            y3 = bslab_spmv_win(self.wchunk, self.slices, x, sub=self.sub,
                                lead=self.lead, w_blocks=self.w_blocks)
        else:
            y3 = bslab_spmv_torch(self.slices, x, sub=self.sub,
                                  lead=self.lead, x_rows=self.x_rows)
        return y3.reshape(-1)[:self.nr].to(out_dtype)

    # ------------------------------------------------------------ protocol
    @property
    def permuted_output(self) -> bool:
        return False

    def permute_vector(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def unpermute_vector(self, v: torch.Tensor) -> torch.Tensor:
        return v

    @property
    def padding_ratio(self) -> float:
        return self.n_elems / max(self.nnz, 1)
