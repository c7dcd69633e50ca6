"""BSELL — block-column SELL (counterpart of sparsebench_tpu/formats/bsell.py).

Rows group 128 to a lane group and 8 lane groups to a tile of 1024 rows.
Each row's entries bucket by 128-wide column block; per (lane group, block)
the rows pad to the longest per-row count, giving "slices": (8, 128) planes
of one tile whose entries in sublane s share one block of x, stored as a
block id per sublane and an int8 lane index per entry. No row permutation
is involved: padding follows column locality, not row lengths. Block ids
are stored relative to the tile's window base ``win_base`` = ``wchunk`` W,
where W (``w_blocks``) covers the widest tile span, so every id lies in
[0, 2W) and the windowed kernels read x rows [wchunk W, wchunk W + 2W).

The host build (``_build_arrays``) is a numpy copy of the JAX package's and
the stencil build (``_stencil_bsell_device``) the same iota arithmetic as
torch ops on the device, so the arrays come out equal element for element;
ops/bsell_spmv.py says what the SpMV computes from them. The JAX package's
native C++ build (host/native.py) gives the same arrays as its numpy one and
is not ported.

``impl`` picks the SpMV: ``kernel`` (K9, x through the caches),
``kernel_win2`` (K10) or ``kernel_win`` (K11), both persistent units that
keep the tiles' windows of x in a ring of chunks in shared memory, or
``torch`` (their plain version). ``auto`` is ``kernel`` on CUDA at every
shape and ``torch`` on the CPU (``resolve_impl`` says why). K10 and K11 run
every window up to a unit of 8
blocks that each hold a stripe of it (200^3 in units of 4, f64 7;
``ops/bsell_spmv.py win_plan`` says how many, PERF.md §6 has their times).
A kernel on the CPU raises, a windowed kernel whose window exceeds 8 blocks
raises at the first SpMV, naming the size, and the build's check of K9
against the host row sums raises on a mismatch: no path falls back to
another.
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
from sparsebench_tpu_torch.ops.bsell_spmv import (
    LANES,
    SUBLANES,
    TILE_ROWS,
    bsell_spmv,
    bsell_spmv_torch,
    bsell_spmv_win2,
    bsell_spmv_windowed,
)
from sparsebench_tpu_torch.ops.stencil import compute_dtype

VALID_IMPLS = ("auto", "torch", "kernel", "kernel_win2", "kernel_win")

Device = Union[str, torch.device]


def resolve_impl(impl: str, device: torch.device) -> str:
    """``auto`` -> ``kernel`` (K9) on CUDA, ``torch`` on the CPU; the
    kernels exist only on CUDA.

    The JAX package's ``auto`` takes its windowed kernel where x exceeds
    its VMEM budget. Here K9, which gathers x through L1/L2, ran faster
    than K10 at every size measured in one call, on an H100 at 700 W:
    1.19x at 100^3 (x 4 MB, W 168), 1.10x at 200^3 (32 MB, W 640) and 1.24x
    at 300^3, whose 108 MB x exceeds the 50 MB L2 (PERF.md §6). So ``auto``
    picks K9 at every shape and dtype, and K10/K11 run when asked for."""
    if impl not in VALID_IMPLS:
        raise ValueError(
            f"unknown bsell impl {impl!r}; valid: {', '.join(VALID_IMPLS)}")
    if device.type != "cuda":
        if impl not in ("auto", "torch"):
            raise ValueError(
                f"impl {impl!r} is a CUDA kernel and the device is {device}; "
                "use impl 'torch' (the plain version) on the CPU")
        return "torch"
    return "kernel" if impl == "auto" else impl


def _build_arrays(csr: HostCSR, host_dt: np.dtype):
    """Vectorised host construction (numpy) of the slice arrays, in
    ``host_dt`` values (numpy has no bf16: bf16 is narrowed with torch).
    Returns (vals, lidx int32, blocks, win_base, wchunk, n_tiles, s_max,
    nc_pad, w_blocks, xw_rows)."""
    nr, nc = csr.nr, csr.nc
    n_tiles = max(1, -(-nr // TILE_ROWS))
    nc_pad = max(LANES, round_up(nc, LANES))
    nb = nc_pad // LANES

    lens = csr.row_lengths
    rows = np.repeat(np.arange(nr, dtype=np.int64), lens)
    col = csr.col
    group = rows // LANES
    lane = rows % LANES
    block = col // LANES
    lidx = col % LANES

    nnz = csr.nnz
    if nnz == 0:
        vals = np.zeros((n_tiles, 1, SUBLANES, LANES), dtype=host_dt)
        lidx_arr = np.zeros((n_tiles, 1, SUBLANES, LANES), dtype=np.int32)
        blocks = np.zeros((n_tiles, 1, SUBLANES), dtype=np.int32)
        win_base = np.zeros((n_tiles, 1, 8), dtype=np.int32)
        wchunk = np.zeros(n_tiles, dtype=np.int32)
        return (vals, lidx_arr, blocks, win_base, wchunk, n_tiles, 1, nc_pad,
                8, 16)

    # occurrence index j within each (row, block) run: entries are sorted
    # by (row, col), so (row, block) runs are contiguous
    key_rb = rows * nb + block
    is_new = np.empty(nnz, dtype=bool)
    is_new[0] = True
    is_new[1:] = key_rb[1:] != key_rb[:-1]
    run_start = np.flatnonzero(is_new)
    run_id = np.cumsum(is_new) - 1
    j = np.arange(nnz, dtype=np.int64) - run_start[run_id]

    # per (group, block): the longest run over the group's rows
    run_len = np.diff(np.append(run_start, nnz))
    key_gb_run = group[run_start] * nb + block[run_start]
    order = np.argsort(key_gb_run, kind="stable")
    kg_sorted = key_gb_run[order]
    len_sorted = run_len[order]
    gb_new = np.empty(kg_sorted.size, dtype=bool)
    gb_new[0] = True
    gb_new[1:] = kg_sorted[1:] != kg_sorted[:-1]
    gb_starts = np.flatnonzero(gb_new)
    gb_keys = kg_sorted[gb_starts]              # ascending (group, block)
    lmax_gb = np.maximum.reduceat(len_sorted, gb_starts)

    gb_group = gb_keys // nb
    gb_block = (gb_keys % nb).astype(np.int32)
    # slice offset of each (group, block): exclusive cumsum of lmax within
    # its group (ascending keys: each group's entries are contiguous)
    csum = np.cumsum(lmax_gb)
    grp_new = np.empty(gb_group.size, dtype=bool)
    grp_new[0] = True
    grp_new[1:] = gb_group[1:] != gb_group[:-1]
    grp_first = np.flatnonzero(grp_new)
    base_before_group = np.zeros(gb_group.size, dtype=np.int64)
    base_before_group[grp_first[1:]] = csum[grp_first[1:] - 1]
    base_before_group = np.maximum.accumulate(base_before_group)
    offset_gb = csum - lmax_gb - base_before_group

    s_per_group = np.zeros(n_tiles * SUBLANES, dtype=np.int64)
    grp_last = np.append(grp_first[1:] - 1, gb_group.size - 1)
    grp_sizes = csum[grp_last] - np.where(grp_first > 0,
                                          csum[grp_first - 1], 0)
    s_per_group[gb_group[grp_first]] = grp_sizes
    s_max = int(s_per_group.max())

    # entry -> slice
    key_gb_entry = group * nb + block
    gb_pos = np.searchsorted(gb_keys, key_gb_entry)
    slice_of = offset_gb[gb_pos] + j

    t = group // SUBLANES
    s = group % SUBLANES

    vals = np.zeros((n_tiles, s_max, SUBLANES, LANES), dtype=host_dt)
    lidx_arr = np.zeros((n_tiles, s_max, SUBLANES, LANES), dtype=np.int32)
    vals[t, slice_of, s, lane] = csr.val.astype(host_dt)
    lidx_arr[t, slice_of, s, lane] = lidx.astype(np.int32)
    # per-tile x window [min block, max block] over the tile's slices. The
    # windowed kernels view x as chunks of W = round_up(max span, 8) block
    # rows; tile t's span then lies in chunks wchunk[t], wchunk[t] + 1
    # (wchunk W <= min < wchunk W + W and hi < min + W). Block ids are
    # stored relative to wchunk W, so they lie in [0, 2W); padding slices
    # stay at 0 (they gather x * 0).
    gb_tile = gb_group // SUBLANES
    win_lo = np.full(n_tiles, nb, dtype=np.int64)
    win_hi = np.zeros(n_tiles, dtype=np.int64)
    np.minimum.at(win_lo, gb_tile, gb_block)
    np.maximum.at(win_hi, gb_tile, gb_block)
    win_lo = np.minimum(win_lo, win_hi)  # empty tiles -> 0
    w_blocks = int(round_up(max(1, int((win_hi - win_lo).max() + 1)), 8))
    wchunk = win_lo // w_blocks
    base_blocks = wchunk * w_blocks
    # x rows the windowed kernels address: chunks [0, max wchunk + 2)
    xw_rows = int(wchunk.max() + 2) * w_blocks

    blocks = np.zeros((n_tiles, s_max, SUBLANES), dtype=np.int64)
    # fill the block table: (group, block) occupies slices
    # [offset_gb, offset_gb + lmax)
    rep = np.repeat(np.arange(gb_keys.size), lmax_gb)
    total = int(lmax_gb.sum())
    run_starts = np.cumsum(lmax_gb) - lmax_gb
    within = np.arange(total, dtype=np.int64) - np.repeat(run_starts, lmax_gb)
    slice_ids = np.repeat(offset_gb, lmax_gb) + within
    bt = gb_group[rep] // SUBLANES
    bs = gb_group[rep] % SUBLANES
    blocks[bt, slice_ids, bs] = gb_block[rep] - base_blocks[bt]
    return (vals, lidx_arr, blocks.astype(np.int32),
            np.broadcast_to(
                base_blocks.astype(np.int32)[:, None, None], (n_tiles, 1, 8)
            ).copy(),
            wchunk.astype(np.int32),
            n_tiles, s_max, nc_pad, w_blocks, xw_rows)


def _stencil_bsell_device(slices, nx: int, ny: int, local_nrow: int,
                          n_tiles: int, w_blocks: int, nb: int,
                          store_dt: torch.dtype, base_blocks: torch.Tensor):
    """The 27/7-point stencil's slice arrays built on ``base_blocks``'s
    device with torch ops (the JAX package's ``_stencil_bsell_device``).

    The stencil's entries lie on its diagonals. For the rows of one lane
    group (i = 128 g + l) and diagonal offset o = 128 q + r, the columns
    i + o = 128 (g + q) + (l + r) fall in block g + q for lanes
    l < 128 - r and in block g + q + 1 for the rest, so each diagonal
    gives at most two lane-complementary slices a group ("A" and "B"),
    with one lane index (l + r) mod 128 a slice and block ids linear in g.
    Iota arithmetic and masks, no scatter. Returns (vals, lidx, blocks,
    counts)."""
    device = base_blocks.device
    nr_pad = n_tiles * TILE_ROWS
    i = torch.arange(nr_pad, dtype=torch.int64, device=device)
    ix = i % nx
    iy = (i // nx) % ny
    valid = i < local_nrow
    lane = i % LANES
    counts = torch.zeros(nr_pad, dtype=torch.int32, device=device)
    vals = torch.empty((n_tiles, len(slices), SUBLANES, LANES),
                       dtype=store_dt, device=device)
    for k, (off, _sz, sy, sx, _q, r, is_b) in enumerate(slices):
        col = i + off
        m = (valid
             & (ix + sx >= 0) & (ix + sx < nx)
             & (iy + sy >= 0) & (iy + sy < ny)
             & (col >= 0) & (col < local_nrow))
        if not is_b:
            counts += m
        sel = (lane + r >= LANES) if is_b else (lane + r < LANES)
        v = 27.0 if off == 0 else -1.0
        vals[:, k] = torch.where(m & sel, v, 0.0).to(store_dt).reshape(
            n_tiles, SUBLANES, LANES)

    r_arr = torch.tensor([sp[5] for sp in slices], dtype=torch.int64,
                         device=device)
    lvec = (torch.arange(LANES, device=device)[None, :] + r_arr[:, None]) \
        % LANES
    lidx = lvec.to(torch.int8)[None, :, None, :].expand(
        n_tiles, len(slices), SUBLANES, LANES).contiguous()

    t_idx = torch.arange(n_tiles, dtype=torch.int64, device=device)
    qoff = torch.tensor([sp[4] + sp[6] for sp in slices], dtype=torch.int64,
                        device=device)
    abs_blocks = (SUBLANES * t_idx[:, None, None]
                  + torch.arange(SUBLANES, device=device)[None, None, :]
                  + qoff[None, :, None])
    rel = abs_blocks.clamp(0, nb - 1) - base_blocks.long()[:, None, None]
    blocks = rel.clamp(0, 2 * w_blocks - 1).to(torch.int32)
    return vals, lidx, blocks, counts


@register_format("bsell")
@dataclasses.dataclass
class BsellMatrix:
    vals: torch.Tensor      # (n_tiles, s_max, 8, 128) value dtype
    lidx: torch.Tensor      # (n_tiles, s_max, 8, 128) int8 lane indices
    blocks: torch.Tensor    # (n_tiles, s_max, 8) int32, relative to win_base
    win_base: torch.Tensor  # (n_tiles, 1, 8) int32 window base (replicated)
    wchunk: torch.Tensor    # (n_tiles,) int32 x chunk (win_base / w_blocks)
    nr: int
    nc: int
    nnz: int
    n_tiles: int
    s_max: int
    nc_pad: int
    w_blocks: int           # W: the x chunk in 128-lane block rows
    xw_rows: int            # rows of the windowed kernels' x
    n_elems: int
    impl: str = "torch"     # "kernel" | "kernel_win2" | "kernel_win" | "torch"
    start_row: int = 0
    total_nr: int = 0
    total_nnz: int = 0

    @property
    def device(self) -> torch.device:
        return self.vals.device

    # ------------------------------------------------------- constructors
    @classmethod
    def from_csr(
        cls,
        csr: HostCSR,
        policy: Optional[DTypePolicy] = None,
        *,
        device: Device,
        impl: str = "auto",
        min_s_max: int = 0,
        compress: bool = True,
    ) -> "BsellMatrix":
        """The BSELL layout of a host CSR matrix; f32 values are stored as
        bf16 when every value round-trips exactly, lane indices as int8.
        ``min_s_max`` pads the slice axis with zero slices."""
        policy = default_policy(policy)
        device = torch.device(device)
        resolve_impl(impl, device)  # refuse a bad impl before the build
        (vals, lidx, blocks, win_base, wchunk, n_tiles, s_max, nc_pad,
         w_blocks, xw_rows) = _build_arrays(csr, policy.host_value)
        v = torch.from_numpy(vals).to(policy.value)
        if compress and v.dtype == torch.float32 and csr.nnz:
            # lossless bf16 compression, decided as the JAX package's
            # default f32 build decides it: a matrix with entries whose
            # values all round-trip
            bf = v.to(torch.bfloat16)
            if torch.equal(bf.to(torch.float32), v):
                v = bf
        # lane indices are < 128: int8 storage cuts index traffic 4x
        li = torch.from_numpy(lidx.astype(np.int8))
        bl = torch.from_numpy(blocks)
        if min_s_max > s_max:
            pad = min_s_max - s_max
            v = torch.cat([v, v.new_zeros((n_tiles, pad, SUBLANES, LANES))], 1)
            li = torch.cat([li, li.new_zeros((n_tiles, pad, SUBLANES,
                                              LANES))], 1)
            bl = torch.cat([bl, bl.new_zeros((n_tiles, pad, SUBLANES))], 1)
            s_max = min_s_max
        obj = cls(
            vals=v.to(device), lidx=li.to(device), blocks=bl.to(device),
            win_base=torch.from_numpy(win_base).to(device),
            wchunk=torch.from_numpy(wchunk).to(device),
            nr=csr.nr, nc=csr.nc, nnz=csr.nnz, n_tiles=n_tiles, s_max=s_max,
            nc_pad=nc_pad, w_blocks=w_blocks, xw_rows=xw_rows,
            n_elems=n_tiles * s_max * SUBLANES * LANES,
            start_row=csr.start_row, total_nr=csr.total_nr,
            total_nnz=csr.total_nnz,
        ).with_impl(impl)
        if impl == "auto" and obj.impl == "kernel":
            _self_check(obj, csr)
        return obj

    def with_impl(self, impl: str) -> "BsellMatrix":
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
    ) -> Tuple["BsellMatrix", np.ndarray]:
        """The 27/7-point stencil (reference src/matrix.c:30-121) built on
        ``device`` in BSELL layout (``_stencil_bsell_device``): one slice
        for each diagonal and a second where its lane shift wraps. Single
        shard. Returns ``(matrix, row_counts)``."""
        policy = default_policy(policy)
        device = torch.device(device)
        resolve_impl(impl, device)
        nr = nx * ny * nz
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
                               compress=compress)
            return obj, csr.row_lengths

        # slice plan: an A slice always, a B slice where the lane shift wraps
        slices = []
        for off, sz, sy, sx in specs:
            q, r = divmod(off, LANES)
            slices.append((off, sz, sy, sx, q, r, 0))
            if r != 0:
                slices.append((off, sz, sy, sx, q, r, 1))
        s_max = len(slices)
        q_min = min(sp[4] for sp in slices if not sp[6])
        q_max_eff = max(sp[4] + sp[6] for sp in slices)
        n_tiles = max(1, -(-nr // TILE_ROWS))
        nc_pad = max(LANES, round_up(nr, LANES))
        nb = nc_pad // LANES
        w_blocks = round_up(SUBLANES + q_max_eff - q_min, 8)
        t_np = np.arange(n_tiles, dtype=np.int64)
        wchunk = np.maximum(SUBLANES * t_np + q_min, 0) // w_blocks
        base_blocks = (wchunk * w_blocks).astype(np.int32)
        xw_rows = int(wchunk.max() + 2) * w_blocks

        if compress and policy.value == torch.float32:
            store_dt = torch.bfloat16  # exact for 27 and -1
        else:
            store_dt = policy.value
        base_t = torch.from_numpy(base_blocks).to(device)
        vals, lidx, blocks, counts = _stencil_bsell_device(
            slices, nx, ny, nr, n_tiles, w_blocks, nb, store_dt, base_t)
        counts = counts[:nr].cpu().numpy()
        nnz = int(counts.sum())
        obj = cls(
            vals=vals, lidx=lidx, blocks=blocks,
            win_base=base_t[:, None, None].expand(
                n_tiles, 1, SUBLANES).contiguous(),
            wchunk=torch.from_numpy(wchunk.astype(np.int32)).to(device),
            nr=nr, nc=nr, nnz=nnz, n_tiles=n_tiles, s_max=s_max,
            nc_pad=nc_pad, w_blocks=w_blocks, xw_rows=xw_rows,
            n_elems=n_tiles * s_max * SUBLANES * LANES,
            start_row=0, total_nr=nr, total_nnz=nnz,
        )
        return obj.with_impl(impl), counts

    # ---------------------------------------------------------------- spmv
    def padded_x(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """x cropped or zero-padded to ``rows`` rows of 128, as (rows, 128)."""
        need = rows * LANES
        if x.shape[0] >= need:
            return x[:need].reshape(rows, LANES)
        xp = torch.zeros(need, dtype=x.dtype, device=x.device)
        xp[:x.shape[0]] = x
        return xp.reshape(rows, LANES)

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x for a length-nc x on this matrix's device, in x's dtype
        (bf16 x is widened to f32 for the sum and the result narrowed)."""
        out_dtype = x.dtype
        x = x.to(compute_dtype(out_dtype))
        if self.impl in ("kernel_win2", "kernel_win"):
            call = (bsell_spmv_win2 if self.impl == "kernel_win2"
                    else bsell_spmv_windowed)
            y3 = call(self.wchunk, self.blocks,
                      self.padded_x(x, self.xw_rows), self.vals, self.lidx,
                      w_blocks=self.w_blocks)
        else:
            call = bsell_spmv if self.impl == "kernel" else bsell_spmv_torch
            y3 = call(self.blocks, self.win_base,
                      self.padded_x(x, self.nc_pad // LANES), self.vals,
                      self.lidx)
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
        """Stored slots / nnz: the format's padding overhead."""
        return self.n_elems / max(self.nnz, 1)


def with_window(A: BsellMatrix, w_blocks: int) -> BsellMatrix:
    """``A`` with its block table re-expressed for a forced chunk size W',
    so that shard builds of the distributed layer share one shape (the JAX
    package's ``with_window``; the bslab analog is bslab's).

    The build guarantees only that stored ids lie in [0, 2W), absolute ids
    in [win_base, win_base + 2W), with padding slices at 0. Re-anchoring
    tile t at base' = (win_base // W') W' keeps every id in [0, 2W') iff
    W' >= 2W - 8 (worst case: base' = win_base - (W' - 8), content up to
    win_base + 2W - 1). W' == W returns ``A`` itself."""
    if w_blocks == A.w_blocks:
        return A
    if w_blocks < 2 * A.w_blocks - 8 or w_blocks % 8:
        raise ValueError(
            f"forced w_blocks {w_blocks} cannot re-anchor a W={A.w_blocks} "
            f"window (need a multiple of 8 >= {2 * A.w_blocks - 8})"
        )
    win_base = A.win_base[:, 0, 0].long()
    wchunk_new = win_base // w_blocks
    shift = (win_base - wchunk_new * w_blocks).to(torch.int32)
    base_new = (wchunk_new * w_blocks).to(torch.int32)
    xw_rows = (int(wchunk_new.max()) + 2) * w_blocks
    return dataclasses.replace(
        A,
        blocks=A.blocks + shift[:, None, None],
        win_base=base_new[:, None, None].expand(
            A.n_tiles, 1, SUBLANES).contiguous(),
        wchunk=wchunk_new.to(torch.int32),
        w_blocks=w_blocks,
        xw_rows=xw_rows,
    )


def _self_check(A: BsellMatrix, csr: HostCSR) -> None:
    """One SpMV of ones through the kernel against the host row sums
    (A @ 1), at the build; raises RuntimeError on a mismatch (the JAX
    package swaps in its XLA path there; the port has none to swap in)."""
    want = np.zeros(csr.nr)
    np.add.at(want, np.repeat(np.arange(csr.nr), np.diff(csr.row_ptr)),
              csr.val.astype(np.float64))
    scale = np.abs(want).max() or 1.0
    xdt = torch.float64 if A.vals.dtype == torch.float64 else torch.float32
    y = A.spmv(torch.ones(A.nc, dtype=xdt, device=A.device)).cpu().numpy()
    err = np.abs(y - want).max() if y.size else 0.0
    if not (np.isfinite(y).all() and err <= 1e-2 * scale):
        raise RuntimeError(
            f"bsell: the {A.impl} SpMV of ones differs from the host row "
            f"sums by {err:.3e} (scale {scale:.3e}) at the build")
