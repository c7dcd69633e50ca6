"""SELL-C-sigma and ELLPACK device formats (counterpart of
sparsebench_tpu/formats/sell.py).

SELL-C-sigma (reference src/matrix-SCS.c, golden-specced by
formats/scs_host.py): rows are stably sorted by descending length within
sigma windows and grouped into chunks of C rows, each padded to its longest
row. Runs of chunks whose padded length (rounded up to a multiple of 4) is
equal form one dense block stored transposed, ``val_t, col_t`` of shape
(L_b, rows_b), so the SpMV is per block ``sum_j val_t[j] * x[col_t[j]]``: a
gather and a sum, in permuted row order. Columns are stored in permuted
index space, so a whole CG solve can stay permuted (``permuted_output``,
``permute_vector``, ``unpermute_vector``; solvers/cg.py applies them, which
the reference's CG never does). Defaults: C = 32, sigma = nr.

The execution bridge: on CUDA (``bridge="auto"``, or ``bridge=True`` on any
device) ``spmv`` runs through a ``fast`` BslabMatrix built from the same CSR
in the original row order, the bslab kernels K6/K7, as the JAX package does
on the TPU; ``permuted_output`` is then False and the SELL arrays stay for
the layout and its reports. On the CPU the permuted gather path runs.

ELLPACK is one dense (Lmax, nr_padded) transposed block with no row
permutation (SELL with C = nr and sigma = 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.base import default_policy, round_up
from sparsebench_tpu_torch.formats.registry import register_format
from sparsebench_tpu_torch.formats.scs_host import (
    inverse_restricted,
    sigma_sort,
)
from sparsebench_tpu_torch.host import HostCSR

_DEFAULT_C = 32
_LEN_QUANT = 4  # chunk lengths round up to a multiple of this

Device = Union[str, torch.device]


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for an int32 or int64 index tensor of any shape."""
    return torch.index_select(x, 0, idx.reshape(-1)).reshape(idx.shape)


@register_format("sell")
@dataclasses.dataclass
class SellMatrix:
    vals: Tuple[torch.Tensor, ...]  # each (L_b, rows_b), value dtype
    cols: Tuple[torch.Tensor, ...]  # each (L_b, rows_b), index dtype
    old_to_new: torch.Tensor        # (nr,) index dtype
    new_to_old: torch.Tensor        # (nr,)
    nr: int
    nc: int
    nnz: int
    C: int
    sigma: int
    nr_padded: int
    n_elems: int                    # stored elements, padding included
    start_row: int = 0
    total_nr: int = 0
    total_nnz: int = 0
    fast: object = None             # BslabMatrix execution delegate

    @property
    def device(self) -> torch.device:
        return self.old_to_new.device

    @property
    def impl(self) -> str:
        return self.fast.impl if self.fast is not None else "torch"

    @classmethod
    def from_csr(
        cls,
        csr: HostCSR,
        policy: Optional[DTypePolicy] = None,
        *,
        device: Device,
        C: int = 0,
        sigma: int = 0,
        len_quant: int = _LEN_QUANT,
        bridge: Union[str, bool] = "auto",
        impl: str = "auto",
    ) -> "SellMatrix":
        """SELL-C-sigma of a host CSR matrix (C = 0 and sigma = 0 take the
        defaults). ``impl`` is the bslab delegate's, where there is one."""
        policy = default_policy(policy)
        device = torch.device(device)
        nr, nc = csr.nr, csr.nc
        C = C if C >= 1 else _DEFAULT_C
        sigma = sigma if sigma >= 1 else max(nr, 1)
        n_chunks = max(1, -(-nr // C))
        nr_padded = n_chunks * C

        counts = np.zeros(nr_padded, dtype=np.int64)
        counts[:nr] = csr.row_lengths
        new_to_old_pad = sigma_sort(counts, sigma)
        old_to_new_pad = np.empty(nr_padded, dtype=np.int64)
        old_to_new_pad[new_to_old_pad] = np.arange(nr_padded, dtype=np.int64)
        chunk_lens = counts[new_to_old_pad].reshape(n_chunks, C).max(axis=1)
        chunk_lens_q = np.maximum(len_quant,
                                  -(-chunk_lens // len_quant) * len_quant)

        # blocks: runs of consecutive chunks with equal quantised length
        change = np.flatnonzero(np.diff(chunk_lens_q)) + 1
        starts = np.concatenate([[0], change, [n_chunks]])
        b_row0 = starts[:-1] * C
        rows_b = starts[1:] * C - b_row0
        b_len = chunk_lens_q[starts[:-1]]

        # columns in permuted space (halo columns >= nr unchanged)
        col = csr.col
        col_perm = np.where(col < nr,
                            old_to_new_pad[np.minimum(col, nr - 1)], col)
        # entry -> block b, then (j_in_row, row_new - b_row0[b]) in it
        rows_old = np.repeat(np.arange(nr, dtype=np.int64), csr.row_lengths)
        j_in_row = np.arange(csr.nnz, dtype=np.int64) - csr.row_ptr[rows_old]
        rows_new = old_to_new_pad[rows_old]
        b_of = np.searchsorted(b_row0, rows_new, side="right") - 1
        sizes = b_len * rows_b
        flat0 = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=flat0[1:])
        dest = flat0[b_of] + j_in_row * rows_b[b_of] + (rows_new - b_row0[b_of])
        flat_val = np.zeros(int(flat0[-1]), dtype=policy.host_value)
        flat_col = np.zeros(int(flat0[-1]), dtype=np.int64)
        flat_val[dest] = csr.val
        flat_col[dest] = col_perm
        vals = torch.from_numpy(flat_val).to(device=device, dtype=policy.value)
        cols = torch.from_numpy(flat_col).to(device=device, dtype=policy.index)
        shapes = [(int(b_len[b]), int(rows_b[b])) for b in range(len(sizes))]
        split = [h * w for h, w in shapes]

        fast = None
        if bridge is True or (bridge == "auto" and device.type == "cuda"):
            from sparsebench_tpu_torch.formats.bslab import BslabMatrix

            fast = BslabMatrix.from_csr(csr, policy, device=device, impl=impl)

        idx = lambda a: torch.from_numpy(a).to(  # noqa: E731
            device=device, dtype=policy.index)
        return cls(
            vals=tuple(v.reshape(s) for v, s in zip(vals.split(split), shapes)),
            cols=tuple(c.reshape(s) for c, s in zip(cols.split(split), shapes)),
            old_to_new=idx(old_to_new_pad[:nr]),
            new_to_old=idx(inverse_restricted(old_to_new_pad, nr)),
            nr=nr, nc=nc, nnz=csr.nnz, C=C, sigma=sigma,
            nr_padded=nr_padded, n_elems=int(flat0[-1]),
            start_row=csr.start_row, total_nr=csr.total_nr,
            total_nnz=csr.total_nnz, fast=fast,
        )

    def spmv_permuted(self, xp: torch.Tensor) -> torch.Tensor:
        """y_perm = A_perm xp: ``xp`` and the length-nr result in permuted
        row order."""
        parts = [(val_t * gather(xp, col_t).to(val_t.dtype)).sum(dim=0)
                 for val_t, col_t in zip(self.vals, self.cols)]
        return torch.cat(parts)[:self.nr]

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """Original-row-order SpMV: the bslab delegate when bridged, else
        permute in, compute, unpermute out."""
        if self.fast is not None:
            return self.fast.spmv(x)
        return gather(self.spmv_permuted(self.permute_vector(x)),
                      self.old_to_new)

    @property
    def permuted_output(self) -> bool:
        return self.fast is None  # bridged matrices solve in original order

    def permute_vector(self, v: torch.Tensor) -> torch.Tensor:
        """Original order -> permuted order (first nr entries; tail kept)."""
        head = gather(v, self.new_to_old)
        return head if v.shape[0] == self.nr else torch.cat(
            [head, v[self.nr:]])

    def unpermute_vector(self, vp: torch.Tensor) -> torch.Tensor:
        head = gather(vp, self.old_to_new)
        return head if vp.shape[0] == self.nr else torch.cat(
            [head, vp[self.nr:]])


@register_format("ell")
@dataclasses.dataclass
class EllMatrix:
    """Padded ELLPACK: one dense (Lmax, nr_padded) transposed block, no row
    permutation."""

    val_t: torch.Tensor  # (Lmax, nr_padded)
    col_t: torch.Tensor  # (Lmax, nr_padded)
    nr: int
    nc: int
    nnz: int
    n_elems: int
    start_row: int = 0
    total_nr: int = 0
    total_nnz: int = 0
    impl = "torch"

    @property
    def device(self) -> torch.device:
        return self.val_t.device

    @classmethod
    def from_csr(cls, csr: HostCSR, policy: Optional[DTypePolicy] = None, *,
                 device: Device, lmax: int = 0) -> "EllMatrix":
        policy = default_policy(policy)
        nr = csr.nr
        nr_p = max(128, round_up(nr, 128))
        lens = csr.row_lengths
        actual_lmax = int(lens.max()) if nr and csr.nnz else 1
        if lmax and lmax < actual_lmax:
            raise ValueError(
                f"forced lmax {lmax} < actual max row length {actual_lmax}")
        lmax = lmax or actual_lmax
        val_t = np.zeros((lmax, nr_p), dtype=policy.host_value)
        col_t = np.zeros((lmax, nr_p), dtype=np.int64)
        rows = np.repeat(np.arange(nr, dtype=np.int64), lens)
        j_in_row = np.arange(csr.nnz, dtype=np.int64) - csr.row_ptr[rows]
        val_t[j_in_row, rows] = csr.val
        col_t[j_in_row, rows] = csr.col
        return cls(
            val_t=torch.from_numpy(val_t).to(device=device,
                                             dtype=policy.value),
            col_t=torch.from_numpy(col_t).to(device=device,
                                             dtype=policy.index),
            nr=nr, nc=csr.nc, nnz=csr.nnz, n_elems=lmax * nr_p,
            start_row=csr.start_row, total_nr=csr.total_nr,
            total_nnz=csr.total_nnz,
        )

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        g = gather(x, self.col_t).to(self.val_t.dtype)
        return (self.val_t * g).sum(dim=0)[:self.nr]

    @property
    def permuted_output(self) -> bool:
        return False

    def permute_vector(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def unpermute_vector(self, v: torch.Tensor) -> torch.Tensor:
        return v
