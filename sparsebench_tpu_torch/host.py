"""Host-side (numpy) ingest: Matrix Market and .bmx files into a host CSR,
the stencil generator for grids too small for the on-device builds, the RGL
spec (the irregular benchmark matrix) and the RCM reordering.

Counterpart of sparsebench_tpu/host/ (csr.py, mmio.py, binfile.py,
generator.py, rgl.py, rcm.py), with the same rules (reference src/matrix.c,
src/matrixBinfile.c). It is a separate copy so that the port never imports
the JAX package, whose import runs its own allocator set-up
(sparsebench_tpu/__init__.py). tests/test_torch_host.py holds it against
the JAX package's readers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# (sz, sy, sx) in the reference generator's loop order (src/matrix.c:71-75).
OFFSETS_27 = [
    (sz, sy, sx)
    for sz in (-1, 0, 1)
    for sy in (-1, 0, 1)
    for sx in (-1, 0, 1)
]

_BMX_HEADER = b"# SparseBench DataFile"
_BMX_HEADER_SIZE = 24
_BMX_ENTRY = np.dtype([("col", "<u4"), ("val", "<f4")])


@dataclasses.dataclass
class HostCSR:
    """The reference's ``GMatrix`` (src/matrix.h:29-35) as arrays: rows
    ``start_row`` .. ``start_row + nr - 1`` of a ``total_nr``-row matrix,
    global column indices. ``model_total_nnz`` is the generator's allocated
    bound 27*nrow, which drives the reference's byte model; -1 means the
    actual count."""

    row_ptr: np.ndarray  # int64[nr+1]
    col: np.ndarray      # int64[nnz]
    val: np.ndarray      # float64[nnz]
    nr: int
    nc: int
    start_row: int = 0
    total_nr: int = -1
    total_nnz: int = -1
    model_total_nnz: int = -1

    def __post_init__(self) -> None:
        if self.total_nr < 0:
            self.total_nr = self.nr
        if self.total_nnz < 0:
            self.total_nnz = self.nnz

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def diagonal(self) -> np.ndarray:
        """diag(A) per local row (0 where absent); columns are global, so
        local row i's diagonal sits at column start_row + i."""
        rows = np.repeat(np.arange(self.nr, dtype=np.int64), self.row_lengths)
        d = np.zeros(self.nr, dtype=self.val.dtype)
        mask = self.col == rows + self.start_row
        d[rows[mask]] = self.val[mask]
        return d

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Host reference SpMV (the oracle of the device formats' tests)."""
        rows = np.repeat(np.arange(self.nr), self.row_lengths)
        y = np.zeros(self.nr, dtype=np.result_type(self.val, x))
        np.add.at(y, rows, self.val * x[self.col])
        return y


def _csr(row, col, val, nr, nc) -> HostCSR:
    """CSR of COO entries sorted by row, then column (src/matrix.c:219-269)."""
    order = np.lexsort((col, row))
    row_ptr = np.zeros(nr + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=nr), out=row_ptr[1:])
    return HostCSR(row_ptr=row_ptr, col=col[order], val=val[order], nr=nr,
                   nc=nc)


def read_mm(path: str) -> HostCSR:
    """A coordinate Matrix Market file (reference MMMatrixRead,
    src/matrix.c:123-229): real, integer or pattern (value 1) entries,
    general or symmetric (off-diagonal entries mirrored), 1-based indices."""
    with open(path, "r") as f:
        banner = f.readline().split()
        if len(banner) != 5 or banner[0] != "%%MatrixMarket":
            raise ValueError(f"{path}: not a Matrix Market file")
        obj, fmt, field, symmetry = (t.lower() for t in banner[1:])
        if obj != "matrix" or fmt != "coordinate":
            raise ValueError(f"{path}: matrix has to be sparse")
        if field not in ("real", "integer", "pattern"):
            raise ValueError(f"{path}: matrix has to be real or pattern")
        if symmetry not in ("general", "symmetric"):
            raise ValueError(f"{path}: matrix has to be symmetric or general")
        line = f.readline()
        while line and (line.startswith("%") or not line.strip()):
            line = f.readline()
        nr, nc, nz = (int(t) for t in line.split())
        toks = f.read().split()
    width = 2 if field == "pattern" else 3
    if len(toks) < nz * width:
        raise ValueError(f"{path}: expected {nz} entries of {width} tokens")
    flat = np.asarray(toks[: nz * width], dtype=np.float64).reshape(nz, width)
    row = flat[:, 0].astype(np.int64) - 1
    col = flat[:, 1].astype(np.int64) - 1
    val = np.ones(nz) if field == "pattern" else flat[:, 2].copy()
    if symmetry == "symmetric":
        off = row != col
        row, col, val = (np.concatenate([row, col[off]]),
                         np.concatenate([col, row[off]]),
                         np.concatenate([val, val[off]]))
    return _csr(row, col, val, nr, nc)


def read_bmx(path: str) -> HostCSR:
    """A whole binary matrix file (reference matrixBinRead,
    src/matrixBinfile.c:107-236): a 24-byte header, u32 totalNr and
    totalNnz, u32 rowPtr[totalNr+1], then {u32 col, f32 val} entries."""
    with open(path, "rb") as f:
        if not f.read(_BMX_HEADER_SIZE).startswith(_BMX_HEADER):
            raise ValueError(f"{path}: not a SparseBench .bmx file")
        nr, nnz = (int(v) for v in np.fromfile(f, dtype="<u4", count=2))
        row_ptr = np.fromfile(f, dtype="<u4", count=nr + 1).astype(np.int64)
        entries = np.fromfile(f, dtype=_BMX_ENTRY, count=nnz)
    return HostCSR(row_ptr=row_ptr, col=entries["col"].astype(np.int64),
                   val=entries["val"].astype(np.float64), nr=nr, nc=nr,
                   total_nnz=nnz)


def generate_stencil(nx: int, ny: int, nz: int, *, rank: int = 0,
                     size: int = 1, use_7pt: bool = False) -> HostCSR:
    """This rank's rows of the 27/7-point stencil matrix (reference
    src/matrix.c:30-121): ranks stack subgrids in z, x and y neighbours are
    bound-checked on the subgrid, z only on the global row range; 27 on the
    diagonal, -1 off it. One pass over all rows at once: the device builds
    take it only where the stencil shifts alias (nx or ny <= 2); the
    host-CSR formats (crs, ccrs, ell) take it at any size."""
    local_nrow = nx * ny * nz
    total_nrow = local_nrow * size
    start_row = local_nrow * rank
    shifts = [s for s in OFFSETS_27
              if not use_7pt or s[0] ** 2 + s[1] ** 2 + s[2] ** 2 <= 1]
    local = np.arange(local_nrow, dtype=np.int64)
    ix = local % nx
    iy = (local // nx) % ny
    cols = np.empty((local_nrow, len(shifts)), dtype=np.int64)
    valid = np.empty((local_nrow, len(shifts)), dtype=bool)
    for k, (sz, sy, sx) in enumerate(shifts):
        cols[:, k] = start_row + local + (sz * nx * ny + sy * nx + sx)
        valid[:, k] = ((ix + sx >= 0) & (ix + sx < nx)
                       & (iy + sy >= 0) & (iy + sy < ny)
                       & (cols[:, k] >= 0) & (cols[:, k] < total_nrow))
    counts = valid.sum(axis=1)
    col = cols[valid]  # row-major: keeps the reference's per-row order
    row_ptr = np.zeros(local_nrow + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    rows = start_row + np.repeat(local, counts)
    return HostCSR(
        row_ptr=row_ptr,
        col=col,
        val=np.where(col == rows, 27.0, -1.0),
        nr=local_nrow,
        nc=local_nrow,
        start_row=start_row,
        total_nr=total_nrow,
        total_nnz=int(row_ptr[-1]) if size == 1 else 27 * total_nrow,
        model_total_nnz=27 * total_nrow,
    )


# -- RGL: the seeded random-graph Laplacian (JAX host/rgl.py) ---------------
#
# Undirected edge (i, j), 0 < |i - j| <= band, exists iff
# mix32(min, max, seed) < floor(p * 2^32) with p = deg / (2 band): symmetric
# by construction. A = Laplacian + I (a_ij = -1 on edges, a_ii = degree + 1)
# is strictly diagonally dominant, so SPD, and its row sums are exactly 1:
# b = A 1 = ones and the exact solution is x == 1. formats/rgl_build.py
# evaluates the same formulas on the device.

_M1 = np.uint32(0x9E3779B1)
_M2 = np.uint32(0x85EBCA77)
_M3 = np.uint32(0xC2B2AE3D)
_F1 = np.uint32(0x2C1B3C6D)
_F2 = np.uint32(0x297A2D39)


def mix32(lo, hi, seed: int):
    """Murmur3-style 32-bit pair hash of nonnegative integer arrays;
    uint32 out."""
    with np.errstate(over="ignore"):
        h = (
            lo.astype(np.uint32) * _M1
            + hi.astype(np.uint32) * _M2
            + np.uint32(seed) * _M3
        )
        h ^= h >> np.uint32(15)
        h *= _F1
        h ^= h >> np.uint32(13)
        h *= _F2
        h ^= h >> np.uint32(16)
    return h


def threshold(band: int, deg: float) -> np.uint32:
    p = min(max(deg / (2.0 * band), 0.0), 1.0)
    return np.uint32(min(int(p * 2.0**32), 2**32 - 1))


def rgl_edges_for_rows(rows: np.ndarray, n: int, band: int, deg: float,
                       seed: int):
    """(mask, cols, edge) over the (rows, 2*band+1 offsets) grid: ``edge``
    the graph's edges, ``mask`` the stored entries (edges and the o == 0
    diagonal), ``cols`` the column of each grid point."""
    o = np.arange(-band, band + 1, dtype=np.int64)
    i = rows.astype(np.int64)[:, None]
    j = i + o[None, :]
    inb = (j >= 0) & (j < n) & (o[None, :] != 0)
    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    h = mix32(np.maximum(lo, 0), np.maximum(hi, 0), seed)
    edge = inb & (h < threshold(band, deg))
    mask = edge | (o[None, :] == 0)
    return mask, j, edge


def rgl_csr(n: int, band: int = 512, deg: float = 16.0, seed: int = 1,
            chunk: int = 4096) -> HostCSR:
    """Host CSR of the RGL matrix (the oracle of the device build)."""
    rows_l, cols_l, vals_l = [], [], []
    for start in range(0, n, chunk):
        rows = np.arange(start, min(start + chunk, n))
        mask, j, edge = rgl_edges_for_rows(rows, n, band, deg, seed)
        degree = edge.sum(axis=1)
        val = np.where(j == rows[:, None], degree[:, None] + 1.0, -1.0)
        r_idx, o_idx = np.nonzero(mask)
        rows_l.append(rows[r_idx])
        cols_l.append(j[r_idx, o_idx])
        vals_l.append(val[r_idx, o_idx])
    return _csr(np.concatenate(rows_l), np.concatenate(cols_l),
                np.concatenate(vals_l), n, n)


# -- RCM: reverse Cuthill-McKee reordering (JAX host/rcm.py) ----------------


def rcm_permutation(csr: HostCSR) -> np.ndarray:
    """Permutation ``perm`` with new row/col i taken from old index
    ``perm[i]`` (symmetrized connectivity): scipy's csgraph where it is
    installed, else ``_rcm_numpy``."""
    if csr.nr != csr.nc:
        raise ValueError("RCM needs a square matrix")
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError:
        return _rcm_numpy(csr)
    m = csr_matrix((np.ones(csr.nnz, np.int8), csr.col, csr.row_ptr),
                   shape=(csr.nr, csr.nc))
    return np.asarray(reverse_cuthill_mckee(m, symmetric_mode=False),
                      dtype=np.int64)


def _rcm_numpy(csr: HostCSR) -> np.ndarray:
    """BFS from a minimum-degree node, neighbours visited in degree order,
    result reversed; restarted per connected component."""
    nr = csr.nr
    rows = np.repeat(np.arange(nr, dtype=np.int64), csr.row_lengths)
    src = np.concatenate([rows, csr.col])
    dst = np.concatenate([csr.col, rows])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    ptr = np.searchsorted(src, np.arange(nr + 1))
    degree = np.diff(ptr)

    visited = np.zeros(nr, dtype=bool)
    out = np.empty(nr, dtype=np.int64)
    pos = 0
    for seed in np.argsort(degree, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        queue = [int(seed)]
        while queue:
            u = queue.pop(0)
            out[pos] = u
            pos += 1
            nbrs = dst[ptr[u]:ptr[u + 1]]
            nbrs = np.unique(nbrs[~visited[nbrs]])
            nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
            visited[nbrs] = True
            queue.extend(int(v) for v in nbrs)
    return out[::-1].copy()


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv


def permute_csr(csr: HostCSR, perm: np.ndarray) -> HostCSR:
    """Symmetric permutation A' = A[perm][:, perm], rows re-sorted by
    column. Vectors map as v' = v[perm]; solutions map back with
    ``x[inverse_permutation(perm)]``."""
    inv = inverse_permutation(perm)
    lens = csr.row_lengths[perm]
    new_row_ptr = np.zeros(csr.nr + 1, dtype=csr.row_ptr.dtype)
    np.cumsum(lens, out=new_row_ptr[1:])
    take = np.concatenate(
        [np.arange(csr.row_ptr[p], csr.row_ptr[p + 1]) for p in perm]
    ) if csr.nnz else np.empty(0, dtype=np.int64)
    new_col = inv[csr.col[take]]
    new_val = csr.val[take]
    new_rows = np.repeat(np.arange(csr.nr, dtype=np.int64), lens)
    order = np.lexsort((new_col, new_rows))
    return HostCSR(row_ptr=new_row_ptr, col=new_col[order],
                   val=new_val[order], nr=csr.nr, nc=csr.nc,
                   start_row=csr.start_row, total_nr=csr.total_nr,
                   total_nnz=csr.total_nnz)
