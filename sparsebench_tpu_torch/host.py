"""Host-side (numpy) ingest: Matrix Market and .bmx files into a host CSR,
and the stencil generator for grids too small for the on-device DIA build.

Counterpart of sparsebench_tpu/host/ (csr.py, mmio.py, binfile.py,
generator.py), with the same rules (reference src/matrix.c,
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
    diagonal, -1 off it. One pass over all rows at once: the port calls it
    only for grids whose stencil shifts alias (nx or ny <= 2)."""
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
