"""crs_spmv_roofline.crs (%): K14 (``ops/crs_spmv.py``,
``csrc/crs_spmv.cu``) in the CG solves of the CRS configuration: its least
time over its mean device time in the traced window. Least time: the
larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s, counted
from the configuration's shapes: every entry's value and column index read
once, the n + 1 row pointers read once, x read once, y written once; a
multiply and an add an entry. Layer: SpMV kernels. Moves ``solve_ms``.
None where the trace holds no K14 launch (a port without K14)."""

from harness.roofline import ITEMSIZE, rows, share_pct

KERNELS = ("crs_spmv_kernel",)
INDEX_BYTES = {"i32": 4, "i64": 8}


def axis_points(extent: int) -> int:
    """Neighbour pairs (i, i + s), |s| <= 1, inside one axis of ``extent``
    points, each point with itself included: 3 extent - 2."""
    return 3 * extent - 2


def nnz(cfg: dict) -> int:
    """The generated stencil's entries: on the 27-point stencil a product
    of the axes' neighbour counts, on the 7-point one the diagonal and two
    neighbours a point along each axis, less the grid's faces."""
    dims = (cfg["nx"], cfg["ny"], cfg["nz"])
    n = rows(cfg)
    if cfg["stencil_points"] == 27:
        out = 1
        for d in dims:
            out *= axis_points(d)
        return out
    return n + sum(2 * (d - 1) * (n // d) for d in dims)


def nbytes(cfg: dict) -> int:
    index = INDEX_BYTES[cfg["indices"]]
    n = rows(cfg)
    return (nnz(cfg) * (ITEMSIZE[cfg["values"]] + index) + (n + 1) * index
            + 2 * n * ITEMSIZE[cfg["vectors"]])


def flops(cfg: dict) -> int:
    return 2 * nnz(cfg)


def read(ctx):
    return share_pct(ctx, KERNELS, nbytes(ctx.config), flops(ctx.config))
