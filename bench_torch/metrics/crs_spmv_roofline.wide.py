"""crs_spmv_roofline.wide (%): K14's wide form (``crs_spmv_wide_kernel``
in ``csrc/crs_spmv.cu``, int64 row pointers) in the CG solves of a CRS
configuration too large for its narrow form: its least time over its mean
device time in the traced window. The work is ``crs_spmv_roofline.crs``'s
(its ``nnz`` and ``flops``: every entry's value and column index read
once, x read once, y written once, a multiply and an add an entry), with
the n + 1 row pointers read at their own width (``row_pointers``). At
440^3 in f64 that is 2,289,529,432 x (8 + 4) + 85,184,001 x 8 +
2 x 85,184,000 x 8 = 29,518,769,192 B, 8.812 ms at 3.35 TB/s. The
operations (0.068 ms at the table's 67 TFLOP/s, 0.135 ms at the card's
f64 rate of 34) never bind, so the table's f32 rate stands. Layer: SpMV
kernels. Moves ``solve_ms``. None where the trace holds no launch of the
wide form (a port without it)."""

from harness.roofline import ITEMSIZE, rows, share_pct
from harness.spec import Spec

KERNELS = ("crs_spmv_wide_kernel",)
# the narrow form's reader: the same matrix, its row pointers at the
# columns' width
CRS = Spec().reader("crs_spmv_roofline.crs")


def nbytes(cfg: dict) -> int:
    n = rows(cfg)
    return (CRS.nnz(cfg) * (ITEMSIZE[cfg["values"]]
                            + CRS.INDEX_BYTES[cfg["indices"]])
            + (n + 1) * CRS.INDEX_BYTES[cfg["row_pointers"]]
            + 2 * n * ITEMSIZE[cfg["vectors"]])


def read(ctx):
    return share_pct(ctx, KERNELS, nbytes(ctx.config), CRS.flops(ctx.config))
