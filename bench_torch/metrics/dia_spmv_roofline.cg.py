"""dia_spmv_roofline.cg (%): K1 (``ops/dia_spmv.py``, ``csrc/dia_spmv.cu``)
in the CG solves: its least time over its mean device time in the traced
window. Least time: the larger of bytes over 3.35 TB/s and operations
over 67 TFLOP/s, counted from the configuration's shapes: every stored
diagonal of n values read once, x read once, y written once; a multiply
and an add an entry. Layer: SpMV kernels. Moves ``solve_ms``."""

from harness.roofline import ITEMSIZE, rows, share_pct

KERNELS = ("dia_spmv_kernel",)


def nbytes(cfg: dict) -> int:
    n = rows(cfg)
    return (cfg["stencil_points"] * n * ITEMSIZE[cfg["values"]]
            + 2 * n * ITEMSIZE[cfg["vectors"]])


def flops(cfg: dict) -> int:
    return 2 * cfg["stencil_points"] * rows(cfg)


def read(ctx):
    return share_pct(ctx, KERNELS, nbytes(ctx.config), flops(ctx.config))
