"""dia_spmm_roofline.nrhs (%): K8 (``ops/dia_spmm.py``,
``csrc/dia_spmm.cu``, either form) in the blocked solves: its least time
over its mean device time in the traced window. Least time: the larger
of bytes over 3.35 TB/s and operations over 67 TFLOP/s, counted from the
configuration's shapes and the mix's right-hand sides k: every stored
diagonal of n values read once, X (k, n) read once, Y (k, n) written
once; a multiply and an add an entry and column. Layer: SpMV kernels.
Moves ``rhs_solve_ms``."""

from harness.roofline import ITEMSIZE, rows, share_pct

KERNELS = ("dia_spmm_kernel", "dia_spmm_quad_kernel")


def nbytes(cfg: dict, k: int) -> int:
    n = rows(cfg)
    return (cfg["stencil_points"] * n * ITEMSIZE[cfg["values"]]
            + 2 * k * n * ITEMSIZE[cfg["vectors"]])


def flops(cfg: dict, k: int) -> int:
    return 2 * cfg["stencil_points"] * rows(cfg) * k


def read(ctx):
    return share_pct(ctx, KERNELS, nbytes(ctx.config, ctx.rhs),
                     flops(ctx.config, ctx.rhs))
