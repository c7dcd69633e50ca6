"""vector_us_per_iter.cg (us): device time per iteration outside the
SpMV's kernels (the loop's vector operations, dots, masks and the
solves' checks), over the traced window's solves times itermax. Layer:
solver loops (``solvers/cg.py``). Moves ``solve_ms``."""

# the SpMV of the solve: K1, ops/dia_spmv.py (csrc/dia_spmv.cu)
SPMV_KERNELS = ("dia_spmv_kernel",)


def read(ctx):
    count, spmv_s = ctx.kernel(SPMV_KERNELS)
    if not ctx.iterations or count == 0:
        return None
    return (ctx.device_s - spmv_s) / ctx.iterations * 1e6
