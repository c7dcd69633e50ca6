"""vector_us_per_iter.crs (us): device time per iteration outside K14's
launches, of either form (the loop's fused body K15 at k = 1, its dots,
masks and the solves' checks), over the traced window's solves times
itermax. In the f64 CRS cell at 440^3 that is K15's body on 681 MB
vectors, whose bound is 11 passes of a vector, 2.24 ms at 3.35 TB/s.
Layer: solver loops (``solvers/cg.py``, ``ops/cg_multi_body.py``). Moves
``solve_ms``. None where the trace holds no K14 launch."""

# the SpMV of the solve: K14, ops/crs_spmv.py (csrc/crs_spmv.cu)
SPMV_KERNELS = ("crs_spmv_kernel", "crs_spmv_wide_kernel")


def read(ctx):
    count, spmv_s = ctx.kernel(SPMV_KERNELS)
    if not ctx.iterations or count == 0:
        return None
    return (ctx.device_s - spmv_s) / ctx.iterations * 1e6
