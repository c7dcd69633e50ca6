"""vector_us_per_iter.nrhs (us): device time per iteration outside the
multi-RHS SpMV (the blocked loop's slab operations, per-column dots,
masks and the checks), over the traced window's blocked solves times
itermax. Layer: solver loops (``solvers/cg_multi.py``). Moves
``rhs_solve_ms``."""

# the blocked SpMV: K8, ops/dia_spmm.py (csrc/dia_spmm.cu), in either form
SPMV_KERNELS = ("dia_spmm_kernel", "dia_spmm_quad_kernel")


def read(ctx):
    count, spmv_s = ctx.kernel(SPMV_KERNELS)
    if not ctx.iterations or count == 0:
        return None
    return (ctx.device_s - spmv_s) / ctx.iterations * 1e6
